"""Transformer/SSD block assembly (port of ``repro/models/blocks.py``).

One block = mixer (attention variant or mamba) + MLP (dense, MoE or none),
with pre-norms (and Gemma-2's post-norms when ``cfg.post_block_norm``).

``apply_block(params, x, cfg, kinds, ...) -> (y, new_cache, moe_info)``
where ``kinds = (mixer_kind, mlp_kind)`` from ``config.layer_pattern``.

Cache dicts per mixer kind (written in place, like every cache of the
port):
  attn*:       {"k","v","pos"} (MLA: {"ckv","kpe","pos"})
  mamba:       {"ssm","conv_x","conv_B","conv_C"}
  cross:       {"xk","xv"}              (static cross K/V, built at prefill)
  self_cross:  {"k","v","pos","xk","xv"}
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.device import torch_dtype
from repro_torch.spans import span

from .attention import (apply_gate, build_cross_kv, cross_attention,
                        gqa_attention, init_attention, mla_attention)
from .config import ModelConfig
from .layers import apply_mlp, apply_norm, init_mlp, init_norm
from .mamba import apply_mamba, init_mamba, init_mamba_cache
from .moe import apply_moe, init_moe


def init_block(gen, cfg: ModelConfig, kinds, device):
    mixer_kind, mlp_kind = kinds
    p = {"norm1": init_norm(cfg, device)}
    if mixer_kind == "mamba":
        p["mixer"] = init_mamba(gen, cfg, device)
    elif mixer_kind == "cross":
        p["mixer"] = init_attention(gen, cfg, device, kind="cross")
        p["mlp_gate"] = torch.zeros((), dtype=torch_dtype(cfg.param_dtype),
                                    device=device)
    elif mixer_kind == "self_cross":
        p["mixer"] = init_attention(gen, cfg, device, kind="attn")
        p["cross"] = init_attention(gen, cfg, device, kind="cross")
        p["norm_cross"] = init_norm(cfg, device)
    else:
        p["mixer"] = init_attention(gen, cfg, device, kind=mixer_kind)
    if cfg.post_block_norm:
        p["norm1_post"] = init_norm(cfg, device)
    if mlp_kind != "none":
        p["norm2"] = init_norm(cfg, device)
        p["mlp"] = (init_moe(gen, cfg, device) if mlp_kind == "moe"
                    else init_mlp(gen, cfg, device))
        if cfg.post_block_norm:
            p["norm2_post"] = init_norm(cfg, device)
    return p


def _cross_kv(params, cache, cross_src, cfg: ModelConfig):
    """The cross keys and values: from the cache when no source is given
    (decode, or a server that passes none), else built from the source and,
    with a cache, written into it in place."""
    from repro_torch.launch.sharding import layout_active
    if cache is not None and cross_src is None:
        return {"k": cache["xk"], "v": cache["xv"]}
    ckv = build_cross_kv(params, cross_src, cfg)
    if cache is not None:
        if cache["xk"].shape != ckv["k"].shape:
            raise ValueError(
                f"a cross source of {ckv['k'].shape[1]} positions does not "
                f"fit the cache's {cache['xk'].shape[1]} (init_caches' "
                "n_cross)")
        if layout_active():
            _write_cross_laid(cache, ckv)
        else:
            cache["xk"].copy_(ckv["k"])
            cache["xv"].copy_(ckv["v"])
    return ckv


def _write_cross_laid(cache, ckv):
    """The fresh cross keys and values (heads over 'model') into a laid-out
    cache in place: the cache lies with its heads whole (``cache_pspecs``,
    as the reference lays it), so each is gathered over 'model' first."""
    from repro_torch.launch.layout import local_kernel

    def put(c, t):
        return c.copy_(t.to(c.dtype))

    for key, t in (("xk", ckv["k"]), ("xv", ckv["v"])):
        c = cache[key]
        cache[key] = local_kernel(put, [c.placements, c.placements],
                                  c.placements)(c, t)


# the residual stream's logical dims (the reference's blocks.py hints)
_RES = ("batch", "res_seq", "embed")


def _norm(params, x, cfg: ModelConfig):
    """``apply_norm``; under laid-out rules on each rank's tokens."""
    from repro_torch.launch.sharding import layout_active

    from .layers import norm_laid
    return (norm_laid if layout_active() else apply_norm)(params, x, cfg)


def _add(x, y):
    """The residual add; under laid-out rules on the local tensors of two
    DTensors laid out alike."""
    from repro_torch.launch.layout import add
    from repro_torch.launch.sharding import layout_active
    return add(x, y) if layout_active() else x + y


def _mlp(params, h, cfg: ModelConfig):
    """The dense FFN; under laid-out rules with its hidden dim over 'model'
    on the tokens as the reference hints them, ``Partial`` over 'model'."""
    from repro_torch.launch.sharding import hint, layout_active

    from .layers import mlp_laid
    if layout_active():
        return mlp_laid(params, hint(h, "batch", "seq", "embed"), cfg)
    return apply_mlp(params, h, cfg)


def apply_block(params, x, cfg: ModelConfig, kinds, *, positions,
                cache=None, cross_src=None, causal: bool = True,
                moe_capacity: Optional[int] = None,
                slots=None, slot_fetch=None, slot_live=None,
                slot_phase: str = "decode", layer: Optional[int] = None):
    """One block.  Under laid-out rules (DTensor inputs, no slot pool) the
    residual stream ``x`` lies as the reference hints it ("batch",
    "res_seq", "embed"), and each mixer's and MLP's output (``Partial``
    over 'model') is reduced back to it there (``hint``, a no-op
    otherwise).  ``layer``, the block's index in the model, is an attribute
    of its spans.  Cross layers follow the reference's ``blocks.py:71-97``:
    their keys and values come from the cache when no source is given,
    else are built from ``cross_src`` and written into it."""
    from repro_torch.launch.sharding import hint
    mixer_kind, mlp_kind = kinds
    moe_info = None
    with span("model.attn", layer=layer):
        h = _norm(params["norm1"], x, cfg)
        if mixer_kind == "mamba":
            y, cache = apply_mamba(params["mixer"], h, cfg, cache)
        elif mixer_kind == "cross":
            ckv = _cross_kv(params["mixer"], cache, cross_src, cfg)
            y = cross_attention(params["mixer"], h, cfg, ckv)
        elif mixer_kind == "self_cross":
            y, cache = gqa_attention(params["mixer"], h, cfg, kind="attn",
                                     positions=positions, cache=cache,
                                     causal=causal)
            ckv = _cross_kv(params["cross"], cache, cross_src, cfg)
            x = _add(x, hint(y, *_RES))
            h = _norm(params["norm_cross"], x, cfg)
            y = cross_attention(params["cross"], h, cfg, ckv)
        elif cfg.attn.mla is not None:
            y, cache = mla_attention(params["mixer"], h, cfg,
                                     positions=positions, cache=cache)
        else:
            y, cache = gqa_attention(params["mixer"], h, cfg,
                                     kind=mixer_kind, positions=positions,
                                     cache=cache, causal=causal)
        y = hint(y, *_RES)
        if cfg.post_block_norm:
            y = _norm(params["norm1_post"], y, cfg)
        x = _add(x, y)

    if mlp_kind != "none":
        with span("model.moe" if mlp_kind == "moe" else "model.mlp",
                  layer=layer):
            h = _norm(params["norm2"], x, cfg)
            if mlp_kind == "moe":
                y, moe_info = apply_moe(params["mlp"], h, cfg,
                                        capacity=moe_capacity, slots=slots,
                                        slot_fetch=slot_fetch,
                                        slot_live=slot_live,
                                        slot_phase=slot_phase)
            else:
                y = _mlp(params["mlp"], h, cfg)
                if mixer_kind == "cross":   # gated FFN on VLM cross layers
                    y = apply_gate(y, params["mlp_gate"])
            y = hint(y, *_RES)
            if cfg.post_block_norm:
                y = _norm(params["norm2_post"], y, cfg)
            x = _add(x, y)
    return x, cache, moe_info


def init_block_cache(cfg: ModelConfig, kinds, batch: int, max_len: int,
                     device, dtype=None, n_cross: Optional[int] = None):
    """An empty cache for one block: the SSM state and conv window for
    Mamba; keys and values for GQA, latents and rotary keys for MLA; the
    cross keys and values (``n_cross`` source positions: the vision
    tokens by default, ``max_len`` for an encoder-decoder) for cross
    layers."""
    mixer_kind, _ = kinds
    dt = torch_dtype(dtype or cfg.dtype)
    if mixer_kind == "mamba":
        return init_mamba_cache(cfg, batch, device, dtype=dt)
    a = cfg.attn
    hd = cfg.head_dim()
    zeros = lambda *shape: torch.zeros(shape, dtype=dt, device=device)
    if mixer_kind == "cross":
        T = n_cross or cfg.n_vision_tokens
        return {"xk": zeros(batch, T, a.n_heads, hd),
                "xv": zeros(batch, T, a.n_heads, hd)}
    S_c = max_len
    if mixer_kind == "attn_local" and a.sliding_window:
        S_c = min(max_len, a.sliding_window)
    pos = torch.full((batch, S_c), -1, dtype=torch.int32, device=device)
    if a.mla is not None:
        m = a.mla
        return {"ckv": zeros(batch, S_c, m.kv_lora_rank),
                "kpe": zeros(batch, S_c, m.qk_rope_head_dim),
                "pos": pos}
    c = {"k": zeros(batch, S_c, a.n_kv_heads, hd),
         "v": zeros(batch, S_c, a.n_kv_heads, hd),
         "pos": pos}
    if mixer_kind == "self_cross":
        T = n_cross or max_len
        c["xk"] = zeros(batch, T, a.n_heads, hd)
        c["xv"] = zeros(batch, T, a.n_heads, hd)
    return c
