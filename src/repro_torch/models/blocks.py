"""Transformer block assembly (port of ``repro/models/blocks.py`` for
self-attention mixers, GQA or MLA, with a dense or MoE MLP).

``apply_block(params, x, cfg, kinds, ...) -> (y, new_cache, moe_info)``
where ``kinds = (mixer_kind, mlp_kind)`` from ``config.layer_pattern``.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.device import torch_dtype

from .attention import gqa_attention, init_attention, mla_attention
from .config import ModelConfig
from .layers import apply_mlp, apply_norm, init_mlp, init_norm
from .moe import apply_moe, init_moe

ATTN_KINDS = ("attn", "attn_local", "attn_global")


def _check_kinds(cfg: ModelConfig, kinds):
    mixer_kind, mlp_kind = kinds
    if mixer_kind not in ATTN_KINDS or mlp_kind not in ("dense", "moe") \
            or cfg.post_block_norm:
        raise NotImplementedError(
            f"block {kinds} (post_block_norm={cfg.post_block_norm}) is ported "
            "with the remaining architectures (ROADMAP.md queue 1, "
            "\"Remaining architectures\")")


def init_block(gen, cfg: ModelConfig, kinds, device):
    _check_kinds(cfg, kinds)
    mixer_kind, mlp_kind = kinds
    return {
        "norm1": init_norm(cfg, device),
        "mixer": init_attention(gen, cfg, device, kind=mixer_kind),
        "norm2": init_norm(cfg, device),
        "mlp": (init_moe(gen, cfg, device) if mlp_kind == "moe"
                else init_mlp(gen, cfg, device)),
    }


def apply_block(params, x, cfg: ModelConfig, kinds, *, positions,
                cache=None, causal: bool = True,
                moe_capacity: Optional[int] = None,
                slots=None, slot_fetch=None, slot_live=None,
                slot_phase: str = "decode"):
    _check_kinds(cfg, kinds)
    mixer_kind, mlp_kind = kinds
    h = apply_norm(params["norm1"], x, cfg)
    if cfg.attn.mla is not None:
        y, new_cache = mla_attention(params["mixer"], h, cfg,
                                     positions=positions, cache=cache)
    else:
        y, new_cache = gqa_attention(params["mixer"], h, cfg, kind=mixer_kind,
                                     positions=positions, cache=cache,
                                     causal=causal)
    x = x + y
    h = apply_norm(params["norm2"], x, cfg)
    moe_info = None
    if mlp_kind == "moe":
        y, moe_info = apply_moe(params["mlp"], h, cfg, capacity=moe_capacity,
                                slots=slots, slot_fetch=slot_fetch,
                                slot_live=slot_live, slot_phase=slot_phase)
    else:
        y = apply_mlp(params["mlp"], h, cfg)
    return x + y, new_cache, moe_info


def init_block_cache(cfg: ModelConfig, kinds, batch: int, max_len: int,
                     device, dtype=None):
    """An empty cache for one attention block: keys and values for GQA,
    latents and rotary keys for MLA."""
    _check_kinds(cfg, kinds)
    a = cfg.attn
    dt = torch_dtype(dtype or cfg.dtype)
    S_c = max_len
    if kinds[0] == "attn_local" and a.sliding_window:
        S_c = min(max_len, a.sliding_window)
    pos = torch.full((batch, S_c), -1, dtype=torch.int32, device=device)
    if a.mla is not None:
        m = a.mla
        return {"ckv": torch.zeros((batch, S_c, m.kv_lora_rank), dtype=dt,
                                   device=device),
                "kpe": torch.zeros((batch, S_c, m.qk_rope_head_dim),
                                   dtype=dt, device=device),
                "pos": pos}
    hd = cfg.head_dim()
    return {"k": torch.zeros((batch, S_c, a.n_kv_heads, hd), dtype=dt,
                             device=device),
            "v": torch.zeros((batch, S_c, a.n_kv_heads, hd), dtype=dt,
                             device=device),
            "pos": pos}
