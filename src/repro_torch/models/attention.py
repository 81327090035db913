"""Attention variants (port of ``repro/models/attention.py``): GQA (rope,
qk-norm, sliding window, softcap), MLA, DeepSeek-V2's multi-head latent
attention, and cross-attention (VLM cross layers, the encoder-decoder's
decoder).

Cache convention (as in the reference): one dict per layer,
``{"k": (B, S_c, Hkv, D), "v": (B, S_c, Hkv, D), "pos": (B, S_c)}`` for
GQA and ``{"ckv": (B, S_c, R), "kpe": (B, S_c, Dr), "pos": (B, S_c)}`` for
MLA, where ``pos`` holds each row's absolute position per slot (-1 =
empty) and every mask is derived from it; cross-attention reads static
``{"k", "v"}`` (B, T_src, H, D) built from the source by ``build_cross_kv``.
``positions`` is ``(S,)``
shared by the batch (prefill) or ``(B, S)`` per row (decode: the
continuous server's per-slot positions, or the wave's shared position
broadcast to ``(B, 1)``, which writes and masks as the shared position
does and is never read on the host).

Unlike the reference, ``_update_cache`` writes into the cache tensors in
place (the caller's cache dict is updated and returned): a serving step
then never copies a layer's whole cache to change one row.  A rolling
(sliding-window) cache keeps every position at slot ``pos % S_c``, also
for a prefill longer than the window whose length the window does not
divide: the write wraps around the buffer in two pieces.  The reference's
``dynamic_update_slice`` clamps that write to slot 0 (ROADMAP.md, "Notes
on the reference").

Prefill (S > 1) runs the flash-attention kernel K3 over the fresh keys and
values: GQA's at its head width, MLA's over the decompressed per-head
keys of width ``qk_nope + qk_rope`` (192 for DeepSeek-V2-Lite) with the
values zero-padded to that width and the output sliced back, since K3
has one head width D as the Pallas kernel has; cross-attention's
non-causal over the source (Sq != Sk: the kernel's suffix-aligned query
positions matter only under a causal mask or a window).  ``_mha`` (the
float32 attention of decode and of K3's plain version) attends blockwise
from ``BLOCKWISE_KV_THRESHOLD`` keys on, as the reference's does.  Decode
attends over the cache in plain PyTorch, as the JAX package does it
outside any Pallas kernel (K3 has no per-row position mask); MLA's
absorbed decode attends in the latent space in float32.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.device import torch_dtype
from repro_torch.kernels.flash_attention.ops import attn_mask as _attn_mask
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.flash_attention.ops import mha as _mha
from repro_torch.kernels.flash_attention.ops import pos_rows as _pos_rows

from .config import ModelConfig
from .layers import apply_rope, dense_init, rms_norm_vec, rope_table

NEG_INF = -1e30


def init_attention(gen, cfg: ModelConfig, device, kind: str = "attn"):
    a = cfg.attn
    d, dt = cfg.d_model, cfg.param_dtype
    if a.mla is not None and kind != "cross":
        m = a.mla
        qk = m.qk_nope_head_dim + m.qk_rope_head_dim
        # with a query LoRA, wq maps the normalised rank-q_lora_rank query
        p = {
            "wq": dense_init(gen, (m.q_lora_rank or d, a.n_heads * qk), dt,
                             device),
            "wdkv": dense_init(gen, (d, m.kv_lora_rank + m.qk_rope_head_dim),
                               dt, device),
            "ckv_norm": torch.zeros((m.kv_lora_rank,),
                                    dtype=torch_dtype(dt), device=device),
            "wuk": dense_init(gen, (m.kv_lora_rank,
                                    a.n_heads * m.qk_nope_head_dim), dt,
                              device),
            "wuv": dense_init(gen, (m.kv_lora_rank, a.n_heads * m.v_head_dim),
                              dt, device),
            "wo": dense_init(gen, (a.n_heads * m.v_head_dim, d), dt, device),
        }
        if m.q_lora_rank:
            p["wdq"] = dense_init(gen, (d, m.q_lora_rank), dt, device)
            p["q_norm"] = torch.zeros((m.q_lora_rank,),
                                      dtype=torch_dtype(dt), device=device)
        return p
    hd = cfg.head_dim()
    # cross-attention: K and V with every query head, q/k norms and a
    # tanh gate (Llama-3.2-Vision's cross layers)
    n_kv = a.n_heads if kind == "cross" else a.n_kv_heads
    p = {
        "wq": dense_init(gen, (d, a.n_heads * hd), dt, device),
        "wk": dense_init(gen, (d, n_kv * hd), dt, device),
        "wv": dense_init(gen, (d, n_kv * hd), dt, device),
        "wo": dense_init(gen, (a.n_heads * hd, d), dt, device),
    }
    if a.qk_norm or kind == "cross":
        p["q_norm"] = torch.zeros((hd,), dtype=torch_dtype(dt), device=device)
        p["k_norm"] = torch.zeros((hd,), dtype=torch_dtype(dt), device=device)
    if kind == "cross":
        p["gate"] = torch.zeros((), dtype=torch_dtype(dt), device=device)
    return p


def _update_cache(cache, positions, **new):
    """Write new tokens (each ``new`` entry (B, S, ...) into the cache
    entry of its name) IN PLACE and return the cache.

    Shared positions (S,): every position lands at slot ``pos % S_c``; a
    chunk longer than the buffer keeps its last S_c tokens, and a chunk
    that runs past the buffer's end wraps to its start.  The slots are
    indexed on the positions' device, so the write reads nothing back to
    the host.  Per-slot positions (B, S): each row scatters to its own
    slots."""
    S_c = cache["pos"].shape[1]
    if positions.dim() == 2:
        slot = (positions % S_c).long()                       # (B, S)
        b_idx = torch.arange(positions.shape[0],
                             device=positions.device)[:, None]
        for key, t in new.items():
            cache[key][b_idx, slot] = t.to(cache[key].dtype)
        cache["pos"][b_idx, slot] = positions.to(cache["pos"].dtype)
        return cache
    if positions.shape[0] > S_c:
        new = {key: t[:, -S_c:] for key, t in new.items()}
        positions = positions[-S_c:]
    slot = (positions % S_c).long()
    new["pos"] = positions[None].expand(cache["pos"].shape[0],
                                        positions.shape[0])
    for key, t in new.items():
        cache[key][:, slot] = t.to(cache[key].dtype)
    return cache


def _check_prefill_positions(positions):
    if positions.dim() != 1:
        raise NotImplementedError("multi-token steps with per-slot positions "
                                  "are not on the serving path")


def gqa_attention(params, x, cfg: ModelConfig, *, kind: str, positions,
                  cache=None, causal: bool = True):
    """kind in {"attn", "attn_local", "attn_global"}.  Returns (y, cache')."""
    a = cfg.attn
    hd = cfg.head_dim()
    B, S, _ = x.shape
    q = (x @ params["wq"]).reshape(B, S, a.n_heads, hd)
    k = (x @ params["wk"]).reshape(B, S, a.n_kv_heads, hd)
    v = (x @ params["wv"]).reshape(B, S, a.n_kv_heads, hd)
    if a.qk_norm:
        q = rms_norm_vec(params["q_norm"], q)
        k = rms_norm_vec(params["k_norm"], k)
    cos, sin = rope_table(_pos_rows(positions), hd, a.rope_theta)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)

    window = a.sliding_window if kind == "attn_local" else 0
    scale = 1.0 / math.sqrt(hd)
    if cache is not None and S == 1:
        cache = _update_cache(cache, positions, k=k, v=v)
        y = _mha(q, cache["k"], cache["v"], positions, cache["pos"],
                 causal=causal, window=window, softcap=a.attn_softcap,
                 scale=scale)
        return y @ params["wo"], cache
    _check_prefill_positions(positions)
    # prefill / full-sequence forward: the cache (if any) was empty, so the
    # fresh K/V are its whole content; positions are an arange, so the
    # kernel's suffix-aligned causal mask is the position mask
    if cache is not None:
        cache = _update_cache(cache, positions, k=k, v=v)
    y = _k3(q, k, v, cfg, causal=causal, window=window,
            softcap=a.attn_softcap, scale=scale)
    return y.reshape(B, S, a.n_heads * hd) @ params["wo"], cache


def _k3(q, k, v, cfg: ModelConfig, **kw):
    """K3 over q / k / v -> (B, Sq, Hq, D) in q's dtype.  A float32 cross
    source promotes the cross keys and values, and the encoder, to float32
    (as the reference's source does); the kernel takes ``cfg.dtype``, so on
    the card such operands are rounded at its boundary.  On the CPU the
    plain version attends in float32 whatever their dtype."""
    dt = torch_dtype(cfg.dtype)
    if q.is_cuda and any(t.dtype != dt for t in (q, k, v)):
        return flash_attention(*(t.to(dt).contiguous() for t in (q, k, v)),
                               **kw).to(q.dtype)
    return flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                           **kw)


def mla_attention(params, x, cfg: ModelConfig, *, positions, cache=None):
    """DeepSeek-V2's multi-head latent attention.  Returns (y, cache').

    The cache holds the normalised latent ``ckv`` (R wide) and the rotary
    key ``kpe`` (Dr wide, shared by the heads).  Prefill decompresses the
    fresh latents to per-head keys and values and runs K3 over them;
    decode attends over the cache, absorbed (``wuk`` folded into the
    query, ``wuv`` applied to the latent output, float32) or, with
    ``absorbed_decode=False``, decompressed as prefill does."""
    a, m = cfg.attn, cfg.attn.mla
    B, S, _ = x.shape
    H = a.n_heads
    nope, rp, vd, R = (m.qk_nope_head_dim, m.qk_rope_head_dim,
                       m.v_head_dim, m.kv_lora_rank)
    if m.q_lora_rank:
        cq = rms_norm_vec(params["q_norm"], x @ params["wdq"])
        q = (cq @ params["wq"]).reshape(B, S, H, nope + rp)
    else:
        q = (x @ params["wq"]).reshape(B, S, H, nope + rp)
    q_nope, q_pe = q[..., :nope], q[..., nope:]

    dkv = x @ params["wdkv"]
    ckv = rms_norm_vec(params["ckv_norm"], dkv[..., :R])        # (B, S, R)
    kpe = dkv[..., R:][:, :, None, :]                           # (B,S,1,rp)
    cos, sin = rope_table(_pos_rows(positions), rp, a.rope_theta)
    q_pe = apply_rope(q_pe, cos, sin)
    kpe = apply_rope(kpe, cos, sin)
    scale = 1.0 / math.sqrt(nope + rp)

    if cache is not None and S == 1:
        cache = _update_cache(cache, positions, ckv=ckv, kpe=kpe[:, :, 0])
        ckv_all, kpe_all, k_pos = cache["ckv"], cache["kpe"], cache["pos"]
        if m.absorbed_decode:
            wuk = params["wuk"].reshape(R, H, nope).float()
            q_lat = torch.einsum("bqhn,rhn->bqhr", q_nope.float(), wuk)
            ckv_f = ckv_all.float()                             # (B, S_c, R)
            s = torch.einsum("bqhr,bsr->bhqs", q_lat, ckv_f)
            s = s + torch.einsum("bqhp,bsp->bhqs", q_pe.float(),
                                 kpe_all.float())
            s = s / math.sqrt(nope + rp)
            valid = _attn_mask(positions, k_pos, causal=True, window=0)
            s = torch.where(valid[:, None], s, NEG_INF)
            p = torch.softmax(s, dim=-1)                        # (B,H,1,S_c)
            o_lat = torch.einsum("bhqs,bsr->bqhr", p, ckv_f)
            wuv = params["wuv"].reshape(R, H, vd).float()
            y = torch.einsum("bqhr,rhv->bqhv", o_lat, wuv)
            y = y.reshape(B, S, H * vd).to(x.dtype)
            return y @ params["wo"], cache
        k, v = _mla_decompress(params, ckv_all, kpe_all[:, :, None], H, nope,
                               rp, vd)
        y = _mha(torch.cat([q_nope, q_pe], dim=-1), k, v, positions, k_pos,
                 causal=True, window=0, softcap=0.0, scale=scale)
        return y @ params["wo"], cache

    # prefill / full-sequence forward over the fresh latents (the cache, if
    # any, was empty); positions are an arange, so K3's suffix-aligned
    # causal mask is the position mask
    _check_prefill_positions(positions)
    if cache is not None:
        cache = _update_cache(cache, positions, ckv=ckv, kpe=kpe[:, :, 0])
    k, v = _mla_decompress(params, ckv, kpe, H, nope, rp, vd)
    q_full = torch.cat([q_nope, q_pe], dim=-1)
    # K3 has one head width: the values are zero-padded to the keys' and
    # the padded output columns (zero) are dropped
    v = F.pad(v, (0, nope + rp - vd))
    y = flash_attention(q_full, k, v, causal=True, scale=scale)[..., :vd]
    return y.reshape(B, S, H * vd) @ params["wo"], cache


def _mla_decompress(params, ckv, kpe, H, nope, rp, vd):
    """Latents (B, Sk, R) and rotary keys (B, Sk, 1, rp) -> per-head keys
    (B, Sk, H, nope + rp) and values (B, Sk, H, vd)."""
    B, Sk = ckv.shape[:2]
    k_nope = (ckv @ params["wuk"]).reshape(B, Sk, H, nope)
    v = (ckv @ params["wuv"]).reshape(B, Sk, H, vd)
    k = torch.cat([k_nope, kpe.expand(B, Sk, H, rp).to(k_nope.dtype)],
                  dim=-1)
    return k, v


# --------------------------------------------------------------------------
# Cross-attention (VLM cross layers / enc-dec decoder)
# --------------------------------------------------------------------------

def build_cross_kv(params, src, cfg: ModelConfig):
    """Keys and values (B, T, H, D) of the encoder / vision embeddings
    ``src`` (B, T, d), every query head its own, in the dtype that ``src``
    and the weights promote to (float32 for the reference's float32
    source over bfloat16 weights)."""
    a = cfg.attn
    hd = cfg.head_dim()
    B, T, _ = src.shape
    dt = torch.promote_types(src.dtype, params["wk"].dtype)
    src = src.to(dt)
    k = (src @ params["wk"].to(dt)).reshape(B, T, a.n_heads, hd)
    v = (src @ params["wv"].to(dt)).reshape(B, T, a.n_heads, hd)
    if "k_norm" in params:
        k = rms_norm_vec(params["k_norm"], k)
    return {"k": k, "v": v}


def cross_attention(params, x, cfg: ModelConfig, cross_kv):
    """x (B, S, d) attends to every source position, unmasked.  A prompt
    (S > 1) runs K3 non-causal over the T source keys; decode (S = 1)
    attends in plain PyTorch, as the self-attention's decode does."""
    a = cfg.attn
    hd = cfg.head_dim()
    B, S, _ = x.shape
    q = (x @ params["wq"]).reshape(B, S, a.n_heads, hd)
    if "q_norm" in params:
        q = rms_norm_vec(params["q_norm"], q)
    k, v = cross_kv["k"], cross_kv["v"]
    scale = 1.0 / math.sqrt(hd)
    if S > 1:
        y = _k3(q, k, v, cfg, causal=False, scale=scale)
        y = y.reshape(B, S, a.n_heads * hd)
    else:
        T = k.shape[1]
        zeros = lambda n: torch.zeros((n,), dtype=torch.int32,
                                      device=x.device)
        y = _mha(q, k, v, zeros(S), zeros(T), causal=False, window=0,
                 softcap=0.0, scale=scale)
    y = y @ params["wo"]
    if "gate" in params:
        y = torch.tanh(params["gate"].float()).to(y.dtype) * y
    return y
