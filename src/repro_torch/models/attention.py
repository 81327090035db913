"""GQA self-attention with a per-slot KV cache (port of the GQA part of
``repro/models/attention.py``).

Cache convention (as in the reference): one dict per layer,
``{"k": (B, S_c, Hkv, D), "v": (B, S_c, Hkv, D), "pos": (B, S_c)}``, where
``pos`` holds each row's absolute position per slot (-1 = empty) and every
mask is derived from it.  ``positions`` is ``(S,)`` shared by the batch
(prefill) or ``(B, S)`` per row (decode: the continuous server's per-slot
positions, or the wave's shared position broadcast to ``(B, 1)``, which
writes and masks as the shared position does and is never read on the
host).

Unlike the reference, ``_update_cache`` writes into the cache tensors in
place (the caller's cache dict is updated and returned): a serving step
then never copies a layer's whole cache to change one row.

Prefill (S > 1) runs the flash-attention kernel K3 over the fresh K/V;
decode attends over the cache in plain PyTorch, as the JAX package does it
outside any Pallas kernel (K3 has no per-row position mask).
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels.flash_attention.ops import flash_attention

from .config import ModelConfig
from .layers import apply_rope, dense_init, rope_table

NEG_INF = -1e30


def init_attention(gen, cfg: ModelConfig, device, kind: str = "attn"):
    a = cfg.attn
    if a.mla is not None or kind == "cross" or a.qk_norm:
        raise NotImplementedError(
            "MLA, cross-attention and qk-norm are ported with their "
            "architectures (ROADMAP.md queue 1, \"The paper's other "
            "evaluation models\" and \"Remaining architectures\")")
    d, hd, dt = cfg.d_model, cfg.head_dim(), cfg.param_dtype
    return {
        "wq": dense_init(gen, (d, a.n_heads * hd), dt, device),
        "wk": dense_init(gen, (d, a.n_kv_heads * hd), dt, device),
        "wv": dense_init(gen, (d, a.n_kv_heads * hd), dt, device),
        "wo": dense_init(gen, (a.n_heads * hd, d), dt, device),
    }


def _pos_rows(pos):
    """Normalise a position vector to per-row form (Bm, S), Bm in {1, B}."""
    return pos if pos.dim() == 2 else pos[None]


def _attn_mask(q_pos, k_pos, *, causal: bool, window: int):
    """Validity mask (Bm, Sq, Sk) from per-row positions; Bm broadcasts."""
    qp = _pos_rows(q_pos)[:, :, None]
    kp = _pos_rows(k_pos)[:, None, :]
    valid = kp >= 0
    if causal:
        valid = valid & (kp <= qp)
    if window:
        valid = valid & (kp > qp - window)
    return valid


def _mha(q, k, v, q_pos, k_pos, *, causal: bool, window: int,
         softcap: float, scale: float):
    """q (B,Sq,Hq,D), k/v (B,Sk,Hkv,D) -> (B, Sq, Hq*D); float32 softmax."""
    B, Sq, Hq, D = q.shape
    Hkv = k.shape[2]
    G = Hq // Hkv
    qg = q.reshape(B, Sq, Hkv, G, D)
    s = torch.einsum("bqkgd,bskd->bkgqs", qg.float(), k.float()) * scale
    if softcap:
        s = softcap * torch.tanh(s / softcap)
    valid = _attn_mask(q_pos, k_pos, causal=causal, window=window)
    s = torch.where(valid[:, None, None], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgqs,bskd->bqkgd", p, v.float())
    return o.reshape(B, Sq, Hq * v.shape[-1]).to(q.dtype)


def _update_cache(cache, new_k, new_v, positions):
    """Write new tokens into ``cache`` IN PLACE and return it.

    Shared positions (S,): a contiguous write from slot positions[0] % S_c
    (the chunk must not wrap the buffer; a chunk longer than the buffer
    keeps its last S_c tokens).  Per-slot positions (B, S): each row
    scatters to its own slots."""
    S_c = cache["k"].shape[1]
    if positions.dim() == 2:
        slot = (positions % S_c).long()                       # (B, S)
        b_idx = torch.arange(positions.shape[0],
                             device=positions.device)[:, None]
        cache["k"][b_idx, slot] = new_k.to(cache["k"].dtype)
        cache["v"][b_idx, slot] = new_v.to(cache["v"].dtype)
        cache["pos"][b_idx, slot] = positions.to(cache["pos"].dtype)
        return cache
    if new_k.shape[1] > S_c:
        new_k, new_v, positions = new_k[:, -S_c:], new_v[:, -S_c:], \
            positions[-S_c:]
    S = new_k.shape[1]
    # the start slot is read on the host: prefill positions are a host-side
    # arange, so this costs no device round trip on the serving path
    start = int(positions[0]) % S_c
    cache["k"][:, start:start + S] = new_k.to(cache["k"].dtype)
    cache["v"][:, start:start + S] = new_v.to(cache["v"].dtype)
    cache["pos"][:, start:start + S] = positions.to(cache["pos"].dtype)
    return cache


def gqa_attention(params, x, cfg: ModelConfig, *, kind: str, positions,
                  cache=None, causal: bool = True):
    """kind in {"attn", "attn_local", "attn_global"}.  Returns (y, cache')."""
    a = cfg.attn
    hd = cfg.head_dim()
    B, S, _ = x.shape
    q = (x @ params["wq"]).reshape(B, S, a.n_heads, hd)
    k = (x @ params["wk"]).reshape(B, S, a.n_kv_heads, hd)
    v = (x @ params["wv"]).reshape(B, S, a.n_kv_heads, hd)
    cos, sin = rope_table(_pos_rows(positions), hd, a.rope_theta)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)

    window = a.sliding_window if kind == "attn_local" else 0
    scale = 1.0 / math.sqrt(hd)
    if cache is not None and S == 1:
        cache = _update_cache(cache, k, v, positions)
        y = _mha(q, cache["k"], cache["v"], positions, cache["pos"],
                 causal=causal, window=window, softcap=a.attn_softcap,
                 scale=scale)
        return y @ params["wo"], cache
    if positions.dim() != 1:
        raise NotImplementedError("multi-token steps with per-slot positions "
                                  "are not on the serving path")
    # prefill / full-sequence forward: the cache (if any) was empty, so the
    # fresh K/V are its whole content; positions are an arange, so the
    # kernel's suffix-aligned causal mask is the position mask
    if cache is not None:
        cache = _update_cache(cache, k, v, positions)
    y = flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                        causal=causal, window=window, softcap=a.attn_softcap,
                        scale=scale)
    return y.reshape(B, S, a.n_heads * hd) @ params["wo"], cache
