"""GQA flash attention (K3): causal mask, sliding window, tanh softcap,
query i at key position Sk - Sq + i; ``csrc/flash_attention.cu``.

``flash_attention`` launches the kernel for CUDA tensors and runs
``flash_attention_plain`` (float32 softmax) for CPU tensors.  The plain
version builds the whole score matrix below ``BLOCKWISE_KV_THRESHOLD``
keys and attends blockwise at or above it (``mha_blockwise``, the
reference's ``_mha_blockwise``: an online softmax over blocks of keys,
query slab by query slab), so its memory stays bounded at long prompts.
q (B, Sq, Hq, D); k / v (B, Sk, Hkv, D) -> (B, Sq, Hq, D) in q's dtype;
the kernel takes D % 16 == 0 up to ``MAX_D`` = 256 and query groups
(Hq / Hkv) that divide 64; a group that does not attends over K/V heads
repeated to one per query head.
When autograd needs a gradient (training on the card) the launch runs
inside ``FlashAttentionFn``, whose backward recomputes through
``flash_attention_plain``; otherwise ``flash_attention`` launches
directly.
"""
from __future__ import annotations

import math

import numpy as np
import torch
from torch.utils.flop_counter import register_flop_formula

from repro_torch import kernels
from repro_torch.kernels.build import check, library

NEG_INF = -1e30
# the reference's memory-bounded path (repro/models/attention.py:84-86,
# :120): at or above this many keys a multi-query attention runs an online
# softmax over blocks of BLOCKWISE_KV_BLOCK keys, BLOCKWISE_Q_CHUNK query
# rows at a time; read at call time, so a test can make them small
BLOCKWISE_KV_THRESHOLD = 4096
BLOCKWISE_KV_BLOCK = 1024
BLOCKWISE_Q_CHUNK = 2048
# the widest head the CUDA kernel takes (four 64-column slabs), the Pallas
# kernel's range; MLA's q/k heads are 192 wide
MAX_D = 256


def pos_rows(pos):
    """Normalise a position vector to per-row form (Bm, S), Bm in {1, B}."""
    return pos if pos.dim() == 2 else pos[None]


def attn_mask(q_pos, k_pos, *, causal: bool, window: int):
    """Validity mask (Bm, Sq, Sk) from per-row positions; Bm broadcasts."""
    qp = pos_rows(q_pos)[:, :, None]
    kp = pos_rows(k_pos)[:, None, :]
    valid = kp >= 0
    if causal:
        valid = valid & (kp <= qp)
    if window:
        valid = valid & (kp > qp - window)
    return valid


def masked_scores(qg, k, q_pos, k_pos, *, causal: bool, window: int,
                  softcap: float, scale: float):
    """Grouped queries qg (B, Sq, Hkv, G, D) against keys k (B, Sk, Hkv, D)
    -> float32 scores (B, Hkv, G, Sq, Sk), soft-capped, NEG_INF where the
    position mask excludes the key (``mha``, its blockwise form and the
    laid-out decode's partial softmax all score through it)."""
    s = torch.einsum("bqkgd,bskd->bkgqs", qg.float(), k.float()) * scale
    if softcap:
        s = softcap * torch.tanh(s / softcap)
    valid = attn_mask(q_pos, k_pos, causal=causal, window=window)
    return torch.where(valid[:, None, None], s, NEG_INF)


def mha_blockwise(q, k, v, q_pos, k_pos, *, causal: bool, window: int,
                  softcap: float, scale: float):
    """Online-softmax attention over blocks of ``BLOCKWISE_KV_BLOCK`` keys,
    ``BLOCKWISE_Q_CHUNK`` query rows at a time (the reference's
    ``_mha_blockwise``): O(slab x block) float32 scores instead of
    O(Sq x Sk).  q (B, Sq, Hq, D), k (B, Sk, Hkv, D), v (B, Sk, Hkv, Dv),
    positions (S,) or (B, S) -> (B, Sq, Hq * Dv) in q's dtype.  Unlike the
    reference, a query run that the slab does not divide is cut into
    slabs too (the last one shorter): each query row's arithmetic is the
    same either way."""
    q_pos, k_pos = pos_rows(q_pos), pos_rows(k_pos)
    qc = BLOCKWISE_Q_CHUNK
    return torch.cat([
        _blockwise_slab(q[:, i:i + qc], k, v, q_pos[:, i:i + qc], k_pos,
                        causal=causal, window=window, softcap=softcap,
                        scale=scale)
        for i in range(0, q.shape[1], qc)], dim=1)


def _blockwise_slab(q, k, v, q_pos, k_pos, *, causal, window, softcap,
                    scale):
    B, Sq, Hq, D = q.shape
    Sk, Hkv, Dv = k.shape[1], k.shape[2], v.shape[-1]
    G = Hq // Hkv
    qg = q.reshape(B, Sq, Hkv, G, D).float()
    m = q.new_full((B, Hkv, G, Sq), NEG_INF, dtype=torch.float32)
    l = torch.zeros_like(m)
    acc = q.new_zeros((B, Hkv, G, Sq, Dv), dtype=torch.float32)
    block = BLOCKWISE_KV_BLOCK
    for s0 in range(0, Sk, block):
        s = masked_scores(qg, k[:, s0:s0 + block], q_pos,
                          k_pos[:, s0:s0 + block], causal=causal,
                          window=window, softcap=softcap, scale=scale)
        m_new = torch.maximum(m, s.amax(-1))
        corr = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l = l * corr + p.sum(-1)
        acc = acc * corr[..., None] + torch.einsum(
            "bkgqs,bskd->bkgqd", p, v[:, s0:s0 + block].float())
        m = m_new
    o = acc / l.clamp(min=1e-30)[..., None]                 # (B,K,G,Sq,Dv)
    return o.permute(0, 3, 1, 2, 4).reshape(B, Sq, Hq * Dv).to(q.dtype)


def mha(q, k, v, q_pos, k_pos, *, causal: bool, window: int,
        softcap: float, scale: float):
    """q (B, Sq, Hq, D), k (B, Sk, Hkv, D), v (B, Sk, Hkv, Dv), positions
    (S,) or (B, S) -> (B, Sq, Hq * Dv) in q's dtype; float32 softmax over
    the whole score matrix, or blockwise (``mha_blockwise``) for a
    multi-query attention over ``BLOCKWISE_KV_THRESHOLD`` keys or more, as
    the reference's ``_mha`` does.  Decode (Sq = 1) stays dense."""
    if q.shape[1] > 1 and k.shape[1] >= BLOCKWISE_KV_THRESHOLD:
        return mha_blockwise(q, k, v, q_pos, k_pos, causal=causal,
                             window=window, softcap=softcap, scale=scale)
    B, Sq, Hq, D = q.shape
    Hkv = k.shape[2]
    G = Hq // Hkv
    s = masked_scores(q.reshape(B, Sq, Hkv, G, D), k, q_pos, k_pos,
                      causal=causal, window=window, softcap=softcap,
                      scale=scale)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgqs,bskd->bqkgd", p, v.float())
    return o.reshape(B, Sq, Hq * v.shape[-1]).to(q.dtype)


def flash_attention_plain(q, k, v, *, causal: bool = True, window: int = 0,
                          softcap: float = 0.0, scale: float | None = None):
    """The kernel's plain version: ``mha`` with query i at key position
    Sk - Sq + i -> (B, Sq, Hq, Dv)."""
    B, Sq, Hq, D = q.shape
    Sk = k.shape[1]
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    q_pos = torch.arange(Sk - Sq, Sk, device=q.device)
    k_pos = torch.arange(Sk, device=q.device)
    return mha(q, k, v, q_pos, k_pos, causal=causal, window=window,
               softcap=softcap, scale=scale).reshape(B, Sq, Hq, -1)


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    softcap: float = 0.0, scale: float | None = None):
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window,
                                     softcap=softcap, scale=scale)
    if q.device.type not in ("cuda", "meta"):
        raise ValueError(f"flash_attention takes CPU, CUDA or meta tensors, "
                         f"got {q.device}")
    B, Sq, Hq, D = q.shape
    if k.dim() != 4 or k.shape[0] != B or k.shape[3] != D \
            or tuple(v.shape) != tuple(k.shape):
        raise ValueError(f"k/v must be (B, Sk, Hkv, {D}) matching q, got "
                         f"{tuple(k.shape)} / {tuple(v.shape)}")
    Hkv = k.shape[2]
    if Hkv and Hq % Hkv == 0 and 64 % (Hq // Hkv):
        # the kernel packs a KV head's G query heads into one 64-row tile,
        # so G must divide 64; a group that does not (Llama-4: 40 / 8 = 5)
        # attends over its K/V heads repeated G times (G = 1)
        k = k.repeat_interleave(Hq // Hkv, dim=2)
        v = v.repeat_interleave(Hq // Hkv, dim=2)
        Hkv = Hq
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device or t.dtype != torch.bfloat16 \
                or not t.is_contiguous():
            raise ValueError(f"flash_attention's CUDA kernel takes contiguous "
                             f"bfloat16 tensors on {q.device}; {name} is "
                             f"{t.dtype} on {t.device}")
    if D % 16 or D > MAX_D or Hq % Hkv or 64 % (Hq // Hkv):
        raise ValueError(f"flash_attention's CUDA kernel needs D % 16 == 0, "
                         f"D <= {MAX_D} and (Hq / Hkv) dividing 64; got D={D} "
                         f"Hq={Hq} Hkv={Hkv}")
    if max(B, Sq, k.shape[1], Hq * D) >= 2**31:
        raise ValueError("flash_attention's CUDA kernel indexes positions "
                         "and head columns in 32 bits")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.data_ptr() % 16:
            raise ValueError(f"flash_attention's CUDA kernel needs 16-byte-"
                             f"aligned tensors; {name} is not")
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    opts = (bool(causal), int(window), float(softcap), float(scale))
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return FlashAttentionFn.apply(q, k, v, *opts)
    return _launch(q, k, v, *opts)


def pairs(Sq: int, Sk: int, causal: bool, window: int) -> int:
    """(query, key) pairs the mask leaves visible, query i at key position
    Sk - Sq + i: what the kernel computes (it skips tiles no row sees)."""
    qpos = np.arange(Sk - Sq, Sk, dtype=np.int64)
    hi = np.minimum(qpos, Sk - 1) if causal else np.full(Sq, Sk - 1)
    lo = np.maximum(qpos - window + 1, 0) if window else np.zeros(Sq, np.int64)
    return int(np.maximum(hi - lo + 1, 0).sum())


def flops(B: int, Sq: int, Sk: int, Hq: int, D: int, causal: bool,
          window: int) -> int:
    """The kernel's operations: Q K^T and P V, 2 D each per visible pair."""
    return 4 * B * Hq * D * pairs(Sq, Sk, causal, window)


@torch.library.custom_op(
    "repro_torch::flash_attention", mutates_args=(),
    schema="(Tensor q, Tensor k, Tensor v, bool causal, int window, "
           "float softcap, float scale) -> Tensor")
def _shape_op(q, k, v, causal, window, softcap, scale):
    """K3 on the ``meta`` device: only its fake (shape) implementation and
    FLOP formula exist."""
    raise RuntimeError("repro_torch::flash_attention runs on the meta "
                       "device only")


@_shape_op.register_fake
def _(q, k, v, causal, window, softcap, scale):
    return torch.empty_like(q)


@register_flop_formula(torch.ops.repro_torch.flash_attention)
def _flop_formula(q, k, v, causal, window, *args, out_shape=None, **kwargs):
    B, Sq, Hq, D = q
    return flops(B, Sq, k[1], Hq, D, causal, window)


def _launch(q, k, v, causal: bool, window: int, softcap: float,
            scale: float):
    """Launch the CUDA kernel on checked tensors -> (B, Sq, Hq, D); on
    ``meta`` the shape op."""
    if q.device.type == "meta":
        return torch.ops.repro_torch.flash_attention(q, k, v, causal, window,
                                                     softcap, scale)
    B, Sq, Hq, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    o = torch.empty_like(q)
    if B == 0 or Sq == 0:
        return o
    stream = torch.cuda.current_stream(q.device).cuda_stream
    check(library().flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), B, Sq, Sk, Hq,
        Hkv, D, int(causal), window, softcap, scale, stream),
        "flash_attention")
    kernels.LAUNCHES["flash_attention"] += 1
    kernels.K3_FORMS["noncausal"] += not causal
    kernels.K3_FORMS["window_softcap"] += bool(window and softcap)
    return o


class FlashAttentionFn(torch.autograd.Function):
    """K3 for autograd: the forward launches the kernel, the backward
    recomputes the attention through ``flash_attention_plain`` and
    differentiates it (dq, dk, dv)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, softcap, scale):
        ctx.save_for_backward(q, k, v)
        ctx.opts = dict(causal=causal, window=window, softcap=softcap,
                        scale=scale)
        return _launch(q, k, v, causal, window, softcap, scale)

    @staticmethod
    def backward(ctx, go):
        return kernels.recompute_grads(
            "flash_attention_bwd",
            lambda *qkv: flash_attention_plain(*qkv, **ctx.opts),
            ctx.saved_tensors, ctx.needs_input_grad[:3], go, 4)
