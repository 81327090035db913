"""GQA flash attention (K3): causal mask, sliding window, tanh softcap,
query i at key position Sk - Sq + i; ``csrc/flash_attention.cu``.

``flash_attention`` launches the kernel for CUDA tensors and runs
``flash_attention_plain`` (dense softmax, float32) for CPU tensors.
q (B, Sq, Hq, D); k / v (B, Sk, Hkv, D) -> (B, Sq, Hq, D) in q's dtype;
the kernel takes D % 16 == 0 up to ``MAX_D`` = 256.
When autograd needs a gradient (training on the card) the launch runs
inside ``FlashAttentionFn``, whose backward recomputes through
``flash_attention_plain``; otherwise ``flash_attention`` launches
directly.
"""
from __future__ import annotations

import math

import torch

from repro_torch import kernels
from repro_torch.kernels.build import check, library

NEG_INF = -1e30
# the widest head the CUDA kernel takes (four 64-column slabs), the Pallas
# kernel's range; MLA's q/k heads are 192 wide
MAX_D = 256


def flash_attention_plain(q, k, v, *, causal: bool = True, window: int = 0,
                          softcap: float = 0.0, scale: float | None = None):
    B, Sq, Hq, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    q_pos = torch.arange(Sk - Sq, Sk, device=q.device)
    k_pos = torch.arange(Sk, device=q.device)
    qg = q.reshape(B, Sq, Hkv, G, D).float()
    s = torch.einsum("bqkgd,bskd->bkgqs", qg, k.float()) * scale
    if softcap:
        s = softcap * torch.tanh(s / softcap)
    valid = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        valid &= k_pos[None, :] <= q_pos[:, None]
    if window:
        valid &= k_pos[None, :] > q_pos[:, None] - window
    s = torch.where(valid, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgqs,bskd->bqkgd", p, v.float())
    return o.reshape(B, Sq, Hq, D).to(q.dtype)


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    softcap: float = 0.0, scale: float | None = None):
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window,
                                     softcap=softcap, scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention takes CPU or CUDA tensors, got "
                         f"{q.device}")
    B, Sq, Hq, D = q.shape
    if k.dim() != 4 or k.shape[0] != B or k.shape[3] != D \
            or tuple(v.shape) != tuple(k.shape):
        raise ValueError(f"k/v must be (B, Sk, Hkv, {D}) matching q, got "
                         f"{tuple(k.shape)} / {tuple(v.shape)}")
    Hkv = k.shape[2]
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
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.data_ptr() % 16:
            raise ValueError(f"flash_attention's CUDA kernel needs 16-byte-"
                             f"aligned tensors; {name} is not")
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    opts = (bool(causal), int(window), float(softcap), float(scale))
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return FlashAttentionFn.apply(q, k, v, *opts)
    return _launch(q, k, v, *opts)


def _launch(q, k, v, causal: bool, window: int, softcap: float,
            scale: float):
    """Launch the CUDA kernel on checked tensors -> (B, Sq, Hq, D)."""
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
