"""Fused MoE router (K1): softmax / sigmoid / raw logits, k rounds of
masked argmax with ties to the lowest index, then the gate transform.

``gating`` launches ``csrc/gating.cu`` for CUDA tensors and runs
``gating_plain`` for CPU tensors.  Both return ``(gates (T,k) f32,
idx (T,k) int32, probs (T,E) f32)``; ``probs`` is the softmax of the logits
(sigmoid for the sigmoid router), the router scores ``route`` returns.
The kernel has two variants, chosen by ``plan``: one row per thread for
E <= 32 (counted in ``LAUNCHES["gating"]``) and one row per warp above
(``LAUNCHES["gating_warp"]``).  When autograd needs the logits' gradient
(training on the card) the launch runs inside ``GatingFn``, whose backward
recomputes ``gates`` and ``probs`` in plain PyTorch from the kernel's
``idx``; otherwise ``gating`` launches directly, so a serving step pays
nothing for it.
"""
from __future__ import annotations

import torch
from torch.utils.flop_counter import register_flop_formula

from repro_torch import kernels
from repro_torch.kernels.build import check, library

NEG = -1e30
ROUTER_TYPES = {"softmax_topk": 0, "topk_softmax": 1, "sigmoid": 2}
VARIANTS = {"row": 0, "warp": 1}      # csrc/gating.cuh's GatingVariant
ROW_WIDTHS = (8, 16, 32)
MAX_E, MAX_K = 256, 16
LAUNCH_KEY = {"row": "gating", "warp": "gating_warp"}


def plan(E: int, k: int) -> tuple[str, int]:
    """Variant of the CUDA kernel for E experts and top-k: ``("row", W)``,
    one row per thread with the row padded to W = 8, 16 or 32 columns, for
    E <= 32; else ``("warp", L)``, one row per warp with L = ceil(E/32)
    columns per lane.  Raises for what neither variant takes."""
    if not (1 <= E <= MAX_E and 1 <= k <= min(E, MAX_K)):
        raise ValueError(f"gating supports E <= {MAX_E} and 1 <= k <= "
                         f"min(E, {MAX_K}), got E={E} k={k}")
    if E <= ROW_WIDTHS[-1]:
        return "row", next(w for w in ROW_WIDTHS if E <= w)
    return "warp", -(-E // 32)


def _probs(x, router_type: str):
    """Router scores: sigmoid for the sigmoid router, else softmax."""
    return torch.sigmoid(x) if router_type == "sigmoid" \
        else torch.softmax(x, dim=-1)


def _gates(x, probs, idx, router_type: str, renormalize: bool):
    """The gate transform of the chosen ``idx`` (T, k): the selected logits'
    softmax (``topk_softmax``) or the selected scores, renormalised for
    ``softmax_topk``.  Differentiable in ``x`` and ``probs``."""
    src = x if router_type == "topk_softmax" else probs
    gates = src.gather(-1, idx.long())
    if router_type == "topk_softmax":
        gates = torch.softmax(gates, dim=-1)
    elif router_type == "softmax_topk" and renormalize:
        gates = gates / (gates.sum(-1, keepdim=True) + 1e-9)
    return gates


def gating_plain(logits, top_k: int, router_type: str = "softmax_topk",
                 renormalize: bool = True):
    """Plain PyTorch version of the kernel (same arithmetic, same ties).
    The selection runs on a detached copy, so ``gates`` and ``probs`` are
    differentiable in ``logits`` (as ``lax.top_k``'s values are)."""
    x = logits.float()
    probs = _probs(x, router_type)
    work = (x if router_type == "topk_softmax" else probs).detach().clone()
    idxs = []
    for _ in range(top_k):
        best_i = torch.argmax(work, dim=-1, keepdim=True)   # first maximum
        idxs.append(best_i)
        work.scatter_(-1, best_i, NEG)
    idx = torch.cat(idxs, -1)
    return (_gates(x, probs, idx, router_type, renormalize),
            idx.to(torch.int32), probs)


def flops(T: int, E: int, top_k: int) -> int:
    """The kernel's operations: one exponential (or sigmoid) and top_k
    masked comparisons per logit."""
    return T * E * (1 + top_k)


@torch.library.custom_op(
    "repro_torch::gating", mutates_args=(),
    schema="(Tensor logits, int top_k, str router_type, bool renormalize) "
           "-> (Tensor, Tensor, Tensor)")
def _shape_op(logits, top_k, router_type, renormalize):
    """K1 on the ``meta`` device: only its fake (shape) implementation and
    FLOP formula exist."""
    raise RuntimeError("repro_torch::gating runs on the meta device only")


@_shape_op.register_fake
def _(logits, top_k, router_type, renormalize):
    T, E = logits.shape
    return (logits.new_empty((T, top_k)),
            logits.new_empty((T, top_k), dtype=torch.int32),
            logits.new_empty((T, E)))


@register_flop_formula(torch.ops.repro_torch.gating)
def _flop_formula(logits, top_k, *args, out_shape=None, **kwargs):
    return flops(*logits, top_k)


def _launch(logits, top_k: int, router_type: str, renormalize: bool):
    """Launch the CUDA kernel on checked (T, E) float32 logits; on ``meta``
    the shape op."""
    if logits.device.type == "meta":
        return torch.ops.repro_torch.gating(logits, top_k, router_type,
                                            renormalize)
    T, E = logits.shape
    variant, width = plan(E, top_k)
    gates = torch.empty((T, top_k), dtype=torch.float32, device=logits.device)
    idx = torch.empty((T, top_k), dtype=torch.int32, device=logits.device)
    probs = torch.empty((T, E), dtype=torch.float32, device=logits.device)
    if T == 0:
        return gates, idx, probs
    stream = torch.cuda.current_stream(logits.device).cuda_stream
    check(library().gating_launch(
        logits.data_ptr(), gates.data_ptr(), idx.data_ptr(), probs.data_ptr(),
        T, E, top_k, ROUTER_TYPES[router_type], int(bool(renormalize)),
        VARIANTS[variant], width, stream), "gating")
    kernels.LAUNCHES[LAUNCH_KEY[variant]] += 1
    return gates, idx, probs


class GatingFn(torch.autograd.Function):
    """K1 for autograd: the forward launches the kernel, the backward
    recomputes ``gates`` and ``probs`` from the logits in plain PyTorch with
    the indices the kernel chose (``idx`` has no gradient)."""

    @staticmethod
    def forward(ctx, logits, top_k, router_type, renormalize):
        gates, idx, probs = _launch(logits, top_k, router_type, renormalize)
        ctx.mark_non_differentiable(idx)
        ctx.save_for_backward(logits, idx)
        ctx.router = (router_type, renormalize)
        return gates, idx, probs

    @staticmethod
    def backward(ctx, g_gates, g_idx, g_probs):
        logits, idx = ctx.saved_tensors

        def plain(x):
            xf = x.float()
            probs = _probs(xf, ctx.router[0])
            return _gates(xf, probs, idx, *ctx.router), probs

        return kernels.recompute_grads("gating_bwd", plain, (logits,),
                                       ctx.needs_input_grad[:1],
                                       (g_gates, g_probs), 3)


def gating(logits, top_k: int, router_type: str = "softmax_topk",
           renormalize: bool = True):
    """logits (T, E) float32 -> (gates, idx, probs)."""
    if router_type not in ROUTER_TYPES:
        raise ValueError(f"router_type must be one of {sorted(ROUTER_TYPES)}, "
                         f"got {router_type!r}")
    if logits.device.type == "cpu":
        return gating_plain(logits, top_k, router_type, renormalize)
    if logits.device.type not in ("cuda", "meta"):
        raise ValueError(f"gating takes CPU, CUDA or meta tensors, got "
                         f"{logits.device}")
    if logits.dtype != torch.float32 or logits.dim() != 2:
        raise ValueError("gating takes (T, E) float32 logits, got "
                         f"{tuple(logits.shape)} {logits.dtype}")
    if not logits.is_contiguous():
        raise ValueError("gating needs contiguous logits")
    if torch.is_grad_enabled() and logits.requires_grad:
        return GatingFn.apply(logits, top_k, router_type, renormalize)
    return _launch(logits, top_k, router_type, renormalize)


def launch_floor(T: int, E: int, top_k: int, device="cuda"):
    """Launch the no-op kernel of ``csrc/noop.cu`` with K1's launch shape
    for ``T`` rows of ``E`` logits: what any kernel of that shape costs the
    card (a measurement probe, not on the serving path)."""
    stream = torch.cuda.current_stream(device).cuda_stream
    check(library().noop_launch(T, VARIANTS[plan(E, top_k)[0]], stream),
          "noop")
