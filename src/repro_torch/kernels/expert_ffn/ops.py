"""Grouped gated expert FFN (K2): dense, ragged (``counts``) and grouped
(``counts`` + ``expert_ids``) in one CUDA kernel, ``csrc/expert_ffn.cu``.

``expert_ffn`` launches it for CUDA tensors and runs ``expert_ffn_plain``
for CPU tensors.  xe (G, C, d); w_gate / w_up (E, d, f); w_down (E, f, d)
-> (G, C, d) in xe's dtype.  Without ``expert_ids``, G == E and group g
uses weight set g.  Rows at or beyond ``counts[g]`` are zero in the output
whatever the bucket tail holds.  When autograd needs a gradient (training
on the card) the launch runs inside ``ExpertFFNFn``, whose backward
recomputes through ``expert_ffn_plain``; otherwise ``expert_ffn``
launches directly.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.flop_counter import register_flop_formula

from repro_torch import kernels
from repro_torch.kernels.build import check, library

ACTS = {"silu": F.silu, "gelu": lambda x: F.gelu(x, approximate="tanh"),
        "relu": F.relu}
ACT_IDS = {"silu": 0, "gelu": 1, "relu": 2}


def plan(C: int, d: int, f: int) -> tuple[int, int, int]:
    """Tile plan of the CUDA kernel: (mw, ns_up, ns_down).

    A block covers 64 * mw rows of a group (the whole capacity bucket up to
    128 rows, so each weight byte leaves device memory once per call) and
    64 * ns output columns.  Decode buckets (C <= 64) take 64-row tiles:
    smaller blocks, two to an SM.  N tiles are 128 columns wide wherever
    that divides the width (two adjacent TMA boxes per weight row), else
    64.
    """
    return (1 if C <= 64 else 2, 2 if f % 128 == 0 else 1,
            2 if d % 128 == 0 else 1)


def _variant(counts, expert_ids) -> str:
    if expert_ids is not None:
        return "grouped"
    return "dense" if counts is None else "ragged"


def expert_ffn_plain(xe, w_gate, w_up, w_down, counts=None, expert_ids=None,
                     act: str = "silu"):
    """Plain PyTorch version: float32 arithmetic, output in xe's dtype.
    Group g indexes its weight set instead of gathering copies of it (the
    stacks are unbound once, so a weight's gradient is one stack of its
    experts' slices, not one full-size buffer per expert).  On ``meta``
    (the shape dry run) every group reads weight set 0."""
    G, C, d = xe.shape
    fn = ACTS[act]
    if counts is None:
        valid = torch.ones((G, C), dtype=torch.bool, device=xe.device)
    else:
        valid = torch.arange(C, device=xe.device)[None, :] < counts[:, None]
    x = torch.where(valid[..., None], xe, 0).float().unbind(0)
    # on ``meta`` the ids are not known; any one gives every group's shapes
    eids = (range(G) if expert_ids is None
            else [0] * G if expert_ids.is_meta else expert_ids.tolist())
    wg, wu, wd = (w.unbind(0) for w in (w_gate, w_up, w_down))
    out = [(fn(x[g] @ wg[e].float()) * (x[g] @ wu[e].float()))
           @ wd[e].float() for g, e in enumerate(eids)]
    out = (torch.stack(out) if out
           else torch.empty((0, C, d), dtype=torch.float32, device=xe.device))
    return torch.where(valid[..., None], out, 0).to(xe.dtype)


def flops(G: int, C: int, d: int, f: int) -> int:
    """The kernel's operations over G groups of C rows: three products of
    2 d f each per row (every row of the bucket: on ``meta`` the counts
    are not known)."""
    return 6 * G * C * d * f


@torch.library.custom_op(
    "repro_torch::expert_ffn", mutates_args=(),
    schema="(Tensor xe, Tensor w_gate, Tensor w_up, Tensor w_down, "
           "Tensor? counts, Tensor? expert_ids, str act) -> Tensor")
def _shape_op(xe, w_gate, w_up, w_down, counts, expert_ids, act):
    """K2 on the ``meta`` device: only its fake (shape) implementation and
    FLOP formula exist."""
    raise RuntimeError("repro_torch::expert_ffn runs on the meta device "
                       "only")


@_shape_op.register_fake
def _(xe, w_gate, w_up, w_down, counts, expert_ids, act):
    return torch.empty_like(xe)


@register_flop_formula(torch.ops.repro_torch.expert_ffn)
def _flop_formula(xe, w_gate, *args, out_shape=None, **kwargs):
    return flops(*xe, w_gate[2])


def _launch(xe, w_gate, w_up, w_down, counts, expert_ids, act: str):
    """Launch the CUDA kernel on checked tensors -> (G, C, d); on ``meta``
    the shape op."""
    if xe.device.type == "meta":
        return torch.ops.repro_torch.expert_ffn(xe, w_gate, w_up, w_down,
                                                counts, expert_ids, act)
    G, C, d = xe.shape
    f = w_gate.shape[2]
    y = torch.empty_like(xe)
    if G == 0 or C == 0:
        return y
    h = torch.empty((G, C, f), dtype=xe.dtype, device=xe.device)
    stream = torch.cuda.current_stream(xe.device).cuda_stream
    check(library().expert_ffn_launch(
        xe.data_ptr(), w_gate.data_ptr(), w_up.data_ptr(), w_down.data_ptr(),
        None if counts is None else counts.data_ptr(),
        None if expert_ids is None else expert_ids.data_ptr(),
        h.data_ptr(), y.data_ptr(), G, w_gate.shape[0], C, d, f,
        ACT_IDS[act], *plan(C, d, f), stream), "expert_ffn")
    kernels.LAUNCHES["expert_ffn_" + _variant(counts, expert_ids)] += 1
    return y


class ExpertFFNFn(torch.autograd.Function):
    """K2 for autograd: the forward launches the kernel, the backward
    recomputes the FFN through ``expert_ffn_plain`` and differentiates it
    (the JAX package's custom VJP, ``repro/kernels/expert_ffn/ops.py``):
    dx, dW_gate, dW_up, dW_down; ``counts`` and ``expert_ids`` get none."""

    @staticmethod
    def forward(ctx, xe, w_gate, w_up, w_down, counts, expert_ids, act):
        ctx.save_for_backward(xe, w_gate, w_up, w_down, counts, expert_ids)
        ctx.act = act
        return _launch(xe, w_gate, w_up, w_down, counts, expert_ids, act)

    @staticmethod
    def backward(ctx, gy):
        xe, wg, wu, wd, counts, expert_ids = ctx.saved_tensors
        return kernels.recompute_grads(
            "expert_ffn_bwd",
            lambda *w: expert_ffn_plain(*w, counts, expert_ids, ctx.act),
            (xe, wg, wu, wd), ctx.needs_input_grad[:4], gy, 3)


def expert_ffn(xe, w_gate, w_up, w_down, counts=None, expert_ids=None,
               act: str = "silu"):
    if expert_ids is not None and counts is None:
        raise ValueError("expert_ids requires counts (grouped ragged)")
    if act not in ACTS:
        raise ValueError(f"act must be one of {sorted(ACTS)}, got {act!r}")
    if xe.device.type == "cpu":
        return expert_ffn_plain(xe, w_gate, w_up, w_down, counts, expert_ids,
                                act)
    if xe.device.type not in ("cuda", "meta"):
        raise ValueError(f"expert_ffn takes CPU, CUDA or meta tensors, got "
                         f"{xe.device}")
    G, C, d = xe.shape
    E, d_w, f = w_gate.shape
    for name, t, shape in (("w_gate", w_gate, (E, d, f)),
                           ("w_up", w_up, (E, d, f)),
                           ("w_down", w_down, (E, f, d))):
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, want {shape}")
    for name, t in (("xe", xe), ("w_gate", w_gate), ("w_up", w_up),
                    ("w_down", w_down)):
        if t.device != xe.device or t.dtype != torch.bfloat16 \
                or not t.is_contiguous():
            raise ValueError(f"expert_ffn's CUDA kernel takes contiguous "
                             f"bfloat16 tensors on {xe.device}; {name} is "
                             f"{t.dtype} on {t.device}")
    if d % 64 or f % 64:
        raise ValueError(f"expert_ffn's CUDA kernel needs d and f multiples "
                         f"of 64, got d={d} f={f}")
    if expert_ids is None and counts is not None and counts.shape[0] != G:
        raise ValueError("counts must have one entry per group")
    if expert_ids is None and G != E:
        raise ValueError(f"without expert_ids xe needs one group per expert "
                         f"({E}), got {G}")
    for name, t in (("counts", counts), ("expert_ids", expert_ids)):
        if t is not None and (t.device != xe.device or t.dtype != torch.int32
                              or tuple(t.shape) != (G,)
                              or not t.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous ({G},) int32 "
                             f"tensor on {xe.device}")
    for name, t in (("xe", xe), ("w_gate", w_gate), ("w_up", w_up),
                    ("w_down", w_down)):
        if t.data_ptr() % 16:
            raise ValueError(f"expert_ffn's CUDA kernel needs 16-byte-aligned "
                             f"tensors; {name} is not")
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (xe, w_gate, w_up, w_down)):
        return ExpertFFNFn.apply(xe, w_gate, w_up, w_down, counts,
                                 expert_ids, act)
    return _launch(xe, w_gate, w_up, w_down, counts, expert_ids, act)
