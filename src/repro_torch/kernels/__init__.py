"""Hand-written Hopper kernels of the port and their launch counters.

Each wrapper (``gating.ops.gating``, ``expert_ffn.ops.expert_ffn``,
``flash_attention.ops.flash_attention``) runs its plain PyTorch version for
CPU tensors and launches its CUDA kernel for CUDA tensors, adding one to
its entry in ``LAUNCHES`` at each launch and nowhere else.  A run can thus
show that the main path went through the kernels.

On the card each wrapper is differentiable: when autograd needs its
gradient, the kernel's launch runs inside a ``torch.autograd.Function``
whose backward recomputes through the plain version (as the JAX package's
custom VJP of the expert FFN does); each such backward adds one to its
``*_bwd`` entry, so a training run can show that every backward ran.
Under ``cfg.remat`` a training step runs each super-block's forward a
second time in its backward, so ``LAUNCHES`` counts those kernels twice
(``models/model.py::apply_model``).

On the ``meta`` device (the shape dry run, ``launch/dryrun.py``) each
wrapper calls its kernel's shape op (``torch.ops.repro_torch.*``): an
empty output of the kernel's shape and dtype, nothing else allocated,
and the kernel's FLOPs (the formula beside it) added to a
``torch.utils.flop_counter.FlopCounterMode`` in progress.  A training
step goes through the same autograd Functions as on the card, so its
backward recomputes through the plain version on ``meta`` and the dry
run counts that recompute's FLOPs and holds its intermediates.  Nothing
is launched or counted on ``meta``.
"""
from __future__ import annotations

LAUNCHES = {
    "gating": 0,            # K1's row variant (E <= 32)
    "gating_warp": 0,       # K1's warp variant (E > 32)
    "expert_ffn_dense": 0,
    "expert_ffn_ragged": 0,
    "expert_ffn_grouped": 0,
    "flash_attention": 0,
    # backward recomputes through the plain versions (not kernels)
    "gating_bwd": 0,
    "expert_ffn_bwd": 0,
    "flash_attention_bwd": 0,
}

# K3's launches by form, counted beside LAUNCHES["flash_attention"]:
# non-causal (cross-attention, the encoder) and windowed with a softcap
# (Gemma-2's local layers)
K3_FORMS = {"noncausal": 0, "window_softcap": 0}


def reset_launch_counts():
    for d in (LAUNCHES, K3_FORMS):
        for k in d:
            d[k] = 0


def launch_counts() -> dict:
    return dict(LAUNCHES)


def recompute_grads(key, plain_fn, inputs, needs, grad_out, n_rest):
    """The backward of a kernel's autograd Function: recompute ``plain_fn``
    on the saved ``inputs`` under ``enable_grad`` and differentiate it.
    Returns one gradient per input (``None`` where ``needs`` is false), then
    ``n_rest`` ``None`` for the Function's other arguments, and adds one to
    ``LAUNCHES[key]`` (not on ``meta``)."""
    import torch
    if inputs[0].device.type != "meta":
        LAUNCHES[key] += 1
    with torch.enable_grad():
        ins = [t.detach().requires_grad_(n) for t, n in zip(inputs, needs)]
        grads = iter(torch.autograd.grad(
            plain_fn(*ins), [t for t, n in zip(ins, needs) if n], grad_out))
    return tuple(next(grads) if n else None for n in needs) + (None,) * n_rest
