"""AdamW with global-norm clipping and a cosine schedule with linear warmup
(port of ``repro/training/optimizer.py``).

``init_adamw`` builds the optimizer state: float32 moments ``mu`` / ``nu``
whatever the param dtype, and an int32 ``step`` counter.  ``adamw_update``
is the reference's arithmetic (the norm is reported before clipping; bias
corrections use the incremented step; weight decay only for leaves with
``ndim >= 2``; the update in float32, cast back to the param dtype), but
it updates the params and moments IN PLACE, one leaf at a time and in
chunks of ``CHUNK`` elements, so that its float32 temporaries stay the
size of a chunk even for a full-width expert stack (at 2 Mixtral layers
one leaf holds 2 x 8 x 4096 x 14336 weights, 3.8 GB in float32).
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from repro_torch.tree import tree_leaves, tree_map

# elements per in-place chunk (256 MiB of float32 per temporary)
CHUNK = 1 << 26


@dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    betas: tuple = (0.9, 0.95)
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1


def schedule(step, oc: OptConfig):
    """Learning rate at ``step`` (an int or int tensor) as a float32
    tensor: linear warmup, then cosine down to ``min_lr_frac``."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = step / max(oc.warmup_steps, 1)
    t = (step - oc.warmup_steps) / max(oc.total_steps - oc.warmup_steps, 1)
    t = t.clamp(0.0, 1.0)
    cos = oc.min_lr_frac + (1 - oc.min_lr_frac) * 0.5 * (
        1 + torch.cos(math.pi * t))
    return oc.lr * torch.where(step < oc.warmup_steps, warm, cos)


def init_adamw(params):
    leaves = tree_leaves(params)
    dev = leaves[0].device if leaves else "cpu"
    zeros = lambda p: tree_map(
        lambda x: torch.zeros(x.shape, dtype=torch.float32, device=x.device),
        p)
    return {"mu": zeros(params), "nu": zeros(params),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def _decay_mask(leaf) -> bool:
    """No weight decay for norms / scalars / biases (ndim < 2)."""
    return leaf.dim() >= 2


def _chunks(t):
    """Flat views of ``t`` of at most ``CHUNK`` elements (one for a small
    leaf, so that its arithmetic is the reference's as written)."""
    flat = t.view(-1)
    return [flat[i:i + CHUNK] for i in range(0, flat.numel(), CHUNK)]


@torch.no_grad()
def adamw_update(params, grads, opt_state, oc: OptConfig):
    """One AdamW step: params, ``opt_state["mu"]`` / ``["nu"]`` are updated
    in place and returned, with ``{"mu", "nu", "step"}`` and the metrics
    ``{"lr", "grad_norm"}`` (both float32 tensors; the norm before
    clipping)."""
    step = opt_state["step"] + 1
    lr = schedule(step, oc).to(step.device)
    b1, b2 = oc.betas

    from repro_torch.launch.layout import global_sq_norm, is_dtensor
    laid = any(is_dtensor(g) for g in tree_leaves(grads))
    if laid:
        # laid-out leaves (launch/layout.py): the norm over every rank's
        # shards, then each rank updates its own
        gnorm = torch.sqrt(global_sq_norm(grads) + 1e-20)
        local = lambda t: t.to_local() if is_dtensor(t) else t
        params_l, grads_l, mu_l, nu_l = (tree_map(local, t) for t in (
            params, grads, opt_state["mu"], opt_state["nu"]))
    else:
        gnorm = torch.sqrt(sum(torch.sum(torch.square(c.to(torch.float32)))
                               for g in tree_leaves(grads)
                               for c in _chunks(g)) + 1e-20)
        params_l, grads_l, mu_l, nu_l = (params, grads, opt_state["mu"],
                                         opt_state["nu"])
    scale = torch.clamp(oc.clip_norm / gnorm, max=1.0)

    stepf = step.to(torch.float32)
    bc1 = 1 - torch.pow(torch.tensor(b1, dtype=torch.float32,
                                     device=step.device), stepf)
    bc2 = 1 - torch.pow(torch.tensor(b2, dtype=torch.float32,
                                     device=step.device), stepf)

    def upd(p, g, mu, nu):
        decay = _decay_mask(p)
        for pc, gc, mc, nc in zip(*(_chunks(t) for t in (p, g, mu, nu))):
            g32 = gc.to(torch.float32) * scale
            mc.mul_(b1).add_((1 - b1) * g32)
            nc.mul_(b2).add_((1 - b2) * g32 * g32)
            del g32
            delta = (mc / bc1).div_((nc / bc2).sqrt_().add_(oc.eps))
            p32 = pc.to(torch.float32)
            if decay:
                delta.add_(oc.weight_decay * p32)
            pc.copy_(p32 - lr * delta)

    # leaves are matched by their keys (trees carried from the JAX package
    # order dict keys differently)
    tree_map(upd, params_l, grads_l, mu_l, nu_l)
    return params, {"mu": opt_state["mu"], "nu": opt_state["nu"],
                    "step": step}, {"lr": lr, "grad_norm": gnorm}
