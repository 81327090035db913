"""Loss and train-step builders (port of ``repro/training/train_step.py``).

Loss = token cross-entropy (float32 logits) + logit z-loss + the MoE
auxiliary load-balance loss + the router z-loss, collected from every MoE
block.  A batch may carry ``cross_src`` (B, T, d), the source of a VLM's or
an encoder-decoder's cross-attention layers.  ``make_train_step`` returns ``train_step(params, opt_state, batch)
-> (params', opt_state', metrics)``: gradients of every param leaf by
``torch.autograd.grad`` (on the card through the kernels' autograd
Functions, whose backward recomputes through the plain versions), then one
AdamW step applied in place.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.models.config import ModelConfig
from repro_torch.models.model import apply_model, collect_moe_scalars
from repro_torch.training.optimizer import OptConfig, adamw_update
from repro_torch.tree import tree_leaves, tree_map

def cross_entropy(logits, labels, z_weight: float = 1e-4):
    """logits (B, S, V) float32, labels (B, S) int (-1 = masked) ->
    (ce + z_weight * mean lse^2, ce).  Laid-out logits (DTensors, the vocab
    over 'model') take ``cross_entropy_laid``."""
    from repro_torch.launch.layout import is_dtensor
    if is_dtensor(logits):
        return cross_entropy_laid(logits, labels, z_weight)
    V = logits.shape[-1]
    mask = (labels >= 0).to(torch.float32)
    lbl = labels.clamp(0, V - 1).long()
    lse = torch.logsumexp(logits, dim=-1)
    ll = logits.gather(-1, lbl[..., None])[..., 0] - lse
    denom = torch.clamp(mask.sum(), min=1.0)
    ce = -(ll * mask).sum() / denom
    z = ((lse ** 2) * mask).sum() / denom
    return ce + z_weight * z, ce


def cross_entropy_laid(logits, labels, z_weight: float = 1e-4):
    """``cross_entropy`` with the vocab over 'model' (Megatron's
    vocab-parallel loss): each rank's max (a stabiliser, no gradient), its
    sum of exponentials and the label's logit where its columns hold it are
    reduced over 'model', never the (B, S, V) logits themselves."""
    from repro_torch.launch import layout as lay
    lp = logits.placements
    b = lay.spec_from(lp, 3)[:2]
    v0 = lay.offset(logits, 2)
    rows = lay.place(tuple(b))
    # the max only stabilises: no gradient flows through it (detached on
    # the local tensor, so no DTensor op runs on the whole logits)
    mx = lay.local_kernel(
        lambda lg: lg.detach().amax(-1), [lp],
        lay.place(tuple(b), partial=("model",), reduce_op="max"))(logits)
    mx = mx.redistribute(logits.device_mesh, rows)

    def parts(lg, lbl, mx):
        s = torch.exp(lg - mx[..., None]).sum(-1)
        li = lbl.long() - v0
        own = (li >= 0) & (li < lg.shape[-1])
        tgt = lg.gather(-1, li.clamp(0, lg.shape[-1] - 1)[..., None])[..., 0]
        return torch.stack([s, torch.where(own, tgt, 0.0)], dim=-1)

    st = lay.local_kernel(
        parts, [lp, rows, rows],
        lay.place(tuple(b) + (None,), partial=("model",)))(
            logits, labels, mx)

    def loss(st, lbl, mx):
        mask = (lbl >= 0).to(torch.float32)
        lse = mx + torch.log(st[..., 0])
        ll = st[..., 1] - lse
        return torch.stack([-(ll * mask).sum(), ((lse ** 2) * mask).sum(),
                            mask.sum()])

    sums = lay.local_kernel(
        loss, [lay.place(tuple(b) + (None,)), rows, rows],
        lay.sums_of(rows))(st, labels, mx)
    sums = sums.redistribute(logits.device_mesh, lay.place((None,)))
    denom = torch.clamp(sums[2], min=1.0)
    ce = sums[0] / denom
    return ce + z_weight * (sums[1] / denom), ce


def make_loss_fn(cfg: ModelConfig, moe_capacity: Optional[int] = None):
    def loss_fn(params, batch):
        logits, _, infos = apply_model(params, batch["tokens"], cfg,
                                       cross_src=batch.get("cross_src"),
                                       moe_capacity=moe_capacity)
        loss, ce = cross_entropy(logits, batch["labels"])
        moe = collect_moe_scalars(infos)
        # a model without MoE blocks adds nothing (its zeros are plain
        # tensors, which a laid-out loss does not mix with)
        total = loss if cfg.moe is None else (loss + moe["aux_loss"]
                                               + moe["z_loss"])
        metrics = {"loss": total, "ce": ce, "aux": moe["aux_loss"],
                   "router_z": moe["z_loss"], "dropped": moe["dropped"]}
        return total, metrics

    return loss_fn


def value_and_grad(loss_fn, params, batch):
    """``((loss, metrics), grads)`` of ``loss_fn(params, batch)`` with
    respect to every param leaf, ``grads`` shaped like ``params`` (zeros
    for a leaf the loss does not reach).  The leaves require grad only for
    the call, so the caller's tensors come back as they were."""
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    try:
        total, metrics = loss_fn(params, batch)
        flat = torch.autograd.grad(total, leaves, allow_unused=True)
    finally:
        for p in leaves:
            p.requires_grad_(False)
    from repro_torch.launch.layout import settle_grads
    flat = iter([torch.zeros_like(p) if g is None else g
                 for p, g in zip(leaves, settle_grads(leaves, flat))])
    grads = tree_map(lambda _: next(flat), params)
    metrics = {k: v.detach() for k, v in metrics.items()}
    return (total.detach(), metrics), grads


def make_train_step(cfg: ModelConfig, oc: OptConfig,
                    moe_capacity: Optional[int] = None):
    loss_fn = make_loss_fn(cfg, moe_capacity)

    def train_step(params, opt_state, batch):
        (_, metrics), grads = value_and_grad(loss_fn, params, batch)
        params, opt_state, opt_metrics = adamw_update(params, grads,
                                                      opt_state, oc)
        metrics.update(opt_metrics)
        return params, opt_state, metrics

    return train_step
