"""Carry parameters and policy state from the JAX package into the port.

The input is the reference's pytree as numpy arrays (for a JAX pytree:
``jax.tree.map(np.asarray, params)``, done by the caller, so this module
imports no JAX).  Nesting is kept: dicts stay dicts, tuples stay tuples
(``prefix``, ``scan``, an encoder's ``stack``), ``scan`` leaves stay
stacked ``(n_super, ...)``, and every leaf keeps its dtype (a Mamba
layer's float32 ``dt_bias`` / ``A_log`` / ``D`` beside bfloat16
projections, a cross layer's 0-d ``gate``).  The same function carries a reference policy state (its random
initial resident set comes from ``jax.random``, which torch cannot
reproduce).

``save_npz`` / ``load_npz`` store such a tree in one ``.npz`` file (keys
are ``/``-joined paths, tuple positions written ``#i``), which is how
``python -m repro_torch.launch.serve --weights`` serves weights made by
the JAX package; ``save_npz`` also takes a tree of tensors, which is how
the port's checkpoints are written (``repro_torch/checkpoint/store.py``).
With ``experts="host"`` ``to_torch`` and ``load_npz`` put the routed expert
stacks of the model ``cfg`` (``models.moe.is_expert_leaf``) in host memory
(page-locked when ``device`` is a card) instead of on ``device``, for a
physical-offload store.  ``adamw_to_torch`` carries a
reference AdamW state (``{"mu", "nu", "step"}``).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models.model import experts_on_host, host_empty
from repro_torch.models.moe import is_expert_leaf
from repro_torch.tree import tree_map_with_path

_BF16 = "::bfloat16"


def _leaf_to_cpu(a):
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":            # ml_dtypes' bfloat16
        u = np.ascontiguousarray(a).view(np.int16)
        return torch.from_numpy(u.copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _placer(device, experts: str, cfg):
    """``place(path, cpu_tensor)``: onto ``device``, or into host memory
    for a routed expert stack of ``cfg`` when ``experts="host"``."""
    host = experts_on_host(experts)
    if host and cfg is None:
        raise ValueError("experts='host' needs the model's cfg: it decides "
                         "which leaves are routed expert stacks")

    def place(path, t):
        if host and is_expert_leaf(path, cfg):
            return host_empty(t.shape, t.dtype, device).copy_(t)
        return t.to(device)

    return place


def to_torch(tree, device="cuda", experts: str = "device", cfg=None):
    """numpy pytree (dict / tuple / list of arrays) -> the same nesting of
    tensors on ``device`` (the routed expert stacks of the model ``cfg`` on
    the host with ``experts="host"``)."""
    place = _placer(resolve_device(device), experts, cfg)
    return tree_map_with_path(lambda path, a: place(path, _leaf_to_cpu(a)),
                              tree)


def adamw_to_torch(state, device="cuda"):
    """A reference AdamW state (numpy ``{"mu", "nu", "step"}``) -> the
    port's: float32 moments shaped like the params and an int32 step."""
    out = to_torch(state, device)
    out["mu"] = tree_map_with_path(lambda _, t: t.float(), out["mu"])
    out["nu"] = tree_map_with_path(lambda _, t: t.float(), out["nu"])
    out["step"] = out["step"].to(torch.int32)
    return out


def flatten(tree, prefix: str = ""):
    """pytree of numpy arrays or tensors -> {path: leaf} (tuple positions
    written ``#i``; tensors stay tensors)."""
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(flatten(v, f"{prefix}{k}/"))
    elif isinstance(tree, (tuple, list)):
        if not tree:                          # keeps an empty ``prefix``
            out[f"{prefix}#"] = np.zeros(0, np.int8)
        for i, v in enumerate(tree):
            out.update(flatten(v, f"{prefix}#{i}/"))
    else:
        out[prefix[:-1]] = tree if torch.is_tensor(tree) else np.asarray(tree)
    return out


def unflatten(flat):
    """Inverse of :func:`flatten`."""
    root: dict = {}
    for path, arr in flat.items():
        node = root
        parts = path.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = arr

    def fix(node):
        if not isinstance(node, dict):
            return node
        if set(node) == {"#"}:
            return ()
        if node and all(k.startswith("#") for k in node):
            return tuple(fix(node[f"#{i}"]) for i in range(len(node)))
        return {k: fix(v) for k, v in node.items()}

    return fix(root)


def _savable(a):
    """A leaf as a numpy array and whether it holds bfloat16 bits."""
    if torch.is_tensor(a):
        a = a.detach().cpu()
        if a.dtype == torch.bfloat16:
            return a.view(torch.int16).numpy().view(np.uint16), True
        return a.numpy(), False
    if a.dtype.name == "bfloat16":
        return np.ascontiguousarray(a).view(np.uint16), True
    return a, False


def save_npz(path, tree):
    """Write a pytree of numpy arrays or tensors to one ``.npz`` (a path or
    an open file; bfloat16 stored as its bits)."""
    arrays = {}
    for k, a in flatten(tree).items():
        a, bf16 = _savable(a)
        arrays[k + _BF16 if bf16 else k] = a
    np.savez(path, **arrays)


def load_npz(path, device="cuda", experts: str = "device", cfg=None):
    """Read a tree written by :func:`save_npz` as tensors on ``device``
    (the routed expert stacks of the model ``cfg`` on the host with
    ``experts="host"``)."""
    place = _placer(resolve_device(device), experts, cfg)
    flat = {}
    with np.load(path) as z:
        for k in z.files:
            a = z[k]
            if k.endswith(_BF16):
                flat[k[:-len(_BF16)]] = torch.from_numpy(
                    a.view(np.int16).copy()).view(torch.bfloat16)
            else:
                flat[k] = torch.from_numpy(a)
    return tree_map_with_path(place, unflatten(flat))
