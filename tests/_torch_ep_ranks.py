"""Rank bodies of the port's expert-parallel tests (``test_torch_ep.py``).

``launch/mesh.py::run_ranks`` spawns processes that import the function
they run, so the bodies live here: this module imports torch and
``repro_torch`` only (no JAX), and every body returns numpy arrays and
plain values.  Each body builds its mesh, runs the EP MoE under
``sharding.rules`` and returns what the tests compare; the expert
gradients come back as this rank's 'model' slots only (the rest of a full
stack's gradient is zero on this rank).
"""
import numpy as np
import torch

from repro_torch.launch import sharding as shd
from repro_torch.launch.mesh import axis_index, axis_size, make_mesh
from repro_torch.models.config import ModelConfig, MoEConfig
from repro_torch.models.moe import apply_moe

EXPERT_KEYS = ("gate", "up", "down")


def make_cfg(d, E, K, d_expert, cf, n_shared=0, d_shared=None,
             router_type="topk_softmax"):
    return ModelConfig(d_model=d, d_ff=128, dtype="float32",
                       param_dtype="float32",
                       moe=MoEConfig(n_routed=E, top_k=K, d_expert=d_expert,
                                     n_shared=n_shared, d_shared=d_shared,
                                     router_type=router_type,
                                     capacity_factor=cf))


def _leaves(params, prefix=""):
    for k, v in params.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + k + "/")
        else:
            yield prefix + k, v


def _params(params):
    return {k: (_params(v) if isinstance(v, dict)
                else torch.tensor(v, requires_grad=True))
            for k, v in params.items()}


def run_layer(params, x, cfg, mesh, **kw):
    """One EP forward + backward of sum(y**2): y, the observables and the
    gradients (expert stacks: this rank's slots)."""
    p = _params(params)
    y, info = apply_moe(p, torch.tensor(x), cfg, **kw)
    (y ** 2).sum().backward()
    E_loc = cfg.moe.n_routed // axis_size(mesh, "model")
    lo = axis_index(mesh, "model") * E_loc
    grads = {}
    for name, t in _leaves(p):
        g = t.grad.numpy()
        grads[name] = g[lo:lo + E_loc] if name in EXPERT_KEYS else g
    out = {"y": y.detach().numpy(), "grads": grads,
           "coord": (axis_index(mesh, "data"), axis_index(mesh, "model"))}
    for k in ("workload", "dropped", "ep_cx", "ep_counts"):
        if k in info:
            out[k] = info[k].numpy()
    for k in ("topk_idx", "gates", "aux_loss", "z_loss"):
        out[k] = info[k].detach().numpy()
    return out


def ragged_rank(rank, world, cfg_kw, params, xs, cfg_t_kw, params_t, x_t):
    """Mesh (2, 4): every routing kind through the ragged exchange, the
    dense exchange and the ragged one with the count exchange not hoisted;
    then the capacity-pressure config through the same three."""
    mesh = make_mesh(2, 4)
    cfg, cfg_t = make_cfg(**cfg_kw), make_cfg(**cfg_t_kw)
    runs = (("ragged", {}), ("dense", {"force_exchange": "dense"}),
            ("sequential", {"count_overlap": False}))
    out = {"kinds": {}, "pressure": {}}
    with shd.rules(mesh, wmode="tp"):
        for kind, x in xs.items():
            out["kinds"][kind] = {name: run_layer(params, x, cfg, mesh, **kw)
                                  for name, kw in runs}
        for name, kw in runs:
            out["pressure"][name] = run_layer(params_t, x_t, cfg_t, mesh,
                                              **kw)
    return out


def fsdp_rank(rank, world, cases, x):
    """Mesh (2, 2): each (config, wmode) case's forward and gradients."""
    mesh = make_mesh(2, 2)
    out = []
    for cfg_kw, params, wmode in cases:
        with shd.rules(mesh, wmode=wmode):
            out.append(run_layer(params, x, make_cfg(**cfg_kw), mesh))
    return out


def placement_rank(rank, world, perm, x):
    """Mesh (1, 4) at the EP bench geometry (``launch/ep_serve.py``): the
    plain path, the identity placement twice and a real permutation with
    pre-permuted stacks, each with the demand view."""
    from repro_torch.launch.ep_serve import build_model
    from repro_torch.models.moe_ep import permute_expert_params
    cfg, params = build_model("float32", 0, "cpu")
    mesh = make_mesh(1, 4)
    x = torch.tensor(x)
    ident = np.arange(cfg.moe.n_routed, dtype=np.int32)
    out = {}
    with shd.rules(mesh, wmode="tp"), torch.no_grad():
        out["plain"] = apply_moe(params, x, cfg)[0].numpy()
        for name, pm, p in (("ident_a", ident, params),
                            ("ident_b", ident, params),
                            ("placed", perm,
                             permute_expert_params(params, perm))):
            y, info = apply_moe(p, x, cfg, placement=pm, demand_view=True)
            out[name] = (y.numpy(), info["ep_counts"].numpy(),
                         info["workload"].numpy())
    return out


def fail_rank(rank, world, how):
    """A rank that raises (``how="raise"``) or never returns
    (``"hang"``) on rank 1; the others return their rank."""
    import time
    if rank == 1 and how == "raise":
        raise ValueError("rank 1 fails on purpose")
    if rank == 1 and how == "hang":
        time.sleep(3600)
    return rank
