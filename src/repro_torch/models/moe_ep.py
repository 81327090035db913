"""Expert-parallel MoE over ``torch.distributed`` with a workload-sized
ragged exchange (port of ``repro/models/moe_ep.py``).

One process per rank (``launch/mesh.py::run_ranks``) on a (dp, tp) mesh
named ``("data", "model")``; the caller passes every rank the full
(B, S, d) input, as the reference's global array.  Per layer each rank:

  1. takes its token shard (batch over 'data', sequence over 'model') and
     routes it (K1 on the card);
  2. ships its per-expert demand first: a ``(tp, E/tp)`` int32
     ``all_to_all`` over 'model' and an ``all_reduce(MAX)`` over the
     world, issued asynchronously ahead of the dispatch index math
     (``count_overlap``, the reference's hoist).  The smallest rung of
     ``exchange_ladder(C)`` covering the global max is read on the host
     (one read per layer, in place of the reference's ``lax.switch``);
  3. packs its (E, C, d) capacity buckets locally and ships only
     ``(E/tp, C_x, d)`` of them to the expert owners through an
     ``all_to_all`` whose backward is the same ``all_to_all``;
  4. runs its E/tp experts over the received buckets as one grouped
     launch (K4 on the card: group ``e * tp + src``, the exchanged counts
     and a group -> expert id map), and ships the results back through
     the symmetric ``all_to_all``;
  5. combines locally; the output and the per-token observables are
     all-gathered back to the full (B, S, ...) on every rank (the
     reference's ``out_specs``).  The gather's backward takes this rank's
     slice: every rank computes one loss over the gathered output, as
     under GSPMD, and backpropagates the part its own tokens produced.

Observables are summed or averaged over the world as in the reference:
``workload``, ``dropped``, ``aux_loss``, ``z_loss``, ``ep_cx`` (the
shipped capacity).  Under gloo a CUDA tensor is staged through host
memory for each collective; under NCCL it stays on the card.  Nothing
falls back: a failed collective raises.

The expert weights: each rank keeps the slots ``[r * E/tp, (r+1) * E/tp)``
of the physical-order stacks (``permute_expert_params``) for its 'model'
coordinate r; ``apply_moe_ep`` takes either those local stacks or the
full ones and slices them.  ``wmode="fsdp"`` also shards their f dim over
'data' and all-gathers it in the layer (shared experts included); the
gather's backward sums over 'data' and keeps this rank's slice.
"""
from __future__ import annotations

from bisect import bisect_left
from typing import List, Optional

import numpy as np
import torch

from .config import ModelConfig

# --------------------------------------------------------------------------
# topology-aware expert placement (numpy, copied from the reference)
# --------------------------------------------------------------------------


def solve_placement(demand, topology, tp: Optional[int] = None) -> np.ndarray:
    """Greedy expert->device placement against a link topology.

    ``demand`` is the count exchange's global demand view — (E,) summed
    per-expert token counts or the (tp, E) per-source matrix
    (``info["ep_counts"]``).  Devices are ranked by
    ``topology.device_quality()`` (bidirectional bottleneck bandwidth to
    peers) and the hottest E/tp experts land on the best-connected
    device, the next E/tp on the next, etc. — so a degraded link's
    endpoints end up hosting the coldest experts and the traffic that
    must cross the bad pair shrinks.  Ties (and a uniform topology) keep
    the canonical identity layout so the healthy fast path never moves
    weights for nothing.

    Returns ``perm`` (E,) int32 with ``perm[p]`` = logical expert stored
    at physical slot p; device k owns slots [k·E/tp, (k+1)·E/tp).
    """
    demand = np.asarray(demand, np.float64)
    per_e = demand.sum(axis=0) if demand.ndim == 2 else demand
    n = int(tp if tp is not None else topology.n)
    E = per_e.size
    if E % n:
        raise ValueError(f"n_experts {E} must divide over {n} devices")
    e_loc = E // n
    if topology.is_uniform():
        return np.arange(E, dtype=np.int32)
    q = topology.device_quality()[:n]
    dev_order = np.argsort(-q, kind="stable")      # best-connected first
    hot = np.argsort(-per_e, kind="stable")        # hottest expert first
    perm = np.empty(E, np.int32)
    for rank, k in enumerate(dev_order):
        # sort each device's expert list so equal-demand workloads keep
        # a deterministic layout
        mine = np.sort(hot[rank * e_loc:(rank + 1) * e_loc])
        perm[k * e_loc:(k + 1) * e_loc] = mine
    return perm


def permute_expert_params(params, placement):
    """Reorder the stacked expert weights to physical slot order (slot p
    holds logical expert ``placement[p]``), on the stacks' own device.
    Applied outside the layer at re-route time, so a placement change
    swaps the stacks a rank holds; the router (and shared experts) keep
    logical expert ids."""
    out = dict(params)
    for k in ("gate", "up", "down"):
        w = params[k]
        out[k] = w[torch.as_tensor(np.asarray(placement), dtype=torch.long,
                                   device=w.device)]
    return out


def placement_pair_bytes(demand, placement, d_model: int,
                         itemsize: int) -> np.ndarray:
    """Analytic directed per-pair exchange bytes under a placement.

    An equal-split ``all_to_all`` physically ships EQUAL-size blocks to
    every peer, so per-pair wire bytes are accounted from demand (the
    repo's ``link_bytes`` convention, DESIGN.md §2): tokens from source s
    to an expert owned by device k cross s->k once at dispatch and k->s
    once on the return.  ``demand`` is the (tp, E) per-source count matrix
    (``info["ep_counts"]``); returns a (tp, tp) int64 byte matrix with a
    zero diagonal (local traffic is free).
    """
    demand = np.asarray(demand, np.int64)
    tp, E = demand.shape
    e_loc = E // tp
    perm = np.asarray(placement, np.int64)
    owner = np.empty(E, np.int64)
    owner[perm] = np.arange(E, dtype=np.int64) // e_loc
    onehot = np.zeros((E, tp), np.int64)
    onehot[np.arange(E), owner] = 1
    disp = (demand @ onehot) * (d_model * itemsize)   # (src, dst) tokens
    np.fill_diagonal(disp, 0)
    return disp + disp.T


def ep_applicable(cfg: ModelConfig, B: int, S: int) -> bool:
    """Whether ``apply_moe`` takes the EP path: an active mesh with a
    'model' axis that divides the experts, token dims that divide over the
    mesh, and at least 64 tokens a rank (decode and tiny shards stay on
    the single-device path)."""
    from repro_torch.launch import sharding as shd
    from repro_torch.launch.mesh import axis_size, data_axes
    mesh = shd.active()["mesh"]
    if mesh is None or "model" not in mesh.mesh_dim_names:
        return False
    tp = axis_size(mesh, "model")
    E = cfg.moe.n_routed
    if E < tp or E % tp:
        return False
    dp = axis_size(mesh, *data_axes(mesh))
    if B % dp or S % tp:
        return False
    if (B // dp) * (S // tp) < 64:       # decode / tiny shards: dense path
        return False
    return True


def exchange_ladder(C: int) -> List[int]:
    """Capacities the ragged exchange can ship: powers of two from the
    dispatch bucket floor (4) upward, clamped to C.  The per-layer pick is
    the smallest rung covering the global max per-(rank, expert) demand,
    so the common skewed/decode case ships a fraction of C (DESIGN.md
    §6)."""
    caps, c = [], 4
    while c < C:
        caps.append(c)
        c *= 2
    caps.append(C)
    return caps


# --------------------------------------------------------------------------
# collectives (gloo stages a CUDA tensor through host memory)
# --------------------------------------------------------------------------


def _wire(t, group):
    """``t`` as a collective takes it: contiguous and, for gloo, in host
    memory.  bfloat16 travels as float16 of the same bits (the collectives
    that take it only move data, and gloo takes float16 in every
    version)."""
    import torch.distributed as dist
    t = t.contiguous()
    if t.is_cuda and dist.get_backend(group) == "gloo":
        t = t.cpu()
    return t


def _bits(t):
    return t.view(torch.float16) if t.dtype == torch.bfloat16 else t


def _all_to_all(t, group):
    """Equal-split ``all_to_all`` along dim 0 (``t.shape[0]`` = the group's
    size): block j goes to the group's rank j, and block s of the result
    came from rank s."""
    import torch.distributed as dist
    src = _wire(t, group)
    out = torch.empty_like(src)
    dist.all_to_all_single(_bits(out), _bits(src), group=group)
    return out.to(t.device)


def _all_gather(t, group):
    """The group's tensors stacked along a new dim 0, in group-rank
    order."""
    import torch.distributed as dist
    src = _wire(t, group)
    parts = [torch.empty_like(src)
             for _ in range(dist.get_world_size(group))]
    dist.all_gather([_bits(p) for p in parts], _bits(src), group=group)
    return torch.stack(parts).to(t.device)


def _all_reduce(t, group, op="sum"):
    import torch.distributed as dist
    src = _wire(t, group)
    if src is t:
        src = src.clone()
    dist.all_reduce(src, op=getattr(dist.ReduceOp, op.upper()), group=group)
    return src.to(t.device)


class _AllToAll(torch.autograd.Function):
    """The bucket exchange; split == concat axis makes it its own
    transpose, so the backward is the same ``all_to_all``."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_to_all(x, group)

    @staticmethod
    def backward(ctx, g):
        return _all_to_all(g, ctx.group), None


class _GatherTokens(torch.autograd.Function):
    """This rank's (B/dp, S/tp, ...) block all-gathered to (B, S, ...) on
    every rank.  Every rank computes the same loss over the result, so
    the backward keeps this rank's slice of the gradient."""

    @staticmethod
    def forward(ctx, t, dp, tp, di, mi):
        ctx.block = (di, mi) + tuple(t.shape[:2])
        g = _all_gather(t, None)                   # (world, Bl, Sl, ...)
        Bl, Sl = t.shape[:2]
        rest = tuple(t.shape[2:])
        g = g.reshape((dp, tp, Bl, Sl) + rest).transpose(1, 2)
        return g.reshape((dp * Bl, tp * Sl) + rest)

    @staticmethod
    def backward(ctx, g):
        di, mi, Bl, Sl = ctx.block
        return (g[di * Bl:(di + 1) * Bl, mi * Sl:(mi + 1) * Sl].contiguous(),
                None, None, None, None)


class _MeanOverWorld(torch.autograd.Function):
    """An observable averaged over the world (the reference's ``pmean``).
    Every rank's loss holds the same mean, so the backward passes this
    rank's share (1/n) to its own input."""

    @staticmethod
    def forward(ctx, t, n):
        ctx.n = n
        return _all_reduce(t, None) / n

    @staticmethod
    def backward(ctx, g):
        return g / ctx.n, None


class _GatherWeights(torch.autograd.Function):
    """FSDP: this rank's slice of a weight along ``dim`` all-gathered over
    'data'.  Each rank uses the whole weight for its own tokens, so the
    backward sums the gradient over 'data' and keeps this rank's slice."""

    @staticmethod
    def forward(ctx, w, dim, group, index):
        ctx.args = (dim, group, index, w.shape[dim])
        parts = _all_gather(w, group)              # (dp, ...)
        return torch.cat(parts.unbind(0), dim=dim)

    @staticmethod
    def backward(ctx, g):
        dim, group, index, n = ctx.args
        g = _all_reduce(g, group)
        return g.narrow(dim, index * n, n).contiguous(), None, None, None


class _CountExchange:
    """The count exchange, issued asynchronously: this rank's capped
    per-expert demand (E,), in physical slot order, goes to the expert
    owners as a (tp, E/tp) ``all_to_all`` over 'model', and its max into
    an ``all_reduce(MAX)`` over the world.  ``wait()`` returns the
    received (tp, E/tp) counts (row s: source s's demand for this rank's
    experts) and the global max."""

    def __init__(self, cnt, perm, tp, group):
        import torch.distributed as dist
        self.device = cnt.device
        tx = cnt[perm] if perm is not None else cnt
        src = _wire(tx.reshape(tp, -1), group)
        self.rx = torch.empty_like(src)
        self.mx = _wire(cnt.max().reshape(1), None)
        self.works = (
            dist.all_to_all_single(self.rx, src, group=group, async_op=True),
            dist.all_reduce(self.mx, op=dist.ReduceOp.MAX, async_op=True))

    def wait(self, top: int):
        """The received counts and the global max (``top``, the ladder's
        top rung, on ``meta``: the shape dry run reads no value)."""
        for w in self.works:
            w.wait()
        gmax = top if self.mx.is_meta else int(self.mx.item())
        return self.rx.to(self.device), gmax


# --------------------------------------------------------------------------
# the layer
# --------------------------------------------------------------------------


def _ep_expert_ffn(xa, wg, wu, wd, cnt_rx, cfg: ModelConfig):
    """Expert FFN over received buckets xa (E/tp, tp, C_x, d): one grouped
    launch with group ``e * tp + src`` over this rank's E/tp weight sets,
    the exchanged counts (``cnt_rx`` (tp, E/tp); None, the dense exchange,
    counts every row: rows past a packed count are zero and come out
    zero) and the group -> expert id map.  On the card that is K4, the
    TPU's grouped kernel at the same call (reference ``moe_ep.py:176-183``);
    on the CPU K4's plain version."""
    from repro_torch.kernels.expert_ffn.ops import expert_ffn
    E_loc, tp, Cx, d = xa.shape
    groups = xa.reshape(E_loc * tp, Cx, d).contiguous()
    if cnt_rx is None:
        gcnt = torch.full((E_loc * tp,), Cx, dtype=torch.int32,
                          device=xa.device)
    else:
        gcnt = cnt_rx.t().reshape(-1).to(torch.int32).contiguous()
    eids = torch.arange(E_loc, dtype=torch.int32,
                        device=xa.device).repeat_interleave(tp)
    y = expert_ffn(groups, wg, wu, wd, counts=gcnt, expert_ids=eids,
                   act=cfg.act)
    return y.reshape(E_loc, tp, Cx, d)


def _local_weights(params, cfg: ModelConfig, mesh, fsdp: bool):
    """This rank's expert stacks (its 'model' slots; full stacks are
    sliced, local ones taken as they are) and shared experts (whole over
    'model'), with the dim FSDP lays over 'data' gathered: the stacks' f
    dim, the shared experts' d_model dim (full widths sliced to this
    rank's share first, so the gradient takes the gather's backward)."""
    from repro_torch.launch import sharding as shd
    from repro_torch.launch.mesh import axis_index, axis_size
    m = cfg.moe
    E = m.n_routed
    tp = axis_size(mesh, "model")
    dp = axis_size(mesh, "data")
    E_loc = E // tp
    mi, di = axis_index(mesh, "model"), axis_index(mesh, "data")
    g_data = mesh.get_group("data") if fsdp and dp > 1 else None

    def fsdp_gather(w, dim, width):
        if g_data is None:
            return w
        if w.shape[dim] == width:                  # full width: this share
            w = w.narrow(dim, di * (width // dp), width // dp)
        elif w.shape[dim] * dp != width:
            raise ValueError(f"an FSDP weight's dim {dim} is "
                             f"{w.shape[dim]}, want {width} or "
                             f"{width // dp}")
        return _GatherWeights.apply(w, dim, g_data, di)

    de = m.d_expert or cfg.d_ff
    out = {}
    for k in ("gate", "up", "down"):
        w = params[k]
        if w.shape[0] == E and E != E_loc:
            w = w[mi * E_loc:(mi + 1) * E_loc]
        elif w.shape[0] != E_loc:
            raise ValueError(f"expert stack {k!r} holds {w.shape[0]} "
                             f"experts, want {E} or this rank's {E_loc}")
        out[k] = fsdp_gather(w, 1 if k == "down" else 2, de)
    if m.n_shared:
        # each rank's own tokens meet the whole shared expert: the leaves
        # come whole over 'model', and FSDP gathers the dim it lays over
        # 'data' (the d_model dim of either matrix)
        out["shared"] = {
            k: fsdp_gather(v, shd.matrix_spec(k, "fsdp").index("data"),
                           cfg.d_model)
            for k, v in params["shared"].items()}
    return out


def apply_moe_ep(params, x, cfg: ModelConfig, *,
                 capacity: Optional[int] = None,
                 force_exchange: Optional[str] = None,
                 count_overlap: Optional[bool] = None,
                 placement=None,
                 demand_view: bool = False,
                 local: bool = False):
    """Expert-parallel MoE on this rank.  x (B, S, d), the full input on
    every rank -> (y (B, S, d), info), both whole on every rank.

    ``local`` (the laid-out model, ``models/moe.py::_moe_laid``): ``x`` is
    this rank's own (B/dp, S/tp, d) block, and ``y`` and the per-token
    observables come back as this rank's block, not gathered.

    ``capacity`` (stated for the full batch, like ``apply_moe``'s) scales
    to each rank's token share; None derives the per-rank capacity from
    the shard size.  ``force_exchange`` pins the exchange: "dense" ships
    the full (E/tp, C, d) buckets, "ragged"/None sizes the exchange to the
    workload through the count exchange and the ladder.  Observables are
    identical either way; ``info["ep_cx"]`` is the shipped capacity.

    ``count_overlap`` (None = on) issues the count exchange before the
    dispatch index math, the FSDP gathers and the shared-expert MLP, and
    waits for it only when the buckets must ship.  The counts are the ones
    ``local_dispatch`` computes, so outputs, ``ep_cx`` and drops are
    bit-identical with it off.

    ``placement`` (E,) int re-routes expert ownership across 'model':
    ``placement[p]`` is the logical expert at physical slot p, whose
    weights the caller has already reordered (``permute_expert_params``)
    before keeping its slots.  The send blocks and exchanged counts are
    permuted to slot order before the exchanges and the returned buckets
    back after, so every expert sees its own tokens and weights and the
    outputs are bit-identical to the identity placement.

    ``demand_view`` adds ``info["ep_counts"]``, the (tp, E) per-source
    capped demand in logical order (gathered over 'model', summed over
    'data'): what the placement solver and the per-link byte accounting
    read."""
    from repro_torch.launch import sharding as shd
    from repro_torch.launch.mesh import axis_index, axis_size, data_axes

    from .layers import apply_mlp
    from .moe import _bincount, expert_capacity, local_dispatch, route

    if force_exchange not in (None, "dense", "ragged"):
        raise ValueError(f"force_exchange must be None|'dense'|'ragged', "
                         f"got {force_exchange!r}")
    import torch.distributed as dist
    st = shd.active()
    mesh = st["mesh"]
    m = cfg.moe
    E, K = m.n_routed, m.top_k
    tp = axis_size(mesh, "model")
    dp = axis_size(mesh, *data_axes(mesh))
    if local:
        Bl, Sl, d = x.shape
        B, S = Bl * dp, Sl * tp
    else:
        B, S, d = x.shape
        Bl, Sl = B // dp, S // tp
    T_my = Bl * Sl
    if capacity is None:
        C = expert_capacity(m, T_my)
    else:
        # an explicit capacity is stated for the full (B, S) batch; each
        # rank packs its T_my-token share, keeping the 4-row tiling floor
        share = -(-capacity * T_my // (B * S))
        C = max(4, -(-share // 4) * 4)
    ragged = force_exchange != "dense"
    overlap = True if count_overlap is None else count_overlap
    caps = exchange_ladder(C)
    E_loc = E // tp
    mi, di = axis_index(mesh, "model"), axis_index(mesh, "data")
    g_model = mesh.get_group("model")
    perm = inv_p = None
    if placement is not None:
        perm = torch.as_tensor(np.asarray(placement), dtype=torch.long,
                               device=x.device)
        inv_p = torch.argsort(perm)

    xb = x if local else x[di * Bl:(di + 1) * Bl, mi * Sl:(mi + 1) * Sl]
    xf = xb.reshape(-1, d)
    gates, idx, probs, logits = route({"router": params["router"]}, xf, m)

    pending = None
    if ragged and overlap:
        # the count exchange needs only the routing choices: issue it
        # before the dispatch math, weight gathers and shared experts
        cnt = _bincount(idx.reshape(-1), E).clamp(max=C)
        pending = _CountExchange(cnt, perm, tp, g_model)

    xe, counts, se, rank, inv = local_dispatch(xf, idx, E, K, C)
    w = _local_weights(params, cfg, mesh, st["wmode"] == "fsdp")
    y_shared = apply_mlp(w["shared"], xf, cfg) if m.n_shared else None

    if not ragged:
        cx, cnt_rx = C, None
    else:
        if pending is None:
            pending = _CountExchange(counts.clamp(max=C), perm, tp, g_model)
        cnt_rx, gmax = pending.wait(C)
        # the smallest rung covering the global max: every rank reads the
        # same max, so every rank ships the same shape
        cx = caps[min(bisect_left(caps, gmax), len(caps) - 1)]

    xs = xe[:, :cx]
    if perm is not None:                  # logical bucket order -> slots
        xs = xs[perm]
    xa = _AllToAll.apply(xs.reshape(tp, E_loc, cx, d), g_model)
    ye = _ep_expert_ffn(xa.transpose(0, 1), w["gate"], w["up"], w["down"],
                        cnt_rx, cfg)                       # (E/tp, tp, cx, d)
    # the symmetric return exchange to each token's owner
    ya = _AllToAll.apply(ye.transpose(0, 1), g_model)
    ye_loc = ya.reshape(E, cx, d)
    if inv_p is not None:                 # slots -> logical bucket order
        ye_loc = ye_loc[inv_p]
    contrib = ye_loc[se, rank.clamp(0, cx - 1)]

    # the ladder's rung covers every kept rank, so the drops are the
    # dense exchange's: rank >= C
    keep_s = rank < C
    contrib = torch.where(keep_s[:, None], contrib, 0)[inv]
    y = (contrib.reshape(-1, K, d)
         * gates.to(contrib.dtype)[..., None]).sum(1).to(xb.dtype)
    if y_shared is not None:
        y = y + y_shared

    # global observables: one integer sum (workload, drops), one float mean
    n = dist.get_world_size()
    ints = _all_reduce(torch.cat([counts.to(torch.int32),
                                  (~keep_s).sum().to(torch.int32)[None]]),
                       None)
    frac = counts.float() / (T_my * K)
    aux = E * (frac * probs.mean(0)).sum()
    z = (torch.logsumexp(logits, dim=-1) ** 2).mean()
    aux_z = _MeanOverWorld.apply(torch.stack([aux, z]), n)

    def gather(t):
        if local:
            return t.reshape((Bl * Sl,) + tuple(t.shape[1:]))
        return _GatherTokens.apply(t.reshape((Bl, Sl) + tuple(t.shape[1:])),
                                   dp, tp, di, mi)

    T_all = Bl * Sl if local else B * S
    info = {
        "workload": ints[:E],
        "topk_idx": gather(idx).reshape(T_all, K),
        "gates": gather(gates).reshape(T_all, K),
        "probs": gather(probs).reshape(T_all, E),
        "gate_in": gather(xf).reshape(T_all, d),
        "aux_loss": aux_z[0] * m.aux_loss_weight,
        "z_loss": aux_z[1] * m.router_z_weight,
        "dropped": ints[E],
        "ep_cx": torch.tensor(cx, dtype=torch.int32, device=x.device),
    }
    if demand_view:
        dv = _all_gather(counts.clamp(max=C).to(torch.int32), g_model)
        if dp > 1:
            dv = _all_reduce(dv, mesh.get_group("data"))
        info["ep_counts"] = dv
    if local:
        return y.reshape(Bl, Sl, d), info
    return gather(y), info
