"""Placing a step's inputs on a mesh as DTensors, and the local regions the
laid-out model runs its kernels in (the port's counterpart of the
reference's ``NamedSharding`` inputs under GSPMD).

``distribute_params`` / ``distribute_opt_state`` / ``distribute_caches`` /
``distribute_batch`` lay the trees out by the specs of
``launch/sharding.py``: each leaf becomes a DTensor whose local tensor is
this rank's shard of the full one (on ``meta``, an empty shard of the local
shape: the dry run's rank 0).  ``gather`` returns full tensors.

``local_kernel(fn, in_placements, out_placements)`` is the one way the
laid-out model computes: a thin ``local_map`` wrapper that redistributes
each DTensor input to its declared placements (the collectives of the
layout), calls ``fn`` on the local tensors (where the hand-written kernels
run; a DTensor never reaches a kernel's binding) and wraps its outputs
with the declared placements (``Partial`` where each rank holds a share of
a sum).  The gradient of an input replicated along a mesh dim along which
the outputs differ is a sum of the ranks' shares: it is declared
``Partial`` there.  The gradient of a ``Partial`` input is each rank's
whole: it is declared ``Replicate``.
"""
from __future__ import annotations

import torch

from repro_torch.launch import sharding as shd
from repro_torch.tree import tree_leaves, tree_map, tree_map_with_path


def mesh():
    return shd.active()["mesh"]


def is_dtensor(t) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(t, DTensor)


def place(spec, partial=(), reduce_op: str = "sum") -> tuple:
    """Placements of ``spec`` on the active mesh (``sharding.placements``)
    with ``Partial`` on the mesh axes named in ``partial``."""
    from torch.distributed.tensor import Partial
    m = mesh()
    out = list(shd.placements(spec, m))
    for ax in partial:
        if ax in m.mesh_dim_names:
            out[m.mesh_dim_names.index(ax)] = Partial(reduce_op)
    return tuple(out)


def local_offset(shape, placements, mesh_=None) -> tuple:
    """(local shape, global offset) of this rank's shard."""
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    m = mesh_ if mesh_ is not None else mesh()
    lshape, off = compute_local_shape_and_global_offset(
        tuple(shape), m, tuple(placements))
    return tuple(lshape), tuple(off)


def offset(x, dim: int) -> int:
    """Global offset of a DTensor's local shard along ``dim``."""
    return local_offset(x.shape, x.placements, x.device_mesh)[1][dim]


def shard_of(t, spec, mesh_):
    """This rank's shard of the full tensor ``t`` under ``spec`` (a
    contiguous copy; on ``meta`` an empty tensor of the local shape)."""
    pl = shd.placements(spec, mesh_)
    lshape, off = local_offset(t.shape, pl, mesh_)
    if t.is_meta:
        return torch.empty(lshape, dtype=t.dtype, device=t.device)
    out = t
    for d, (o, n) in enumerate(zip(off, lshape)):
        if n != t.shape[d]:
            out = out.narrow(d, o, n)
    return out.clone(memory_format=torch.contiguous_format)


def distribute(t, spec, mesh_):
    """``t`` (full, or ``meta``) as a DTensor laid out by ``spec``; the
    local shard goes to the mesh's device type (a full tensor may stay in
    host memory while only the shards go to the card)."""
    from torch.distributed.tensor import DTensor
    spec = shd.fit_spec(spec, tuple(t.shape), mesh_)
    local = shard_of(t, spec, mesh_)
    if not local.is_meta and local.device.type != mesh_.device_type:
        local = local.to(mesh_.device_type)
    return DTensor.from_local(local, mesh_,
                              shd.placements(spec, mesh_), run_check=False,
                              shape=t.shape, stride=t.stride())


def distribute_params(params, cfg, mesh_, wmode: str = "tp"):
    specs = shd.param_pspecs(cfg, params, mode=wmode, mesh=mesh_)
    return tree_map(lambda t, s: distribute(t, s, mesh_), params, specs)


def distribute_opt_state(opt_state, cfg, mesh_, wmode: str = "tp"):
    """The moments laid out as their params; the step counter stays a plain
    tensor on every rank."""
    return {"mu": distribute_params(opt_state["mu"], cfg, mesh_, wmode),
            "nu": distribute_params(opt_state["nu"], cfg, mesh_, wmode),
            "step": opt_state["step"]}


def distribute_caches(caches, cfg, shape_name: str, mesh_):
    specs = shd.cache_pspecs(cfg, caches, shape_name, mesh_)
    return tree_map(lambda t, s: distribute(t, s, mesh_), caches, specs)


def distribute_batch(batch, mesh_):
    """Token ids and labels (B, S) by ``batch_pspec``; a cross source (B,
    T, d) over the same batch axes; anything else replicated."""
    def one(path, t):
        if not isinstance(t, torch.Tensor):
            return t
        b = shd.batch_pspec(mesh_, t.shape[0])[0] if t.dim() else None
        return distribute(t, (b,) + (None,) * (t.dim() - 1), mesh_)
    return tree_map_with_path(one, batch)


def gather(tree):
    """Full tensors of every DTensor leaf (a collective per sharded leaf);
    other leaves as they are."""
    return tree_map(lambda t: t.full_tensor() if is_dtensor(t) else t, tree)


def _grad_placements(in_pls, out_pls):
    """A Replicate input dim whose outputs differ along that mesh dim gets
    a Partial gradient (each rank holds a share of it); a Partial input
    dim a Replicate one (the gradient of each rank's summand is the whole
    gradient of the sum)."""
    from torch.distributed.tensor import Partial, Replicate
    flat_out = [p for p in out_pls if p is not None]
    differs = [any(not isinstance(o[m], Replicate) for o in flat_out)
               for m in range(len(flat_out[0]))] if flat_out else []

    def grad(m, p):
        if isinstance(p, Partial):
            return Replicate()
        return Partial() if isinstance(p, Replicate) and differs[m] else p

    return tuple(None if pl is None else
                 tuple(grad(m, p) for m, p in enumerate(pl))
                 for pl in in_pls)


def local_of(t, out_placements):
    """``t.to_local()`` for a region whose outputs lie with
    ``out_placements``: the gradient comes back as ``local_kernel``
    declares it, ``Partial`` on each mesh dim where ``t`` is replicated and
    the outputs differ (each rank's share, summed when it is settled)."""
    pl = _grad_placements([tuple(t.placements)], [tuple(out_placements)])[0]
    return t.to_local(grad_placements=pl)


def local_kernel(fn, in_placements, out_placements):
    """``fn`` over local shards (``local_map``): DTensor inputs are
    redistributed to ``in_placements`` (None for a plain tensor, which
    every rank holds whole), outputs wrapped with ``out_placements`` (a
    tuple per output, or one tuple for a single output).  Inputs are a
    flat list of tensors; anything else goes into ``fn``'s closure."""
    from torch.distributed.tensor.experimental import local_map
    in_pls = tuple(None if p is None else tuple(p) for p in in_placements)
    single = not isinstance(out_placements[0], (tuple, list))
    outs = (tuple(out_placements),) if single else tuple(
        tuple(p) for p in out_placements)
    mapped = local_map(fn, out_placements=outs,
                       in_placements=in_pls,
                       in_grad_placements=_grad_placements(in_pls, outs),
                       device_mesh=mesh(), redistribute_inputs=True)
    if not any(pl and any(p.is_replicate() for p in pl) for pl in in_pls):
        return mapped

    def checked(*args):
        # a replicated input's gradient is either each rank's share (the
        # outputs differ along that mesh dim) or each rank's whole (they do
        # not): a region whose differentiable outputs are mixed there has
        # no one answer
        res = mapped(*args)
        if not torch.is_grad_enabled():
            return res
        live = [o for o, r in zip(outs, res if isinstance(res, tuple)
                                  else (res,)) if r.requires_grad]
        for a, pl in zip(args, in_pls):
            if pl is None or not getattr(a, "requires_grad", False):
                continue
            dims = [m for m, p in enumerate(pl) if p.is_replicate()
                    and len({o[m].is_replicate() for o in live}) > 1]
            if dims:
                raise NotImplementedError(
                    f"{getattr(fn, '__name__', fn)}: a gradient through a "
                    "region whose outputs are sharded and replicated along "
                    f"mesh dims {dims}; split the region")
        return res
    return checked


class _Stack:
    """The per-index DTensors of a stacked leaf (``unstack``)."""

    def __init__(self, t):
        from torch.distributed.tensor import Shard
        # unbound once: the gradients of the parts come back as one stack
        # (an index's backward would build a zero stack for each part)
        self.parts = t.to_local().unbind(0)
        self.mesh = t.device_mesh
        self.pls = []
        for p in t.placements:
            if isinstance(p, Shard):
                if p.dim == 0:
                    raise ValueError("unstack of a stack sharded along dim 0")
                p = Shard(p.dim - 1)
            self.pls.append(p)
        shape = tuple(t.shape[1:])
        stride = [1] * len(shape)
        for d in range(len(shape) - 2, -1, -1):
            stride[d] = stride[d + 1] * shape[d + 1]
        self.shape, self.stride = shape, tuple(stride)

    def __getitem__(self, i):
        from torch.distributed.tensor import DTensor
        return DTensor.from_local(self.parts[i], self.mesh, self.pls,
                                  run_check=False, shape=self.shape,
                                  stride=self.stride)


def unstack(t):
    """A stacked leaf whose dim 0 no mesh axis shards, indexable per
    super-block: one ``to_local`` of the stack, unbound, each part
    rewrapped.  So no DTensor op runs on the stack (its sharding
    propagation would build global-size ``meta`` arguments, which the dry
    run would count), and a parameter's gradients from its super-blocks
    come back as one local stack.  Plain tensors are returned as they
    are."""
    return _Stack(t) if is_dtensor(t) else t


def tp_laid(tree):
    """A replicated layer's leaves laid out as ``param_pspecs`` lays a
    decoder layer's under tp: each 2-D projection with its 'model' dim
    sharded (a local slice, no collective; its gradient is gathered back
    in the backward), other leaves as they are.  The reference replicates
    the encoder's stack (its keys hold no 'scan'), and GSPMD slices such
    weights to the heads and hidden units its hints shard."""
    def one(path, w):
        name = str(path[-1])
        if not is_dtensor(w) or w.dim() != 2 or not shd.is_matrix(name):
            return w
        m = w.device_mesh
        spec = shd.fit_spec(shd.matrix_spec(name), tuple(w.shape), m)
        return w.redistribute(m, shd.placements(spec, m))
    return tree_map_with_path(one, tree)


def add(x, y):
    """x + y of two DTensors laid out alike, on the local tensors."""
    return local_kernel(lambda a, b: a + b, [x.placements, x.placements],
                        x.placements)(x, y)


def spec_from(pls, ndim: int) -> list:
    """The spec (a mesh axis name, a tuple of them or None per tensor dim)
    that placements ``pls`` lay a tensor of ``ndim`` dims out by on the
    active mesh; Partial dims read as unsharded."""
    from torch.distributed.tensor import Shard
    names = mesh().mesh_dim_names
    dims = [[] for _ in range(ndim)]
    for m, p in enumerate(pls):
        if isinstance(p, Shard):
            dims[p.dim].append(names[m])
    return [None if not d else d[0] if len(d) == 1 else tuple(d)
            for d in dims]


def replicated_on(pls, axes) -> tuple:
    """Placements ``pls`` on the active mesh with the mesh dims named in
    ``axes`` replicated."""
    from torch.distributed.tensor import Replicate
    names = mesh().mesh_dim_names
    return tuple(Replicate() if names[m] in axes else p
                 for m, p in enumerate(pls))


def gathered_weight(w) -> tuple:
    """A weight's placements with its FSDP shards ('data', 'pod')
    gathered: what a region that computes with the whole weight declares."""
    return replicated_on(w.placements, ("data", "pod"))


def sums_of(pls) -> tuple:
    """Placements of a sum over the tokens of a region whose tokens lie
    with ``pls``: Partial on each mesh dim where they are sharded."""
    from torch.distributed.tensor import Partial, Replicate
    return tuple(Replicate() if isinstance(p, Replicate) else Partial()
                 for p in pls)


def settle_grads(leaves, grads):
    """Each DTensor leaf's gradient redistributed to its leaf's placements
    (the data-parallel all-reduce / reduce-scatter of the gradients)."""
    out = []
    for p, g in zip(leaves, grads):
        if g is not None and is_dtensor(p) and g.placements != p.placements:
            g = g.redistribute(p.device_mesh, p.placements)
        out.append(g)
    return out


_CHUNK = 1 << 26


def global_sq_norm(grads):
    """Σ g² over every leaf (float32), each element counted once: a leaf's
    local sum over its replicas is divided out, and the ranks' shares are
    summed by one reduction per mesh dim.  Plain leaves are summed as
    they are."""
    from torch.distributed.tensor import DTensor, Partial, Replicate
    local = None
    m = None
    for g in tree_leaves(grads):
        if not is_dtensor(g):
            raise TypeError("global_sq_norm takes laid-out gradients")
        flat = g.to_local().reshape(-1)
        reps = 1
        for d, p in enumerate(g.placements):
            if isinstance(p, Replicate):
                reps *= g.device_mesh.size(d)
        # in chunks, as the optimizer's own norm: float32 temporaries the
        # size of a chunk, not of a leaf
        s = sum(torch.sum(torch.square(flat[i:i + _CHUNK].to(torch.float32)))
                for i in range(0, flat.numel(), _CHUNK)) / reps
        local = s if local is None else local + s
        m = g.device_mesh
    tot = DTensor.from_local(local, m, [Partial()] * m.ndim, run_check=False)
    return tot.redistribute(m, [Replicate()] * m.ndim).to_local()
