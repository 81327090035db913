"""The collectives a laid-out step issues (port of
``repro/launch/hloparse.py::collective_traffic``) and the host wire for
CUDA tensors under gloo.

Where the reference reads the collectives out of the compiled HLO, the
port records them as they are dispatched: ``CollectiveCount`` is a
``TorchDispatchMode`` that sees every functional collective a DTensor
redistribution issues (``_c10d_functional``, forward and backward) and
every ``c10d`` collective of the expert-parallel exchange
(``models/moe_ep.py``).  For each it keeps the kind, the per-device
traffic of the reference's ring formulas (``traffic``), the group's size,
the mesh axes the group spans and the link it crosses.  The same step on
ranks and on the dry run's fake group counts the same collectives.

``HostWire`` carries a DTensor's functional collectives on CUDA tensors
through host memory over gloo, whose all-gather of a CUDA tensor kills
its process on the card: each collective, of every kind, is copied to the
host, run there and copied back.  bfloat16 is reduced in bfloat16, as
NCCL reduces it, and moves as float16 of the same bits.
"""
from __future__ import annotations

import torch
from torch.utils._python_dispatch import TorchDispatchMode

KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
         "collective-permute")

# op name -> (kind, result bytes from the input's: "same" | "mul" | "div")
_FUNCTIONAL = {
    "all_reduce": ("all-reduce", "same"),
    "all_reduce_": ("all-reduce", "same"),
    "all_gather_into_tensor": ("all-gather", "mul"),
    "reduce_scatter_tensor": ("reduce-scatter", "div"),
    "all_to_all_single": ("all-to-all", "same"),
    "broadcast": ("collective-permute", "same"),
    "broadcast_": ("collective-permute", "same"),
}
_C10D = {
    "allreduce_": "all-reduce",
    "allgather_": "all-gather",
    "_allgather_base_": "all-gather",
    "reduce_scatter_": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "alltoall_base_": "all-to-all",
    "alltoall_": "all-to-all",
    "broadcast_": "collective-permute",
}


def traffic(kind: str, b: float, g: int) -> float:
    """Per-device bytes a ring collective moves, from its result's bytes
    ``b`` and its group size ``g`` (reference ``hloparse._traffic``)."""
    if kind == "all-gather":
        return b * (g - 1) / g
    if kind == "all-reduce":
        return 2.0 * b * (g - 1) / g
    if kind == "reduce-scatter":
        return b * (g - 1)
    if kind == "all-to-all":
        return b * (g - 1) / g
    return float(b)   # collective-permute


def _op_name(func) -> tuple:
    """(namespace, op name) of an op overload."""
    return func.namespace, func._schema.name.split("::")[-1]


def _nbytes(t) -> int:
    if isinstance(t, torch.Tensor):
        return t.numel() * t.element_size()
    if isinstance(t, (list, tuple)):
        return sum(_nbytes(x) for x in t)
    return 0


def _is_subclass_call(types) -> bool:
    """Whether a call carries DTensors: a mode returns NotImplemented to
    it, so DTensor runs first and the mode sees the local ops it lowers
    to (its redistributions' collectives among them)."""
    from torch.distributed.tensor import DTensor
    return any(issubclass(t, DTensor) for t in types)


def _c10d_group(args):
    """The process group a ``c10d`` op was called with (a boxed script
    object at the dispatcher)."""
    from torch._C._distributed_c10d import ProcessGroup
    for a in args:
        if isinstance(a, ProcessGroup):
            return a
        if isinstance(a, torch.ScriptObject):
            return ProcessGroup.unbox(a)
    raise ValueError("a c10d collective without a process group")


def _group_ranks(group) -> tuple:
    import torch.distributed as dist
    from torch.distributed.distributed_c10d import _resolve_process_group
    pg = _resolve_process_group(group) if isinstance(group, str) else group
    return tuple(dist.get_process_group_ranks(pg))


class CollectiveCount(TorchDispatchMode):
    """Record every collective dispatched while active.  ``mesh`` (a
    ``DeviceMesh``) names the axes a group spans; ``link_of(ranks)`` (e.g.
    ``launch/mesh.py::group_link``) gives the link a group crosses."""

    def __init__(self, mesh=None, link_of=None):
        super().__init__()
        self.mesh = mesh
        self.link_of = link_of
        self.events = []
        self._groups = {}

    def _group(self, group):
        key = group if isinstance(group, str) else group.group_name
        if key not in self._groups:
            ranks = _group_ranks(group)
            axes = ()
            if self.mesh is not None:
                coords = self.mesh.mesh
                names = self.mesh.mesh_dim_names
                where = [tuple(int(i) for i in (coords == r).nonzero()[0])
                         for r in ranks]
                axes = tuple(n for d, n in enumerate(names)
                             if len({w[d] for w in where}) > 1)
            link = self.link_of(ranks)[0] if self.link_of else None
            self._groups[key] = (len(ranks), axes, link)
        return self._groups[key]

    def _record(self, kind, result_bytes, group, itemsize):
        g, axes, link = self._group(group)
        self.events.append({"kind": kind, "result_bytes": int(result_bytes),
                            "elements": int(result_bytes) // itemsize,
                            "bytes": traffic(kind, result_bytes, max(g, 2)),
                            "group_size": g, "axes": axes, "link": link})

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if _is_subclass_call(types):
            return NotImplemented
        kwargs = kwargs or {}
        ns, name = _op_name(func)
        if ns in ("_c10d_functional", "_c10d_functional_autograd") \
                and name in _FUNCTIONAL:
            kind, rule = _FUNCTIONAL[name]
            group = args[-1] if isinstance(args[-1], str) \
                else kwargs["group_name"]
            b = _nbytes(args[0])
            g = self._group(group)[0]
            b = b * g if rule == "mul" else b // g if rule == "div" else b
            self._record(kind, b, group, args[0].element_size())
        elif ns == "c10d" and name in _C10D:
            group = _c10d_group(args)
            kind = _C10D[name]
            # result bytes: the output buffers of a gather / exchange /
            # scatter, the reduced tensors of an all-reduce
            first = args[0]
            while isinstance(first, (list, tuple)):
                first = first[0]
            self._record(kind, _nbytes(args[0]), group, first.element_size())
        return func(*args, **kwargs)

    def summary(self) -> dict:
        """Per-device bytes by kind with ``_n_<kind>`` counts and
        ``"total"`` (the reference's ``collective_traffic`` dict), plus
        ``"by_axis"`` and ``"by_link"`` (bytes per mesh-axis group and per
        link)."""
        out, by_axis, by_link = {}, {}, {}
        for e in self.events:
            out[e["kind"]] = out.get(e["kind"], 0.0) + e["bytes"]
            out["_n_" + e["kind"]] = out.get("_n_" + e["kind"], 0) + 1
            ax = ",".join(e["axes"]) or "-"
            by_axis[ax] = by_axis.get(ax, 0.0) + e["bytes"]
            if e["link"] is not None:
                by_link[e["link"]] = by_link.get(e["link"], 0.0) + e["bytes"]
        out["total"] = sum(v for k, v in out.items() if not k.startswith("_"))
        out["by_axis"] = by_axis
        out["by_link"] = by_link
        return out

    def signature(self, unit: str = "result_bytes") -> list:
        """(kind, size, group size, axes) of every collective in issue
        order, the size in ``unit`` ("result_bytes" or "elements"): what a
        run on ranks and the fake group's dry run of the same step share."""
        return [(e["kind"], e[unit], e["group_size"], e["axes"])
                for e in self.events]


_REDUCES = ("all_reduce", "all_reduce_", "reduce_scatter_tensor")
# collectives the wire does not stage (the layout issues none of them)
_UNSTAGED = ("all_reduce_coalesced", "all_reduce_coalesced_",
             "all_gather_into_tensor_coalesced", "all_gather_into_tensor_out",
             "reduce_scatter_tensor_coalesced")


class HostWire(TorchDispatchMode):
    """Run each functional collective on a CUDA tensor through host memory
    (gloo), as ``models/moe_ep.py::_wire`` does for the exchange."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if _is_subclass_call(types):
            return NotImplemented
        kwargs = kwargs or {}
        ns, name = _op_name(func)
        if ns not in ("_c10d_functional", "_c10d_functional_autograd"):
            return func(*args, **kwargs)
        t = args[0]
        if name == "wait_tensor":
            # a staged collective returned a finished tensor
            return t if t.is_cuda else func(*args, **kwargs)
        if not (isinstance(t, torch.Tensor) and t.is_cuda) \
                or name not in tuple(_FUNCTIONAL) + _UNSTAGED:
            # host tensors, and the namespace's ops that move nothing
            # (``_wrap_tensor_autograd``)
            return func(*args, **kwargs)
        if name in _UNSTAGED:
            raise NotImplementedError(f"HostWire: {ns}.{name} on a CUDA "
                                      "tensor")
        bits = t.dtype == torch.bfloat16 and name not in _REDUCES
        src = t.detach().view(torch.float16) if bits else t.detach()
        out = func(src.cpu(), *args[1:], **kwargs)
        out = torch.ops._c10d_functional.wait_tensor(out).to(t.device)
        if bits:
            out = out.view(torch.bfloat16)
        if name.endswith("_"):                      # in place
            t.copy_(out)
            return t
        return out
