"""Device meshes and rank processes for expert parallelism (port of
``repro/launch/mesh.py``).

Where the JAX package runs one program over a mesh of devices, the port
runs one process per rank (``run_ranks``), joined by ``torch.distributed``,
and each rank builds the mesh it belongs to (``make_mesh``): a
``DeviceMesh`` of shape (dp, tp) named ``("data", "model")``, rank
``i * tp + j`` at (data i, model j).  ``backend="gloo"`` is the one path a
machine with one card can run: every rank computes on that card (or on the
CPU) and the exchanged tensors travel through host memory.
``backend="nccl"`` puts rank ``r`` on ``cuda:r`` and needs a card per
rank; it is the same collectives without the staging.  Under gloo on the
card, a laid-out model's DTensor collectives cross host memory too
(``sharding.rules`` enters ``collectives.HostWire``).

``make_production_mesh`` lays out the mesh a production deployment of the
port would run on (``AXIS_LINKS``: the link each axis crosses); the shape
dry run builds it over a fake process group (``launch/dryrun.py``).
"""
from __future__ import annotations

import datetime
import os
import pickle
import queue
import tempfile
import time
import traceback

import torch

AXES = ("data", "model")
BACKENDS = ("gloo", "nccl")

# the card's production mesh: 8 H100 SXM a node, joined by NVLink 4 inside
# it; nodes joined by InfiniBand NDR, one 400 Gb/s port a card
NODE_CARDS = 8
PRODUCTION_SHAPES = {False: ((32, 8), ("data", "model")),
                     True: ((2, 32, 8), ("pod", "data", "model"))}
# axis -> (link, bytes/s each way per card, source); data-sheet
# predictions, not readings
NVLINK = ("NVLink 4", 450e9, "H100 SXM data sheet: 900 GB/s bidirectional "
          "NVLink per card")
INFINIBAND = ("InfiniBand NDR", 50e9, "DGX H100: one 400 Gb/s NDR port "
              "(ConnectX-7) per card")
AXIS_LINKS = {"model": NVLINK, "data": INFINIBAND, "pod": INFINIBAND}


def make_production_mesh(multi_pod: bool = False):
    """The production mesh: (data=32, model=8), 256 H100 SXM in 32 nodes of
    8, or with ``multi_pod`` (pod=2, data=32, model=8), 512 cards.

    Tensor parallelism ('model') carries an all-reduce or an all-gather in
    every layer, so it stays inside one NVLink domain of 8 cards, where
    each card moves 450 GB/s each way.  Data parallelism ('data', 'pod')
    carries the batch, the FSDP weight gathers and the gradient
    reductions, which are fewer and larger; it crosses InfiniBand at 50
    GB/s each way a card.  (The TPU pod's 16 x 16 torus has no such
    boundary: there every axis rides the same ICI links.)

    Built over the initialised world, which must hold the mesh's ranks:
    the shape dry run's fake process group (``launch/dryrun.py``), whose
    collectives move nothing; the mesh's device type is ``cpu`` and its
    local tensors live on ``meta``."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    shape, names = PRODUCTION_SHAPES[bool(multi_pod)]
    n = 1
    for s in shape:
        n *= s
    if not dist.is_initialized() or dist.get_world_size() != n:
        raise RuntimeError(f"the production mesh needs an initialised world "
                           f"of {n} ranks (launch/dryrun.py::fake_world)")
    return init_device_mesh("cpu", shape, mesh_dim_names=names)


def group_link(ranks) -> tuple:
    """The link a group of global ranks crosses on the production mesh:
    NVLink inside one node of ``NODE_CARDS``, InfiniBand across nodes."""
    nodes = {r // NODE_CARDS for r in ranks}
    return NVLINK if len(nodes) <= 1 else INFINIBAND


def make_mesh(dp: int, tp: int, device_type=None):
    """The (dp, tp) ``DeviceMesh`` over the initialised world, named
    ``("data", "model")``.  Its device type defaults to the ranks' wire:
    ``cpu`` under gloo (tensors staged through host memory), ``cuda`` under
    NCCL; a laid-out model on the card under gloo passes
    ``device_type="cuda"`` (a DTensor's local tensors live on its mesh's
    device type; ``HostWire`` stages their collectives)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    if not dist.is_initialized():
        raise RuntimeError("make_mesh runs inside an initialised rank "
                           "(launch/mesh.py::run_ranks)")
    world = dist.get_world_size()
    if dp * tp != world:
        raise ValueError(f"a ({dp}, {tp}) mesh needs {dp * tp} ranks, the "
                         f"world has {world}")
    dev = device_type or ("cuda" if dist.get_backend() == "nccl" else "cpu")
    mesh = init_device_mesh(dev, (dp, tp), mesh_dim_names=AXES)
    if mesh.mesh.flatten().tolist() != list(range(world)):
        raise RuntimeError("the mesh must hold the ranks in row-major order")
    return mesh


def data_axes(mesh) -> tuple:
    """Mesh axes that carry the batch dimension."""
    return tuple(a for a in ("pod", "data") if a in mesh.mesh_dim_names)


def axis_size(mesh, *names) -> int:
    n = 1
    for a in names:
        if a in mesh.mesh_dim_names:
            n *= mesh.size(mesh.mesh_dim_names.index(a))
    return n


def axis_index(mesh, name) -> int:
    """This rank's coordinate on mesh axis ``name`` (0 without the axis)."""
    return (mesh.get_local_rank(name) if name in mesh.mesh_dim_names
            else 0)


def wire_name(backend: str, device) -> str:
    """How the ranks' collectives travel: gloo over host memory for CPU
    tensors, the host-staged wire (``launch/collectives.py::HostWire``,
    entered by a laid-out ``sharding.rules``) for CUDA tensors under gloo,
    NCCL on the cards."""
    if backend == "nccl":
        return "nccl"
    return "host-staged gloo" if torch.device(device).type == "cuda" \
        else "gloo"


def _rank_main(rank, world, backend, device, path, timeout_s, fn,
               args_path, results):
    """One rank: join the process group, run ``fn(rank, world, *args)``
    (the arguments read from the file the caller pickled them to), send
    back its pickled result or the traceback."""
    import torch.distributed as dist
    torch.set_num_threads(1)
    with open(args_path, "rb") as f:
        args = pickle.load(f)
    if device == "cuda":
        torch.cuda.set_device(rank if backend == "nccl" else 0)
    dist.init_process_group(backend, init_method=f"file://{path}",
                            world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=timeout_s))
    try:
        out = (rank, True, pickle.dumps(fn(rank, world, *args)))
    except BaseException:
        out = (rank, False, traceback.format_exc())
    results.put(out)
    if out[1]:
        dist.destroy_process_group()


def run_ranks(fn, world: int, *, backend: str = "gloo", device="cpu",
              timeout_s: float = 300.0, args=()):
    """Run ``fn(rank, world, *args)`` in ``world`` spawned processes joined
    by ``torch.distributed`` and return the ranks' results, in rank order.

    ``fn`` is a module-level function (the ranks import it) whose result
    pickles without a card (numpy arrays, CPU tensors, plain values).  The
    group is initialised through a fresh file (never a fixed port, so runs
    side by side do not meet) with ``timeout_s`` as its collective timeout;
    each rank runs torch on one thread.  ``device="cuda"`` puts every rank
    on the card (gloo: all on ``cuda:0``, tensors staged through host
    memory; NCCL: rank r on ``cuda:r``, one card per rank).  If any rank
    raises, or the ranks outlive ``timeout_s``, the others are killed and
    the caller gets a ``RuntimeError`` with the failure."""
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got "
                         f"{backend!r}")
    dev = torch.device(device).type
    if dev not in ("cpu", "cuda"):
        raise ValueError(f"device must be 'cuda' or 'cpu', got {device!r}")
    if backend == "nccl":
        if dev != "cuda":
            raise ValueError("backend='nccl' runs CUDA tensors: pass "
                             "device='cuda'")
        if world > torch.cuda.device_count():
            raise ValueError(f"backend='nccl' needs one card per rank: "
                             f"{world} ranks, {torch.cuda.device_count()} "
                             f"cards")
    if dev == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("run_ranks(device='cuda') needs a CUDA card; "
                           "pass device='cpu' to run the ranks on the CPU")
    fd, path = tempfile.mkstemp(prefix="ranks-")
    os.close(fd)
    os.unlink(path)                    # the file store creates it
    # the arguments go through a file: a spawned child reads its Process
    # arguments only after importing the caller's main module, so large
    # ones passed there would start the ranks one after the other
    fd, args_path = tempfile.mkstemp(prefix="ranks-args-")
    with os.fdopen(fd, "wb") as f:
        pickle.dump(tuple(args), f)
    ctx = torch.multiprocessing.get_context("spawn")
    results = ctx.Queue()
    procs = [ctx.Process(target=_rank_main,
                         args=(r, world, backend, dev, path, timeout_s, fn,
                               args_path, results), daemon=True)
             for r in range(world)]
    got = {}
    try:
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout_s
        while len(got) < world:
            left = deadline - time.monotonic()
            if left <= 0:
                raise RuntimeError(
                    f"ranks {sorted(set(range(world)) - set(got))} of "
                    f"{world} did not finish within {timeout_s} s")
            try:
                rank, ok, payload = results.get(timeout=min(left, 1.0))
            except queue.Empty:
                dead = [r for r, p in enumerate(procs)
                        if r not in got and p.exitcode not in (None, 0)]
                if dead:
                    raise RuntimeError(
                        f"rank {dead[0]} of {world} exited with code "
                        f"{procs[dead[0]].exitcode} and no result")
                continue
            if not ok:
                raise RuntimeError(f"rank {rank} of {world} failed:\n"
                                   f"{payload}")
            got[rank] = pickle.loads(payload)
        for p in procs:
            p.join(timeout=max(1.0, deadline - time.monotonic()))
    finally:
        started = [p for p in procs if p.pid is not None]
        for p in started:
            if p.is_alive():
                p.kill()
        for p in started:
            p.join(timeout=10)
        for p in (path, args_path):
            if os.path.exists(p):
                os.unlink(p)
    return [got[r] for r in range(world)]
