"""Shape dry run of every (architecture x input shape) step on the ``meta``
device (port of ``repro/launch/dryrun.py``): no weights, no card, no
FLOP performed.  Each step runs once on meta tensors, which carry only
shapes and dtypes; the kernel wrappers return their kernels' output
shapes there and add their kernels' FLOPs to the count
(``repro_torch/kernels/__init__.py``).  Each record holds:

* the parameter bytes and the peak live bytes of the step (every storage
  the run allocates, from its first op to its last, beside the
  parameters, optimizer state, caches and inputs it starts from; a
  weakref on each storage frees its bytes when it dies), what one card
  would have to hold;
* the analytic FLOPs, HBM bytes, KV bytes and parameter bytes of
  ``launch/costs.py::step_cost``, and the FLOPs
  ``torch.utils.flop_counter.FlopCounterMode`` counted in the run;
* the roofline terms at the H100 80GB HBM3 SXM data sheet's peaks (989
  TFLOP/s dense bf16, 3.35 TB/s, and the link rates of
  ``launch/mesh.py::AXIS_LINKS``): predictions, not readings.

``--mesh card`` (the default) runs the step whole on one card.  ``--mesh
pod`` / ``multi-pod`` runs it laid out on the production mesh
(``launch/mesh.py::make_production_mesh``: 256 or 512 cards) as rank 0 of
a fake process group (``torch.testing._internal.distributed.fake_pg``,
whose collectives move nothing; only the dry run and the tests use it).
The step's inputs are rank 0's local shards (``launch/shapes.py::build``,
the weight mode by ``weights_need_fsdp`` at 80 GB), and the record adds:

* the per-card peak live bytes (the local tensors' storages);
* every collective the step issues (``launch/collectives.py::
  CollectiveCount``): per-device bytes by kind, by mesh axis and by link;
* ``collective_s``: the sum over links of (bytes on it / its rate); a
  group that spans a node boundary runs at the InfiniBand rate.

FLOPs: the kernels and every op in ``launch/layout.py::local_kernel``
regions count at local shapes, so ``counted_flops`` of a laid-out run is
rank 0's share; the roofline's compute term uses ``step_cost``'s global
FLOPs over the cards.  On ``meta`` the expert-parallel exchange cannot
read its global max demand, so it ships the ladder's top rung (recorded
as ``ep_exchange``).  Each combination runs in a process of its own
(``--all``), since the fake group is per process.

Usage::

  python -m repro_torch.launch.dryrun --arch mixtral-8x7b --shape decode_32k
  python -m repro_torch.launch.dryrun --arch A --shape S --mesh pod
  python -m repro_torch.launch.dryrun --all [--mesh M] [--force]

Results accumulate in ``reports/dryrun_torch/<arch>__<shape>__<mesh>.json``
(ignored by git), beside the reference's ``reports/dryrun/``.
"""
from __future__ import annotations

import argparse
import contextlib
import gc
import json
import os
import subprocess
import sys
import time
import traceback
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode

# the H100 80GB HBM3 SXM data sheet's peaks (dense, no sparsity), at its
# 700 W power limit
PEAK_FLOPS = 989e12        # bf16 tensor-core FLOP/s
HBM_BW = 3.35e12           # device-memory bytes/s
PEAK_SOURCE = "NVIDIA H100 80GB HBM3 SXM data sheet, 700 W"

MESHES = ("card", "pod", "multi-pod")
# each combination's process under --all
COMBO_TIMEOUT_S = 7200

_FAKE = torch._C._TorchDispatchModeKey.FAKE

REPORT_DIR = os.path.normpath(os.path.join(
    os.path.dirname(__file__), "..", "..", "..", "reports", "dryrun_torch"))


def model_flops(cfg, spec) -> float:
    """MODEL_FLOPS = 6*N*D (train) / 2*N*D (inference) with N = active
    params (MoE: top_k experts + shared, not all routed)."""
    from repro_torch.launch.sharding import estimate_params
    from repro_torch.models.config import layer_pattern
    n = estimate_params(cfg)
    if cfg.moe is not None:
        m = cfg.moe
        de = m.d_expert or cfg.d_ff
        per_layer_all = m.n_routed * 3 * cfg.d_model * de
        per_layer_act = m.top_k * 3 * cfg.d_model * de
        n_moe = sum(1 for _, mlp in layer_pattern(cfg) if mlp == "moe")
        n = n - n_moe * (per_layer_all - per_layer_act)
    tokens = spec.batch * (spec.seq if spec.kind != "decode" else 1)
    mult = 6.0 if spec.kind == "train" else 2.0
    return mult * n * tokens


def _storage_bytes(t) -> tuple:
    st = t.untyped_storage()
    return st._cdata, st.nbytes(), st


class PeakBytes(TorchDispatchMode):
    """Live bytes of the storages in use while active: those of the
    tensors passed to ``start`` (the step's inputs) plus every storage an
    op allocates, each freed when its storage dies.  Views and in-place
    ops allocate nothing.  What an op allocates while a ``FakeTensorMode``
    runs it is not counted: DTensor's sharding propagation runs each op
    there on global-size fake arguments to learn its output's shape, and
    those tensors hold no memory on any card."""

    def __init__(self):
        super().__init__()
        self.live = {}
        self.cur = self.peak = 0

    def _free(self, key):
        self.cur -= self.live.pop(key, 0)

    def _add(self, t, owned: bool):
        key, nbytes, st = _storage_bytes(t)
        if key in self.live:
            return
        self.live[key] = nbytes
        self.cur += nbytes
        self.peak = max(self.peak, self.cur)
        if owned:
            weakref.finalize(st, self._free, key)

    def start(self, tensors):
        """Count the storages of ``tensors`` (a DTensor's local one)."""
        from repro_torch.launch.layout import is_dtensor
        for t in tensors:
            self._add(t.to_local() if is_dtensor(t) else t, owned=False)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from repro_torch.launch.collectives import _is_subclass_call
        if _is_subclass_call(types):
            # a DTensor call: counted as the local ops it lowers to
            return NotImplemented
        out = func(*args, **(kwargs or {}))
        if torch._C._get_dispatch_mode(_FAKE) is not None:
            return out
        for t in (out if isinstance(out, (tuple, list)) else (out,)):
            if isinstance(t, torch.Tensor):
                self._add(t, owned=True)
        return out


def _tensors(tree):
    from repro_torch.tree import tree_leaves
    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


def _local(t):
    from repro_torch.launch.layout import is_dtensor
    return t.to_local() if is_dtensor(t) else t


def measure(fn, args, train: bool = False, mesh=None) -> dict:
    """Run ``fn(*args)`` once on meta tensors: parameter bytes (of
    ``args[0]``), input bytes, peak live bytes and counted FLOPs, all of
    this rank's local tensors; with a ``mesh``, the collectives too."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.launch.collectives import CollectiveCount
    from repro_torch.launch.mesh import group_link
    inputs = _tensors(args)
    mem = PeakBytes()
    mem.start(inputs)
    grad = torch.enable_grad() if train else torch.no_grad()
    coll = CollectiveCount(mesh, group_link) if mesh is not None \
        else contextlib.nullcontext()
    with grad, FlopCounterMode(display=False) as fc, mem, coll:
        fn(*args)
    out = {"param_bytes": float(sum(_local(t).nbytes
                                    for t in _tensors(args[0]))),
           "input_bytes": float(sum(_local(t).nbytes for t in inputs)),
           "peak_live_bytes": float(mem.peak),
           "counted_flops": float(fc.get_total_flops())}
    if mesh is not None:
        out["collectives"] = coll.summary()
    return out


@contextlib.contextmanager
def fake_world(world: int):
    """A fake process group of ``world`` ranks with this process as rank 0:
    collectives return at once and move nothing."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()


def collective_seconds(coll: dict) -> float:
    """Σ over links of (per-device bytes on the link / its rate each way)."""
    from repro_torch.launch.mesh import INFINIBAND, NVLINK
    rate = {NVLINK[0]: NVLINK[1], INFINIBAND[0]: INFINIBAND[1]}
    return sum(b / rate[link] for link, b in coll["by_link"].items())


def run_one(arch: str, shape: str, mesh: str = "card") -> dict:
    from repro_torch.launch.costs import step_cost
    from repro_torch.launch.shapes import SHAPES, build, skip_reason

    if mesh not in MESHES:
        raise ValueError(f"mesh must be one of {MESHES}, got {mesh!r}")
    rec = {"arch": arch, "shape": shape, "mesh": mesh, "device": "meta",
           "status": "ok", "time_s": 0.0}
    reason = skip_reason(arch, shape)
    if reason:
        rec["status"] = "skipped"
        rec["reason"] = reason
        return rec

    t0 = time.time()
    spec = SHAPES[shape]
    train = spec.kind == "train"
    if mesh == "card":
        n_chips = 1
        cfg, fn, args, _ = build(arch, shape)
        rec.update(measure(fn, args, train=train))
    else:
        from repro_torch.launch import sharding as shd
        from repro_torch.launch.mesh import (AXIS_LINKS, PRODUCTION_SHAPES,
                                             make_production_mesh)
        multi = mesh == "multi-pod"
        dims, names = PRODUCTION_SHAPES[multi]
        n_chips = 1
        for n in dims:
            n_chips *= n
        with fake_world(n_chips):
            m = make_production_mesh(multi_pod=multi)
            cfg, fn, args, wmode = build(arch, shape, mesh=m)
            rec["weight_mode"] = wmode
            rec["mesh_shape"] = dict(zip(names, dims))
            rec["links"] = {a: {"link": AXIS_LINKS[a][0],
                                "bytes_s": AXIS_LINKS[a][1],
                                "source": AXIS_LINKS[a][2]} for a in names}
            with shd.rules(m, shd.logical_map_for(cfg, shape, m), wmode):
                rec.update(measure(fn, args, train=train, mesh=m))
            if cfg.moe is not None and shd.expert_parallel(cfg):
                rec["ep_exchange"] = ("the ladder's top rung C: on meta the "
                                      "global max demand is not read")
        rec["counted_flops_note"] = ("rank 0's share: local shapes in the "
                                     "local_kernel regions")
    rec["run_s"] = round(time.time() - t0, 1)

    sc = step_cost(cfg, spec.kind, spec.seq, spec.batch)
    mf = model_flops(cfg, spec)
    rec["roofline"] = {
        "n_chips": n_chips,
        "peaks": {"flops": PEAK_FLOPS, "hbm_bytes_s": HBM_BW,
                  "source": PEAK_SOURCE},
        "flops_global": sc.flops,
        "hbm_bytes_global": sc.hbm_bytes,
        "compute_s": sc.flops / (n_chips * PEAK_FLOPS),
        "memory_s": sc.hbm_bytes / (n_chips * HBM_BW),
        "model_flops": mf,
        "useful_flops_ratio": mf / sc.flops if sc.flops else 0.0,
        "kv_bytes": sc.kv_bytes,
        "param_bytes": sc.param_bytes,
    }
    terms = rec["roofline"]
    keys = ("compute_s", "memory_s")
    if "collectives" in rec:
        coll = rec["collectives"]
        terms["collective_bytes_global"] = coll["total"] * n_chips
        terms["collective_s"] = collective_seconds(coll)
        keys += ("collective_s",)
    terms["dominant"] = max(keys, key=lambda k: terms[k])
    rec["time_s"] = round(time.time() - t0, 1)
    return rec


def report_path(arch: str, shape: str, mesh: str = "card") -> str:
    os.makedirs(REPORT_DIR, exist_ok=True)
    return os.path.join(REPORT_DIR, f"{arch}__{shape}__{mesh}.json")


def run_and_write(arch: str, shape: str, mesh: str = "card") -> dict:
    try:
        rec = run_one(arch, shape, mesh)
    except Exception:                   # noqa: BLE001 — recorded, reported
        rec = {"arch": arch, "shape": shape, "mesh": mesh, "device": "meta",
               "status": "error", "error": traceback.format_exc()}
    with open(report_path(arch, shape, mesh), "w") as f:
        json.dump(rec, f, indent=2)
    gc.collect()
    return rec


def summary(rec: dict) -> str:
    head = f"{rec['arch']} {rec['shape']} {rec.get('mesh', 'card')}"
    if rec["status"] == "skipped":
        return f"{head}: SKIPPED — {rec['reason']}"
    if rec["status"] != "ok":
        return f"{head}: ERROR\n{rec['error']}"
    r = rec["roofline"]
    line = (f"{head}: OK ({rec['run_s']}s on meta) "
            f"params={rec['param_bytes'] / 1e9:.2f}GB "
            f"peak={rec['peak_live_bytes'] / 1e9:.2f}GB "
            f"flops={r['flops_global']:.3e} (counted "
            f"{rec['counted_flops']:.3e}) compute={r['compute_s'] * 1e3:.3f}ms "
            f"memory={r['memory_s'] * 1e3:.3f}ms")
    if "collective_s" in r:
        by_axis = " ".join(f"{a}={b / 1e9:.3f}GB" for a, b in sorted(
            rec["collectives"]["by_axis"].items()))
        line += (f" collective={r['collective_s'] * 1e3:.3f}ms "
                 f"wmode={rec['weight_mode']} [{by_axis}]")
    return line + f" dominant={r['dominant']}"


def _combo(arch: str, shape: str, mesh: str, force: bool):
    """Run one combination in a process of its own; -> (status, line)."""
    path = report_path(arch, shape, mesh)
    if os.path.exists(path) and not force:
        with open(path) as f:
            st = json.load(f).get("status")
        if st in ("ok", "skipped"):
            return st, f"cached   {arch} {shape} {mesh} [{st}]"
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
           arch, "--shape", shape, "--mesh", mesh]
    try:
        r = subprocess.run(cmd, capture_output=True, text=True,
                           timeout=COMBO_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        return "error", (f"{arch} {shape} {mesh}: TIMEOUT after "
                         f"{COMBO_TIMEOUT_S} s")
    out = r.stdout.strip()[-3000:]
    if r.returncode != 0:
        return "error", out + "\n" + r.stderr[-2000:]
    return "ok", out


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="meta-device shape dry run of every arch x shape step")
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--mesh", default="card", choices=MESHES)
    ap.add_argument("--all", action="store_true",
                    help="every arch x shape at --mesh, each in a process "
                    "of its own")
    ap.add_argument("--force", action="store_true",
                    help="with --all: rerun combinations already recorded")
    args = ap.parse_args(argv)

    if args.all:
        from repro_torch.configs import ARCHS
        from repro_torch.launch.shapes import SHAPES
        failures = []
        for arch in ARCHS:
            for shape in SHAPES:
                st, line = _combo(arch, shape, args.mesh, args.force)
                print(line, flush=True)
                if st == "error":
                    failures.append((arch, shape))
        print(f"done; failures={len(failures)} {failures}")
        return 1 if failures else 0

    if not (args.arch and args.shape):
        ap.error("give --arch and --shape, or --all")
    rec = run_and_write(args.arch, args.shape, args.mesh)
    print(summary(rec))
    return 1 if rec["status"] == "error" else 0


if __name__ == "__main__":
    sys.exit(main())
