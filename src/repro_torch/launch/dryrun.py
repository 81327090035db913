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
* the roofline terms of one card at the H100 80GB HBM3 SXM data sheet's
  peaks (989 TFLOP/s dense bf16, 3.35 TB/s): predictions, not readings.
  There is no collective term until expert parallelism is ported.

Usage::

  python -m repro_torch.launch.dryrun --arch mixtral-8x7b --shape decode_32k
  python -m repro_torch.launch.dryrun --all [--force]

Results accumulate in ``reports/dryrun_torch/<arch>__<shape>.json``
(ignored by git), beside the reference's ``reports/dryrun/``.
"""
from __future__ import annotations

import argparse
import gc
import json
import os
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
    ops allocate nothing."""

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
        for t in tensors:
            self._add(t, owned=False)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in (out if isinstance(out, (tuple, list)) else (out,)):
            if isinstance(t, torch.Tensor):
                self._add(t, owned=True)
        return out


def _tensors(tree):
    from repro_torch.tree import tree_leaves
    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


def measure(fn, args, train: bool = False) -> dict:
    """Run ``fn(*args)`` once on meta tensors: parameter bytes (of
    ``args[0]``), input bytes, peak live bytes and counted FLOPs."""
    from torch.utils.flop_counter import FlopCounterMode
    inputs = _tensors(args)
    mem = PeakBytes()
    mem.start(inputs)
    grad = torch.enable_grad() if train else torch.no_grad()
    with grad, FlopCounterMode(display=False) as fc, mem:
        fn(*args)
    return {"param_bytes": float(sum(t.nbytes for t in _tensors(args[0]))),
            "input_bytes": float(sum(t.nbytes for t in inputs)),
            "peak_live_bytes": float(mem.peak),
            "counted_flops": float(fc.get_total_flops())}


def run_one(arch: str, shape: str) -> dict:
    from repro_torch.launch.costs import step_cost
    from repro_torch.launch.shapes import SHAPES, build, skip_reason

    rec = {"arch": arch, "shape": shape, "device": "meta", "status": "ok",
           "time_s": 0.0}
    reason = skip_reason(arch, shape)
    if reason:
        rec["status"] = "skipped"
        rec["reason"] = reason
        return rec

    t0 = time.time()
    spec = SHAPES[shape]
    cfg, fn, args = build(arch, shape)
    rec.update(measure(fn, args, train=spec.kind == "train"))
    rec["run_s"] = round(time.time() - t0, 1)

    sc = step_cost(cfg, spec.kind, spec.seq, spec.batch)
    mf = model_flops(cfg, spec)
    rec["roofline"] = {
        "n_chips": 1,
        "peaks": {"flops": PEAK_FLOPS, "hbm_bytes_s": HBM_BW,
                  "source": PEAK_SOURCE},
        "flops_global": sc.flops,
        "hbm_bytes_global": sc.hbm_bytes,
        "compute_s": sc.flops / PEAK_FLOPS,
        "memory_s": sc.hbm_bytes / HBM_BW,
        "model_flops": mf,
        "useful_flops_ratio": mf / sc.flops if sc.flops else 0.0,
        "kv_bytes": sc.kv_bytes,
        "param_bytes": sc.param_bytes,
    }
    terms = rec["roofline"]
    terms["dominant"] = max(("compute_s", "memory_s"), key=lambda k: terms[k])
    rec["time_s"] = round(time.time() - t0, 1)
    return rec


def report_path(arch: str, shape: str) -> str:
    os.makedirs(REPORT_DIR, exist_ok=True)
    return os.path.join(REPORT_DIR, f"{arch}__{shape}.json")


def run_and_write(arch: str, shape: str) -> dict:
    try:
        rec = run_one(arch, shape)
    except Exception:                   # noqa: BLE001 — recorded, reported
        rec = {"arch": arch, "shape": shape, "device": "meta",
               "status": "error", "error": traceback.format_exc()}
    with open(report_path(arch, shape), "w") as f:
        json.dump(rec, f, indent=2)
    gc.collect()
    return rec


def summary(rec: dict) -> str:
    if rec["status"] == "skipped":
        return f"{rec['arch']} {rec['shape']}: SKIPPED — {rec['reason']}"
    if rec["status"] != "ok":
        return f"{rec['arch']} {rec['shape']}: ERROR\n{rec['error']}"
    r = rec["roofline"]
    return (f"{rec['arch']} {rec['shape']}: OK ({rec['run_s']}s on meta) "
            f"params={rec['param_bytes'] / 1e9:.2f}GB "
            f"peak={rec['peak_live_bytes'] / 1e9:.2f}GB "
            f"flops={r['flops_global']:.3e} (counted "
            f"{rec['counted_flops']:.3e}) compute={r['compute_s'] * 1e3:.3f}ms "
            f"memory={r['memory_s'] * 1e3:.3f}ms dominant={r['dominant']}")


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="meta-device shape dry run of every arch x shape step")
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--force", action="store_true",
                    help="with --all: rerun combinations already recorded")
    args = ap.parse_args(argv)

    if args.all:
        from repro_torch.configs import ARCHS
        from repro_torch.launch.shapes import SHAPES
        failures = []
        for arch in ARCHS:
            for shape in SHAPES:
                path = report_path(arch, shape)
                if os.path.exists(path) and not args.force:
                    with open(path) as f:
                        st = json.load(f).get("status")
                    if st in ("ok", "skipped"):
                        print(f"cached   {arch} {shape} [{st}]")
                        continue
                rec = run_and_write(arch, shape)
                print(summary(rec), flush=True)
                if rec["status"] == "error":
                    failures.append((arch, shape))
        print(f"done; failures={len(failures)} {failures}")
        return 1 if failures else 0

    if not (args.arch and args.shape):
        ap.error("give --arch and --shape, or --all")
    rec = run_and_write(args.arch, args.shape)
    print(summary(rec))
    return 1 if rec["status"] == "error" else 0


if __name__ == "__main__":
    sys.exit(main())
