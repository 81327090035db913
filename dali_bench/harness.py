"""One run of one cell: set-up, the measured window, the metrics and the
comparison that decides ``correct``.

Everything a cell is made of is found by name:

  ``BENCHMARK.json``                 the cell (``workloads``), its
                                     configuration and its metrics
  ``dali_bench/configs/<c>.json``    the configuration's sizes
  ``dali_bench/cells/<w>.json``      the deployment: offload mode, miss
                                     tier, cache ratio, slots, policy; the
                                     offered load (``requests_per_s``);
                                     the comparison's sample and limit
  ``dali_bench/traffic/<t>.json``    the traffic mix (``traffic.py``)
  ``dali_bench/metrics/<m>.py``      one reader per metric: ``read(ctx)``
                                     returns a number, or None where the run
                                     has nothing for it to read; a metric
                                     ``<q>.<part>`` with no file of its own
                                     is read by ``<q>.py``
  ``dali_bench/reference/<model_type>.py``  the plain reference

The window drives the port's own entry: ``ServeSpec(...).resolve(params)
.server(res_vecs).run()`` (``ContinuousBatchServer``), with every request
submitted before it opens.  It opens when ``run()`` is called and closes
at the last request's completion.  Set-up is everything before: loading
the port's kernel library (a first run in a checkout builds it there, and
the run logs those seconds on a line of their own), drawing the weights (the routed experts of an offloaded cell into page-locked host
memory), building the store, calibrating the residual vectors as the
port's launcher does, drawing the traffic and serving a warm-up that takes
each prompt bucket the traffic uses once.
"""
from __future__ import annotations

import contextlib
import gc
import importlib.util
import json
import sys
import time
from pathlib import Path

import numpy as np

from dali_bench import check, traffic as traffic_mod
from dali_bench.capture import LogitKeeper, TimedList
from dali_bench.reference import for_config
from dali_bench.weights import served_dtype

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")   # top-level module names


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def find_cell(bench: dict, workload: str, root: Path = ROOT) -> dict:
    """The cell's entries and files, under the checkout ``root``:
    {workload, config (the file's dict), cell, traffic, metrics (the
    readers' directory)}."""
    w = {c["name"]: c for c in bench["workloads"]}.get(workload)
    if w is None:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")
    entry = {c["name"]: c for c in bench["configs"]}[w["config"]]
    here = Path(root) / HERE.name
    return {"workload": w, "config": load_json(Path(root) / entry["file"]),
            "cell": load_json(here / "cells" / f"{workload}.json"),
            "traffic": load_json(here / "traffic" / f"{w['traffic']}.json"),
            "metrics": here / "metrics"}


def metrics_of(bench: dict, workload: str, trace: bool) -> list:
    """The metric entries a run of ``workload`` reports: the end-to-end
    ones without ``--trace``, the per-layer ones with it."""
    key = "per_layer" if trace else "end_to_end"
    return [m for m in bench[key]
            if workload in m.get("workloads", [workload])]


def reader(name: str, directory: Path = HERE / "metrics"):
    """``<directory>/<name>.py``'s ``read``, or where there is no such file
    that of the quantity's reader, ``<name up to its first dot>.py``."""
    path = Path(directory) / f"{name}.py"
    if not path.exists():
        path = Path(directory) / f"{name.split('.')[0]}.py"
    spec = importlib.util.spec_from_file_location(
        "dali_bench_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def _sync(torch, dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def warmup_requests(reqs, min_bucket: int = 16):
    """One request per prompt bucket the traffic uses (the server pads a
    prompt to the next power of two from ``min_bucket``), each with a few
    output tokens: every prefill shape, and the decode step, whose shape is
    the whole slot table's whatever the slots hold."""
    def bucket(n):
        b = min_bucket
        while b < n:
            b *= 2
        return b
    seen, out = set(), []
    for p, o in reqs:
        if bucket(len(p)) not in seen:
            seen.add(bucket(len(p)))
            out.append((p, min(o, 4)))
    return out


def run_cell(found: dict, bench: dict, seed: int, seconds: float,
             trace: bool, device="cuda", t_start=None, log=print,
             patch=None, control: bool = False,
             errors: bool = False) -> dict:
    """One run; returns the result line's dict (``checks`` last).
    ``patch(objects)``, for tests, may replace parts of the timed path
    (``objects``: the server, its store and the requests it will serve)
    before the window opens.
    ``control`` also reads the float8 control's numbers on the same
    sample, and ``errors`` returns every sampled token's errors under
    ``errors`` (``control.py``; the benchmark's runs do neither)."""
    import torch

    from repro_torch.core.residual import calibrate_residuals
    from repro_torch.core.tracing import capture_decode_trace
    from repro_torch.serving.scheduler import Request
    from repro_torch.serving.spec import OffloadSpec, ServeSpec
    from repro_torch.serving.steps import default_dali_config

    from dali_bench import port, trace as trace_mod

    t_start = time.perf_counter() if t_start is None else t_start
    dev = torch.device(device)
    cfg, cell, traffic = found["config"], found["cell"], found["traffic"]
    workload = found["workload"]["name"]
    ref = for_config(cfg)
    spec = ref.dims(cfg)
    wdtype = served_dtype(cfg)
    pcfg = port.port_config(spec, cfg["name"], cfg["torch_dtype"])
    offload = cell["offload"]

    # -- set-up --------------------------------------------------------------
    marks = [("start", time.perf_counter())]
    if dev.type == "cuda":
        from repro_torch.kernels import build
        build.library()
        if build.BUILD_INFO.get("seconds"):
            log(f"kernel library built in {build.BUILD_INFO['seconds']:.3f} s"
                " (a first run in this checkout; part of its set-up)")
        marks.append(("kernels", time.perf_counter()))
    params = port.port_params(spec, seed, dev, wdtype,
                              experts_on_host=offload != "modeled")
    _sync(torch, dev)
    marks.append(("weights", time.perf_counter()))
    reqs = traffic_mod.requests(
        traffic, spec["vocab"], seed,
        traffic_mod.n_requests(cell["requests_per_s"], seconds))
    max_len = max(len(p) + o for p, o in reqs) + 2
    dali_cfg = default_dali_config(pcfg, cache_ratio=cell["cache_ratio"])
    rs = ServeSpec(cfg=pcfg, server="continuous", policy=cell["policy"],
                   dali_cfg=dali_cfg, batch_size=cell["slots"],
                   max_len=max_len, eos_id=-1,
                   offload=OffloadSpec(mode=offload,
                                       fallback=cell["fallback"]),
                   device=dev).resolve(params)
    del params
    marks.append(("store", time.perf_counter()))
    res_vecs = None
    if dali_cfg is not None:
        calib = traffic_mod.calibration_prompts(spec["vocab"], seed)
        off = rs.init_state()["offload"] if rs.store is not None else None
        tr = capture_decode_trace(rs.params, pcfg, calib, n_decode=8,
                                  device=dev, store=rs.store, off=off)
        res_vecs = np.stack(calibrate_residuals([tr]))
        del off, tr
    marks.append(("calibration", time.perf_counter()))
    warm = rs.server(res_vecs=res_vecs)
    for i, (p, o) in enumerate(warmup_requests(reqs)):
        warm.submit(Request(rid=i, prompt=p, max_new_tokens=o))
    warm.run()
    del warm
    if rs.store is not None:
        rs.store.reset_stats()
    _sync(torch, dev)
    marks.append(("warm-up", time.perf_counter()))
    log("set-up: " + ", ".join(
        f"{b[0]} {b[1] - a[1]:.3f} s" for a, b in zip(marks, marks[1:]))
        + f" (process start to set-up {marks[0][1] - t_start:.3f} s)")
    launches0 = _launches()
    server = rs.server(res_vecs=res_vecs)
    idx = check.sample([len(p) + o for p, o in reqs], cell["check"]["sample"],
                       seed)
    keeper = LogitKeeper(idx)
    live = [Request(rid=i, prompt=p, max_new_tokens=o,
                    output=TimedList(keeper))
            for i, (p, o) in enumerate(reqs)]
    objects = {"server": server, "store": rs.store, "requests": live}
    if patch is not None:
        patch(objects)
    for r in live:
        server.submit(r)
    _sync(torch, dev)
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)

    # -- the window --------------------------------------------------------
    traced = {"spans": []}
    if trace and dev.type == "cuda":
        trace_mod.wrap_spans(objects, traced["spans"])
        ctx_mgr = trace_mod.profiled(traced)
    else:
        ctx_mgr = contextlib.nullcontext()
    with ctx_mgr, keeper.installed(server):
        traced["t0_ns"] = time.time_ns()
        t0 = time.perf_counter()
        done = server.run()
        _sync(torch, dev)
        traced["t1_ns"] = time.time_ns()
        t_closed = time.perf_counter()
    setup_s = t0 - t_start
    t_end = max((r.done_at for r in done), default=t_closed)
    window_s = t_end - t0
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else 0)
    serve = server.metrics
    store_stats = rs.store.stats() if rs.store is not None else None
    store_bytes = rs.store.expert_bytes if rs.store is not None else None
    launches = {k: v - launches0.get(k, 0) for k, v in _launches().items()}

    log(f"drain: {drain_s(done, cell['slots'], t_end):.4f} s of the window "
        "(from the first completion that leaves a slot with no request "
        "waiting)")
    log(f"served {len(done)} of {len(live)} requests in {window_s:.4f} s: "
        f"{sum(len(r.prompt) for r in done)} prompt tokens, "
        f"{sum(len(r.output) for r in done)} output tokens, "
        f"{serve.steps} decode steps, prefill_s {serve.prefill_s:.4f}, "
        f"decode_s {serve.decode_s:.4f}, set-up {setup_s:.4f} s")
    log(f"kernel launches in the window: {json.dumps(launches)}")
    if store_stats is not None:
        log(f"store: {json.dumps(store_stats)} expert_bytes {store_bytes}")
    if traced.get("busy_s") is not None:
        log(f"trace: busy {traced['busy_s']:.4f} s of {traced['window_s']:.4f}"
            f" s; device s by group {json.dumps(traced['groups_s'])}")

    # -- the comparison, once the program's state is freed ---------------------
    by_rid = {r.rid: r for r in done}
    outputs = [None if r.rid not in by_rid else
               {"prompt": list(map(int, r.prompt)), "served": list(r.output),
                "logits": (keeper.logits_of(r.rid, r.output)
                           if r.rid in keeper.rids else None)}
               for r in live]
    del server, rs, objects
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    failed = sum(1 for r in live if r.rid not in by_rid
                 or len(r.output) != r.max_new_tokens)
    t_ref = time.perf_counter()
    checks = check.compare(ref, spec, seed, outputs, idx, cell["check"], dev,
                           wdtype, control=control)
    del keeper, outputs
    log(f"reference over {checks['sample']} requests ({checks['tokens']} "
        f"served tokens) in {time.perf_counter() - t_ref:.4f} s: "
        f"{json.dumps(checks['info'])}")
    if control:
        log(f"control (float8 e4m3 reference): "
            f"{json.dumps(checks['control'])}")

    ctx = {"spec": spec, "config": cfg, "cell": cell, "traffic": traffic,
           "requests": done, "window_s": window_s, "setup_s": setup_s,
           "serve": serve, "store": store_stats,
           "expert_bytes": store_bytes, "launches": launches,
           "trace": traced if "busy_s" in traced else None,
           "elem_bytes": torch.empty((), dtype=wdtype).element_size()}
    metrics = {}
    for m in metrics_of(bench, workload, trace):
        v = reader(m["name"], found.get("metrics", HERE / "metrics"))(ctx)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    device_info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                   "kind": (torch.cuda.get_device_name(dev)
                            if dev.type == "cuda" else "cpu"),
                   "count": 1, "memory_peak_bytes": int(peak)}
    if ctx["trace"] is not None:
        device_info.update(busy_s=traced["busy_s"],
                           window_s=traced["window_s"])
    out = {"correct": checks["correct"] and failed == 0,
           "attempted": len(live), "failed": failed, "metrics": metrics,
           "device": device_info}
    if ctx["trace"] is not None:
        out["breakdown"] = traced["breakdown"]
    if errors:
        out["errors"] = checks["errors"]
    out["checks"] = checks["numbers"]
    return out


def drain_s(done, slots: int, t_end: float) -> float:
    """The closed loop's drain: from the completion that first leaves a
    slot with no request waiting (every request is queued when the window
    opens, so it is the (n - slots + 1)-th) to the window's close."""
    ends = sorted(r.done_at for r in done)
    return t_end - ends[max(0, len(ends) - slots)] if ends else 0.0


def _launches() -> dict:
    from repro_torch import kernels
    return dict(kernels.LAUNCHES)
