#!/usr/bin/env python3
"""The program's spans on the card, read against the benchmark's device
trace: where the decode cells' idle time lies, what recording costs and
whether it adds a host sync.

  python3 chip_spans.py --mode syncs|cost|site [--cells a,b]
      [--seeds n,m] [--seconds S] [--first on|off] [--out DIR]

Each run is one traced run of a cell through ``dali_bench``'s harness
(its ``--trace 1`` path, unchanged), with the program's span recorder
(``repro_torch.spans``) on or off for the window.  With it on, the
program's spans join the harness's own in labelling the idle gaps, by
``label_gaps`` below: the labels ``dali_bench/trace.py::reduce`` gives,
found exactly where it looks back only 256 spans (a DeepSeek step holds
some 400 of the program's).  Each run also gives the readings the
benchmark cannot take while its harness does not turn the recorder on,
by the span kinds below:

  idle_sync_share    idle seconds whose innermost open span is a sync
                     span, over the traced window, in %;
  idle_launch_share  the same under a launch or host span;
  policy_ms          seconds of ``policy.observe`` and ``policy.step`` per
                     decode step, in ms;
  admission_idle_s   idle seconds that begin inside ``scheduler.admit``.

``--mode syncs``: for each cell, a run with the recorder on and one with
it off, ``server.run()`` under ``torch.cuda.set_sync_debug_mode("warn")``:
the synchronising calls per decode step by the line that made them,
beside the program's ``host_syncs``.  ``--mode cost``: for each cell and
seed, a run with the recorder on and one with it off (``step_ms.decode``
of both), the readings and the idle seconds by span name.  ``--mode
site``: the host nanoseconds of one span site, the recorder on and off.

Each run's result goes to ``<DIR>/spans_<mode>.jsonl`` as a line
(``--out``, by default ``build/spans`` in the checkout).
"""
import argparse
import bisect
import collections
import heapq
import json
import os
import sys
import time
import warnings

ROOT = os.path.dirname(os.path.abspath(__file__))
CELLS = "mixtral.off25.decode,deepseek.off25.decode"

# the program's spans by kind: the host waits on the card (SYNC), issues
# its work (LAUNCH) or works alone (HOST); a parent's kind is that of the
# work it does between its children
SYNC = ("scheduler.prompt_upload", "scheduler.slot_write",
        "scheduler.first_token", "scheduler.token_sync", "store.read_misses",
        "moe.miss_upload", "policy.next_target", "policy.telemetry_flush")
LAUNCH = ("model.prefill", "model.decode", "model.embed", "model.layer",
          "model.attn", "model.moe", "model.mlp", "model.head",
          "model.sample", "moe.route", "moe.dispatch", "moe.k2",
          "moe.k2_pool", "moe.k2_miss", "moe.combine",
          "scheduler.admit_copy", "store.pre_step", "store.post_dispatch",
          "store.prefill_barrier", "store.build_view", "store.fetch_weights",
          "store.prefill_fetch", "store.host_ffn", "store.little_weights",
          "store.prefill_little", "store.prefill_host", "policy.observe",
          "policy.step", "policy.prefetch", "policy.assign", "policy.cache")
HOST = ("scheduler.admit", "scheduler.decode_step", "scheduler.retire",
        "model.slice")
POLICY = ("policy.observe", "policy.step")
OUTSIDE = "host, outside every span"


def idle_gaps(events, t0_ns: int, t1_ns: int):
    """The window's idle gaps [(start, end)] in order, between the union
    of the card's operations, as ``dali_bench/trace.py::reduce`` finds
    them."""
    dev = []
    for e in events:
        if e.is_user_annotation() or not str(e.device_type()).endswith(
                "CUDA"):
            continue
        a = max(e.start_ns(), t0_ns)
        b = min(e.start_ns() + e.duration_ns(), t1_ns)
        if b > a:
            dev.append((a, b))
    gaps, at = [], t0_ns
    for a, b in sorted(dev):
        if a > at:
            gaps.append((at, a))
        at = max(at, b)
    if t1_ns > at:
        gaps.append((at, t1_ns))
    return gaps


def label_gaps(gaps, spans) -> dict:
    """Idle ns by the innermost span open at each gap's start: the latest
    starting among those that began at or before it and end after it
    (``spans`` [(start, end, name)]).  The gaps come in order, so the spans
    begun so far sit on a heap by their order, latest on top, and one that
    has ended leaves once it reaches the top (it has ended for every later
    gap too)."""
    spans = sorted(spans)
    idle, heap, j = {}, [], 0
    for a, b in gaps:
        while j < len(spans) and spans[j][0] <= a:
            heapq.heappush(heap, -j)
            j += 1
        while heap and spans[-heap[0]][1] <= a:
            heapq.heappop(heap)
        label = spans[-heap[0]][2] if heap else OUTSIDE
        idle[label] = idle.get(label, 0) + (b - a)
    return idle


def admission_idle_ns(gaps, records) -> int:
    """Idle ns of the gaps that begin inside a ``scheduler.admit`` span."""
    adm = sorted((r[0], r[1]) for r in records if r[2] == "scheduler.admit")
    starts = [a for a, _ in adm]
    total = 0
    for a, b in gaps:
        i = bisect.bisect_right(starts, a) - 1
        if i >= 0 and adm[i][1] > a:
            total += b - a
    return total


def readings(idle_s: dict, window_s: float, records, steps: int) -> dict:
    """The recorder's readings of one traced window (module docstring)."""
    share = lambda names: 100.0 * sum(idle_s.get(n, 0.0)
                                      for n in names) / window_s
    return {"idle_sync_share": share(SYNC),
            "idle_launch_share": share(LAUNCH + HOST),
            "policy_ms": sum(r[1] - r[0] for r in records
                             if r[2] in POLICY) / 1e6 / max(steps, 1),
            "spans_per_step": len(records) / max(steps, 1)}


def _run(harness, bench, cell, seed, seconds, recorder: bool, syncs: bool):
    import torch

    from dali_bench import trace as trace_mod
    from repro_torch import spans
    found = harness.find_cell(bench, cell)
    got = {"records": []}

    def patch(objects):
        server, store = objects["server"], objects["store"]
        real = server.run

        def run():
            with warnings.catch_warnings(record=True) as caught:
                if syncs:
                    warnings.simplefilter("always")
                    torch.cuda.set_sync_debug_mode("warn")
                if recorder:
                    spans.start()
                try:
                    return real()
                finally:
                    if recorder:
                        got["records"] = spans.stop()
                    torch.cuda.set_sync_debug_mode(0)
                    c = collections.Counter(
                        f"{os.path.relpath(w.filename, ROOT)}:{w.lineno}"
                        for w in caught if "synchroniz" in str(w.message))
                    got.update(steps=server.metrics.steps,
                               host_syncs=server.metrics.host_syncs
                               + store.stats()["host_syncs"],
                               sites=dict(c.most_common()),
                               sync_calls=sum(c.values()))
        server.run = run

    real_reduce = trace_mod.reduce

    def reduce(events, span_list, t0_ns, t1_ns):
        gaps = idle_gaps(events, t0_ns, t1_ns)
        idle = label_gaps(gaps, list(span_list)
                          + [r[:3] for r in got["records"]])
        got["idle_s"] = {k: v / 1e9 for k, v in idle.items()}
        got["admission_idle_s"] = admission_idle_ns(
            gaps, got["records"]) / 1e9
        return real_reduce(events, span_list, t0_ns, t1_ns)

    trace_mod.reduce = reduce
    try:
        out = harness.run_cell(found, bench, seed, seconds, True,
                               device="cuda", log=lambda s: None,
                               patch=patch)
    finally:
        trace_mod.reduce = real_reduce
    line = {"cell": cell, "seed": seed, "recorder": recorder,
            "correct": out["correct"],
            "metrics": {k: v["value"] for k, v in out["metrics"].items()},
            "device": out["device"]}
    line.update((k, got[k]) for k in ("steps", "host_syncs", "idle_s",
                                      "admission_idle_s"))
    if syncs:
        line.update(sync_calls=got["sync_calls"], sites=got["sites"])
    if recorder:
        line["readings"] = readings(got["idle_s"],
                                    out["device"]["window_s"],
                                    got["records"], got["steps"])
    return line


def _site_ns(on: bool, n: int = 1_000_000) -> float:
    from repro_torch import spans
    if on:
        spans.start()
    t = time.perf_counter_ns()
    for i in range(n):
        with spans.span("model.layer", layer=i, phase="decode"):
            pass
    dt = time.perf_counter_ns() - t
    spans.stop()
    return dt / n


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--mode", choices=("syncs", "cost", "site"),
                    required=True)
    ap.add_argument("--cells", default=CELLS)
    ap.add_argument("--seeds", default="2147483999")
    ap.add_argument("--seconds", type=float, default=45)
    ap.add_argument("--out", default=os.path.join(ROOT, "build", "spans"),
                    help="directory of the result lines")
    ap.add_argument("--first", choices=("on", "off"), default="on",
                    help="which of the two runs of a seed comes first")
    args = ap.parse_args(argv)
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = os.path.join(ROOT, "build", "bench_cache", sub)
    sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]
    os.makedirs(args.out, exist_ok=True)
    path = os.path.join(args.out, f"spans_{args.mode}.jsonl")
    if args.mode == "site":
        line = {f"ns_{k}": min(_site_ns(k == "on") for _ in range(3))
                for k in ("off", "on")}
        print("ns a span site:", json.dumps(line), flush=True)
        with open(path, "a") as f:
            f.write(json.dumps(line) + "\n")
        return 0
    from dali_bench import harness
    bench = harness.load_json(os.path.join(ROOT, "BENCHMARK.json"))
    order = (True, False) if args.first == "on" else (False, True)
    for cell in args.cells.split(","):
        for seed in map(int, args.seeds.split(",")):
            for on in order:
                line = _run(harness, bench, cell, seed, args.seconds, on,
                            args.mode == "syncs")
                with open(path, "a") as f:
                    f.write(json.dumps(line) + "\n")
                brief = {k: round(v, 4) for k, v in
                         {**line["metrics"], **line.get("readings", {}),
                          "admission_idle_s": line["admission_idle_s"]}
                         .items()}
                print(cell, seed, "recorder", "on " if on else "off",
                      "correct", line["correct"], json.dumps(brief),
                      flush=True)
                if "sites" in line:
                    n = max(line["steps"], 1)
                    print(f"  sync-debug calls {line['sync_calls']} over "
                          f"{line['steps']} steps "
                          f"({line['sync_calls'] / n:.3f} a step); "
                          f"host_syncs {line['host_syncs']} "
                          f"({line['host_syncs'] / n:.3f}); by site:",
                          json.dumps(line["sites"]), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
