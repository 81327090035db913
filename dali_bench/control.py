"""The readings a cell's limits are set from: for each seed, a run of the
cell (its timed path at its own sizes, over a window of ``--seconds``) and,
on the same sample, the control: the plain reference computed in float8
e4m3, the precision below the configuration's bfloat16.  The benchmark's
own runs do not run it.

  python3 dali_bench/control.py --workload <name> --seeds 11,12,13 \\
      --seconds 10 [--control 3] [--dump errors.jsonl]

One process serves every seed (the page-locked host store is allocated
once, and the allocator hands it out again).  Each seed prints one JSON
line: the program's numbers and, on the first ``--control`` seeds (all by
default), the control's.  ``--dump`` appends each seed's per-token errors,
request by request, to a JSON-lines file.  A limit lies above the
program's largest reading and below the control's smallest
(``PERF.md`` keeps both).
"""
from __future__ import annotations

import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--control", type=int, default=None)
    ap.add_argument("--dump", default=None)
    args = ap.parse_args(argv)
    sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]

    import torch

    from dali_bench import harness
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    bench = harness.load_json(os.path.join(ROOT, "BENCHMARK.json"))
    found = harness.find_cell(bench, args.workload)
    seeds = [int(s) for s in args.seeds.split(",")]
    n_control = len(seeds) if args.control is None else args.control
    for i, seed in enumerate(seeds):
        lines = []
        out = harness.run_cell(found, bench, seed, args.seconds, False,
                               device="cuda", log=lines.append,
                               control=i < n_control,
                               errors=bool(args.dump))
        if args.dump and "errors" in out:
            with open(args.dump, "a") as f:
                f.write(json.dumps({"workload": args.workload, "seed": seed,
                                    "errors": out["errors"]}) + "\n")
        ctl = [ln for ln in lines if ln.startswith(("control", "reference"))]
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "correct": out["correct"],
                          "program": {k: v["value"]
                                      for k, v in out["checks"].items()},
                          "metrics": {k: v["value"] for k, v in
                                      out["metrics"].items()},
                          "lines": ctl}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
