"""Run one cell of ``BENCHMARK.json`` once, on the CUDA card of this
machine, and print its result as the last line of standard output:

  python3 dali_bench/run.py --workload <name> --seed <n> --seconds <s> \\
      --trace <0|1>

``--trace 0`` reports the cell's end-to-end metrics, ``--trace 1`` its
per-layer metrics from a profiled window.  Both compare what the window
served with the plain reference and print each number compared beside
its limit, as the last lines of standard error and under ``checks`` in the
result.  The run fails (no result, exit code not 0) without a CUDA card,
with fewer cards than the cell asks for, or if ``jax``, ``jaxlib``,
``flax`` or the JAX package ``repro`` is loaded once the window has
closed.  Kernel builds and caches stay inside the checkout.
"""
from __future__ import annotations

import os
import sys
import time


def _process_start() -> float:
    """This process's start on ``time.perf_counter``'s clock (from
    /proc; where that is unreadable, now)."""
    now = time.perf_counter()
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        age = uptime - start_ticks / os.sysconf("SC_CLK_TCK")
        return now - max(0.0, age)
    except (OSError, ValueError, IndexError):
        return now


T_START = _process_start()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    import argparse
    import json

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    # every cache the program or torch keeps stays in the checkout
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = os.path.join(ROOT, "build", "bench_cache", sub)
    os.environ["USE_FLAX"] = "0"
    sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]

    import torch

    from dali_bench import harness

    if not torch.cuda.is_available():
        print("no CUDA card: this benchmark measures the port on the card "
              "and has no CPU fallback", file=sys.stderr)
        return 2
    bench = harness.load_json(os.path.join(ROOT, "BENCHMARK.json"))
    found = harness.find_cell(bench, args.workload)
    chips = found["workload"]["chips"]
    if torch.cuda.device_count() < chips:
        print(f"the cell asks for {chips} cards; this machine has "
              f"{torch.cuda.device_count()}", file=sys.stderr)
        return 2
    out = harness.run_cell(found, bench, args.seed, args.seconds,
                           bool(args.trace), device="cuda", t_start=T_START,
                           log=lambda s: print(s, flush=True))
    # read after the run, so that its seconds stay out of the set-up
    import subprocess
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=False).stdout.strip()
    print(f"card: {torch.cuda.get_device_name(0)} | nvidia-smi: {smi} | "
          f"torch {torch.__version__} cuda {torch.version.cuda}", flush=True)
    bad = harness.forbidden_modules()
    if bad:
        print(f"the process loaded {', '.join(bad)} (JAX or the JAX "
              "package): no result", file=sys.stderr)
        return 3
    for name, c in out["checks"].items():
        print(f"{name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
