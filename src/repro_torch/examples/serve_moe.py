"""End-to-end driver (the paper's regime): serve a small MoE with batched
requests, the DALI policy on, telemetry reported (port of
``examples/serve_moe.py``).

  PYTHONPATH=src python -m repro_torch.examples.serve_moe \
      [--arch deepseek-v2-lite-16b] [--device cpu --dtype float32]

A thin wrapper over ``repro_torch.launch.serve`` with the example's
defaults (120 training steps, 16 requests of 24 new tokens); any of the
launcher's flags follows them and wins.  Requests flow through the
continuous-batching server by default; ``--server wave`` takes the wave
scheduler.
"""
from __future__ import annotations

import sys

DEFAULTS = ["--train-steps", "120", "--requests", "16", "--max-new", "24"]


def main(argv=None):
    from repro_torch.launch import serve
    argv = sys.argv[1:] if argv is None else list(argv)
    return serve.main(DEFAULTS + argv)


if __name__ == "__main__":
    main()
