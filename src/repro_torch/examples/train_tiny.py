"""Train a ~100M-parameter MoE for a few hundred steps on the synthetic
Markov corpus, or the 4-layer smoke Mixtral with ``--tiny`` (port of
``examples/train_tiny.py``).

  PYTHONPATH=src python -m repro_torch.examples.train_tiny --tiny
  PYTHONPATH=src python -m repro_torch.examples.train_tiny   # ~100M

Runs on the card unless ``--device cpu``; the CUDA kernels take bfloat16,
so ``--dtype`` defaults to it.  ``--ckpt DIR`` saves the final params and
optimizer state there (the reference writes a checkpoint by default; the
port only when asked).  Exits non-zero unless the cross-entropy falls.
"""
from __future__ import annotations

import argparse
import dataclasses


def build_cfg(tiny: bool):
    from repro_torch.configs import get_config, make_smoke
    base = make_smoke(get_config("mixtral-8x7b"))
    if tiny:
        return base.replace(n_layers=4)
    # ~100M params: 8 layers, d=512, 8 experts of d_ff=1024, 16k vocab
    return base.replace(
        n_layers=8, d_model=512, d_ff=1024, vocab=16384,
        moe=dataclasses.replace(base.moe, n_routed=8, top_k=2,
                                d_expert=1024, capacity_factor=1.5))


def main(argv=None):
    from repro_torch.launch.sharding import estimate_params
    from repro_torch.launch.train import train_loop

    ap = argparse.ArgumentParser()
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--steps", type=int, default=None)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--dtype", default="bfloat16",
                    choices=["bfloat16", "float32"])
    args = ap.parse_args(argv)
    cfg = build_cfg(args.tiny).replace(dtype=args.dtype,
                                       param_dtype=args.dtype)
    n = estimate_params(cfg)
    steps = args.steps or (60 if args.tiny else 300)
    print(f"{cfg.name}: ~{n / 1e6:.1f}M params, {steps} steps")
    _, _, hist = train_loop(cfg, steps=steps, batch=8,
                            seq=64 if args.tiny else 128,
                            ckpt_dir=args.ckpt, device=args.device)
    print(f"ce {hist[0]:.3f} -> {hist[-1]:.3f}"
          + (f" (ckpt in {args.ckpt})" if args.ckpt else ""))
    if not hist[-1] < hist[0]:
        raise SystemExit("training did not reduce loss")
    return hist


if __name__ == "__main__":
    main()
