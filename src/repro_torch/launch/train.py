"""Training launcher of the port (port of ``repro/launch/train.py``'s real
run): trains a model on the synthetic ``MarkovCorpus``, as the reference
does before it serves or benchmarks, so that routing has structure
(residual-vector calibration wants a trained model).

  PYTHONPATH=src python -m repro_torch.launch.train --smoke --device cpu \\
      --dtype float32 --steps 200 --batch 8 --seq 128 --ckpt /tmp/run1

It runs on ``cuda`` unless ``--device cpu`` is given; the CUDA kernels take
bfloat16, so ``--dtype`` defaults to it.  On the card the forward runs
K1, K2 and K3 and their backward recomputes through the plain versions
(``repro_torch/kernels``).
"""
from __future__ import annotations

import argparse
import time


def train_loop(cfg, steps: int, batch: int, seq: int, lr: float = 1e-3,
               seed: int = 0, ckpt_dir: str | None = None,
               log_every: int = 20, corpus=None, *, device="cuda",
               params=None):
    """``steps`` AdamW steps on ``batch`` x ``seq`` Markov batches, from
    ``params`` (updated in place) or from ``init_model(cfg, seed)``.
    Returns ``(params, opt_state, history)``, ``history`` the per-step
    cross-entropy.  A VLM or audio arch trains against the reference's
    constant cross source (0.02 everywhere; 16 audio frames, or up to 16
    vision tokens).  With ``ckpt_dir`` the final params and optimizer state
    are saved there."""
    import numpy as np
    import torch

    from repro_torch.checkpoint.store import CheckpointManager
    from repro_torch.data.pipeline import MarkovCorpus, batches
    from repro_torch.device import resolve_device
    from repro_torch.models.model import init_model
    from repro_torch.training.optimizer import OptConfig, init_adamw
    from repro_torch.training.train_step import make_train_step

    dev = resolve_device(device)
    if params is None:
        params = init_model(cfg, seed=seed, device=dev)
    oc = OptConfig(lr=lr, warmup_steps=min(50, steps // 10 + 1),
                   total_steps=steps)
    opt = init_adamw(params)
    step_fn = make_train_step(cfg, oc)
    corpus = corpus or MarkovCorpus(vocab=cfg.vocab, seed=seed)
    cm = CheckpointManager(ckpt_dir) if ckpt_dir else None

    history = []
    t0 = time.time()
    for i, b in enumerate(batches(corpus, batch, seq, steps, seed=seed)):
        if cfg.family in ("vlm", "audio"):
            # the reference's stand-in for vision / audio embeddings
            T = 16 if cfg.family == "audio" else min(cfg.n_vision_tokens, 16)
            b = dict(b, cross_src=np.full((batch, T, cfg.d_model), 0.02,
                                          np.float32))
        params, opt, m = step_fn(params, opt,
                                 {k: torch.as_tensor(v, device=dev)
                                  for k, v in b.items()})
        history.append(float(m["ce"]))
        if (i + 1) % log_every == 0:
            print(f"step {i+1:5d} ce={history[-1]:.4f} "
                  f"lr={float(m['lr']):.2e} gnorm={float(m['grad_norm']):.2f} "
                  f"({(time.time()-t0)/(i+1):.2f}s/step)", flush=True)
    if cm:
        cm.save(steps, {"params": params, "opt": opt})
    return params, opt, history


def training_bytes(params) -> int:
    """Device bytes that training adds to ``params``: a gradient per leaf
    in the leaf's dtype and AdamW's two float32 moments."""
    from repro_torch.tree import tree_leaves
    return sum(t.numel() * (t.element_size() + 8)
               for t in tree_leaves(params))


def main(argv=None):
    from repro_torch.configs import get_config, make_smoke

    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="mixtral-8x7b")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced same-family config (CPU-trainable)")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--dtype", default="bfloat16",
                    choices=["bfloat16", "float32"])
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.smoke:
        cfg = make_smoke(cfg)
    cfg = cfg.replace(dtype=args.dtype, param_dtype=args.dtype)
    print(f"training {cfg.name}: {args.steps} steps, "
          f"batch={args.batch} seq={args.seq}")
    _, _, hist = train_loop(cfg, args.steps, args.batch, args.seq,
                            lr=args.lr, seed=args.seed, ckpt_dir=args.ckpt,
                            device=args.device)
    print(f"ce: {hist[0]:.3f} -> {hist[-1]:.3f}")
    return hist


if __name__ == "__main__":
    main()
