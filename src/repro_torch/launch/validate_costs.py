"""Validation of the analytic cost model (``launch/costs.py``) against the
FLOPs a run counts (port of ``repro/launch/validate_costs.py``, which
holds it against XLA's ``compiled.cost_analysis()``).

The comparison runs the one-super-block variant of each arch (n_layers =
its prefix plus one pattern period, as the reference's) on the ``meta``
device under ``torch.utils.flop_counter.FlopCounterMode``: the kernels
count their own formulas there, every other matmul PyTorch's.  The MoE
layers run at the capacity the dry run's steps use
(``expert_capacity(tokens)``), which is the capacity ``step_cost``
counts::

  PYTHONPATH=src python -m repro_torch.launch.validate_costs
"""
from __future__ import annotations

import torch
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs import ARCHS, get_config
from repro_torch.device import torch_dtype
from repro_torch.launch.costs import step_cost
from repro_torch.models.config import scan_pattern
from repro_torch.models.model import apply_model, meta_caches, meta_model
from repro_torch.models.moe import expert_capacity


def validate(arch: str, kind: str = "prefill", batch: int = 2,
             seq: int = 128):
    """(counted FLOPs, analytic FLOPs, analytic / counted) of one
    prefill over (batch, seq) or one decode step at kv length seq."""
    cfg = get_config(arch)
    prefix, period, _ = scan_pattern(cfg)
    cfg = cfg.replace(n_layers=len(prefix) + len(period))
    if cfg.encoder is not None:
        cfg = cfg.replace(encoder=None, family="dense")   # decoder only
    meta = torch.device("meta")
    cs = None
    if cfg.family == "vlm":
        cs = torch.empty((batch, cfg.n_vision_tokens, cfg.d_model),
                         dtype=torch_dtype(cfg.dtype), device=meta)
    params = meta_model(cfg)
    tokens = batch * (1 if kind == "decode" else seq)
    cap = expert_capacity(cfg.moe, tokens) if cfg.moe else None
    with torch.no_grad(), FlopCounterMode(display=False) as fc:
        if kind == "decode":
            caches = meta_caches(cfg, batch, seq, dtype=cfg.dtype)
            tok = torch.empty((batch, 1), dtype=torch.int32, device=meta)
            pos = torch.full((1,), seq - 1, dtype=torch.int32, device=meta)
            apply_model(params, tok, cfg, positions=pos, caches=caches,
                        moe_capacity=cap)
        else:
            tok = torch.empty((batch, seq), dtype=torch.int32, device=meta)
            apply_model(params, tok, cfg, cross_src=cs, moe_capacity=cap)
    counted = float(fc.get_total_flops())
    analytic = step_cost(cfg, kind, seq, batch).flops
    ratio = analytic / counted if counted else float("nan")
    return counted, analytic, ratio


def main():
    print(f"{'arch':28s} {'kind':8s} {'counted':>12s} {'analytic':>12s} "
          f"{'ratio':>6s}")
    for arch in ARCHS:
        for kind in ("prefill", "decode"):
            try:
                c, a, r = validate(arch, kind)
                print(f"{arch:28s} {kind:8s} {c:12.3e} {a:12.3e} {r:6.2f}")
            except Exception as e:  # pragma: no cover
                print(f"{arch:28s} {kind:8s} ERROR {type(e).__name__}: "
                      f"{str(e)[:80]}")


if __name__ == "__main__":
    main()
