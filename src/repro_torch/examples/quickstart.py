"""Quickstart: DALI's three techniques on a toy MoE (port of
``examples/quickstart.py``).

  PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]

1. the smoke Mixtral at 4 layers, random weights from seed 0, one traced
   forward of 8 x 16 tokens: the per-layer expert workloads;
2. Greedy Assignment (paper Alg. 1) against the optimal 0-1 plan on layer
   0's workloads, under the full-size model's costs on the paper's local
   PC (``LOCAL_PC``);
3. one step of the DALI policy (assignment + residual prefetch + cache)
   through the legacy ``dali_schedule`` wrapper.

Runs on the card unless ``--device cpu``; the CUDA kernels take bfloat16,
so ``--dtype`` defaults to it.  ``main`` returns the two makespans and the
DALI step's hits and misses.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch


@torch.no_grad()
def main(argv=None):
    from repro_torch.configs import get_config, make_smoke
    from repro_torch.core.assignment import greedy_assign, optimal_assign
    from repro_torch.core.cost_model import LOCAL_PC, CostModel
    from repro_torch.core.engine import (DaliConfig, dali_schedule,
                                         init_dali_state)
    from repro_torch.device import resolve_device
    from repro_torch.models.model import (apply_model, collect_field,
                                          init_model, stack_routers)

    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--dtype", default="bfloat16",
                    choices=["bfloat16", "float32"])
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    # 1. a small Mixtral-family MoE with real routing -----------------------
    cfg = make_smoke(get_config("mixtral-8x7b")).replace(
        n_layers=4, dtype=args.dtype, param_dtype=args.dtype)
    params = init_model(cfg, seed=0, device=dev)
    tokens = torch.as_tensor(np.random.default_rng(1).integers(
        0, cfg.vocab, (8, 16)), device=dev)
    _, _, infos = apply_model(params, tokens, cfg, trace=True,
                              last_logit_only=True)
    workloads = collect_field(infos, "workload")          # (L, E)
    print("per-layer expert workloads:\n", workloads.cpu().numpy())

    # 2. Greedy Assignment (paper Alg. 1) vs the optimal 0-1 plan -----------
    cm = CostModel.for_config(get_config("mixtral-8x7b"), LOCAL_PC)
    w = workloads[0].cpu().numpy()
    tc, tg = cm.t_cpu(w), cm.t_gpu(w, on_gpu=np.zeros_like(w, bool))
    g = greedy_assign(tc, tg)
    o = optimal_assign(tc, tg)
    print(f"\ngreedy makespan={g.makespan * 1e3:.2f}ms "
          f"(optimal {o.makespan * 1e3:.2f}ms, "
          f"{100 * o.makespan / max(g.makespan, 1e-12):.0f}% quality) "
          f"gpu={g.on_gpu.sum()} cpu={g.on_cpu.sum()} experts")

    # 3. the DALI step: assignment + residual prefetch + cache --------------
    L, E = workloads.shape
    dcfg = DaliConfig.from_cost_model(cm, n_moe_layers=L, n_experts=E,
                                      cache_size=E // 2, prefetch_size=1)
    state = init_dali_state(dcfg, device=dev)
    gate_in = collect_field(infos, "gate_in")
    routers = stack_routers(params, cfg)
    res_vecs = torch.zeros((L, cfg.d_model), device=dev)  # calibrated in serve
    state, tel = dali_schedule(state, workloads, gate_in, routers, res_vecs,
                               dcfg, top_k=cfg.moe.top_k,
                               router_type=cfg.moe.router_type)
    hits, misses = int(tel["hits"].sum()), int(tel["misses"].sum())
    print(f"\nDALI step: est moe time="
          f"{float(tel['step_moe_time']) * 1e3:.2f}ms, hits={hits} "
          f"misses={misses} "
          f"link={float(tel['link_seconds'].sum()) * 1e3:.2f}ms")
    print("experts on GPU (layer 0):",
          np.where(tel["on_gpu"][0].cpu().numpy())[0])
    print("experts on CPU (layer 0):",
          np.where(tel["on_cpu"][0].cpu().numpy())[0])
    return {"greedy_makespan": g.makespan, "optimal_makespan": o.makespan,
            "hits": hits, "misses": misses}


if __name__ == "__main__":
    main()
