"""Paper Fig. 19-style breakdown (port of ``examples/offload_ablation.py``):
Naive (all-CPU) -> +Greedy Assignment -> +Residual Prefetching ->
+Workload-Aware Cache, replayed over a routing trace of a trained smoke
MoE under the paper's local-PC cost profile; the same comparison through
the registered policies; then the "dali" policy run physically (expert
weights in a pinned host store, decode against a device slot pool) in the
four ``--offload`` modes side by side.

  PYTHONPATH=src python -m repro_torch.examples.offload_ablation \
      [--device cpu --dtype float32] [--steps 100]

The smoke Mixtral at 4 layers trains ``--steps`` AdamW steps first (100,
as the reference).  The traces decode with sampling (a
``torch.Generator``; the reference's ``jax.random`` draws differ).  The
physical rows drive the legacy construction surface on purpose
(``scheduler.make_store``, ``make_decode_step(offload=)``,
``init_serve_state(offload=)``): this example is its back-compat proof,
so expect one ``DeprecationWarning`` each.  Runs on the card unless
``--device cpu``.  ``main`` returns the rows it prints.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

WARM, STEPS = 8, 20          # physical rows: warm-up and timed B=1 steps


def main(argv=None):
    from repro_torch.configs import get_config, make_smoke
    from repro_torch.core.cost_model import LOCAL_PC, CostModel
    from repro_torch.core.policy import DaliConfig, make_policy
    from repro_torch.core.prefetch import (FeaturePrefetcher,
                                           ResidualPrefetcher)
    from repro_torch.core.residual import calibrate_residuals
    from repro_torch.core.simulator import (FrameworkSpec, simulate,
                                            simulate_policy)
    from repro_torch.core.tracing import capture_decode_trace, gate_weights
    from repro_torch.data.pipeline import MarkovCorpus
    from repro_torch.device import resolve_device
    from repro_torch.launch.train import train_loop
    from repro_torch.serving.expert_store import strip_expert_params
    from repro_torch.serving.scheduler import make_store
    from repro_torch.serving.steps import init_serve_state, make_decode_step

    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=100,
                    help="AdamW steps before the traces")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--dtype", default="bfloat16",
                    choices=["bfloat16", "float32"])
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = make_smoke(get_config("mixtral-8x7b")).replace(
        n_layers=4, dtype=args.dtype, param_dtype=args.dtype)
    corpus = MarkovCorpus(vocab=cfg.vocab, seed=0)
    params, _, _ = train_loop(cfg, args.steps, 8, 64, corpus=corpus,
                              device=dev)

    rng = np.random.default_rng(1)
    prompts = np.stack([corpus.sample(rng, 32) for _ in range(8)])
    trace = capture_decode_trace(params, cfg, prompts, n_decode=32,
                                 greedy=False, device=dev)
    calib = capture_decode_trace(
        params, cfg, np.stack([corpus.sample(rng, 32) for _ in range(8)]),
        n_decode=16, greedy=False, seed=7, device=dev)
    res = calibrate_residuals([calib])
    gws = gate_weights(params, cfg)
    pfs = {"residual": ResidualPrefetcher(gws, res, cfg.moe),
           "feature": FeaturePrefetcher(gws, cfg.moe)}

    cm = CostModel.for_config(get_config("mixtral-8x7b"), LOCAL_PC)
    E = cfg.moe.n_routed
    specs = [
        FrameworkSpec("Naive (all CPU)", assignment="all_cpu"),
        FrameworkSpec("+Greedy Assignment", assignment="greedy"),
        FrameworkSpec("+Residual Prefetch", assignment="greedy",
                      prefetch="residual", prefetch_size=1),
        FrameworkSpec("+Workload Cache", assignment="greedy",
                      prefetch="residual", prefetch_size=1,
                      cache_policy="workload", cache_size=E // 4,
                      w_size=4, u_size=1),
    ]
    out = {"ablation": [], "policies": [], "offload": []}
    base = None
    print(f"{'config':26s} {'tok/s':>8s} {'speedup':>8s} {'hit%':>6s}")
    for spec in specs:
        r = simulate(trace, cfg, cm, spec, prefetchers=pfs, batch=8,
                     ctx_len=32)
        base = base or r.tokens_per_s
        out["ablation"].append((spec.name, r.tokens_per_s,
                                r.cache_hit_rate))
        print(f"{spec.name:26s} {r.tokens_per_s:8.2f} "
              f"{r.tokens_per_s / base:7.2f}x {100 * r.cache_hit_rate:5.1f}")

    # the same comparison through the registered policies (the definitions
    # the serving path runs), with the full-size model's cost constants
    dcfg = DaliConfig.from_cost_model(
        cm, n_moe_layers=trace.n_moe_layers, n_experts=E,
        cache_size=E // 4, prefetch_size=1, w_size=4, u_size=1)
    print(f"\n{'--policy':26s} {'tok/s':>8s} {'hit%':>6s}")
    for name in ("none", "all_gpu", "static", "lru", "score", "dali"):
        r = simulate_policy(trace, cfg, cm, name, dcfg=dcfg, gate_ws=gws,
                            res_vecs=res, batch=8, ctx_len=32)
        out["policies"].append((name, r.tokens_per_s, r.cache_hit_rate))
        print(f"{name:26s} {r.tokens_per_s:8.2f} "
              f"{100 * r.cache_hit_rate:5.1f}")

    # the modeled rows estimate offload cost; these measure it: the "dali"
    # policy drives a host expert store and a device slot pool through one
    # B=1 decode loop per mode (wall time includes the pool streaming each
    # mode schedules differently)
    pol = make_policy("dali", dcfg, top_k=cfg.moe.top_k,
                      router_type=cfg.moe.router_type)
    rv = torch.as_tensor(np.stack(res), device=dev)
    print(f"\n{'--offload':26s} {'wall µs/step':>12s} {'streamed MB':>12s}"
          f" {'miss rows':>10s}")
    with torch.no_grad():
        for mode in ("modeled", "blocking", "overlap", "pipelined"):
            store = make_store(mode, params, cfg, pol, device=dev)
            dparams = (params if store is None
                       else strip_expert_params(params, cfg))
            decode = make_decode_step(cfg, policy=pol, offload=store)
            state = init_serve_state(cfg, 1, 64, policy=pol, offload=store,
                                     device=dev)
            target = None
            for t in range(WARM + STEPS):
                if t == WARM:
                    t0 = time.perf_counter()
                # blocking: the plan's copies on the critical path;
                # overlap: commit at the step boundary, stage behind the
                # step in flight; pipelined: per-layer copies the step's
                # MoE layers wait on
                if store is not None:
                    state["offload"] = store.pre_step(state["offload"],
                                                      mode, target)
                state, _, tel = decode(dparams, state, rv)
                if store is not None:
                    store.post_dispatch(mode, target)
                state["tokens"].cpu()
                if store is not None:
                    target = store.next_target(state, tel)
            us = (time.perf_counter() - t0) / STEPS * 1e6
            st = store.stats() if store is not None else {}
            mb = st.get("h2d_bytes", 0) / 1e6
            miss = st.get("fallback_rows", 0)
            out["offload"].append((mode, us, mb, miss))
            print(f"{mode:26s} {us:12.0f} {mb:12.2f} {miss:10d}")
    return out


if __name__ == "__main__":
    main()
