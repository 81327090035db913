"""Discrete-event replay of routing traces under offloading-framework
policies (the paper's evaluation methodology, §6).

The simulator charges time exactly as the paper's cost formulation does:
per MoE layer, ``layer_time = solve + max(T_cpu, T_gpu)`` with
``T_gpu = Σ_i max(trans_i·[not resident], compute_i)`` (Eq. 3-6), prefetch
transfers for layer l+1 overlapping layer l's execution on the link, cache
replacement transfers charged to the link, and a constant attention/dense
portion per step executed on the device holding those weights.

Framework presets mirror the paper's baselines:
  llama.cpp / KTransformers  — layer-wise hybrid (no CPU/GPU parallelism)
  MoE-Lightning              — offline-profiled static placement, parallel
  Fiddler                    — static expert-wise threshold, no prefetch/cache
  HybriMoE                   — static threshold + feature prefetch + score cache
  DALI                       — greedy assignment + residual prefetch +
                               workload-aware cache (+ each ablation)

Solve costs are *measured* wall-clock of the actual solver implementations
(greedy numpy vs exact DP/B&B), so the greedy-vs-optimal trade-off (Fig. 15,
Table 4) is real, not assumed.

``simulate_policy`` replays a trace through the registered policies of
``core/policy.py``: the same ``step`` the serving path runs, here on CPU
tensors, so simulator ablations and serving ablations cannot diverge.

A copy of ``repro/core/simulator.py``; where the reference's
``simulate_policy`` replays through the policies' NumPy mirror
(``step_np``), the port replays through ``step`` itself.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np

import torch

from repro_torch.core.assignment import (Assignment, all_cpu, beam_search_assign,
                                   greedy_assign, optimal_assign,
                                   static_assign)
from repro_torch.core.cache import (BaseCache, LRUCache, ScoreCache, StaticCache,
                              WorkloadAwareCache)
from repro_torch.core.cost_model import CostModel
from repro_torch.core.prefetch import (BasePrefetcher, prefetch_accuracy,
                                 top_workload_experts)
from repro_torch.models.config import ModelConfig


# --------------------------------------------------------------------------
# Framework specification
# --------------------------------------------------------------------------

@dataclass
class FrameworkSpec:
    name: str
    assignment: str = "greedy"      # greedy|optimal|beam|static|all_cpu|layerwise
    prefetch: Optional[str] = None  # residual|feature|statistical|random|None
    prefetch_size: int = 1
    cache_policy: Optional[str] = None   # workload|lru|score|static|None
    cache_size: int = 0
    w_size: int = 4
    u_size: int = 1
    static_threshold: float = 0.0   # tokens; >thr -> GPU (expert-wise static)
    layerwise_attn_on_gpu: bool = True   # KTransformers yes, llama.cpp no
    prefetch_overhead_s: float = 40e-6   # extra gating + stream switch / layer


@dataclass
class SimResult:
    name: str
    tokens_per_s: float
    step_time_s: float
    moe_time_s: float
    attn_time_s: float
    solve_time_s: float
    pcie_time_s: float
    pcie_frac: float
    cache_hit_rate: float
    prefetch_acc: float
    t_cpu_total: float
    t_gpu_total: float
    stall_s: float
    n_steps: int

    def row(self) -> str:
        return (f"{self.name:28s} tok/s={self.tokens_per_s:9.3f} "
                f"pcie%={100*self.pcie_frac:5.1f} hit%={100*self.cache_hit_rate:5.1f} "
                f"pfacc%={100*self.prefetch_acc:5.1f} solve={self.solve_time_s:.4f}s")


# --------------------------------------------------------------------------
# Helpers
# --------------------------------------------------------------------------

def nonmoe_time_per_step(cfg: ModelConfig, cm: CostModel, batch: int,
                         ctx_len: int, on_gpu: bool = True) -> float:
    """Per-decode-step time of the non-MoE portion (attention projections,
    norms, embeddings) on the chosen device."""
    d = cfg.d_model
    a = cfg.attn
    per_layer = 0.0
    if a is not None:
        hd = cfg.head_dim()
        q = a.n_heads * hd
        kv = a.n_kv_heads * hd
        proj = 2.0 * d * (q + 2 * kv + q)            # q,k,v,o FLOPs/token
        attn = 2.0 * 2.0 * a.n_heads * hd * ctx_len  # qk + pv
        per_layer = proj + attn
    shared = 0.0
    if cfg.moe is not None and cfg.moe.n_shared:
        ds = cfg.moe.d_shared or cfg.moe.n_shared * (cfg.moe.d_expert or cfg.d_ff)
        shared = 6.0 * d * ds
    flops = (per_layer + shared) * cfg.n_layers * batch \
        + 2.0 * d * cfg.vocab * batch
    rate = (cm.profile.gpu_gflops if on_gpu else cm.profile.cpu_gflops) * 1e9
    return flops / rate


def make_cache(spec: FrameworkSpec, n_experts: int, seed: int) -> Optional[BaseCache]:
    if not spec.cache_policy or spec.cache_size <= 0:
        return None
    if spec.cache_policy == "workload":
        return WorkloadAwareCache(n_experts, spec.cache_size,
                                  spec.w_size, spec.u_size, seed)
    if spec.cache_policy == "lru":
        return LRUCache(n_experts, spec.cache_size, seed)
    if spec.cache_policy == "score":
        return ScoreCache(n_experts, spec.cache_size, seed=seed)
    if spec.cache_policy == "static":
        return StaticCache(n_experts, spec.cache_size, seed)
    raise ValueError(spec.cache_policy)


def _assign(spec: FrameworkSpec, w, tc, tg) -> tuple[Assignment, float]:
    t0 = time.perf_counter()
    if spec.assignment == "greedy":
        a = greedy_assign(tc, tg)
    elif spec.assignment == "optimal":
        a = optimal_assign(tc, tg)
    elif spec.assignment == "beam":
        a = beam_search_assign(tc, tg)
    elif spec.assignment == "static":
        a = static_assign(w, tc, tg, spec.static_threshold)
    elif spec.assignment == "all_cpu":
        a = all_cpu(tc, tg)
    else:
        raise ValueError(spec.assignment)
    return a, time.perf_counter() - t0


# --------------------------------------------------------------------------
# The simulator
# --------------------------------------------------------------------------

def simulate(trace, cfg: ModelConfig, cm: CostModel, spec: FrameworkSpec,
             prefetchers: Optional[Dict[str, BasePrefetcher]] = None,
             batch: int = 1, ctx_len: int = 64, seed: int = 0,
             solve_time_scale: float = 1.0) -> SimResult:
    """Replay a RoutingTrace under one framework policy."""
    L = trace.n_moe_layers
    E = cfg.moe.n_routed
    caches = [make_cache(spec, E, seed + l) for l in range(L)]
    prefetcher = (prefetchers or {}).get(spec.prefetch) if spec.prefetch else None

    total = dict(moe=0.0, attn=0.0, solve=0.0, pcie=0.0, stall=0.0,
                 tcpu=0.0, tgpu=0.0)
    hits = lookups = 0
    pf_acc: List[float] = []

    if spec.assignment == "layerwise":
        return _simulate_layerwise(trace, cfg, cm, spec, batch, ctx_len,
                                   total)

    for step in range(trace.n_steps):
        pf_stall = 0.0              # prefetch link time spilling past a layer
        prefetched: set = set()
        for l in range(L):
            w = trace.workload[step][l].astype(np.float64)
            resident = np.zeros(E, bool)
            if caches[l] is not None:
                resident[caches[l].resident_set()] = True
            for e in prefetched:
                resident[e] = True

            tc = cm.t_cpu(w)
            tg = cm.t_gpu(w, resident)
            a, solve_t = _assign(spec, w, tc, tg)
            solve_t *= solve_time_scale
            # wait for any prefetch link traffic spilling past prev layer
            layer_time = a.makespan + solve_t + pf_stall
            total["stall"] += pf_stall

            # cache accounting against GPU-assigned experts (demand fetches)
            gpu_experts = np.where(a.on_gpu & (w > 0))[0]
            if caches[l] is not None:
                for e in gpu_experts:
                    lookups += 1
                    if resident[e]:
                        hits += 1
                transfers = caches[l].observe(
                    w, trace.gates_sum[step][l], used_on_gpu=a.on_gpu)
                total["pcie"] += transfers * cm.trans_time
                layer_time += transfers * cm.trans_time
            demand_trans = sum(cm.trans_time for e in gpu_experts
                               if not resident[e])
            total["pcie"] += demand_trans

            # prefetch next layer, overlapping this layer's execution
            prefetched = set()
            if prefetcher is not None and l + 1 < L:
                h = trace.gate_in[step][l]
                pred = prefetcher.predict(l, h)
                prefetcher.observe(l, trace.workload[step][l])
                top = top_workload_experts(pred, spec.prefetch_size)
                prefetched = set(int(e) for e in top)
                true_next = trace.workload[step][l + 1]
                pf_acc.append(prefetch_accuracy(pred, true_next,
                                                spec.prefetch_size))
                pf_time = len(prefetched) * cm.trans_time
                total["pcie"] += pf_time
                layer_time += spec.prefetch_overhead_s
                # link time beyond this layer's span stalls the next layer
                pf_stall = max(0.0, pf_time - layer_time)
            else:
                pf_stall = 0.0

            total["moe"] += layer_time
            total["solve"] += solve_t
            total["tcpu"] += a.t_cpu
            total["tgpu"] += a.t_gpu

        total["attn"] += nonmoe_time_per_step(cfg, cm, batch,
                                              ctx_len + step, True)

    # pf_stall is already folded into layer times; "stall" is report-only
    step_time = (total["moe"] + total["attn"]) / max(trace.n_steps, 1)
    tokens_per_s = trace.n_tokens / step_time if step_time > 0 else 0.0
    wall = total["moe"] + total["attn"]
    return SimResult(
        name=spec.name, tokens_per_s=tokens_per_s, step_time_s=step_time,
        moe_time_s=total["moe"], attn_time_s=total["attn"],
        solve_time_s=total["solve"], pcie_time_s=total["pcie"],
        pcie_frac=total["pcie"] / wall if wall else 0.0,
        cache_hit_rate=hits / lookups if lookups else 0.0,
        prefetch_acc=float(np.mean(pf_acc)) if pf_acc else 0.0,
        t_cpu_total=total["tcpu"], t_gpu_total=total["tgpu"],
        stall_s=total["stall"], n_steps=trace.n_steps)


def _simulate_layerwise(trace, cfg, cm, spec, batch, ctx_len, total):
    """llama.cpp / KTransformers: whole MoE layers pinned to CPU or GPU,
    sequential execution (no heterogeneous parallelism).  The number of
    GPU-resident layers matches the same device-memory budget as the
    expert-cache frameworks (paper §6.1 fair-comparison protocol)."""
    L = trace.n_moe_layers
    E = cfg.moe.n_routed
    budget_experts = spec.cache_size * L
    gpu_layers = min(L, budget_experts // E)
    hits = lookups = 0
    for step in range(trace.n_steps):
        for l in range(L):
            w = trace.workload[step][l].astype(np.float64)
            if l < gpu_layers:              # resident on GPU, no transfer
                total["moe"] += float(cm.t_gpu_compute(w).sum())
                lookups += int((w > 0).sum())
                hits += int((w > 0).sum())
            else:
                total["moe"] += float(cm.t_cpu(w).sum())
                lookups += int((w > 0).sum())
        total["attn"] += nonmoe_time_per_step(
            cfg, cm, batch, ctx_len + step, on_gpu=spec.layerwise_attn_on_gpu)
    step_time = (total["moe"] + total["attn"]) / max(trace.n_steps, 1)
    tokens_per_s = trace.n_tokens / step_time if step_time else 0.0
    wall = total["moe"] + total["attn"]
    return SimResult(
        name=spec.name, tokens_per_s=tokens_per_s, step_time_s=step_time,
        moe_time_s=total["moe"], attn_time_s=total["attn"], solve_time_s=0.0,
        pcie_time_s=0.0, pcie_frac=0.0,
        cache_hit_rate=hits / lookups if lookups else 0.0,
        prefetch_acc=0.0, t_cpu_total=0.0, t_gpu_total=0.0, stall_s=0.0,
        n_steps=trace.n_steps)


# --------------------------------------------------------------------------
# Policy replay (the registry-driven simulator path)
# --------------------------------------------------------------------------

def simulate_policy(trace, cfg: ModelConfig, cm: CostModel, policy,
                    dcfg=None, gate_ws=None, res_vecs=None,
                    batch: int = 1, ctx_len: int = 64) -> SimResult:
    """Replay a RoutingTrace under a registered policy name (or an
    already-built policy object), through the policy's ``step`` on CPU
    tensors.

    Time is charged exactly as the serving telemetry models it: per step,
    ``moe = Σ_l max(T_cpu_l, T_gpu_l)`` (T_gpu folds per-expert transfer
    via ``max(trans, comp)``), link traffic (misses + swaps + prefetches)
    reported as ``pcie_time_s``, plus the constant non-MoE portion per
    step.  "none" (scheduling off) is modeled as naive on-demand GPU
    execution: every activated expert demand-fetched (all_gpu assignment,
    empty cache).  The initial state is ``policy.init(device="cpu")``."""
    from repro_torch.core.policy import DaliConfig, Observation, make_policy
    L = trace.n_moe_layers
    E = cfg.moe.n_routed
    if dcfg is None:
        dcfg = DaliConfig.from_cost_model(cm, n_moe_layers=L, n_experts=E,
                                          cache_size=max(1, E // 2))
    name = policy if isinstance(policy, str) else policy.name
    if isinstance(policy, str) and policy != "none":
        policy = make_policy(policy, dcfg, top_k=cfg.moe.top_k,
                             router_type=cfg.moe.router_type)
    if isinstance(policy, str) or not policy.schedules:
        # "none" emits no telemetry to replay: model it as naive on-demand
        # GPU execution instead
        policy = make_policy("all_gpu", dcfg, top_k=cfg.moe.top_k,
                             router_type=cfg.moe.router_type,
                             cache="none")
    # an already-built policy carries its own config: score prefetch
    # accuracy against THAT prefetch_size, not the locally-defaulted one
    dcfg = policy.dcfg
    gws = torch.from_numpy(
        np.stack([np.asarray(g, np.float32) for g in gate_ws])
        if gate_ws is not None
        else np.zeros((L, cfg.d_model, E), np.float32))
    rvs = torch.from_numpy(
        np.stack([np.asarray(r, np.float32) for r in res_vecs])
        if res_vecs is not None
        else np.zeros((L, cfg.d_model), np.float32))

    state = policy.init(device="cpu")
    total = dict(moe=0.0, attn=0.0, pcie=0.0, tcpu=0.0, tgpu=0.0)
    hits = lookups = 0
    pf_acc: List[float] = []
    for t in range(trace.n_steps):
        wl = np.stack([np.asarray(trace.workload[t][l]) for l in range(L)])
        gi = np.stack([np.asarray(trace.gate_in[t][l], np.float32)
                       for l in range(L)])
        obs = Observation(gate_in=torch.from_numpy(gi), routers=gws,
                          res_vecs=rvs)
        state, dec = policy.step(state, torch.from_numpy(wl), obs)
        tel = {k: v.numpy() for k, v in dec.tel.items()}
        total["moe"] += float(tel["step_moe_time"])
        total["pcie"] += float(tel["link_seconds"].sum())
        total["tcpu"] += float(tel["T_cpu"].sum())
        total["tgpu"] += float(tel["T_gpu"].sum())
        hits += int(tel["hits"].sum())
        lookups += int(tel["hits"].sum() + tel["misses"].sum())
        for l in range(1, L):
            if tel["prefetched"][l].any():
                pf_acc.append(prefetch_accuracy(
                    np.asarray(tel["pf_pred"][l], np.float64), wl[l],
                    dcfg.prefetch_size))
        total["attn"] += nonmoe_time_per_step(cfg, cm, batch,
                                              ctx_len + t, True)

    step_time = (total["moe"] + total["attn"]) / max(trace.n_steps, 1)
    tokens_per_s = trace.n_tokens / step_time if step_time > 0 else 0.0
    wall = total["moe"] + total["attn"]
    return SimResult(
        name=name, tokens_per_s=tokens_per_s, step_time_s=step_time,
        moe_time_s=total["moe"], attn_time_s=total["attn"],
        solve_time_s=0.0, pcie_time_s=total["pcie"],
        pcie_frac=total["pcie"] / wall if wall else 0.0,
        cache_hit_rate=hits / lookups if lookups else 0.0,
        prefetch_acc=float(np.mean(pf_acc)) if pf_acc else 0.0,
        t_cpu_total=total["tcpu"], t_gpu_total=total["tgpu"],
        stall_s=0.0, n_steps=trace.n_steps)


# --------------------------------------------------------------------------
# Paper-baseline presets
# --------------------------------------------------------------------------

def paper_frameworks(cache_size: int, prefetch_size: int = 1,
                     w_size: int = 4, u_size: int = 1,
                     threshold: float = 2.0) -> List[FrameworkSpec]:
    return [
        FrameworkSpec("llama.cpp", assignment="layerwise",
                      cache_size=cache_size, layerwise_attn_on_gpu=False),
        FrameworkSpec("KTransformers", assignment="layerwise",
                      cache_size=cache_size, layerwise_attn_on_gpu=True),
        FrameworkSpec("MoE-Lightning", assignment="static",
                      static_threshold=threshold,
                      cache_policy="static", cache_size=cache_size),
        FrameworkSpec("Fiddler", assignment="static",
                      static_threshold=threshold),
        FrameworkSpec("HybriMoE", assignment="static",
                      static_threshold=threshold,
                      prefetch="feature", prefetch_size=prefetch_size,
                      cache_policy="score", cache_size=cache_size),
        FrameworkSpec("DALI", assignment="greedy",
                      prefetch="residual", prefetch_size=prefetch_size,
                      cache_policy="workload", cache_size=cache_size,
                      w_size=w_size, u_size=u_size),
    ]
