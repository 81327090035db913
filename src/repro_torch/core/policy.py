"""Offloading policies (port of ``repro/core/policy.py``).

The paper's three mechanisms — Greedy Assignment (Alg. 1), Residual-Based
Prefetching (Eq. 10-11) and Workload-Aware Cache Replacement (Alg. 2) —
are one composition of three swappable sub-policies (assignment, prefetch,
cache); the paper's baselines are others.  Every composition has the
reference's API::

  init(seed, device) -> state      a dict of tensors, stable across steps
  step(state, workloads, obs) -> (state', Decisions)

``step`` runs once per decode step on the serving device and never reads a
value back to the host, so the decode loop does not wait on it.  The state
layout is the reference's (``resident``, ``cache``, ``prefetch``, ``tick``,
``acc``), so ``repro_torch.bridge`` can carry a reference state over.

Ties follow ``lax.top_k``, ``jnp.argsort`` and ``jnp.argmin`` (lowest
index first) through stable sorts and ``torch.argmin``; float sums are
float32 in the reference's order.  The reference's NumPy mirror
(``step_np``) is not ported: the simulator replays traces through
``step`` on CPU tensors (``core/simulator.py``).

Registry (``make_policy``): "dali", "static", "all_gpu", "lru", "score",
"statistical", "random", "none", with the reference's sub-policy
overrides.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import NamedTuple, Optional

import torch

from repro_torch.core.assignment import greedy_assign_torch
from repro_torch.core.cost_model import CostModel
from repro_torch.device import resolve_device
from repro_torch.spans import span

NEG, POS = -1e30, 1e30


@dataclass(frozen=True)
class DaliConfig:
    """Scheduling geometry + cost constants, baked from a CostModel."""
    n_moe_layers: int
    n_experts: int
    cache_size: int
    prefetch_size: int = 1
    w_size: int = 4
    u_size: int = 1
    # cost constants (seconds), baked from a CostModel
    t_trans: float = 0.01
    cpu_alpha: float = 30e-6
    cpu_per_tok: float = 1e-4        # FLOP-bound slope
    cpu_mem: float = 5e-3            # DRAM weight-read floor
    gpu_alpha: float = 15e-6
    gpu_per_tok: float = 1e-6
    gpu_mem: float = 4e-4            # HBM weight-read floor

    @classmethod
    def from_cost_model(cls, cm: CostModel, n_moe_layers: int,
                        n_experts: int, cache_size: int, **kw):
        p = cm.profile
        flops_tok = 6.0 * cm.d_model * cm.d_expert
        return cls(
            n_moe_layers=n_moe_layers, n_experts=n_experts,
            cache_size=cache_size,
            t_trans=cm.trans_time,
            cpu_alpha=p.cpu_overhead_s,
            cpu_per_tok=flops_tok / (p.cpu_gflops * 1e9),
            cpu_mem=cm.expert_bytes / (p.cpu_dram_gbps * 1e9),
            gpu_alpha=p.gpu_overhead_s,
            gpu_per_tok=flops_tok / (p.gpu_gflops * 1e9),
            gpu_mem=cm.expert_bytes / (p.gpu_hbm_gbps * 1e9),
            **kw)


class Observation(NamedTuple):
    """Routing observables one forward produces, as the policy sees them.

    gate_in  (L, T, d)  gate input features per MoE layer
    routers  (L, d, E)  router weights, layer order
    res_vecs (L, d)     calibrated residual-correction vectors (Eq. 11)
    token_mask (T,) bool or None — live slots under continuous batching
    """
    gate_in: object
    routers: object
    res_vecs: object
    token_mask: object = None


class Decisions(NamedTuple):
    """assign_mask (L, E) bool — True = execute on GPU; prefetch_set (L, E);
    resident (L, E) — the effective resident set (cache ∪ prefetch); tel —
    the telemetry dict ``TelemetryAggregator`` understands."""
    assign_mask: object
    prefetch_set: object
    resident: object
    tel: dict


# --------------------------------------------------------------------------
# Shared cost/selection primitives
# --------------------------------------------------------------------------

def _t_cpu(w, dcfg: DaliConfig):
    t = dcfg.cpu_alpha + torch.clamp_min(w * dcfg.cpu_per_tok, dcfg.cpu_mem)
    return torch.where(w > 0, t, 0.0)


def _t_gpu(w, resident, dcfg: DaliConfig):
    comp = dcfg.gpu_alpha + torch.clamp_min(w * dcfg.gpu_per_tok,
                                            dcfg.gpu_mem)
    trans = torch.where(resident, 0.0, dcfg.t_trans)
    return torch.where(w > 0, torch.maximum(trans, comp), 0.0)


def _topk_idx(x, k: int):
    """Indices of the k largest entries along the last axis, ties to the
    lowest index (``lax.top_k``'s order)."""
    return torch.sort(x, dim=-1, descending=True, stable=True)[1][..., :k]


def predict_next_workload(gate_in_prev, res_vec_prev, router, top_k: int,
                          router_type: str = "softmax_topk",
                          token_mask=None):
    """Eq. 10 for a stack of layers: each layer's workload predicted from
    the PREVIOUS layer's residual-corrected gate input.  gate_in_prev
    (L', T, d), res_vec_prev (L', d), router (L', d, E) -> (L', E) int32.

    ``token_mask`` (T,) bool drops tokens from retired/empty slots so a
    partially-occupied continuous batch predicts only real traffic."""
    h = gate_in_prev.float() + res_vec_prev[:, None, :]
    logits = torch.bmm(h, router)                               # (L', T, E)
    scores = (torch.sigmoid(logits) if router_type == "sigmoid"
              else torch.softmax(logits, dim=-1))
    idx = _topk_idx(scores, top_k)                              # (L', T, k)
    Lp, T, E = scores.shape
    ones = torch.ones(idx.shape, dtype=torch.int32, device=idx.device)
    if token_mask is not None:
        ones = ones * token_mask.to(torch.int32)[None, :, None]
    counts = torch.zeros((Lp, E), dtype=torch.int32, device=idx.device)
    return counts.scatter_add_(1, idx.reshape(Lp, -1), ones.reshape(Lp, -1))


def _select_prefetch(pf_pred, prefetch_size: int):
    """Top ``prefetch_size`` predicted experts per layer; layer 0 has no
    upstream layer to predict it, so it never prefetches."""
    cols = torch.sort(-pf_pred, dim=-1, stable=True)[1][:, :prefetch_size]
    prefetched = torch.zeros(pf_pred.shape, dtype=torch.bool,
                             device=pf_pred.device)
    prefetched.scatter_(1, cols, True)
    prefetched[0] = False
    return prefetched


def _random_resident(dcfg: DaliConfig, gen: torch.Generator, device):
    """Paper §4: the cache is seeded with ``cache_size`` random residents
    per layer.  The draw differs from the reference's ``jax.random``; a
    test that compares the two carries the reference's state over with
    ``repro_torch.bridge``."""
    L, E, C = dcfg.n_moe_layers, dcfg.n_experts, dcfg.cache_size
    order = torch.stack([torch.randperm(E, generator=gen, device=device)
                         for _ in range(L)])
    return order < C


def _init_acc(device):
    """Device-side telemetry accumulator."""
    i32 = lambda: torch.zeros((), dtype=torch.int32, device=device)
    f32 = lambda: torch.zeros((), dtype=torch.float32, device=device)
    return {"steps": i32(), "moe_time": f32(), "link_time": f32(),
            "hits": i32(), "misses": i32(), "swaps": i32()}




# --------------------------------------------------------------------------
# Assignment sub-policies (expert -> device)
# --------------------------------------------------------------------------

class GreedyAssign:
    """Algorithm 1 (the paper's method) over every layer at once.

    Every assignment maps (w, tc, tg) over (L, E) to (on_cpu, on_gpu,
    T_cpu, T_gpu) with per-layer (L,) makespan components."""
    name = "greedy"

    def assign(self, w, tc, tg):
        return greedy_assign_torch(tc, tg)


def _masked_sum(mask, t):
    return torch.where(mask, t, 0.0).sum(-1)


@dataclass(frozen=True)
class StaticAssign:
    """Fiddler/HybriMoE-style workload threshold: > threshold -> GPU."""
    threshold: float = 2.0
    name = "static"

    def assign(self, w, tc, tg):
        on_gpu = w > self.threshold
        on_cpu = (w > 0) & ~on_gpu
        return on_cpu, on_gpu, _masked_sum(on_cpu, tc), \
            _masked_sum(on_gpu, tg)


class AllGpuAssign:
    """Naive baseline: every activated expert executes on the GPU."""
    name = "all_gpu"

    def assign(self, w, tc, tg):
        on_gpu = w > 0
        return torch.zeros_like(on_gpu), on_gpu, \
            torch.zeros(w.shape[0], dtype=torch.float32, device=w.device), \
            _masked_sum(on_gpu, tg)


class AllCpuAssign:
    """Naive baseline: every activated expert executes on the CPU."""
    name = "all_cpu"

    def assign(self, w, tc, tg):
        on_cpu = w > 0
        return on_cpu, torch.zeros_like(on_cpu), _masked_sum(on_cpu, tc), \
            torch.zeros(w.shape[0], dtype=torch.float32, device=w.device)


# --------------------------------------------------------------------------
# Prefetch sub-policies (predict next-layer workloads)
# --------------------------------------------------------------------------
# predict(sub, w, obs, ...) -> (sub', pf_pred (L, E)): ``pf_pred[l]`` is the
# prediction for layer l, which ``_select_prefetch`` turns into the
# prefetched set.  ``enabled`` False (NoPrefetch) short-circuits selection
# to the empty set: a zero prediction must not prefetch arbitrary experts.

class ResidualPrefetch:
    """The paper's residual-corrected gate replay (Eq. 10-11), stateless."""
    name = "residual"
    enabled = True

    def init(self, dcfg: DaliConfig, device):
        return {}

    def predict(self, sub, w, obs: Observation, dcfg, top_k, router_type):
        L, E = w.shape
        pf_pred = torch.zeros((L, E), dtype=torch.int32, device=w.device)
        if L > 1:
            # layer l's router applied to layer l-1's corrected gate input
            pf_pred[1:] = predict_next_workload(
                obs.gate_in[:-1], obs.res_vecs[:-1], obs.routers[1:], top_k,
                router_type, token_mask=obs.token_mask)
        return sub, pf_pred


@dataclass(frozen=True)
class StatisticalPrefetch:
    """EdgeMoE-style historical activation frequencies.  Predicts layer l
    from its own (decayed) workload history; observations fold in after
    predicting, so step t's prediction uses history through t-1."""
    decay: float = 1.0
    name = "statistical"
    enabled = True

    def init(self, dcfg: DaliConfig, device):
        return {"counts": torch.zeros((dcfg.n_moe_layers, dcfg.n_experts),
                                      dtype=torch.float32, device=device)}

    def predict(self, sub, w, obs, dcfg, top_k, router_type):
        return {"counts": self.decay * sub["counts"] + w}, sub["counts"]


_M32 = 0xFFFFFFFF


def _hash32(x):
    """A 32-bit integer mix (xorshift-multiply rounds) over int64 tensors
    holding 32-bit values; the multipliers stay below 2**31, so no product
    leaves int64."""
    x = x ^ (x >> 16)
    x = (x * 0x7FEB352D) & _M32
    x = x ^ (x >> 15)
    x = (x * 0x2C1B3C6D) & _M32
    return x ^ (x >> 16)


@dataclass(frozen=True)
class RandomPrefetch:
    """Stall-inducing lower bound: random prediction scores.  The reference
    draws them from ``jax.random``; the port hashes (seed, step, layer,
    expert) into uniform floats on the serving device, so the draws are
    deterministic under ``seed`` and need no host round trip.  Like the
    reference's NumPy mirror, it is held to invariants, not to the
    reference's draws."""
    seed: int = 0
    name = "random"
    enabled = True

    def init(self, dcfg: DaliConfig, device):
        return {"t": torch.zeros((), dtype=torch.int64, device=device)}

    def predict(self, sub, w, obs, dcfg, top_k, router_type):
        t = sub["t"]
        key = _hash32((t + self.seed * 0x9E3779B1) & _M32)
        n = torch.arange(w.numel(), dtype=torch.int64, device=w.device)
        bits = _hash32(_hash32(key ^ n) ^ 0x5BD1E995)
        pf_pred = ((bits >> 8).float() * 2.0 ** -24).reshape(w.shape)
        return {"t": t + 1}, pf_pred


class NoPrefetch:
    name = "none"
    enabled = False

    def init(self, dcfg: DaliConfig, device):
        return {}

    def predict(self, sub, w, obs, dcfg, top_k, router_type):
        return sub, torch.zeros(w.shape, dtype=torch.int32, device=w.device)


# --------------------------------------------------------------------------
# Cache sub-policies (which experts stay device-resident)
# --------------------------------------------------------------------------
# init(dcfg, gen, device) -> (resident (L, E) bool, sub); update(sub,
# resident, w, gpu_active, tick, dcfg) -> (resident', sub', n_swaps (L,)).
# ``tick`` is the post-increment step counter (windowed policies key off
# it).  The per-expert scans of LRU and score run as a loop over E of
# tensor ops batched over the L layers, as the greedy assignment does.

def _cache_update(resident, scores, w, do_update, dcfg: DaliConfig):
    """Alg. 2 for every layer: windowed swap of u_size experts.
    resident / scores / w (L, E); do_update a () bool tensor."""
    scores = scores + w.float()
    non_res = torch.where(resident, NEG, scores)
    res_s = torch.where(resident, scores, POS)
    inc_val, inc_idx = torch.sort(non_res, dim=-1, descending=True,
                                  stable=True)
    out_val, out_idx = torch.sort(res_s, dim=-1, stable=True)
    u = dcfg.u_size
    inc_val, inc_idx = inc_val[:, :u], inc_idx[:, :u]
    out_val, out_idx = out_val[:, :u], out_idx[:, :u]
    # pair highest incoming with lowest outgoing; swap only on improvement
    swap = (inc_val > out_val) & (inc_val > NEG / 2) & (out_val < POS / 2)
    new_resident = resident.clone()
    new_resident.scatter_(1, out_idx, torch.where(
        swap, False, new_resident.gather(1, out_idx)))
    new_resident.scatter_(1, inc_idx, torch.where(
        swap, True, new_resident.gather(1, inc_idx)))
    n_swaps = swap.sum(-1, dtype=torch.int32)
    resident = torch.where(do_update, new_resident, resident)
    scores = torch.where(do_update, torch.zeros_like(scores), scores)
    n_swaps = torch.where(do_update, n_swaps, 0)
    return resident, scores, n_swaps


def _no_swaps(resident):
    return torch.zeros(resident.shape[0], dtype=torch.int32,
                       device=resident.device)


def _swap_in(resident, victim, e: int, miss):
    """Per layer where ``miss``: evict ``victim`` (L,) and make expert ``e``
    resident, in place (the victim first, as the reference does)."""
    v = victim[:, None]
    resident.scatter_(1, v, torch.where(miss[:, None], False,
                                        resident.gather(1, v)))
    resident[:, e] = torch.where(miss, True, resident[:, e])


class WorkloadAwareCachePolicy:
    """The paper's Alg. 2: windowed workload-score swaps."""
    name = "workload"

    def init(self, dcfg: DaliConfig, gen, device):
        return _random_resident(dcfg, gen, device), {
            "scores": torch.zeros((dcfg.n_moe_layers, dcfg.n_experts),
                                  dtype=torch.float32, device=device)}

    def update(self, sub, resident, w, gpu_active, tick, dcfg):
        do_update = (tick % dcfg.w_size) == 0
        resident_new, scores_new, n_swaps = _cache_update(
            resident, sub["scores"], w, do_update, dcfg)
        return resident_new, {"scores": scores_new}, n_swaps


_STAMP_FREE = torch.iinfo(torch.int32).max


class LruCachePolicy:
    """FastMoE-style LRU over GPU-assigned experts: a hit refreshes the
    stamp, a miss evicts the least-recently-stamped resident.  Misses ride
    along with the demand fetch (already charged to the link), so n_swaps
    stays 0."""
    name = "lru"

    def init(self, dcfg: DaliConfig, gen, device):
        shape = (dcfg.n_moe_layers, dcfg.n_experts)
        return _random_resident(dcfg, gen, device), {
            "stamp": torch.zeros(shape, dtype=torch.int32, device=device),
            "t": torch.zeros((), dtype=torch.int32, device=device)}

    def update(self, sub, resident, w, gpu_active, tick, dcfg):
        t = sub["t"] + 1
        resident = resident.clone()
        stamp = sub["stamp"].clone()
        for e in range(resident.shape[1]):
            used = gpu_active[:, e]
            res_e = resident[:, e].clone()
            stamp[:, e] = torch.where(used & res_e, t, stamp[:, e])
            victim = torch.argmin(torch.where(resident, stamp, _STAMP_FREE),
                                  dim=-1)
            miss = used & ~res_e
            _swap_in(resident, victim, e, miss)
            stamp[:, e] = torch.where(miss, t, stamp[:, e])
        return resident, {"stamp": stamp, "t": t}, _no_swaps(resident)


_SCORE_FREE = torch.finfo(torch.float32).max


@dataclass(frozen=True)
class ScoreCachePolicy:
    """HybriMoE-style score-EMA replacement: per-layer activation scores
    decay by ``decay`` and accumulate the step's workload; each
    GPU-activated non-resident expert then evicts the lowest-scoring
    resident iff it outscores it.  Like LRU, n_swaps stays 0."""
    decay: float = 0.7
    name = "score"

    def init(self, dcfg: DaliConfig, gen, device):
        return _random_resident(dcfg, gen, device), {
            "score": torch.zeros((dcfg.n_moe_layers, dcfg.n_experts),
                                 dtype=torch.float32, device=device)}

    def update(self, sub, resident, w, gpu_active, tick, dcfg):
        score = self.decay * sub["score"] + w
        resident = resident.clone()
        for e in range(resident.shape[1]):
            victim = torch.argmin(torch.where(resident, score, _SCORE_FREE),
                                  dim=-1)
            miss = (gpu_active[:, e] & ~resident[:, e]
                    & (score[:, e] > score.gather(1, victim[:, None])[:, 0]))
            _swap_in(resident, victim, e, miss)
        return resident, {"score": score}, _no_swaps(resident)


class StaticCachePolicy:
    """Never replaces: the random initial residents persist (ablation lower
    bound / MoE-Lightning-style offline placement)."""
    name = "static"

    def init(self, dcfg: DaliConfig, gen, device):
        return _random_resident(dcfg, gen, device), {}

    def update(self, sub, resident, w, gpu_active, tick, dcfg):
        return resident, sub, _no_swaps(resident)


class NoCachePolicy:
    """No device-resident experts at all: every GPU execution is a demand
    fetch (the 'naive on-demand' lower bound)."""
    name = "none"

    def init(self, dcfg: DaliConfig, gen, device):
        return torch.zeros((dcfg.n_moe_layers, dcfg.n_experts),
                           dtype=torch.bool, device=device), {}

    def update(self, sub, resident, w, gpu_active, tick, dcfg):
        return resident, sub, _no_swaps(resident)


# --------------------------------------------------------------------------
# The composed policy
# --------------------------------------------------------------------------

@dataclass(frozen=True)
class ComposedPolicy:
    """OffloadPolicy built from the three sub-policies."""
    name: str
    assignment: object
    prefetch: object
    cache: object
    dcfg: DaliConfig
    top_k: int
    router_type: str = "softmax_topk"
    schedules: bool = field(default=True, init=False)

    def with_dcfg(self, dcfg: DaliConfig) -> "ComposedPolicy":
        """The same composition over other cost constants; the state keeps
        its structure as long as the scheduling geometry does."""
        return dataclasses.replace(self, dcfg=dcfg)

    def init(self, seed: int = 0, device="cuda"):
        dev = resolve_device(device)
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        resident, cache_sub = self.cache.init(self.dcfg, gen, dev)
        return {
            "resident": resident,
            "cache": cache_sub,
            "prefetch": self.prefetch.init(self.dcfg, dev),
            "tick": torch.zeros((), dtype=torch.int32, device=dev),
            "acc": _init_acc(dev),
        }

    def step(self, state, workloads, obs: Observation):
        """workloads (L, E) int; obs per :class:`Observation`.  Returns
        (state', Decisions), op for op the reference's ``step``."""
        dcfg = self.dcfg
        w = workloads.float()

        # --- prefetch: predictions for layers 1..L-1 ----------------------
        with span("policy.prefetch"):
            pf_sub, pf_pred = self.prefetch.predict(
                state["prefetch"], w, obs, dcfg, self.top_k,
                self.router_type)
            prefetched = (_select_prefetch(pf_pred, dcfg.prefetch_size)
                          if self.prefetch.enabled
                          else torch.zeros(w.shape, dtype=torch.bool,
                                           device=w.device))

        # --- assignment against the effective resident set ----------------
        with span("policy.assign"):
            resident_eff = state["resident"] | prefetched
            tc = _t_cpu(w, dcfg)                                   # (L, E)
            tg = _t_gpu(w, resident_eff, dcfg)
            on_cpu, on_gpu, T_cpu, T_gpu = self.assignment.assign(w, tc, tg)

        # --- cache replacement --------------------------------------------
        with span("policy.cache"):
            tick = state["tick"] + 1
            gpu_active = on_gpu & (workloads > 0)
            resident_new, cache_sub, n_swaps = self.cache.update(
                state["cache"], state["resident"], w, gpu_active, tick,
                dcfg)

        new_state = {"resident": resident_new, "cache": cache_sub,
                     "prefetch": pf_sub, "tick": tick}
        hits = (gpu_active & resident_eff).sum(-1, dtype=torch.int32)
        misses = (gpu_active & ~resident_eff).sum(-1, dtype=torch.int32)
        link_s = (misses.float() * dcfg.t_trans
                  + n_swaps.float() * dcfg.t_trans
                  + prefetched.sum(-1).float() * dcfg.t_trans)
        layer_time = torch.maximum(T_cpu, T_gpu)
        step_moe_time = layer_time.sum()
        tel = {
            "on_gpu": on_gpu, "on_cpu": on_cpu,
            "T_cpu": T_cpu, "T_gpu": T_gpu,
            "layer_time": layer_time,
            "hits": hits, "misses": misses, "swaps": n_swaps,
            "prefetched": prefetched, "pf_pred": pf_pred,
            "link_seconds": link_s,
            "step_moe_time": step_moe_time,
        }
        # cumulative sums stay on the device: the serve loop drains them
        # once per flush interval (TelemetryAggregator)
        acc = state.get("acc")
        if acc is not None:
            new_state["acc"] = {
                "steps": acc["steps"] + 1,
                "moe_time": acc["moe_time"] + step_moe_time,
                "link_time": acc["link_time"] + link_s.sum(),
                "hits": acc["hits"] + hits.sum(dtype=torch.int32),
                "misses": acc["misses"] + misses.sum(dtype=torch.int32),
                "swaps": acc["swaps"] + n_swaps.sum(dtype=torch.int32),
            }
        return new_state, Decisions(on_gpu, prefetched, resident_eff, tel)


@dataclass(frozen=True)
class NullPolicy:
    """Scheduling off: the decode step skips trace collection entirely."""
    name: str = "none"
    schedules: bool = field(default=False, init=False)

    def init(self, seed: int = 0, device="cuda"):
        return {}

    def step(self, state, workloads, obs):
        return state, Decisions(None, None, None, {})


# --------------------------------------------------------------------------
# Registry
# --------------------------------------------------------------------------

ASSIGNMENTS = {
    "greedy": GreedyAssign,
    "static": StaticAssign,
    "all_gpu": AllGpuAssign,
    "all_cpu": AllCpuAssign,
}

PREFETCHES = {
    "residual": ResidualPrefetch,
    "statistical": StatisticalPrefetch,
    "random": RandomPrefetch,
    "none": NoPrefetch,
}

CACHES = {
    "workload": WorkloadAwareCachePolicy,
    "lru": LruCachePolicy,
    "score": ScoreCachePolicy,
    "static": StaticCachePolicy,
    "none": NoCachePolicy,
}

# name -> (assignment, prefetch, cache); "none" is the NullPolicy
POLICY_COMPOSITIONS = {
    "dali": ("greedy", "residual", "workload"),
    "static": ("static", "none", "static"),
    "all_gpu": ("all_gpu", "none", "static"),
    "lru": ("greedy", "none", "lru"),
    "score": ("greedy", "none", "score"),
    "statistical": ("greedy", "statistical", "workload"),
    "random": ("greedy", "random", "workload"),
}


def policy_names():
    return sorted(POLICY_COMPOSITIONS) + ["none"]


def _resolve_sub(kind: str, override, default_name: str, registry):
    """An override is a registry name, an already-built sub-policy instance
    (parameterised, e.g. ``StaticAssign(threshold=1.0)``), or None (the
    composition's default)."""
    if override is None:
        return registry[default_name]()
    if isinstance(override, str):
        if override not in registry:
            raise ValueError(f"{kind} must be one of "
                             f"{'|'.join(sorted(registry))}, "
                             f"got {override!r}")
        return registry[override]()
    return override


def make_policy(name: str, dcfg: Optional[DaliConfig] = None, *,
                top_k: int = 1, router_type: str = "softmax_topk",
                assignment=None, prefetch=None, cache=None):
    """Build a registered policy ("dali" | "static" | "all_gpu" | "lru" |
    "score" | "statistical" | "random" | "none").  The optional
    ``assignment`` / ``prefetch`` / ``cache`` overrides swap one sub-policy
    of a named composition, by registry name (``make_policy("dali",
    cache="lru")``) or as a parameterised instance (``make_policy("static",
    ..., assignment=StaticAssign(threshold=1.0))``)."""
    if name not in POLICY_COMPOSITIONS and name != "none":
        raise ValueError(f"policy must be one of "
                         f"{'|'.join(policy_names())}, got {name!r}")
    if name == "none" and (assignment or prefetch or cache):
        raise ValueError("policy 'none' has no sub-policies to override")
    if name == "none":
        return NullPolicy()
    if dcfg is None:
        raise ValueError(f"policy {name!r} needs a DaliConfig "
                         "(cost constants + scheduling geometry)")
    a, p, c = POLICY_COMPOSITIONS[name]
    return ComposedPolicy(
        name=name,
        assignment=_resolve_sub("assignment", assignment, a, ASSIGNMENTS),
        prefetch=_resolve_sub("prefetch", prefetch, p, PREFETCHES),
        cache=_resolve_sub("cache", cache, c, CACHES),
        dcfg=dcfg, top_k=top_k, router_type=router_type)
