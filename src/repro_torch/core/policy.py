"""Offloading policies (port of the ``dali`` and ``none`` policies of
``repro/core/policy.py``).

The paper's three mechanisms — Greedy Assignment (Alg. 1), Residual-Based
Prefetching (Eq. 10-11) and Workload-Aware Cache Replacement (Alg. 2) —
compose into one policy with the reference's API::

  init(seed, device) -> state      a dict of tensors, stable across steps
  step(state, workloads, obs) -> (state', Decisions)

``step`` runs once per decode step on the serving device and never reads a
value back to the host, so the decode loop does not wait on it.  The state
layout is the reference's (``resident``, ``cache``, ``prefetch``, ``tick``,
``acc``), so ``repro_torch.bridge`` can carry a reference state over.

Ties follow ``lax.top_k`` and ``jnp.argsort`` (stable, lowest index first)
through stable sorts; float sums are float32 in the reference's order.
The reference's other registered policies (static, all_gpu, lru, score,
statistical, random) are ported later (ROADMAP.md, "other policies").
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import NamedTuple, Optional

import torch

from repro_torch.core.assignment import greedy_assign_torch
from repro_torch.core.cost_model import CostModel
from repro_torch.device import resolve_device

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
# Sub-policies of the "dali" composition
# --------------------------------------------------------------------------

class GreedyAssign:
    """Algorithm 1 (the paper's method) over every layer at once."""
    name = "greedy"

    def assign(self, w, tc, tg):
        return greedy_assign_torch(tc, tg)


class ResidualPrefetch:
    """The paper's residual-corrected gate replay (Eq. 10-11), stateless."""
    name = "residual"

    def init(self, dcfg: DaliConfig):
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


# --------------------------------------------------------------------------
# The composed policy
# --------------------------------------------------------------------------

@dataclass(frozen=True)
class ComposedPolicy:
    """OffloadPolicy built from the three sub-policies."""
    name: str
    assignment: GreedyAssign
    prefetch: ResidualPrefetch
    cache: WorkloadAwareCachePolicy
    dcfg: DaliConfig
    top_k: int
    router_type: str = "softmax_topk"
    schedules: bool = field(default=True, init=False)

    def init(self, seed: int = 0, device="cuda"):
        dev = resolve_device(device)
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        resident, cache_sub = self.cache.init(self.dcfg, gen, dev)
        return {
            "resident": resident,
            "cache": cache_sub,
            "prefetch": self.prefetch.init(self.dcfg),
            "tick": torch.zeros((), dtype=torch.int32, device=dev),
            "acc": _init_acc(dev),
        }

    def step(self, state, workloads, obs: Observation):
        """workloads (L, E) int; obs per :class:`Observation`.  Returns
        (state', Decisions), op for op the reference's ``step``."""
        dcfg = self.dcfg
        w = workloads.float()

        # --- prefetch: predictions for layers 1..L-1 ----------------------
        pf_sub, pf_pred = self.prefetch.predict(
            state["prefetch"], w, obs, dcfg, self.top_k, self.router_type)
        prefetched = _select_prefetch(pf_pred, dcfg.prefetch_size)

        # --- assignment against the effective resident set ----------------
        resident_eff = state["resident"] | prefetched
        tc = _t_cpu(w, dcfg)                                       # (L, E)
        tg = _t_gpu(w, resident_eff, dcfg)
        on_cpu, on_gpu, T_cpu, T_gpu = self.assignment.assign(w, tc, tg)

        # --- cache replacement --------------------------------------------
        tick = state["tick"] + 1
        gpu_active = on_gpu & (workloads > 0)
        resident_new, cache_sub, n_swaps = self.cache.update(
            state["cache"], state["resident"], w, gpu_active, tick, dcfg)

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

POLICY_COMPOSITIONS = {"dali": ("greedy", "residual", "workload")}
# registered in the reference, ported in a later slice
NOT_PORTED = ("all_gpu", "lru", "random", "score", "static", "statistical")


def policy_names():
    return sorted(POLICY_COMPOSITIONS) + ["none"]


def make_policy(name: str, dcfg: Optional[DaliConfig] = None, *,
                top_k: int = 1, router_type: str = "softmax_topk"):
    """Build the "dali" policy or the null policy "none"."""
    if name in NOT_PORTED:
        raise NotImplementedError(
            f"policy {name!r} is ported with the other policies "
            "(ROADMAP.md, 'other policies and the wave server')")
    if name not in POLICY_COMPOSITIONS and name != "none":
        raise ValueError(f"policy must be one of "
                         f"{'|'.join(policy_names())}, got {name!r}")
    if name == "none":
        return NullPolicy()
    if dcfg is None:
        raise ValueError(f"policy {name!r} needs a DaliConfig "
                         "(cost constants + scheduling geometry)")
    return ComposedPolicy(name=name, assignment=GreedyAssign(),
                          prefetch=ResidualPrefetch(),
                          cache=WorkloadAwareCachePolicy(),
                          dcfg=dcfg, top_k=top_k, router_type=router_type)
