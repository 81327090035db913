"""DALI engine helpers around the policy step (port of
``repro/core/engine.py``): the legacy flat-state wrappers over the
registered ``dali`` policy (``init_dali_state``, ``dali_schedule``),
live-slot workload recounting and the host-side telemetry aggregator.

The aggregator is sync-free per step, as in the reference: ``observe``
keeps a handle to the policy state's device accumulator and the host reads
it once per ``flush_interval`` steps.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import torch

from repro_torch.core.policy import (DaliConfig, Observation,  # noqa: F401
                                     _init_acc, _random_resident,
                                     make_policy)
from repro_torch.device import resolve_device
from repro_torch.spans import span


def init_dali_state(dcfg: DaliConfig, gen=None, device="cuda"):
    """Legacy flat DALI state: {resident, scores, tick, acc}.

    ``resident`` (L, E) bool is the cache seeded with ``cache_size`` random
    experts per layer, drawn from ``gen`` (a ``torch.Generator`` on
    ``device``; default: one seeded with 0; the draws differ from the
    reference's ``jax.random``).  ``acc`` is the device-side telemetry
    accumulator that ``TelemetryAggregator`` drains.  New code builds a
    policy's state with ``make_policy(...).init()``."""
    dev = resolve_device(device)
    if gen is None:
        gen = torch.Generator(device=dev)
        gen.manual_seed(0)
    L, E = dcfg.n_moe_layers, dcfg.n_experts
    return {
        "resident": _random_resident(dcfg, gen, dev),
        "scores": torch.zeros((L, E), dtype=torch.float32, device=dev),
        "tick": torch.zeros((), dtype=torch.int32, device=dev),
        "acc": _init_acc(dev),
    }


def dali_schedule(state, workloads, gate_in, routers, res_vecs,
                  dcfg: DaliConfig, top_k: int,
                  router_type: str = "softmax_topk", token_mask=None):
    """One serve step of DALI scheduling on the legacy flat state (a
    wrapper over the registered "dali" policy).  workloads (L, E) int;
    gate_in (L, T, d); routers (L, d, E); res_vecs (L, d); ``token_mask``
    (T,) bool restricts prefetch prediction to live tokens.  Returns
    (new_state, telemetry dict) on ``init_dali_state``'s layout."""
    pol = make_policy("dali", dcfg, top_k=top_k, router_type=router_type)
    pstate = {"resident": state["resident"],
              "cache": {"scores": state["scores"]},
              "prefetch": {},
              "tick": state["tick"]}
    if "acc" in state:
        pstate["acc"] = state["acc"]
    obs = Observation(gate_in=gate_in, routers=routers, res_vecs=res_vecs,
                      token_mask=token_mask)
    new, decisions = pol.step(pstate, workloads, obs)
    out = {"resident": new["resident"],
           "scores": new["cache"]["scores"],
           "tick": new["tick"]}
    if "acc" in new:
        out["acc"] = new["acc"]
    return out, decisions.tel


def masked_workloads(topk_idx, n_experts: int, token_mask):
    """Per-expert token counts from per-token routing choices, restricted
    to live slots.  topk_idx (L, T, K), token_mask (T,) bool -> (L, E)
    int32: the scheduler sees the actual per-step token mix under
    continuous batching instead of counting tokens of empty slots."""
    L, T, K = topk_idx.shape
    live = token_mask.to(torch.int32)[None, :, None].expand(L, T, K)
    counts = torch.zeros((L, n_experts), dtype=torch.int32,
                         device=topk_idx.device)
    return counts.scatter_add_(1, topk_idx.reshape(L, -1).long(),
                               live.reshape(L, -1))


@dataclass
class TelemetryAggregator:
    """Host-side view of policy telemetry across a serve run whose batch
    composition changes every step.

    ``observe`` once per decode step records the host-known counters
    (steps, live tokens) and keeps a handle to the device accumulator
    (``policy_state["acc"]``): no device-to-host copy.  Every
    ``flush_interval`` observed steps (and at ``flush``/``end_epoch``) the
    accumulator is read with one copy and the deltas land in the totals."""
    flush_interval: int = 16
    steps: int = 0
    moe_time_est: float = 0.0
    link_time_est: float = 0.0
    hits: int = 0
    misses: int = 0
    swaps: int = 0
    active_tokens: int = 0
    _pending: object = field(default=None, repr=False)
    _prev: dict = field(default_factory=dict, repr=False)
    _since_flush: int = field(default=0, repr=False)

    def observe(self, policy_state, n_active=None) -> int:
        """Per decode step, sync-free but every ``flush_interval``-th.
        No-op when scheduling is off.  Returns the host reads made
        (``flush``)."""
        acc = policy_state.get("acc") if policy_state else None
        if acc is None:
            return 0
        self.steps += 1
        if n_active is not None:
            self.active_tokens += int(n_active)
        self._pending = acc
        self._since_flush += 1
        if self._since_flush >= self.flush_interval:
            return self.flush()
        return 0

    @span("policy.telemetry_flush")
    def flush(self) -> int:
        """Drain the last observed device accumulator: one read back per
        counter, the first of which waits on the card.  Returns the number
        of reads (0 with nothing pending)."""
        if self._pending is None:
            return 0
        acc = {k: v.cpu() for k, v in self._pending.items()}
        for attr, key, cast in (("moe_time_est", "moe_time", float),
                                ("link_time_est", "link_time", float),
                                ("hits", "hits", int),
                                ("misses", "misses", int),
                                ("swaps", "swaps", int)):
            cur = float(acc[key])
            setattr(self, attr,
                    getattr(self, attr) + cast(cur - self._prev.get(key, 0)))
            self._prev[key] = cur
        self._pending = None
        self._since_flush = 0
        return len(acc)

    def end_epoch(self) -> int:
        """Flush and re-base: the next observed policy state starts its
        accumulator from zero.  Returns ``flush``'s reads."""
        n = self.flush()
        self._prev = {}
        return n

    @property
    def lookups(self) -> int:
        return self.hits + self.misses

    def hit_rate(self) -> float:
        return self.hits / self.lookups if self.lookups else 0.0

    def summary(self) -> str:
        if not self.steps:
            return ""
        return (f"DALI est: moe={self.moe_time_est:.3f}s "
                f"link={self.link_time_est:.3f}s "
                f"hit%={100 * self.hit_rate():.1f}")
