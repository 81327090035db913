"""GPU expert-cache replacement policies (paper §4.3, Algorithm 2).

Each MoE layer owns one cache of ``cache_size`` expert slots in device
memory; all experts also reside in host memory.  A policy decides which
experts stay resident.  Replacements cost one host->device transfer each —
the simulator charges them to the link.

  * WorkloadAwareCache — the paper's policy: accumulate per-expert workload
    scores over a sliding window of ``w_size`` tokens; every window swap the
    ``u_size`` lowest-scoring residents for the ``u_size`` highest-scoring
    non-residents, then reset scores.
  * LRUCache           — FastMoE-style least-recently-used.
  * ScoreCache         — HybriMoE: activation-score (gate-probability EMA)
    driven replacement.
  * StaticCache        — never replaces (ablation lower bound).

A copy of ``repro/core/cache.py`` (numpy only), which the simulator reads.
"""
from __future__ import annotations

import numpy as np


class BaseCache:
    name = "base"

    def __init__(self, n_experts: int, cache_size: int, seed: int = 0):
        self.n = n_experts
        self.size = min(cache_size, n_experts)
        rng = np.random.default_rng(seed)
        # paper §4: initial residents chosen randomly
        self.resident = np.zeros(n_experts, bool)
        self.resident[rng.choice(n_experts, self.size, replace=False)] = True
        self.transfers = 0                 # replacement-driven transfers

    def hit(self, expert: int) -> bool:
        return bool(self.resident[expert])

    def resident_set(self) -> np.ndarray:
        return np.where(self.resident)[0]

    # called once per token (decode) or per step with that step's stats
    def observe(self, workload: np.ndarray, gates: np.ndarray | None = None,
                used_on_gpu: np.ndarray | None = None) -> int:
        """Update policy state; returns #transfers this update performed."""
        return 0

    def insert(self, expert: int) -> None:
        """Opportunistic insert after a demand fetch (policy-specific)."""
        pass


class WorkloadAwareCache(BaseCache):
    name = "workload-aware (DALI)"

    def __init__(self, n_experts, cache_size, w_size: int = 4,
                 u_size: int = 1, seed: int = 0):
        super().__init__(n_experts, cache_size, seed)
        self.w_size = w_size
        self.u_size = u_size
        self.scores = np.zeros(n_experts, np.float64)   # Alg. 2 line 1
        self._tick = 0

    def observe(self, workload, gates=None, used_on_gpu=None) -> int:
        self.scores += workload                          # Alg. 2 line 6
        self._tick += 1
        if self._tick % self.w_size:
            return 0
        # window boundary: swap u_size in, u_size out (Alg. 2 lines 10-14)
        res = np.where(self.resident)[0]
        off = np.where(~self.resident)[0]
        u = min(self.u_size, len(res), len(off))
        if u == 0:
            self.scores[:] = 0.0
            return 0
        off_sorted = off[np.argsort(-self.scores[off], kind="stable")]
        res_sorted = res[np.argsort(self.scores[res], kind="stable")]
        incoming = off_sorted[:u]
        outgoing = res_sorted[:u]
        # only swap where the incoming expert actually outscores the victim
        swaps = 0
        for inc, out in zip(incoming, outgoing):
            if self.scores[inc] > self.scores[out]:
                self.resident[out] = False
                self.resident[inc] = True
                swaps += 1
        self.scores[:] = 0.0                             # Alg. 2 line 15
        self.transfers += swaps
        return swaps


class LRUCache(BaseCache):
    name = "LRU"

    def __init__(self, n_experts, cache_size, seed: int = 0):
        super().__init__(n_experts, cache_size, seed)
        self.stamp = np.zeros(n_experts, np.int64)
        self._t = 0

    def observe(self, workload, gates=None, used_on_gpu=None) -> int:
        self._t += 1
        used = np.where(np.asarray(workload) > 0)[0] if used_on_gpu is None \
            else np.where(used_on_gpu)[0]
        swaps = 0
        for e in used:
            if self.resident[e]:
                self.stamp[e] = self._t
            else:
                res = np.where(self.resident)[0]
                victim = res[np.argmin(self.stamp[res])]
                self.resident[victim] = False
                self.resident[e] = True
                self.stamp[e] = self._t
                swaps += 1
        self.transfers += 0    # demand fetches already paid; not extra
        return 0


class ScoreCache(BaseCache):
    """HybriMoE-style: EMA of activation scores drives replacement."""

    name = "score (HybriMoE)"

    def __init__(self, n_experts, cache_size, decay: float = 0.7,
                 seed: int = 0):
        super().__init__(n_experts, cache_size, seed)
        self.score = np.zeros(n_experts, np.float64)
        self.decay = decay

    def observe(self, workload, gates=None, used_on_gpu=None) -> int:
        s = np.asarray(gates if gates is not None else workload, np.float64)
        self.score = self.decay * self.score + s
        used = np.where(np.asarray(workload) > 0)[0]
        swaps = 0
        for e in used:
            if self.resident[e]:
                continue
            res = np.where(self.resident)[0]
            victim = res[np.argmin(self.score[res])]
            if self.score[e] > self.score[victim]:
                self.resident[victim] = False
                self.resident[e] = True
                swaps += 1
        return 0           # swaps ride along with the demand fetch


class StaticCache(BaseCache):
    name = "static"


POLICIES = {
    "workload": WorkloadAwareCache,
    "lru": LRUCache,
    "score": ScoreCache,
    "static": StaticCache,
}
