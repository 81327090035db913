"""Expert prefetching strategies (paper §4.2).

A prefetcher predicts the *next* MoE layer's per-expert workload from
information available while the current layer executes, and the top
``prefetch_size`` predicted high-workload experts are transferred ahead of
time.  Accuracy metric (paper Table 2 / Fig. 16b): overlap between the
predicted and true top-k highest-workload expert sets.

  * ResidualPrefetcher    — the paper's method: correct the current gate
                            input with an offline-calibrated per-layer mean
                            residual (Eq. 10-11), then apply the next
                            layer's gate.
  * FeaturePrefetcher     — HybriMoE: same pipeline, no residual correction.
  * StatisticalPrefetcher — EdgeMoE: historical activation frequencies.
  * RandomPrefetcher      — stall-inducing lower bound (Fig. 16a).

A copy of ``repro/core/prefetch.py`` (numpy only), which the simulator
reads.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np

from repro_torch.models.config import MoEConfig


def _route_workload(h: np.ndarray, gate_w: np.ndarray, m: MoEConfig):
    """Replicate the router's top-k selection in numpy and count tokens per
    expert -> predicted workload vector (E,)."""
    logits = h.astype(np.float64) @ gate_w
    if m.router_type == "sigmoid":
        scores = 1.0 / (1.0 + np.exp(-logits))
    else:
        x = logits - logits.max(-1, keepdims=True)
        e = np.exp(x)
        scores = e / e.sum(-1, keepdims=True)
    k = m.top_k
    topk = np.argpartition(-scores, k - 1, axis=-1)[:, :k]
    counts = np.bincount(topk.reshape(-1), minlength=m.n_routed)
    return counts.astype(np.int64)


class BasePrefetcher:
    name = "base"

    def predict(self, layer: int, h: Optional[np.ndarray]) -> np.ndarray:
        raise NotImplementedError

    def observe(self, layer: int, workload: np.ndarray) -> None:
        pass


class ResidualPrefetcher(BasePrefetcher):
    """res_vecs[l] calibrated offline via core/residual.py; gate_ws[l]
    is layer l's router weight (d, E)."""

    name = "residual (DALI)"

    def __init__(self, gate_ws: List[np.ndarray], res_vecs: List[np.ndarray],
                 moe_cfg: MoEConfig):
        self.gate_ws = gate_ws
        self.res_vecs = res_vecs
        self.m = moe_cfg

    def predict(self, layer, h):
        if h is None or layer + 1 >= len(self.gate_ws):
            return np.zeros(self.m.n_routed, np.int64)
        h_tilde = h + self.res_vecs[layer][None, :]        # Eq. 10
        return _route_workload(h_tilde, self.gate_ws[layer + 1], self.m)


class FeaturePrefetcher(BasePrefetcher):
    name = "feature (HybriMoE)"

    def __init__(self, gate_ws, moe_cfg: MoEConfig):
        self.gate_ws = gate_ws
        self.m = moe_cfg

    def predict(self, layer, h):
        if h is None or layer + 1 >= len(self.gate_ws):
            return np.zeros(self.m.n_routed, np.int64)
        return _route_workload(h, self.gate_ws[layer + 1], self.m)


class StatisticalPrefetcher(BasePrefetcher):
    name = "statistical (EdgeMoE)"

    def __init__(self, n_layers: int, n_experts: int, decay: float = 1.0):
        self.counts = np.zeros((n_layers, n_experts), np.float64)
        self.decay = decay

    def observe(self, layer, workload):
        self.counts[layer] = self.decay * self.counts[layer] + workload

    def predict(self, layer, h):
        n_layers = self.counts.shape[0]
        if layer + 1 >= n_layers:
            return np.zeros(self.counts.shape[1], np.int64)
        return self.counts[layer + 1].copy()


class RandomPrefetcher(BasePrefetcher):
    name = "random"

    def __init__(self, n_experts: int, seed: int = 0):
        self.n = n_experts
        self.rng = np.random.default_rng(seed)

    def predict(self, layer, h):
        return self.rng.permutation(self.n).astype(np.float64)


def top_workload_experts(workload: np.ndarray, k: int) -> np.ndarray:
    """Indices of the k highest-workload experts (ties broken by index)."""
    k = min(k, workload.shape[0])
    order = np.lexsort((np.arange(len(workload)), -np.asarray(workload)))
    return order[:k]


def prefetch_accuracy(pred_workload: np.ndarray, true_workload: np.ndarray,
                      k: int) -> float:
    """|predicted top-k  ∩  true top-k| / k, counting only true experts with
    non-zero workload (paper Table 2 semantics)."""
    true_top = [e for e in top_workload_experts(true_workload, k)
                if true_workload[e] > 0]
    if not true_top:
        return 1.0
    pred_top = set(top_workload_experts(pred_workload, len(true_top)))
    return len(pred_top & set(true_top)) / len(true_top)
