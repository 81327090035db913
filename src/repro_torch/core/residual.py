"""Offline residual-vector calibration (paper §4.2, Eq. 11) and the
per-token cosine similarity of feature matrices (Table 8); a copy of
``repro/core/residual.py``.

``res_vec^(l) = mean_i( hidden_states_i^(l+1) - hidden_states_i^(l) )``
over a calibration dataset, where hidden_states^(l) is the input to layer
l's MoE gate.
"""
from __future__ import annotations

from typing import List

import numpy as np

from repro_torch.core.tracing import RoutingTrace


def calibrate_residuals(traces: List[RoutingTrace]) -> List[np.ndarray]:
    """Accumulate Eq. 11 over all steps of the given calibration traces.
    Returns res_vecs[l] (d,) for l = 0..L-1, with a zero vector in the
    final slot (the last layer predicts nothing)."""
    if not traces:
        raise ValueError("need at least one calibration trace")
    L = traces[0].n_moe_layers
    d = traces[0].gate_in[0][0].shape[-1]
    acc = [np.zeros(d, np.float64) for _ in range(L)]
    cnt = [0 for _ in range(L)]
    for tr in traces:
        for step in range(tr.n_steps):
            for l in range(L - 1):
                h_l = tr.gate_in[step][l]
                h_n = tr.gate_in[step][l + 1]
                acc[l] += (h_n.astype(np.float64)
                           - h_l.astype(np.float64)).sum(0)
                cnt[l] += h_l.shape[0]
    return [(acc[l] / max(cnt[l], 1)).astype(np.float32) for l in range(L)]


def cosine_similarity(a: np.ndarray, b: np.ndarray) -> float:
    """Mean per-token cosine similarity between feature matrices (Table 8)."""
    a = a.astype(np.float64)
    b = b.astype(np.float64)
    num = (a * b).sum(-1)
    den = np.linalg.norm(a, axis=-1) * np.linalg.norm(b, axis=-1) + 1e-12
    return float((num / den).mean())
