"""Expert-to-device assignment strategies (paper §4.1, Algorithm 1).

The optimisation: ``min max(T_cpu, T_gpu)`` over binary assignment vectors
(C, G) subject to each *activated* expert going to exactly one device
(Eqs. 3-9): makespan minimisation on two unrelated machines, NP-hard in
general, which the paper solves with a greedy heuristic.

  * ``greedy_assign_torch`` — Algorithm 1 over every layer at once on
                              tensors, the form the serving policy runs
  * ``greedy_assign``       — Algorithm 1, host-side numpy (the simulator)
  * ``optimal_assign``      — exact for small N (branch & bound), else a
                              DP over discretised CPU time ("Opt_plan")
  * ``beam_search_assign``  — Appendix A.2 baseline
  * ``static_assign``       — Fiddler/HybriMoE workload-threshold policy
  * ``all_cpu`` / ``all_gpu`` — degenerate baselines ("Naive")

The numpy solvers are copies of ``repro/core/assignment.py``'s.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


@dataclass
class Assignment:
    on_cpu: np.ndarray      # bool (N,)
    on_gpu: np.ndarray      # bool (N,)
    t_cpu: float            # sum of CPU expert times
    t_gpu: float
    solve_time: float = 0.0

    @property
    def makespan(self) -> float:
        return max(self.t_cpu, self.t_gpu)

    @property
    def imbalance(self) -> float:
        hi = max(self.t_cpu, self.t_gpu)
        return (hi - min(self.t_cpu, self.t_gpu)) / (hi + 1e-12)


def _finish(C, G, tc, tg, solve_time=0.0) -> Assignment:
    return Assignment(C, G, float(tc[C].sum()), float(tg[G].sum()),
                      solve_time)


# --------------------------------------------------------------------------
# Algorithm 1: Greedy Assignment
# --------------------------------------------------------------------------

def greedy_assign(t_cpu: np.ndarray, t_gpu: np.ndarray) -> Assignment:
    """t_cpu/t_gpu: per-expert execution times (0 for inactive experts)."""
    tc = np.asarray(t_cpu, np.float64)
    tg = np.asarray(t_gpu, np.float64)
    N = tc.shape[0]
    C = np.zeros(N, bool)
    G = np.zeros(N, bool)
    Tc = Tg = 0.0
    order = np.argsort(-np.abs(tg - tc), kind="stable")
    for idx in order:
        if tc[idx] == 0.0 and tg[idx] == 0.0:
            continue                                    # not activated
        if Tg + tg[idx] <= Tc + tc[idx]:
            G[idx] = True
            Tg += tg[idx]
        else:
            C[idx] = True
            Tc += tc[idx]
    return Assignment(C, G, Tc, Tg)


def greedy_assign_torch(t_cpu, t_gpu):
    """Algorithm 1 over every layer at once: t_cpu / t_gpu (L, E) -> (on_cpu,
    on_gpu) bool (L, E) and the accumulated (T_cpu, T_gpu) (L,).

    Experts are visited in the reference's order (a stable sort on
    ``-|t_gpu - t_cpu|``) and the running sums are float32 in the
    reference's order of additions, so every decision matches it.  The loop
    runs over the E sorted positions on (L,) tensors: nothing leaves the
    device."""
    tc = t_cpu.float()
    tg = t_gpu.float()
    L, E = tc.shape
    _, order = torch.sort(-(tg - tc).abs(), dim=-1, stable=True)
    on_cpu = torch.zeros((L, E), dtype=torch.bool, device=tc.device)
    on_gpu = torch.zeros_like(on_cpu)
    Tc = torch.zeros((L,), dtype=torch.float32, device=tc.device)
    Tg = torch.zeros_like(Tc)
    for i in range(E):
        idx = order[:, i:i + 1]                                 # (L, 1)
        tci = tc.gather(1, idx)[:, 0]
        tgi = tg.gather(1, idx)[:, 0]
        active = (tci > 0) | (tgi > 0)
        to_gpu = active & (Tg + tgi <= Tc + tci)
        to_cpu = active & ~to_gpu
        Tg = Tg + torch.where(to_gpu, tgi, 0.0)
        Tc = Tc + torch.where(to_cpu, tci, 0.0)
        on_gpu.scatter_(1, idx, to_gpu[:, None])
        on_cpu.scatter_(1, idx, to_cpu[:, None])
    return on_cpu, on_gpu, Tc, Tg


# --------------------------------------------------------------------------
# Exact / near-exact solvers
# --------------------------------------------------------------------------

def optimal_assign(t_cpu, t_gpu, exact_limit: int = 18,
                   grid: int = 4096) -> Assignment:
    """Exact branch & bound for ≤ exact_limit activated experts, else a
    pseudo-polynomial DP over discretised CPU time (error ≤ T_cpu_max/grid)."""
    tc = np.asarray(t_cpu, np.float64)
    tg = np.asarray(t_gpu, np.float64)
    act = np.where((tc > 0) | (tg > 0))[0]
    n = len(act)
    N = tc.shape[0]
    C = np.zeros(N, bool)
    G = np.zeros(N, bool)
    if n == 0:
        return _finish(C, G, tc, tg)
    if n <= exact_limit:
        best = [np.inf, 0]
        # order by descending max time for better pruning
        order = act[np.argsort(-np.maximum(tc[act], tg[act]))]
        tcs, tgs = tc[order], tg[order]
        suffix_min = np.zeros(n + 1)

        def dfs(i, Tc, Tg, mask):
            if max(Tc, Tg) >= best[0]:
                return
            if i == n:
                best[0] = max(Tc, Tg)
                best[1] = mask
                return
            # try the device that keeps the makespan lower first
            if Tc + tcs[i] <= Tg + tgs[i]:
                dfs(i + 1, Tc + tcs[i], Tg, mask | (1 << i))
                dfs(i + 1, Tc, Tg + tgs[i], mask)
            else:
                dfs(i + 1, Tc, Tg + tgs[i], mask)
                dfs(i + 1, Tc + tcs[i], Tg, mask | (1 << i))

        dfs(0, 0.0, 0.0, 0)
        for i in range(n):
            if best[1] >> i & 1:
                C[order[i]] = True
            else:
                G[order[i]] = True
        return _finish(C, G, tc, tg)

    # DP: dp[b] = min achievable T_gpu with discretised T_cpu == b
    tc_max = tc[act].sum()
    step = tc_max / grid if tc_max > 0 else 1.0
    NEG = np.inf
    dp = np.full(grid + 1, NEG)
    dp[0] = 0.0
    choice = np.zeros((n, grid + 1), bool)   # True = CPU
    for i, e in enumerate(act):
        db = max(1, int(round(tc[e] / step))) if tc[e] > 0 else 0
        new = dp + tg[e]                     # put on GPU
        shifted = np.full(grid + 1, NEG)
        if db <= grid:
            shifted[db:] = dp[:grid + 1 - db]
        take_cpu = shifted < new
        choice[i] = take_cpu
        dp = np.where(take_cpu, shifted, new)
    b_best = int(np.argmin(np.maximum(np.arange(grid + 1) * step, dp)))
    b = b_best
    for i in range(n - 1, -1, -1):
        e = act[i]
        if choice[i][b]:
            C[e] = True
            db = max(1, int(round(tc[e] / step))) if tc[e] > 0 else 0
            b -= db
        else:
            G[e] = True
    return _finish(C, G, tc, tg)


def beam_search_assign(t_cpu, t_gpu, beam: int = 2) -> Assignment:
    """Appendix A.2: beam search scored by current makespan."""
    tc = np.asarray(t_cpu, np.float64)
    tg = np.asarray(t_gpu, np.float64)
    act = np.where((tc > 0) | (tg > 0))[0]
    order = act[np.argsort(-np.abs(tg[act] - tc[act]))]
    beams = [(0.0, 0.0, 0)]                  # (Tc, Tg, cpu_mask over order)
    for i, e in enumerate(order):
        cand = []
        for Tc, Tg, mask in beams:
            cand.append((Tc + tc[e], Tg, mask | (1 << i)))
            cand.append((Tc, Tg + tg[e], mask))
        cand.sort(key=lambda s: max(s[0], s[1]))
        beams = cand[:beam]
    Tc, Tg, mask = beams[0]
    N = tc.shape[0]
    C = np.zeros(N, bool)
    G = np.zeros(N, bool)
    for i, e in enumerate(order):
        if mask >> i & 1:
            C[e] = True
        else:
            G[e] = True
    return _finish(C, G, tc, tg)


# --------------------------------------------------------------------------
# Baseline policies
# --------------------------------------------------------------------------

def static_assign(workloads, t_cpu, t_gpu, threshold: float) -> Assignment:
    """Fiddler/HybriMoE: workload > threshold -> GPU, else CPU."""
    w = np.asarray(workloads)
    tc = np.asarray(t_cpu, np.float64)
    tg = np.asarray(t_gpu, np.float64)
    G = (w > threshold)
    C = (w > 0) & ~G
    return _finish(C, G, tc, tg)


def all_cpu(t_cpu, t_gpu) -> Assignment:
    tc = np.asarray(t_cpu, np.float64)
    tg = np.asarray(t_gpu, np.float64)
    C = tc > 0
    return _finish(C, np.zeros_like(C), tc, tg)


def all_gpu(t_cpu, t_gpu) -> Assignment:
    tc = np.asarray(t_cpu, np.float64)
    tg = np.asarray(t_gpu, np.float64)
    G = tg > 0
    return _finish(np.zeros_like(G), G, tc, tg)
