"""Expert-to-device assignment (paper §4.1, Algorithm 1).

The port of ``repro/core/assignment.py::greedy_assign_jnp``, the in-graph
form the serving engine runs.  The exact and baseline solvers of the
reference are host tools of the simulator and are ported with it.
"""
from __future__ import annotations

import torch


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
