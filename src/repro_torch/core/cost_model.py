"""Cost model for heterogeneous expert execution (paper §4.1, Eq. 4-6).

A copy of the parts of ``repro/core/cost_model.py`` that
``default_dali_config``, the simulator, the expert store and its link
watchdog read: the hardware profile of the paper's platform
(``LOCAL_PC``, the one entry of ``PROFILES``), ``CostModel.for_config`` / ``expert_bytes`` /
``trans_time`` and the per-expert times (``t_cpu``, ``t_gpu_compute``,
``t_gpu``, ``break_even_workload``), and the warm-up calibration the paper
describes: ``calibrate_cpu`` fits the CPU line from float32 FFN timings on
the host, ``calibrate_link`` fits the link constants from timed copies of
expert-sized pinned host buffers to the card (``fit_link_constants``
rejects a degenerate fit).  Link topologies between devices come with
expert parallelism (ROADMAP.md queue 1, "Expert parallelism").

All times are in seconds; workloads ``w`` are token counts per expert.
"""
from __future__ import annotations

import dataclasses
import time
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.models.config import ModelConfig


@dataclass(frozen=True)
class HardwareProfile:
    name: str
    cpu_gflops: float          # effective CPU GEMM throughput (f32/bf16 mix)
    cpu_dram_gbps: float       # host DRAM bandwidth (expert weights stream
                               # from DRAM: small-w expert FFN is mem-bound)
    gpu_gflops: float          # effective accelerator throughput
    gpu_hbm_gbps: float        # accelerator memory bandwidth
    link_gbps: float           # host->device link (PCIe / DMA)
    cpu_overhead_s: float      # fixed per-expert launch overhead on CPU
    gpu_overhead_s: float      # fixed per-expert launch overhead on GPU
    link_latency_s: float      # per-transfer latency


# Paper's platform: AMD EPYC 7532 (16 cores used) + RTX 3090 + PCIe4 x16.
LOCAL_PC = HardwareProfile(
    name="local-pc-3090",
    cpu_gflops=250.0,          # 16 cores x ~16 GFLOP/s effective GEMM
    cpu_dram_gbps=35.0,        # DDR4 8-ch, effective share of ~16 threads
    gpu_gflops=25_000.0,       # RTX 3090 bf16 tensor-core, effective
    gpu_hbm_gbps=800.0,        # of 936 peak
    link_gbps=25.0,            # of 32 peak (PCIe 4.0 x16)
    cpu_overhead_s=30e-6,
    gpu_overhead_s=15e-6,
    link_latency_s=20e-6,
)

# the reference's other profile, a TPU host's (``TPU_V5E_HOST``), describes
# no machine the port runs on and is not carried
PROFILES = {p.name: p for p in (LOCAL_PC,)}


def fit_link_constants(sizes_bytes, times_s,
                       profile: HardwareProfile | None = None):
    """Guarded least-squares fit of link constants from transfer timings.

    Returns ``(gbps, latency_s, rejected)``.  A degenerate fit — zero or
    negative per-byte slope (a larger buffer "finished faster") or negative
    latency — is *rejected* instead of clamped into nonsense constants: the
    returned constants fall back to ``profile``'s (or a median-throughput
    estimate when no profile is given) and ``rejected`` is True.
    """
    sizes = np.asarray(sizes_bytes, np.float64)
    times = np.asarray(times_s, np.float64)
    per_b, lat = np.nan, np.nan
    if sizes.size >= 2 and np.ptp(sizes) > 0:
        A = np.stack([sizes, np.ones_like(sizes)], axis=1)
        (per_b, lat), *_ = np.linalg.lstsq(A, times, rcond=None)
    rejected = (not np.isfinite(per_b) or not np.isfinite(lat)
                or per_b <= 0.0 or lat < 0.0)
    if rejected:
        if profile is not None:
            return profile.link_gbps, profile.link_latency_s, True
        med = float(np.median(times / np.maximum(sizes, 1.0)))
        return 1.0 / (max(med, 1e-12) * 1e9), 0.0, True
    return 1.0 / (float(per_b) * 1e9), float(lat), False


@dataclass
class CostModel:
    """Per-(model, hardware) cost tables for one MoE layer's experts."""

    profile: HardwareProfile
    d_model: int
    d_expert: int
    dtype_bytes: int = 2

    # fitted CPU line overrides (from calibrate_cpu)
    cpu_alpha: float | None = None
    cpu_beta: float | None = None   # seconds per token
    # fitted link overrides (from calibrate_link)
    link_gbps: float | None = None
    link_latency_s: float | None = None
    # True when calibrate_link measured a degenerate fit and fell back to
    # the hardware profile's constants
    link_fit_rejected: bool = False

    @classmethod
    def for_config(cls, cfg: ModelConfig,
                   profile: HardwareProfile = LOCAL_PC) -> "CostModel":
        if cfg.moe is None:
            raise ValueError("cost model applies to MoE layers "
                             "(cfg.moe is None)")
        return cls(profile=profile, d_model=cfg.d_model,
                   d_expert=cfg.moe.d_expert or cfg.d_ff,
                   dtype_bytes=2 if "16" in cfg.param_dtype else 4)

    @property
    def expert_bytes(self) -> float:
        return 3 * self.d_model * self.d_expert * self.dtype_bytes

    @property
    def trans_time(self) -> float:
        """Eq. 6: constant PCIe/DMA time to move one expert's weights
        (measured link constants from ``calibrate_link`` when fitted, else
        the hardware profile's)."""
        lat = (self.link_latency_s if self.link_latency_s is not None
               else self.profile.link_latency_s)
        gbps = (self.link_gbps if self.link_gbps is not None
                else self.profile.link_gbps)
        return lat + self.expert_bytes / (gbps * 1e9)

    def expert_flops(self, w) -> np.ndarray:
        return 6.0 * np.asarray(w, np.float64) * self.d_model * self.d_expert

    def t_cpu(self, w) -> np.ndarray:
        """Eq. 4 term: CPU execution time for workload w (0 if w == 0).
        max(FLOP-bound, DRAM-weight-read-bound): at small w the CPU streams
        the full expert weights from DRAM regardless of token count."""
        w = np.asarray(w, np.float64)
        if self.cpu_beta is not None:
            t = self.cpu_alpha + self.cpu_beta * w
        else:
            t_flop = self.expert_flops(w) / (self.profile.cpu_gflops * 1e9)
            t_mem = self.expert_bytes / (self.profile.cpu_dram_gbps * 1e9)
            t = self.profile.cpu_overhead_s + np.maximum(t_flop, t_mem)
        return np.where(w > 0, t, 0.0)

    def t_gpu_compute(self, w) -> np.ndarray:
        """Accelerator compute: max of FLOP-bound and weight-read-bound."""
        w = np.asarray(w, np.float64)
        t_flop = self.expert_flops(w) / (self.profile.gpu_gflops * 1e9)
        t_mem = self.expert_bytes / (self.profile.gpu_hbm_gbps * 1e9)
        t = self.profile.gpu_overhead_s + np.maximum(t_flop, t_mem)
        return np.where(w > 0, t, 0.0)

    def t_gpu(self, w, on_gpu) -> np.ndarray:
        """Eq. 5 term: max(transfer-unless-resident, compute) (pipelined)."""
        w = np.asarray(w, np.float64)
        trans = np.where(np.asarray(on_gpu, bool), 0.0, self.trans_time)
        t = np.maximum(trans, self.t_gpu_compute(w))
        return np.where(w > 0, t, 0.0)

    def break_even_workload(self, cached: bool = False) -> float:
        """Smallest workload where GPU execution (incl. transfer unless
        cached) beats CPU — the natural static threshold a Fiddler-style
        policy would profile."""
        for w in range(1, 1 << 16):
            if self.t_gpu(w, cached) < self.t_cpu(w):
                return float(w)
        return float(1 << 16)

    # -- warm-up profiling (paper §4.1: "obtained through warm-up
    #    profiling before execution") -------------------------------------
    def calibrate_cpu(self, workloads=(1, 4, 16, 64), repeats: int = 3):
        """Fit t_cpu(w) = alpha + beta*w from float32 FFN timings on this
        host's CPU."""
        d, f = self.d_model, self.d_expert
        wg = torch.ones((d, f), dtype=torch.float32)
        wd = torch.ones((f, d), dtype=torch.float32)

        def ffn(x):
            return (torch.nn.functional.silu(x @ wg) * (x @ wg)) @ wd

        ts = []
        for w in workloads:
            x = torch.ones((w, d), dtype=torch.float32)
            ffn(x)
            t0 = time.perf_counter()
            for _ in range(repeats):
                ffn(x)
            ts.append((time.perf_counter() - t0) / repeats)
        A = np.stack([np.ones(len(workloads)), np.asarray(workloads)], 1)
        (alpha, beta), *_ = np.linalg.lstsq(A, np.asarray(ts), rcond=None)
        return dataclasses.replace(self, cpu_alpha=float(max(alpha, 1e-6)),
                                   cpu_beta=float(max(beta, 1e-9)))

    def calibrate_link(self, n_experts=(1, 2, 4, 8), repeats: int = 5,
                       device="cuda"):
        """Fit trans_time(n) = latency + n·expert_bytes/(gbps·1e9) from timed
        copies of n expert-sized host buffers to ``device`` — pinned host
        memory to a card, the copy the physical offload path issues when it
        streams an expert into the slot pool.  Each copy is waited on before
        the clock stops.  Returns a copy of the model with the fitted
        ``link_gbps`` / ``link_latency_s`` (the profile's, and
        ``link_fit_rejected``, when the fit is degenerate)."""
        from repro_torch.device import pinned_empty, resolve_device
        dev = resolve_device(device)
        dt = torch.bfloat16 if self.dtype_bytes == 2 else torch.float32
        shape = (max(n_experts), 3, self.d_model, self.d_expert)
        src = (pinned_empty(shape, dt) if dev.type == "cuda"
               else torch.empty(shape, dtype=dt))
        src.fill_(1)
        dst = torch.empty(shape, dtype=dt, device=dev)

        def copy(n):
            dst[:n].copy_(src[:n], non_blocking=True)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)

        ts, sizes = [], []
        for n in n_experts:
            copy(n)                                        # warm-up
            t0 = time.perf_counter()
            for _ in range(repeats):
                copy(n)
            ts.append((time.perf_counter() - t0) / repeats)
            sizes.append(n * 3 * self.d_model * self.d_expert
                         * src.element_size())
        gbps, lat, rejected = fit_link_constants(sizes, ts, self.profile)
        return dataclasses.replace(
            self, link_latency_s=float(lat), link_gbps=float(gbps),
            link_fit_rejected=bool(rejected))
