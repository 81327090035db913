"""Cost model for heterogeneous expert execution (paper §4.1, Eq. 4-6).

A copy of the parts of ``repro/core/cost_model.py`` that
``default_dali_config`` and the simulator read: the hardware profile of the
paper's platform (``LOCAL_PC``), ``CostModel.for_config`` /
``expert_bytes`` / ``trans_time`` and the per-expert times (``t_cpu``,
``t_gpu_compute``, ``t_gpu``, ``break_even_workload``).  Calibration
(``calibrate_cpu``, ``calibrate_link``), link topologies and the TPU
profile come with fault tolerance (ROADMAP.md queue item 3).

All times are in seconds; workloads ``w`` are token counts per expert.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

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


@dataclass
class CostModel:
    """Per-(model, hardware) cost tables for one MoE layer's experts."""

    profile: HardwareProfile
    d_model: int
    d_expert: int
    dtype_bytes: int = 2

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
        """Eq. 6: constant PCIe/DMA time to move one expert's weights."""
        return (self.profile.link_latency_s
                + self.expert_bytes / (self.profile.link_gbps * 1e9))

    def expert_flops(self, w) -> np.ndarray:
        return 6.0 * np.asarray(w, np.float64) * self.d_model * self.d_expert

    def t_cpu(self, w) -> np.ndarray:
        """Eq. 4 term: CPU execution time for workload w (0 if w == 0).
        max(FLOP-bound, DRAM-weight-read-bound): at small w the CPU streams
        the full expert weights from DRAM regardless of token count."""
        w = np.asarray(w, np.float64)
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
