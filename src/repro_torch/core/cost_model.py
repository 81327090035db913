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
rejects a degenerate fit).  Expert parallelism prices the links between
devices per ordered pair: ``LinkTopology`` (homogeneous, island
hierarchies, directed degradation, each device's connectivity),
``parse_topology`` (the ``--topology`` grammar), ``fit_topology`` /
``calibrate_links`` (per-pair refits from timed copies between torch
devices) and ``CostModel.with_topology`` / ``for_link`` /
``trans_time_for``.

All times are in seconds; workloads ``w`` are token counts per expert.
"""
from __future__ import annotations

import dataclasses
import re
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


class TopologyParseError(ValueError):
    """Malformed ``--topology`` spec (typed so callers can catch it)."""


@dataclass
class LinkTopology:
    """Per-ordered-pair link constants for an n-device fabric.

    ``gbps[i, j]`` / ``latency_s[i, j]`` describe the directed link
    i -> j; the diagonal is unused (a device never ships to itself).
    ``rejected[i, j]`` records pairs whose calibration fit was
    degenerate and kept the prior constants (mirrors
    ``CostModel.link_fit_rejected`` per link).  Hierarchical fabrics
    (NVLink island + inter-host PCIe/NIC) come from
    :meth:`hierarchical`; a measured topology from
    :func:`calibrate_links`; a fault-degraded view from
    :meth:`degrade`.
    """

    gbps: np.ndarray
    latency_s: np.ndarray
    rejected: np.ndarray
    name: str = "flat"

    @property
    def n(self) -> int:
        return int(self.gbps.shape[0])

    @classmethod
    def homogeneous(cls, n: int, gbps: float, latency_s: float,
                    name: str = "flat") -> "LinkTopology":
        return cls(gbps=np.full((n, n), float(gbps)),
                   latency_s=np.full((n, n), float(latency_s)),
                   rejected=np.zeros((n, n), bool), name=name)

    @classmethod
    def hierarchical(cls, n: int, island: int, *,
                     intra_gbps: float, inter_gbps: float,
                     intra_latency_s: float,
                     inter_latency_s: float) -> "LinkTopology":
        """Islands of ``island`` devices with fast intra-island links
        (NVLink-class) and slower inter-island links (PCIe/NIC-class)."""
        if island <= 0 or n % island:
            raise TopologyParseError(
                f"island size {island} must divide n_devices {n}")
        isl = np.arange(n) // island
        same = isl[:, None] == isl[None, :]
        t = cls.homogeneous(n, inter_gbps, inter_latency_s,
                            name=f"island:{island}")
        t.gbps[same] = float(intra_gbps)
        t.latency_s[same] = float(intra_latency_s)
        return t

    def pair(self, src: int, dst: int):
        """(gbps, latency_s) of the directed link src -> dst."""
        return float(self.gbps[src, dst]), float(self.latency_s[src, dst])

    def pairs(self):
        """All ordered (src, dst) pairs, src != dst."""
        n = self.n
        return [(i, j) for i in range(n) for j in range(n) if i != j]

    def pair_time(self, src: int, dst: int, nbytes) -> float:
        """Directed transfer time (Eq. 6 per link); 0 for src == dst."""
        if src == dst:
            return 0.0
        g, lat = self.pair(src, dst)
        return lat + float(nbytes) / (g * 1e9)

    def with_pair(self, src: int, dst: int, gbps: float, latency_s: float,
                  rejected: bool = False) -> "LinkTopology":
        t = self.copy()
        t.gbps[src, dst] = float(gbps)
        t.latency_s[src, dst] = float(latency_s)
        t.rejected[src, dst] = bool(rejected)
        return t

    def degrade(self, src: int, dst: int, factor: float) -> "LinkTopology":
        """Directed slowdown by ``factor`` (bandwidth /x, latency *x)."""
        g, lat = self.pair(src, dst)
        return self.with_pair(src, dst, g / float(factor),
                              lat * float(factor))

    def copy(self) -> "LinkTopology":
        return LinkTopology(gbps=self.gbps.copy(),
                            latency_s=self.latency_s.copy(),
                            rejected=self.rejected.copy(), name=self.name)

    def device_quality(self) -> np.ndarray:
        """Per-device connectivity score: sum over peers of the
        bidirectional bottleneck bandwidth min(gbps[k, j], gbps[j, k]).
        A degraded link drags BOTH endpoints down, which is what the
        greedy placement ranks against (models/moe_ep.solve_placement)."""
        n = self.n
        bidir = np.minimum(self.gbps, self.gbps.T)
        off = ~np.eye(n, dtype=bool)
        return np.where(off, bidir, 0.0).sum(axis=1)

    def is_uniform(self, rtol: float = 1e-6) -> bool:
        q = self.device_quality()
        return bool(np.ptp(q) <= rtol * max(float(np.abs(q).max()), 1e-12))


_TOPO_PAIR_RE = re.compile(
    r"^(\d+)>(\d+):(?:x([0-9.]+)|g([0-9.]+)(?::l([0-9.]+))?)$")


def parse_topology(spec, n_devices: int,
                   profile: HardwareProfile = LOCAL_PC) -> LinkTopology:
    """Parse a ``--topology`` spec string into a :class:`LinkTopology`.

    Grammar (comma-separated; first item is the base, rest are
    per-directed-pair overrides)::

        base      := "flat" | "island:K"
        override  := SRC>DST:xFACTOR        (slow the pair down by xFACTOR)
                   | SRC>DST:gGBPS[:lLAT_US] (set constants directly)

    e.g. ``island:4,0>5:x8`` — two 4-device islands with the directed
    0->5 link 8x slower.  ``None``/empty -> homogeneous at the hardware
    profile's link constants.  Already-built topologies pass through.
    Malformed specs raise :class:`TopologyParseError`.
    """
    if spec is None or isinstance(spec, LinkTopology):
        return spec if spec is not None else LinkTopology.homogeneous(
            n_devices, profile.link_gbps, profile.link_latency_s)
    items = [s.strip() for s in str(spec).split(",") if s.strip()]
    if not items:
        return LinkTopology.homogeneous(
            n_devices, profile.link_gbps, profile.link_latency_s)
    base, overrides = items[0], items[1:]
    if base == "flat":
        topo = LinkTopology.homogeneous(
            n_devices, profile.link_gbps, profile.link_latency_s)
    elif base.startswith("island:"):
        try:
            k = int(base.split(":", 1)[1])
        except ValueError as e:
            raise TopologyParseError(f"bad island size in {base!r}") from e
        # intra-island: NVLink-class (8x the profile link, 1/4 latency)
        topo = LinkTopology.hierarchical(
            n_devices, k,
            intra_gbps=8 * profile.link_gbps,
            inter_gbps=profile.link_gbps,
            intra_latency_s=profile.link_latency_s / 4,
            inter_latency_s=profile.link_latency_s)
    elif _TOPO_PAIR_RE.match(base):
        overrides, topo = items, LinkTopology.homogeneous(
            n_devices, profile.link_gbps, profile.link_latency_s)
    else:
        raise TopologyParseError(
            f"bad topology base {base!r}: expected 'flat', 'island:K' or "
            f"a SRC>DST override")
    for ov in overrides:
        m = _TOPO_PAIR_RE.match(ov)
        if m is None:
            raise TopologyParseError(
                f"bad topology override {ov!r}: expected "
                f"'SRC>DST:xFACTOR' or 'SRC>DST:gGBPS[:lLAT_US]'")
        src, dst = int(m.group(1)), int(m.group(2))
        if not (0 <= src < n_devices and 0 <= dst < n_devices) \
                or src == dst:
            raise TopologyParseError(
                f"topology override {ov!r}: pair out of range for "
                f"{n_devices} devices")
        if m.group(3) is not None:
            topo = topo.degrade(src, dst, float(m.group(3)))
        else:
            g = float(m.group(4))
            lat = (float(m.group(5)) * 1e-6 if m.group(5) is not None
                   else topo.pair(src, dst)[1])
            topo = topo.with_pair(src, dst, g, lat)
    return topo


def fit_topology(prior: LinkTopology, samples: dict) -> LinkTopology:
    """Pure per-pair refit: ``samples`` maps (src, dst) ->
    (sizes_bytes, times_s).  Degenerate fits keep the prior pair's
    constants and are recorded in ``rejected`` (same contract as
    :func:`fit_link_constants`); unmeasured pairs keep the prior."""
    topo = prior.copy()
    for (src, dst), (sizes, times) in samples.items():
        gbps, lat, rejected = fit_link_constants(sizes, times)
        if rejected:
            topo.rejected[src, dst] = True
        else:
            topo = topo.with_pair(src, dst, gbps, lat)
    return topo


def measure_pair_times(sizes_bytes, repeats: int = 3, devices=None,
                       dtype=torch.float32) -> dict:
    """Time a copy between every ordered pair of torch devices (``cuda:i``
    to ``cuda:j``) at each buffer size: the transfer a cross-device expert
    re-route issues.  Each copy is waited on before the clock stops.
    Returns the :func:`fit_topology` samples dict."""
    devs = [torch.device(d) for d in (
        devices if devices is not None
        else [f"cuda:{i}" for i in range(torch.cuda.device_count())])]

    def sync():
        for d in devs:
            if d.type == "cuda":
                torch.cuda.synchronize(d)

    itemsize = torch.empty((), dtype=dtype).element_size()
    samples = {}
    for i, src in enumerate(devs):
        for j, dst in enumerate(devs):
            if i == j:
                continue
            ts = []
            for nb in sizes_bytes:
                buf = torch.ones(max(1, int(nb) // itemsize), dtype=dtype,
                                 device=src)
                buf.to(dst)                                # warm-up
                sync()
                t0 = time.perf_counter()
                for _ in range(repeats):
                    buf.to(dst)
                    sync()
                ts.append((time.perf_counter() - t0) / repeats)
            samples[(i, j)] = (list(sizes_bytes), ts)
    return samples


def calibrate_links(prior: LinkTopology, *, sizes_bytes=None,
                    repeats: int = 3, devices=None) -> LinkTopology:
    """Measured per-pair generalization of ``CostModel.calibrate_link``:
    fit each ordered pair's (gbps, latency) from timed device-to-device
    copies (:func:`measure_pair_times`), keeping the prior (and recording
    the rejection) wherever the fit is degenerate.  With fewer than two
    devices there is no pair to time and the prior comes back (a copy)."""
    devs = list(devices if devices is not None
                else [f"cuda:{i}" for i in range(torch.cuda.device_count())])
    if len(devs) < 2:
        return prior.copy()
    if sizes_bytes is None:
        sizes_bytes = (1 << 16, 1 << 18, 1 << 20)
    return fit_topology(prior, measure_pair_times(
        sizes_bytes, repeats=repeats, devices=devs))


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
    # per-ordered-pair fabric constants (calibrate_links / parse_topology);
    # None = the single homogeneous host link above
    topology: "LinkTopology | None" = None

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

    def trans_time_for(self, src: int, dst: int) -> float:
        """Per-link Eq. 6: one expert's weights over the directed fabric
        link src -> dst (0 when src == dst; falls back to the scalar
        ``trans_time`` when no topology is attached)."""
        if self.topology is None:
            return 0.0 if src == dst else self.trans_time
        return self.topology.pair_time(src, dst, self.expert_bytes)

    def for_link(self, src: int, dst: int) -> "CostModel":
        """A CostModel whose scalar link constants are the topology's
        (src, dst) pair — so ``DaliConfig.from_cost_model`` (and anything
        else consuming ``trans_time``) prices THAT link instead of the
        homogeneous one."""
        if self.topology is None:
            return self
        g, lat = self.topology.pair(src, dst)
        return dataclasses.replace(
            self, link_gbps=g, link_latency_s=lat,
            link_fit_rejected=bool(self.topology.rejected[src, dst]))

    def with_topology(self, topology: "LinkTopology") -> "CostModel":
        return dataclasses.replace(self, topology=topology)

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
