"""Fault injection, link watchdog, and the degradation ladder (a copy of
``repro/serving/faults.py``; ``FaultInjector.corrupt`` flips bits in torch
tensors on either device instead of numpy arrays).

This module is the robustness seam around the physical offload path:

* :class:`FaultInjector` — a seeded, schedule-driven injector that the
  :class:`~repro_torch.serving.expert_store.ExpertStore` consults around
  its host reads and host-to-device copies.  Faults are *deterministic*
  (driven by the store's step counter, not wall clock) so tests and CI
  can pin exact recovery behaviour.
* :class:`LinkWatchdog` — stage/commit deadline detection budgeted from
  the cost model's link constants, with an online re-fit of
  (gbps, latency) from observed stage timings.
* :class:`DegradationLadder` — the recoverable reaction state machine:
  healthy -> degraded (shrunk prefetch, re-solved assignment with the
  degraded t_trans) -> little (resident int8 twins) -> healthy again
  once the link heals.

Everything runs at Python level inside the store's hook protocol
(`pre_step` / `post_dispatch`), which is also why it composes identically
across the blocking / overlap / pipelined modes.
"""

from __future__ import annotations

import re
import threading
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.cost_model import fit_link_constants


class TransientFault(Exception):
    """A recoverable fault raised by the injector (stall / timeout)."""


class HostReadError(TransientFault):
    """Injected host-store read error (e.g. mmap page-in failure)."""


class FaultParseError(ValueError):
    """Malformed ``--faults`` spec (typed so callers can catch it)."""


FAULT_KINDS = ("link_degrade", "transient_stall", "read_error", "corrupt_rows")

# Shorthand presets so `--faults link_degrade` works without a schedule.
PRESETS = {
    "link_degrade": "link_degrade:x12@8-26",
    "transient_stall": "transient_stall@5-7",
    "read_error": "read_error@5-6",
    "corrupt_rows": "corrupt_rows@4-7",
}

#: the default link the single-host offload path streams over — specs
#: with no ``[src>dst]`` selector match every link, including this one
HOST_LINK = ("host", 0)


@dataclass(frozen=True)
class FaultSpec:
    """One scheduled fault: `kind` active on steps [start, stop).

    ``link`` narrows a fault to one directed fabric link: a
    (src, dst) pair where each side is a device index, ``"host"`` or
    the wildcard ``"*"``.  ``None`` (default) hits every link — the
    pre-topology behaviour."""

    kind: str
    start: int = 0
    stop: int = 1 << 30
    factor: float = 8.0  # link slowdown multiplier (link_degrade only)
    link: Optional[Tuple] = None

    def active(self, step: int) -> bool:
        return self.start <= step < self.stop

    def matches_link(self, pair) -> bool:
        """Does this spec hit the directed link ``pair``?  ``None``
        selectors are global; ``"*"`` wildcards either side."""
        if self.link is None:
            return True
        if pair is None:
            pair = HOST_LINK
        return all(sel == "*" or sel == got
                   for sel, got in zip(self.link, pair))


_SPEC_RE = re.compile(
    r"(\w+)(?:\[([^\]]*)\])?(?::x([0-9.]+))?(?:@(\d+)(?:-(\d+))?)?")
_LINK_SEL_RE = re.compile(r"^(host|\*|\d+)>(host|\*|\d+)$")


def _parse_link_selector(sel: str, item: str) -> Tuple:
    m = _LINK_SEL_RE.match(sel.strip())
    if m is None:
        raise FaultParseError(
            f"bad link selector [{sel}] in {item!r}: expected "
            f"[SRC>DST] with SRC/DST a device index, 'host' or '*'")
    return tuple(int(t) if t.isdigit() else t for t in m.groups())


def parse_faults(spec) -> List[FaultSpec]:
    """Parse a fault schedule string into :class:`FaultSpec` list.

    Grammar (comma-separated items)::

        kind[SRC>DST][:xFACTOR][@START[-STOP]]

    e.g. ``link_degrade:x12@8-26``, ``link_degrade[0>3]:x8@20-60`` (only
    the directed fabric link 0->3), ``transient_stall@5-7``.  A bare
    kind with no schedule uses the preset from :data:`PRESETS`.  Already
    parsed lists pass through unchanged.  Malformed items raise
    :class:`FaultParseError`.
    """
    if spec is None:
        return []
    if isinstance(spec, FaultSpec):
        return [spec]
    if isinstance(spec, (list, tuple)):
        out: List[FaultSpec] = []
        for s in spec:
            out.extend(parse_faults(s))
        return out
    text = str(spec).strip()
    if not text:
        return []
    specs: List[FaultSpec] = []
    for item in text.split(","):
        item = item.strip()
        if not item:
            continue
        if item in PRESETS:
            item = PRESETS[item]
        m = _SPEC_RE.fullmatch(item)
        if m is None:
            raise FaultParseError(f"bad fault spec item: {item!r}")
        kind, link_sel, factor, start, stop = m.groups()
        if kind not in FAULT_KINDS:
            raise FaultParseError(
                f"unknown fault kind {kind!r}; expected one of {FAULT_KINDS}"
            )
        link = None
        if link_sel is not None:
            if kind in ("read_error", "corrupt_rows"):
                raise FaultParseError(
                    f"{item!r}: {kind} is a store fault, not a link "
                    f"fault — link selectors apply to link_degrade / "
                    f"transient_stall")
            link = _parse_link_selector(link_sel, item)
        start_i = int(start) if start is not None else 0
        stop_i = int(stop) if stop is not None else (
            start_i + 1 if start is not None else 1 << 30
        )
        specs.append(
            FaultSpec(
                kind=kind,
                start=start_i,
                stop=stop_i,
                factor=float(factor) if factor is not None else 8.0,
                link=link,
            )
        )
    return specs


class FaultInjector:
    """Seeded, schedule-driven fault source consulted by the store.

    The store calls :meth:`tick` once at the top of each `pre_step`, then
    the various `maybe_*` hooks from inside its gather/H2D path.  Stall
    and read-error faults fire *once per (spec, step)* so a bounded
    retry always succeeds — persistent trouble is modelled with
    ``link_degrade`` instead, which the watchdog must detect.
    """

    def __init__(self, schedule, seed: int = 0):
        self.schedule: List[FaultSpec] = parse_faults(schedule)
        self.seed = int(seed)
        self.rng = np.random.default_rng(self.seed)
        self.step = -1
        self._fired: set = set()
        self._lock = threading.Lock()

    def tick(self) -> int:
        with self._lock:
            self.step += 1
            return self.step

    def _active(self, kind: str) -> List[FaultSpec]:
        return [s for s in self.schedule if s.kind == kind and s.active(self.step)]

    def link_factor(self, pair=None) -> float:
        """Current slowdown multiplier for one directed link (1.0 =
        healthy).  ``pair`` is a (src, dst) link id; ``None`` means the
        single-host offload link (:data:`HOST_LINK`) — unselected specs
        hit every link, so the pre-topology behaviour is unchanged."""
        with self._lock:
            specs = [s for s in self._active("link_degrade")
                     if s.matches_link(pair)]
            if not specs:
                return 1.0
            return max(s.factor for s in specs)

    def _fire_once(self, kind: str) -> Optional[FaultSpec]:
        specs = self._active(kind)
        for s in specs:
            key = (id(s), self.step)
            if key not in self._fired:
                self._fired.add(key)
                return s
        return None

    def maybe_stall(self) -> None:
        """Raise :class:`TransientFault` once per active stall spec/step."""
        with self._lock:
            s = self._fire_once("transient_stall")
        if s is not None:
            raise TransientFault(f"injected stage stall at step {self.step}")

    def maybe_read_error(self) -> None:
        """Raise :class:`HostReadError` once per active read-error spec/step."""
        with self._lock:
            s = self._fire_once("read_error")
        if s is not None:
            raise HostReadError(f"injected host read error at step {self.step}")

    def corrupt(self, named_rows: Dict[str, object], n_real: int) -> int:
        """Flip bits in real staged rows, in place, on either device.

        `named_rows` maps name -> anything whose ``[row]`` is a contiguous
        tensor (a tensor with the staged-row axis first, or a list of row
        tensors); only rows ``< n_real`` are touched.  The draws (row, then
        one element per name) and the flipped bit (``0x4000`` of a 16-bit
        word, ``0x40000000`` of a 32-bit one) are the reference's, so the
        same layout and seed corrupt the same element.  Returns the number
        of corrupted rows (0 when no corrupt_rows spec is active this
        step).
        """
        with self._lock:
            s = self._fire_once("corrupt_rows")
            if s is None or n_real <= 0:
                return 0
            row = int(self.rng.integers(0, n_real))
            for rows in named_rows.values():
                flat = rows[row].reshape(-1)
                two = flat.element_size() == 2
                view = flat.view(torch.int16 if two else torch.int32)
                j = int(self.rng.integers(0, view.numel()))
                view[j] ^= 0x4000 if two else 0x40000000
            return 1

    def last_fault_step(self) -> int:
        """Last step at which any scheduled fault is active (-1 if none)."""
        stops = [s.stop - 1 for s in self.schedule]
        return max(stops) if stops else -1


class LinkWatchdog:
    """Deadline detection + online link re-fit from observed stage timings.

    Budgets come from the cost model's link constants (`gbps`,
    `latency_s`); the first `calib_n` observations re-baseline them to
    the actual machine (CI runners vary wildly), after which a stage
    taking more than ``margin * expected + floor`` counts towards a
    degradation streak.  `patience` consecutive misses flips
    :attr:`degraded`; `recover_patience` consecutive on-time stages
    flips :attr:`healed`.
    """

    def __init__(
        self,
        expert_bytes: int,
        gbps: float,
        latency_s: float,
        *,
        name: str = "host>0",
        margin: float = 4.0,
        floor_s: float = 5e-4,
        patience: int = 3,
        recover_patience: int = 3,
        calib_n: int = 4,
        window: int = 32,
    ):
        self.name = str(name)
        self.expert_bytes = max(1, int(expert_bytes))
        self.gbps = max(float(gbps), 1e-3)
        self.latency_s = max(float(latency_s), 0.0)
        self.margin = float(margin)
        self.floor_s = float(floor_s)
        self.patience = int(patience)
        self.recover_patience = int(recover_patience)
        self.calib_n = int(calib_n)
        self.window = int(window)
        self._samples: List[Tuple[float, float]] = []  # (nbytes, seconds)
        self._calibrated = False
        self.over_streak = 0
        self.ok_streak = 0
        self.deadline_misses = 0
        # per-link counters the serve reports surface (ServeMetrics.links)
        self.refits = 0
        self.refit_rejections = 0
        self.degrade_events = 0

    def expected_s(self, nbytes: int) -> float:
        return self.latency_s + float(nbytes) / (self.gbps * 1e9)

    def deadline(self, nbytes: int) -> float:
        # margin multiplies the floor as well: when transfers are small
        # enough that the floor (observed median) dominates expected_s,
        # healthy jitter sits AT the median — an additive floor would put
        # the deadline right on top of it and miss ~half the time.  A
        # slowdown of factor k is detectable whenever k > margin.
        return self.margin * max(self.expected_s(nbytes), self.floor_s)

    def _recent(self) -> Tuple[np.ndarray, np.ndarray]:
        recent = self._samples[-self.window :]
        sizes = np.asarray([r[0] for r in recent], dtype=np.float64)
        times = np.asarray([r[1] for r in recent], dtype=np.float64)
        return sizes, times

    def _baseline(self) -> None:
        sizes, times = self._recent()
        gbps, lat, _rejected = fit_link_constants(sizes, times)
        self.gbps = max(gbps, 1e-3)
        self.latency_s = max(lat, 0.0)
        # Tiny transfers on a shared CI box jitter by hundreds of us; keep
        # the absolute floor at least the observed median so calibration
        # noise can't trip the deadline.
        self.floor_s = max(self.floor_s, float(np.median(times)))
        self._calibrated = True

    def observe(self, nbytes: int, seconds: float) -> bool:
        """Record one stage timing; returns True if it missed its deadline."""
        self._samples.append((float(nbytes), float(seconds)))
        if len(self._samples) > 4 * self.window:
            del self._samples[: -2 * self.window]
        if not self._calibrated:
            if len(self._samples) >= self.calib_n:
                self._baseline()
            return False
        missed = seconds > self.deadline(nbytes)
        if missed:
            self.deadline_misses += 1
            self.over_streak += 1
            self.ok_streak = 0
            if self.over_streak == self.patience:
                self.degrade_events += 1
        else:
            self.ok_streak += 1
            self.over_streak = 0
        return missed

    @property
    def degraded(self) -> bool:
        return self.over_streak >= self.patience

    @property
    def healed(self) -> bool:
        return self.ok_streak >= self.recover_patience

    def refit(self) -> Tuple[float, float, bool]:
        """Re-fit (gbps, latency_s) from the recent window.

        Returns ``(gbps, latency_s, rejected)`` where `rejected` means
        the lstsq fit was degenerate and a median-throughput fallback
        was used.  Does *not* mutate the baseline — the baseline is the
        healthy link; the refit describes the link as it is now, for
        building the degraded DaliConfig.
        """
        self.refits += 1
        if not self._samples:
            self.refit_rejections += 1
            return self.gbps, self.latency_s, True
        sizes, times = self._recent()
        gbps, lat, rejected = fit_link_constants(sizes, times)
        if rejected:
            self.refit_rejections += 1
        return max(gbps, 1e-3), max(lat, 0.0), rejected

    def report(self) -> dict:
        """Numeric per-link view for ServeMetrics / server reports."""
        return {
            "name": self.name,
            "gbps": self.gbps,
            "latency_s": self.latency_s,
            "deadline_misses": self.deadline_misses,
            "refits": self.refits,
            "refit_rejections": self.refit_rejections,
            "degrade_events": self.degrade_events,
            "degraded": self.degraded,
        }


# Ladder states.
HEALTHY = "healthy"
DEGRADED = "degraded"
LITTLE = "little"


@dataclass
class DegradationLadder:
    """Recoverable escalation: healthy -> degraded -> little -> healthy.

    Driven once per step by the store with the watchdog's current view.
    Transitions are recorded (step, from, to) so benchmarks can report
    time-to-recover.
    """

    watchdog: LinkWatchdog
    little_after: int = 6
    enable_little: bool = True
    state: str = HEALTHY
    steps_in_state: int = 0
    transitions: List[Tuple[int, str, str]] = field(default_factory=list)

    def _move(self, step: int, to: str) -> Tuple[str, str]:
        frm = self.state
        self.state = to
        self.steps_in_state = 0
        self.transitions.append((step, frm, to))
        return (frm, to)

    def on_step(self, step: int) -> Optional[Tuple[str, str]]:
        """Advance the ladder; returns (from, to) on a transition."""
        self.steps_in_state += 1
        wd = self.watchdog
        if self.state == HEALTHY:
            if wd.degraded:
                return self._move(step, DEGRADED)
        elif self.state == DEGRADED:
            if wd.healed:
                return self._move(step, HEALTHY)
            if self.enable_little and self.steps_in_state >= self.little_after and not wd.healed:
                return self._move(step, LITTLE)
        elif self.state == LITTLE:
            if wd.healed:
                return self._move(step, HEALTHY)
        return None

    def time_to_recover(self) -> Optional[int]:
        """Steps from first leaving HEALTHY to last returning to it."""
        first_down = next(
            (s for s, frm, to in self.transitions if frm == HEALTHY), None
        )
        last_up = None
        for s, frm, to in self.transitions:
            if to == HEALTHY:
                last_up = s
        if first_down is None or last_up is None:
            return None
        return max(0, last_up - first_down)


class WatchdogBank:
    """One :class:`LinkWatchdog` + :class:`DegradationLadder` per ordered
    fabric pair, advanced on a shared cadence (DESIGN.md §13).

    The single-host ladder reacts to ONE link; an EP fabric has
    n·(n-1) directed links that degrade independently.  The bank keeps
    a per-pair watchdog (budgeted from that pair's topology constants)
    and a per-pair ladder, all driven once per step by
    :meth:`on_step` so refit and heal decisions share the step clock —
    a pair that degrades re-routes immediately while the rest keep
    their healthy baselines.
    """

    def __init__(self, nbytes_hint: int, topology, *,
                 margin: float = 4.0, floor_s: float = 0.0,
                 patience: int = 3, recover_patience: int = 3,
                 calib_n: int = 4, window: int = 32,
                 little_after: int = 1 << 30,
                 enable_little: bool = False):
        # floor_s defaults to 0 here (unlike the host watchdog's 5e-4):
        # modeled fabric pair times are µs-scale, so the only meaningful
        # floor is the observed median each pair calibrates for itself
        self.topology = topology
        self.watchdogs: Dict[Tuple[int, int], LinkWatchdog] = {}
        self.ladders: Dict[Tuple[int, int], DegradationLadder] = {}
        for (i, j) in topology.pairs():
            gbps, lat = topology.pair(i, j)
            wd = LinkWatchdog(
                nbytes_hint, gbps, lat, name=f"{i}>{j}", margin=margin,
                floor_s=floor_s, patience=patience,
                recover_patience=recover_patience, calib_n=calib_n,
                window=window)
            self.watchdogs[(i, j)] = wd
            # the EP re-route ladder has no little tier by default: the
            # reaction to a bad fabric link is placement, not int8 twins
            self.ladders[(i, j)] = DegradationLadder(
                wd, little_after=little_after,
                enable_little=enable_little)

    def observe(self, pair, nbytes, seconds) -> bool:
        """Record one directed transfer timing; True on a deadline miss."""
        return self.watchdogs[tuple(pair)].observe(nbytes, seconds)

    def on_step(self, step: int) -> List[Tuple[Tuple[int, int], str, str]]:
        """Advance every pair's ladder once; returns the transitions
        [(pair, from, to), ...] that fired this step."""
        out = []
        for pair, ladder in self.ladders.items():
            tr = ladder.on_step(step)
            if tr is not None:
                out.append((pair, tr[0], tr[1]))
        return out

    def state(self, pair) -> str:
        return self.ladders[tuple(pair)].state

    def degraded_pairs(self) -> List[Tuple[int, int]]:
        return [p for p, lad in self.ladders.items()
                if lad.state != HEALTHY]

    def refit_topology(self, base=None):
        """The fabric as it is NOW: non-healthy pairs get their online
        refit constants (honest degraded t_trans for the placement
        re-solve), healthy pairs keep the base topology's."""
        topo = (base if base is not None else self.topology).copy()
        for pair in self.degraded_pairs():
            wd = self.watchdogs[pair]
            gbps, lat, rejected = wd.refit()
            if rejected:
                # fixed-size probe windows carry no per-byte slope, so
                # the lstsq refit degenerates to ~the healthy median
                # (the window is mostly pre-fault samples).  Charge the
                # OBSERVED slowdown instead: the median of the samples
                # that tripped the ladder over the healthy expectation.
                sizes, times = wd._recent()
                k = float(np.median(times[-wd.patience:])
                          / max(wd.expected_s(sizes[-1]), 1e-12))
                topo = topo.degrade(pair[0], pair[1], max(k, 1.0))
                topo.rejected[pair[0], pair[1]] = True
            else:
                topo = topo.with_pair(pair[0], pair[1], gbps, lat)
        return topo

    def report(self) -> Dict[str, dict]:
        """Per-link counter reports keyed by link name ("0>3")."""
        out = {}
        for pair, wd in self.watchdogs.items():
            rep = wd.report()
            rep["state"] = self.ladders[pair].state
            out[wd.name] = rep
        return out

    def transitions(self) -> List[Tuple[Tuple[int, int], int, str, str]]:
        """All (pair, step, from, to) transitions, time-ordered."""
        out = []
        for pair, lad in self.ladders.items():
            out.extend((pair, s, frm, to) for s, frm, to in lad.transitions)
        return sorted(out, key=lambda r: r[1])
