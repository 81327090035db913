"""Topology-aware EP resilience: per-link watchdogs + degraded-link
expert re-route (port of ``repro/serving/ep_resilience.py``, DESIGN.md
§13) — the multi-device sibling of the single-host degradation ladder.

The :class:`EPResilience` controller sits at Python level around the
expert-parallel layer (models/moe_ep.py):

1. each step, the step's ``info["ep_counts"]`` demand view prices every
   directed fabric pair analytically (``placement_pair_bytes`` — an
   equal-split ``all_to_all`` ships equal blocks physically, so per-pair
   wire cost is demand-derived, the repo's link-bytes convention);
2. the schedule-driven :class:`~repro_torch.serving.faults.FaultInjector`
   supplies per-link slowdown factors (``link_degrade[src>dst]:x8``)
   and the controller charges the *extra* time onto the wall clock, so
   a degraded link honestly costs ms/step;
3. every pair's observed (bytes, seconds) feeds the
   :class:`~repro_torch.serving.faults.WatchdogBank`; when a pair's ladder
   leaves HEALTHY the controller re-solves the expert placement against
   the bank's refit topology and hands the caller a new permutation — the
   caller swaps in ``permute_expert_params(params, placement)`` and the
   next step's hot experts avoid the bad link, bit-identically (the
   permutation only moves WHERE each expert computes);
4. when the link heals the ladder walks back and the placement
   re-solves to the healthy layout.

The controller consumes numpy demand matrices and returns numpy
permutations.  Over several ranks (``launch/mesh.py::run_ranks``),
``step_ranks`` steps it on rank 0 only, on the demand view every rank
holds, and broadcasts the placement to the others: only rank 0 sleeps
for the injected time, and the others wait for it in the broadcast.
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional

import numpy as np

from repro_torch.core.cost_model import LinkTopology
from repro_torch.models.moe_ep import placement_pair_bytes, solve_placement
from repro_torch.serving.faults import FaultInjector, WatchdogBank


class EPResilience:
    """Per-step controller for the expert-parallel fabric.

    Parameters
    ----------
    topology:
        Healthy-prior :class:`LinkTopology` for the ``tp`` devices on
        the 'model' axis (calibrated or parsed).
    n_experts, d_model, itemsize:
        Exchange row geometry for the analytic per-pair byte accounting.
    faults:
        Fault schedule (``serving/faults.py`` grammar, link selectors
        supported) or None.
    reroute:
        False freezes the placement (the no-re-route baseline the
        benchmark compares against); detection still runs.
    demand_ema:
        Smoothing for the demand view the re-solve uses (hot experts
        are stable; a single step's jitter should not thrash placement).
    probe_bytes:
        Fixed transfer size for watchdog *detection* observations.  The
        injected slowdown is charged on the actual demand bytes, but the
        bank watches a constant-size probe per pair per step (the
        ExpertStore's ``_probe`` idiom): if detection rode the demand
        bytes, a re-route would shrink the victim pair's traffic below
        the deadline floor, the ladder would heal, placement would
        restore, and the loop would oscillate for the fault's lifetime.
    """

    def __init__(self, topology: LinkTopology, *, n_experts: int,
                 d_model: int, itemsize: int, faults=None, seed: int = 0,
                 reroute: bool = True, demand_ema: float = 0.5,
                 margin: float = 4.0, patience: int = 3,
                 recover_patience: int = 3, calib_n: int = 4,
                 probe_bytes: int = 1 << 16):
        if n_experts % topology.n:
            raise ValueError(f"n_experts {n_experts} must divide over "
                             f"{topology.n} devices")
        self.topology = topology
        self.n_experts = int(n_experts)
        self.d_model = int(d_model)
        self.itemsize = int(itemsize)
        self.reroute = bool(reroute)
        self.demand_ema = float(demand_ema)
        self.injector = (FaultInjector(faults, seed=seed)
                         if faults is not None else None)
        self.probe_bytes = int(probe_bytes)
        self.bank = WatchdogBank(
            max(1, self.probe_bytes), topology, margin=margin,
            patience=patience, recover_patience=recover_patience,
            calib_n=calib_n)
        self.placement = np.arange(self.n_experts, dtype=np.int32)
        self._healthy_placement = self.placement.copy()
        self._demand: Optional[np.ndarray] = None
        self._step = -1
        self.reroutes = 0
        self.slept_s = 0.0
        self.events: List[tuple] = []

    # -- per-step protocol -------------------------------------------------

    def step(self, demand) -> Dict:
        """Advance one step with the step's (tp, E) demand view.

        Charges injected per-link slowdowns onto the wall clock, feeds
        the watchdog bank, advances the ladders on the shared cadence,
        and (re)solves the placement when any pair's state changed.
        Returns the step report; when ``placement_changed`` is True the
        caller must re-permute its expert params before the next step.
        """
        demand = np.asarray(demand, np.int64)
        if demand.ndim != 2 or demand.shape[0] != self.topology.n:
            raise ValueError(f"demand must be (tp={self.topology.n}, E), "
                             f"got {demand.shape}")
        step = (self.injector.tick() if self.injector is not None
                else self._step + 1)
        self._step = step
        self._demand = (demand.astype(np.float64) if self._demand is None
                        else self.demand_ema * self._demand
                        + (1 - self.demand_ema) * demand)
        pair_bytes = placement_pair_bytes(demand, self.placement,
                                          self.d_model, self.itemsize)
        slept = 0.0
        for (i, j) in self.topology.pairs():
            nb = int(pair_bytes[i, j])
            healthy_s = self.topology.pair_time(i, j, nb)
            factor = (self.injector.link_factor((i, j))
                      if self.injector is not None else 1.0)
            if factor > 1.0:
                # charge only the EXTRA over the healthy analytic time,
                # on the ACTUAL demand bytes: compute already paid the
                # real wall clock, the injected fault pays the slowdown
                slept += healthy_s * (factor - 1.0)
            # detection watches a constant-size probe, not the demand
            # bytes — see the probe_bytes docstring
            probe_s = self.topology.pair_time(i, j, self.probe_bytes)
            self.bank.observe((i, j), self.probe_bytes, probe_s * factor)
        if slept > 0.0:
            time.sleep(slept)
            self.slept_s += slept
        transitions = self.bank.on_step(step)
        for pair, frm, to in transitions:
            self.events.append((step, f"{pair[0]}>{pair[1]}", frm, to))
        placement_changed = False
        if self.reroute and transitions:
            placement_changed = self._resolve_placement()
        return {
            "step": step,
            "pair_bytes": pair_bytes,
            "slept_s": slept,
            "transitions": transitions,
            "placement_changed": placement_changed,
            "degraded_pairs": self.bank.degraded_pairs(),
            "placement": self.placement.copy(),
        }

    def _resolve_placement(self) -> bool:
        """Greedy re-solve under the bank's refit topology (degraded
        pairs charged their measured constants, healthy pairs the
        prior's)."""
        topo_now = self.bank.refit_topology(self.topology)
        new = solve_placement(self._demand, topo_now, tp=self.topology.n)
        if np.array_equal(new, self.placement):
            return False
        self.placement = new
        self.reroutes += 1
        return True

    # -- reporting ---------------------------------------------------------

    def link_report(self) -> Dict[str, dict]:
        """Per-link watchdog counters (ServeMetrics.links payload)."""
        return self.bank.report()

    def report(self) -> Dict:
        return {
            "reroutes": self.reroutes,
            "slept_s": self.slept_s,
            "events": list(self.events),
            "degraded_pairs": [f"{i}>{j}"
                               for i, j in self.bank.degraded_pairs()],
            "placement": self.placement.tolist(),
            "links": self.link_report(),
        }


def step_ranks(ctrl: EPResilience, demand):
    """One controller step over the ranks of the default process group.
    Rank 0 steps ``ctrl`` on ``demand`` (the all-gathered (tp, E)
    ``ep_counts``, the same on every rank) and broadcasts the placement
    as an int32 tensor.  Returns ``(placement, report)``: the report on
    rank 0, None elsewhere."""
    import torch
    import torch.distributed as dist
    rep = ctrl.step(demand) if dist.get_rank() == 0 else None
    buf = (torch.from_numpy(np.ascontiguousarray(ctrl.placement, np.int32))
           if rep is not None
           else torch.empty(ctrl.n_experts, dtype=torch.int32))
    dist.broadcast(buf, 0)
    return buf.numpy(), rep
