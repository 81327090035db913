"""Typed serving construction: one spec, one ``resolve()`` (port of
``repro/serving/spec.py``).

``ServeSpec`` says what to serve (config, server preset, policy, batch
geometry, sampling, device); ``OffloadSpec`` says how expert weights reach
the device.  ``ServeSpec.resolve(params)`` validates both once, resolves the
policy, builds the ``ExpertStore`` for the physical modes (blocking,
overlap, pipelined), strips the routed expert stacks from the served
params, and returns a ``ResolvedServe`` whose factories build the step
functions (``resilient_decode`` follows the store's degradation ladder),
the serve state and the server.  ``OffloadSpec.faults`` arms the store's
fault injection, link watchdog and ladder; ``topology`` attaches the
per-link fabric (``core/cost_model.py::parse_topology``) to the store's
cost model.

The legacy kwarg surfaces (``scheduler.make_store``, ``make_decode_step``
and ``init_serve_state`` with ``offload=``, the servers built from
``cfg=``) still work and warn once per process (``warn_legacy``); the
spec's own factories build on them under ``_internal()``, which keeps
them silent.
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
import warnings
from typing import Any, Optional

from repro_torch.device import resolve_device
from repro_torch.tree import tree_leaves

OFFLOAD_MODES = ("modeled", "blocking", "overlap", "pipelined")

# the offload <-> policy contract, in the reference's words
OFFLOAD_POLICY_ERROR = (
    "physical offload requires an MoE architecture and a scheduling "
    "policy (policy != 'none'): slot plans are lowered from the policy's "
    "decisions and its initial resident set seeds the slot pool")


def require_offload_policy(policy, cfg):
    """Raise the shared contract error unless ``policy`` schedules an MoE
    architecture."""
    if not (getattr(policy, "schedules", False) and cfg.moe is not None):
        raise ValueError(OFFLOAD_POLICY_ERROR)


_STATE = threading.local()
_WARNED: set = set()


@contextlib.contextmanager
def _internal():
    """Mark legacy-surface calls made by the spec machinery itself, so
    that only direct legacy construction warns."""
    prev = getattr(_STATE, "in_resolve", False)
    _STATE.in_resolve = True
    try:
        yield
    finally:
        _STATE.in_resolve = prev


def warn_legacy(api: str):
    """Once-per-process DeprecationWarning for a legacy construction entry
    point, suppressed under ``_internal()``."""
    if getattr(_STATE, "in_resolve", False) or api in _WARNED:
        return
    _WARNED.add(api)
    warnings.warn(
        f"{api} with legacy kwargs is deprecated; construct through "
        "ServeSpec.resolve() (repro_torch/serving/spec.py)",
        DeprecationWarning, stacklevel=3)


@dataclasses.dataclass(frozen=True)
class OffloadSpec:
    """How expert weights reach the device.

    mode          — "modeled" (every expert resident; the policy feeds
                    telemetry only) | "blocking" | "overlap" | "pipelined"
                    (pinned host store + device slot pool, see
                    serving/expert_store.py)
    fallback      — miss tier: "fetch" (bit-exact demand fetch) | "host"
                    (CPU FFN) | "little" (device-resident int8 twins)
    prefill_rows  — experts per wave a prefill sweep streams (None = pool
                    size)
    strip_params  — remove the expert stacks from the served params (None =
                    auto: stripped for physical modes)
    faults        — a fault schedule (serving/faults.py, e.g.
                    "link_degrade:x12@8-26" or a bare preset name): arms
                    fault injection, the link watchdog and the degradation
                    ladder (physical modes only)
    cost_model    — the CostModel whose link constants budget the watchdog
                    (default: the config's, LOCAL_PC's link)
    topology      — per-link fabric spec (core/cost_model.parse_topology:
                    "flat", "island:K", "SRC>DST:xF" overrides) attached
                    to the store's cost model (physical modes; one device
                    per card, one on the CPU)
    """
    mode: str = "modeled"
    fallback: str = "fetch"
    prefill_rows: Optional[int] = None
    strip_params: Optional[bool] = None
    faults: Any = None
    cost_model: Any = None
    topology: Any = None

    @property
    def physical(self) -> bool:
        return self.mode != "modeled"


@dataclasses.dataclass(frozen=True)
class ServeSpec:
    """What to serve and how — the single construction surface.

    ``device`` is where the server runs: ``"cuda"`` unless the caller
    asks for ``"cpu"`` (the tests do); asking for ``cuda`` without a card
    raises at ``resolve``."""
    cfg: Any
    server: str = "continuous"
    policy: Any = None                  # name | policy instance | None
    dali_cfg: Any = None
    batch_size: int = 8
    max_len: int = 256
    eos_id: int = 1
    min_bucket: int = 16
    moe_capacity: Optional[int] = None
    sample: bool = False
    temperature: float = 1.0
    offload: OffloadSpec = dataclasses.field(default_factory=OffloadSpec)
    device: Any = "cuda"

    def resolve(self, params) -> "ResolvedServe":
        """Validate + build: policy, store, (stripped) params, which must
        then live on the spec's device (a store reads expert stacks from
        the host or the device)."""
        from repro_torch.serving.steps import resolve_policy
        dev = resolve_device(self.device)
        off = self.offload
        policy = resolve_policy(self.policy, self.cfg, self.dali_cfg)
        store = build_store(off.mode, params, self.cfg, policy,
                            fallback=off.fallback, faults=off.faults,
                            cost_model=off.cost_model,
                            prefill_rows=off.prefill_rows,
                            topology=off.topology, device=dev)
        use_params = params
        if store is not None and off.strip_params is not False:
            from repro_torch.serving.expert_store import strip_expert_params
            use_params = strip_expert_params(params, self.cfg)
        wrong = {str(t.device) for t in tree_leaves(use_params)
                 if t.device.type != dev.type}
        if wrong:
            raise ValueError(f"params live on {sorted(wrong)} but the spec "
                             f"serves on {dev}")
        return ResolvedServe(spec=self, policy=policy, store=store,
                             params=use_params, device=dev)


def build_store(offload: str, params, cfg, policy, fallback: str = "fetch",
                faults=None, cost_model=None, prefill_rows=None,
                topology=None, device=None):
    """The ExpertStore of a physical offload mode (None for "modeled").
    The pool is sized to the policy's largest effective resident set
    (cache ∪ prefetch) plus one plan of slack, the per-step copy budget to
    its churn — the reference's sizing."""
    from repro_torch.serving.expert_store import ExpertStore
    if offload not in OFFLOAD_MODES:
        raise ValueError(f"offload must be one of "
                         f"{'|'.join(OFFLOAD_MODES)}, got {offload!r}")
    if offload == "modeled":
        if faults is not None:
            raise ValueError('faults need a physical offload mode '
                             '("blocking" | "overlap" | "pipelined"); '
                             '"modeled" has no streaming path to inject '
                             'into')
        return None
    require_offload_policy(policy, cfg)
    if topology is not None:
        # attach the per-link fabric to the store's cost model, so anything
        # reading CostModel.for_link prices each directed pair, not one
        # homogeneous link (DESIGN.md §13); the devices are the cards (one
        # device on the CPU, as the reference's single-device runs)
        import torch
        from repro_torch.core.cost_model import CostModel, parse_topology
        dev = resolve_device(device if device is not None else "cuda")
        n = torch.cuda.device_count() if dev.type == "cuda" else 1
        cm = cost_model if cost_model is not None \
            else CostModel.for_config(cfg)
        cost_model = cm.with_topology(parse_topology(topology, n))
    dcfg = policy.dcfg
    moves = max(2, dcfg.prefetch_size + dcfg.u_size)
    return ExpertStore(
        params, cfg,
        n_slots=min(cfg.moe.n_routed,
                    dcfg.cache_size + dcfg.prefetch_size + moves),
        max_moves=moves, fallback=fallback, mode=offload, faults=faults,
        cost_model=cost_model, prefill_rows=prefill_rows, device=device)


@dataclasses.dataclass
class ResolvedServe:
    """A resolved spec: policy + params + device, with factory methods for
    the steps, the serve state and the server."""
    spec: ServeSpec
    policy: Any
    store: Any
    params: Any
    device: Any

    def decode_step(self):
        from repro_torch.serving.steps import make_decode_step
        s = self.spec
        with _internal():
            return make_decode_step(s.cfg, policy=self.policy,
                                    moe_capacity=s.moe_capacity,
                                    sample=s.sample,
                                    temperature=s.temperature,
                                    offload=self.store)

    def resilient_decode(self):
        """The decode the servers call: variants switched by the store's
        degradation ladder (only the healthy one without faults)."""
        from repro_torch.serving.steps import ResilientDecode
        s = self.spec
        return ResilientDecode(s.cfg, moe_capacity=s.moe_capacity,
                               sample=s.sample, temperature=s.temperature,
                               policy=self.policy, offload=self.store)

    def prefill_step(self):
        """Wave prefill; with a physical store the sweep streams through the
        slot pool (call with ``off=state["offload"]``)."""
        from repro_torch.serving.steps import make_prefill_step
        return make_prefill_step(self.spec.cfg,
                                 moe_capacity=self.spec.moe_capacity,
                                 offload=self.store)

    def admit_prefill(self):
        from repro_torch.serving.steps import make_admit_prefill
        return make_admit_prefill(self.spec.cfg,
                                  moe_capacity=self.spec.moe_capacity,
                                  offload=self.store)

    def init_state(self, per_slot: bool = False, seed: int = 0,
                   batch: Optional[int] = None,
                   max_len: Optional[int] = None):
        from repro_torch.serving.steps import init_serve_state
        s = self.spec
        with _internal():
            return init_serve_state(s.cfg, batch or s.batch_size,
                                    max_len or s.max_len,
                                    policy=self.policy, per_slot=per_slot,
                                    seed=seed, device=self.device,
                                    offload=self.store)

    def audit(self, rungs=None, raise_on_violation: bool = True,
              with_costs: bool = False):
        """Serving-path audit of THIS resolution's entry points
        (repro_torch/analysis, DESIGN.md §12): host seams and their
        guarding, the sync census, updates in place, the weight-capture
        budget.  Runs each entry point once on this resolution's device
        (the pool and caches it touches are its own).  Returns the
        machine-readable report dict; raises
        :class:`repro_torch.analysis.GraphContractError` on any violation
        unless ``raise_on_violation=False``.  ``with_costs=True`` also
        cross-checks the copied bytes and the decode FLOPs against the
        :class:`~repro_torch.core.cost_model.CostModel`."""
        from repro_torch.analysis.step_audit import audit_resolved
        report = audit_resolved(self, rungs=rungs,
                                raise_on_violation=raise_on_violation)
        if with_costs:
            from repro_torch.analysis.contracts import maybe_raise
            from repro_torch.analysis.cost_audit import audit_costs
            report["costs"] = audit_costs(self)
            report["violations"].extend(report["costs"]["violations"])
            report["ok"] = not report["violations"]
            maybe_raise(report, raise_on_violation)
        return report

    def server(self, res_vecs=None):
        """The server the spec names, built from this resolution."""
        from repro_torch.serving.scheduler import SERVER_PRESETS
        try:
            cls = SERVER_PRESETS[self.spec.server]
        except KeyError:
            raise ValueError(
                f"unknown server preset {self.spec.server!r}; choose "
                f"from {sorted(SERVER_PRESETS)}") from None
        return cls(self.params, resolved=self, res_vecs=res_vecs)
