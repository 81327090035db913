"""Calibration of the cost model the Greedy Assignment solver trusts (port
of ``repro/analysis/cost_audit.py``, DESIGN.md §12): the bytes a pool
update copies and the FLOPs a decode step performs, measured on a run of
the port, against :class:`~repro_torch.core.cost_model.CostModel` and the
analytic active-parameter model.

Three checks:

* **expert-row bytes** — ``CostModel.expert_bytes`` must equal the
  store's host-row bytes EXACTLY (the unit every ``t_trans`` prediction
  and the watchdog's budget are denominated in);
* **pipelined stage bytes** — the bytes one ``_copy_rows`` call of a
  ``q``-row stage copies (the sources of its ``aten.copy_`` ops, counted by
  a ``TorchDispatchMode``; the counterpart of the reference's non-donated
  HLO entry parameters) must agree with the store's accounting
  ``Q x expert_bytes`` (what ``h2d_bytes`` telemetry reports) within
  tolerance;
* **decode FLOPs** — the decode step's FLOPs, counted by
  ``torch.utils.flop_counter.FlopCounterMode`` (the counterpart of
  ``launch/hloparse.py::hlo_flops``), against (a) the analytic model
  ``2 x N_active x tokens`` within a generous ratio and (b) across offload
  modes against the modeled baseline within a tight tolerance: the slot
  path must not bring dense dispatch compute back.
"""
from __future__ import annotations

from types import SimpleNamespace
from typing import Any, Dict, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.analysis.contracts import E_COST_DRIFT, Violation
from repro_torch.core.cost_model import CostModel


class _CopyBytes(TorchDispatchMode):
    """Sums the bytes of every ``aten.copy_`` source while active."""

    def __init__(self):
        super().__init__()
        self.nbytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func is torch.ops.aten.copy_.default:
            src = args[1]
            self.nbytes += src.numel() * src.element_size()
        return func(*args, **(kwargs or {}))


def stage_h2d_bytes(store, off, q: int = 2) -> Dict[str, float]:
    """Bytes one pipelined stage of ``q`` rows (layer 0, pool slots 0..q-1,
    experts the pool does not hold there) copies from the host store into
    the pool, against the convention ``q x expert_bytes``."""
    held = {int(e) for e in store._cur[0] if e >= 0}
    experts = ([e for e in range(store.E) if e not in held] * q)[:q] \
        or [0] * q
    rows = [(0, s % store.n_slots, e) for s, e in enumerate(experts)]
    with _CopyBytes() as cb:
        store._copy_rows(off, rows)
    return {"copied_bytes": float(cb.nbytes),
            "model_bytes": float(q * store.expert_bytes), "q": q}


def decode_flops(rs, rung: str = "healthy", state=None) -> float:
    """FLOPs of one decode step (``FlopCounterMode``; the kernels' plain
    versions on the CPU, the kernels' own formulas on ``meta``) on
    ``state`` (default: a fresh slot table, every row dead)."""
    fn = rs.resilient_decode().variant(rung)
    if state is None:
        state = rs.init_state(per_slot=True)
    with torch.no_grad(), FlopCounterMode(display=False) as fc:
        fn(rs.params, state, None)
    return float(fc.get_total_flops())


def analytic_decode_flops(cfg, batch: int) -> float:
    """The active-param analytic model (``launch/dryrun.model_flops``):
    2 x N_active x tokens for one decode step."""
    from repro_torch.launch.dryrun import model_flops
    return float(model_flops(
        cfg, SimpleNamespace(batch=batch, seq=1, kind="decode")))


def audit_costs(rs, tol_h2d: float = 0.10, tol_mode_flops: float = 0.25,
                flops_ratio_max: float = 8.0,
                reference_flops: Optional[float] = None,
                rung: str = "healthy") -> Dict[str, Any]:
    """Cross-check one resolved server's measured costs against the
    CostModel.  ``reference_flops`` (the modeled mode's decode FLOPs, when
    auditing a physical mode) arms the cross-mode check.  Returns a
    record with ``violations`` as dicts (never raises)."""
    spec = rs.spec
    cfg = spec.cfg
    mode = spec.offload.mode
    violations = []
    out: Dict[str, Any] = {"mode": mode, "violations": violations}

    cm = CostModel.for_config(cfg)
    out["cm_expert_bytes"] = cm.expert_bytes
    state = rs.init_state(per_slot=True)
    if rs.store is not None:
        out["store_expert_bytes"] = rs.store.expert_bytes
        if rs.store.expert_bytes != cm.expert_bytes:
            violations.append(Violation(
                E_COST_DRIFT, f"expert_bytes[{mode}]",
                f"CostModel.expert_bytes={cm.expert_bytes} but the host "
                f"store rows measure {rs.store.expert_bytes}B — every "
                f"t_trans prediction is denominated in the wrong unit"
            ).asdict())

    if mode == "pipelined":
        h2d = stage_h2d_bytes(rs.store, state["offload"])
        drift = abs(h2d["copied_bytes"] - h2d["model_bytes"]) \
            / max(h2d["model_bytes"], 1.0)
        h2d["drift"] = drift
        out["stage_h2d"] = h2d
        if drift > tol_h2d:
            violations.append(Violation(
                E_COST_DRIFT, f"stage_h2d[{mode}]",
                f"a {h2d['q']}-row stage copies {h2d['copied_bytes']:.0f}B "
                f"but the telemetry/benchmark convention records Q x "
                f"expert_bytes = {h2d['model_bytes']:.0f}B ({drift:.1%} > "
                f"{tol_h2d:.0%}) — the staged payload drifted from the "
                f"cost model").asdict())

    flops = decode_flops(rs, rung=rung)
    analytic = analytic_decode_flops(cfg, spec.batch_size)
    out["decode_flops"] = flops
    out["analytic_flops"] = analytic
    ratio = flops / max(analytic, 1.0)
    out["flops_ratio"] = ratio
    if not (1.0 / flops_ratio_max) <= ratio <= flops_ratio_max:
        violations.append(Violation(
            E_COST_DRIFT, f"decode_flops[{mode}]",
            f"the decode step performs {flops:.3g} FLOPs vs {analytic:.3g} "
            f"analytic active-param FLOPs (ratio {ratio:.2f} outside "
            f"1/{flops_ratio_max:g}..{flops_ratio_max:g}) — dense dispatch "
            f"compute crept onto the decode step").asdict())
    if reference_flops is not None:
        rel = abs(flops - reference_flops) / max(reference_flops, 1.0)
        out["vs_modeled"] = rel
        if rel > tol_mode_flops:
            violations.append(Violation(
                E_COST_DRIFT, f"decode_flops[{mode}]",
                f"physical-mode decode FLOPs ({flops:.3g}) drift {rel:.1%} "
                f"from the modeled baseline ({reference_flops:.3g}) — the "
                f"slot path must not change the step's compute beyond "
                f"{tol_mode_flops:.0%}").asdict())
    out["ok"] = not violations
    return out
