"""Auditing the serving hot path (port of ``repro/analysis``, DESIGN.md
§12).

Every headline property of the port — bit-exact slot-pool decode and
prefill, O(rows) pool updates, misses served only on a miss,
``strip_expert_params`` really stripping — is a property of what a serving
step does.  This package checks them per build by running each entry
point once and watching it:

* :mod:`repro_torch.analysis.step_audit` (``repro/analysis/jaxpr_audit.py``)
  — runs every serving entry point (decode per offload mode x ladder rung,
  prefill, admission, the admit scatter, the store's pool updates, the
  policy step) under a census of host reads and seam entries, and checks
  the contract table: the seam registry and guarding, updates in place,
  the weight-capture budget, the sync census;
* :mod:`repro_torch.analysis.cost_audit` (``repro/analysis/cost_audit.py``)
  — the bytes a pool update copies and the decode step's FLOPs (counted by
  ``torch.utils.flop_counter.FlopCounterMode``) against the
  :class:`~repro_torch.core.cost_model.CostModel` and the analytic model;
* :mod:`repro_torch.analysis.lint` (``repro/analysis/lint.py``) — an AST
  lint for the port's conventions (no bare ``assert`` on serving paths, no
  host syncs in the hot hooks, the seams called only from ``models/moe.py``,
  telemetry mutated only by its owners);
* :mod:`repro_torch.analysis.audit` (``repro/analysis/audit.py``) — the
  ``python -m repro_torch.analysis.audit`` CLI, with ``--self-test``'s
  seeded-violation fixtures (:mod:`repro_torch.analysis.selftest`,
  ``repro/analysis/selftest.py``) proving the audit fails loudly, not
  vacuously;
* :mod:`repro_torch.analysis.contracts` (``repro/analysis/contracts.py``)
  — the contract table and the report types.

Any resolved server can audit itself: ``ServeSpec(...).resolve(params)
.audit()``.
"""
from repro_torch.analysis.contracts import (GraphContract, GraphContractError,
                                            Violation)

__all__ = ["GraphContract", "GraphContractError", "Violation"]
