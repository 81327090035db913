"""The declarative contract table the serving-path audit enforces (port of
``repro/analysis/contracts.py``, DESIGN.md §12), and the violation and
report types every audit emits.

A contract is a set of facts about one run of a step, where the
reference's are facts about compiled artifacts: which host seams a
serving step may enter and when, which tensors a pool update or a decode
step must update in place (keep their storage, the reference's donation:
an update that reallocates turns the O(rows) commit into an O(pool) copy
without failing any runtime test), how large a tensor a stripped-params
step may close over, and how many host reads a hot-path step may perform
outside the seams (zero).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Tuple

# violation codes — one per distinct defect class; the seeded-violation
# self-test (analysis/selftest.py) proves each fires with its own code
E_CALLBACK_UNREGISTERED = "E_CALLBACK_UNREGISTERED"
E_CALLBACK_UNGUARDED = "E_CALLBACK_UNGUARDED"
E_CALLBACK_KIND = "E_CALLBACK_KIND"
E_DONATION_DROPPED = "E_DONATION_DROPPED"
E_CONST_CAPTURE = "E_CONST_CAPTURE"
E_SYNC_CENSUS = "E_SYNC_CENSUS"
E_COST_DRIFT = "E_COST_DRIFT"
E_ENTRY_BUILD = "E_ENTRY_BUILD"

ALL_CODES = (E_CALLBACK_UNREGISTERED, E_CALLBACK_UNGUARDED,
             E_CALLBACK_KIND, E_DONATION_DROPPED, E_CONST_CAPTURE,
             E_SYNC_CENSUS, E_COST_DRIFT, E_ENTRY_BUILD)

# no stripped-params serving step may close over a tensor larger than
# this many bytes: one captured expert row (3 x d x f x dtype_bytes, the
# smallest weight-capture regression) is far above it even on the smoke
# config
MAX_CONST_BYTES = 65536


@dataclasses.dataclass(frozen=True)
class Violation:
    """One broken contract: a machine-readable code, the entry point it
    was found in, and an actionable human detail."""
    code: str
    entry: str
    detail: str

    def __str__(self) -> str:
        return f"[{self.code}] {self.entry}: {self.detail}"

    def asdict(self) -> Dict[str, str]:
        return dataclasses.asdict(self)


class GraphContractError(RuntimeError):
    """Raised by ``ResolvedServe.audit()`` / the CLI when any contract is
    violated; carries the full violation list."""

    def __init__(self, violations: List[Violation]):
        self.violations = list(violations)
        lines = "\n  ".join(str(v) for v in self.violations)
        super().__init__(
            f"{len(self.violations)} graph-contract violation(s):\n"
            f"  {lines}")


@dataclasses.dataclass
class GraphContract:
    """What one entry point's run must satisfy.

    max_const_bytes  — weight-capture budget for tensors the step closes
                       over
    allow_consts     — tensors legitimately closed over above the budget
                       (the store's own host stacks, staging rows and
                       int8 twins); a tensor passes when it IS one of
                       these (identity) or matches one's (shape, dtype)
    in_place         — names of the tensors the entry must update in
                       place: each keeps its storage (``data_ptr``)
                       across the call (the reference's ``donate``)
    require_guarded  — every cond-required seam may be entered only on a
                       step that needs it (the decode fast-path contract:
                       zero host reads on an all-hit step)
    """
    max_const_bytes: int = MAX_CONST_BYTES
    allow_consts: Tuple[Any, ...] = ()
    in_place: Tuple[str, ...] = ()
    require_guarded: bool = True

    def const_allowed(self, const) -> bool:
        nbytes = getattr(const, "nbytes", 0)
        if nbytes <= self.max_const_bytes:
            return True
        for a in self.allow_consts:
            if a is const:
                return True
            if (tuple(getattr(a, "shape", ())) ==
                    tuple(getattr(const, "shape", ()))
                    and str(getattr(a, "dtype", "")) ==
                    str(getattr(const, "dtype", ""))):
                return True
        return False


@dataclasses.dataclass
class EntryPoint:
    """One audited serving entry point: a callable, the example arguments
    it runs on, and its contract.  ``kept(args, result)`` names the
    tensors the contract's ``in_place`` covers: called with ``result=None``
    before the run and with the run's result after it."""
    name: str
    fn: Any
    args: Tuple[Any, ...]
    contract: GraphContract = dataclasses.field(default_factory=GraphContract)
    kept: Optional[Callable[[Tuple[Any, ...], Any],
                            Dict[str, Any]]] = None
    check_consts: bool = True


def maybe_raise(report: Dict[str, Any],
                raise_on_violation: bool = True) -> Dict[str, Any]:
    viols = report.get("violations", [])
    if viols and raise_on_violation:
        raise GraphContractError([
            v if isinstance(v, Violation) else Violation(**v)
            for v in viols])
    return report


def default_rungs(mode: str) -> Tuple[str, ...]:
    """The ladder rungs that exist for an offload mode: physical modes
    build all three decode variants, "modeled" has no store (and so no
    ladder) — only the healthy variant exists."""
    return ("healthy", "degraded", "little") if mode != "modeled" \
        else ("healthy",)
