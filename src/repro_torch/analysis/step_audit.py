"""The serving-path audit: runs every serving entry point of a resolved
server once and checks what the run did (the torch counterpart of
``repro/analysis/jaxpr_audit.py``, which walks jaxprs and compiled HLO;
an eager step has neither, so the port watches the run itself).

Four checks per entry point (DESIGN.md §12):

* **sync census** — a ``TorchDispatchMode`` counts the ops that read
  device data on the host (``aten._local_scalar_dense``, ``nonzero``,
  ``masked_select``, the ``unique`` family, ``is_nonzero``, ``equal``,
  ``bincount``, ``repeat_interleave`` with tensor repeats and no
  ``output_size``, indexing by a bool mask) and a ``TorchFunctionMode``
  the explicit host reads (``.cpu()``, ``.numpy()``, ``.tolist()``); the
  registered host seams (``repro_torch.models.moe.callback_seam``) report
  their entries.  A data-dependent read outside a seam is
  ``E_SYNC_CENSUS``, a host read outside a seam ``E_CALLBACK_UNREGISTERED``,
  a host read inside a "stage" seam ``E_CALLBACK_KIND``, and a
  cond-required seam entered where the step did not need it (a
  ``read_misses`` of a layer where every row hit, so no miss tier
  followed) ``E_CALLBACK_UNGUARDED``.  On the CPU ``.cpu()`` dispatches
  nothing, so the seams' entries are how a step is seen to leave the
  device there; a kernel's plain version stands for the kernel and is not
  looked into (on the card the wrapper launches the kernel instead).
* **const capture** — the step's closure cells, recursively through
  closures, bound methods and the store's attributes: a tensor over
  ``MAX_CONST_BYTES`` that is neither one of the store's own buffers (its
  host stacks, staging rows and int8 twins) nor in the contract's
  allowlist is ``E_CONST_CAPTURE`` (``strip_expert_params`` really
  strips).
* **in place** — the tensors the contract names keep their storage
  (``data_ptr``) across the call: the pool's ``gate``, ``up``, ``down`` and
  ``cur`` across ``step_update`` and ``commit``, ``gate``, ``up`` and
  ``down`` across ``_copy_rows``, every cache leaf across a decode,
  prefill or admission; one that reallocated is ``E_DONATION_DROPPED``
  (the reference's ``aliased == [0, 1, 2, 3]`` and ``[0, 1, 2]``).
* **build** — an entry point that raises is ``E_ENTRY_BUILD``, never a
  silent skip.
"""
from __future__ import annotations

import functools
import os
import sys
import types
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch.overrides import TorchFunctionMode
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.analysis.contracts import (E_CALLBACK_KIND,
                                            E_CALLBACK_UNGUARDED,
                                            E_CALLBACK_UNREGISTERED,
                                            E_CONST_CAPTURE,
                                            E_DONATION_DROPPED,
                                            E_ENTRY_BUILD, E_SYNC_CENSUS,
                                            EntryPoint, GraphContract,
                                            Violation, default_rungs,
                                            maybe_raise)
from repro_torch.models.moe import add_seam_listener, remove_seam_listener

#: aten ops whose result the host has to read back (a scalar or a
#: data-dependent shape): each is a device sync on the card
SYNC_OPS = ("_local_scalar_dense", "nonzero", "masked_select", "unique",
            "_unique", "_unique2", "unique_dim", "unique_consecutive",
            "unique_dim_consecutive", "is_nonzero", "equal", "bincount")
#: tensor methods that read a tensor's data on the host
HOST_READS = ("cpu", "numpy", "tolist")

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_HERE = os.path.abspath(__file__)


@functools.lru_cache(maxsize=1)
def _plain_codes() -> frozenset:
    """The kernels' plain versions: on the card the wrappers launch the
    kernels instead, so what those read on the CPU is not the step's."""
    from repro_torch.kernels.expert_ffn.ops import expert_ffn_plain
    from repro_torch.kernels.flash_attention.ops import flash_attention_plain
    from repro_torch.kernels.gating.ops import gating_plain
    return frozenset(f.__code__ for f in (expert_ffn_plain, gating_plain,
                                          flash_attention_plain))


def _site() -> Tuple[bool, str]:
    """(inside a kernel's plain version, the innermost frame of the port
    outside this package) for the op being dispatched."""
    plain, site = _plain_codes(), None
    f = sys._getframe(2)
    while f is not None:
        if f.f_code in plain:
            return True, site or "?"
        fn = os.path.abspath(f.f_code.co_filename)
        if site is None and fn.startswith(_PKG) and fn != _HERE:
            site = (f"{os.path.relpath(fn, _PKG)}:{f.f_lineno} "
                    f"({f.f_code.co_name})")
        f = f.f_back
    return False, site or "?"


def _op_syncs(func, args, kwargs) -> bool:
    name = func._schema.name.split("::")[-1]
    if name in SYNC_OPS:
        return True
    if name == "repeat_interleave":
        return (len(args) > 1 and torch.is_tensor(args[1])
                and (kwargs or {}).get("output_size") is None)
    if name in ("index", "index_put", "index_put_"):
        idx = args[1] if len(args) > 1 else ()
        return any(torch.is_tensor(i) and i.dtype == torch.bool
                   for i in (idx or ()))
    return False


def _seam_work(args) -> bool:
    """Whether a stage or host seam's call has work: its last argument is
    the rows' hit mask (work when some row misses) or the experts to stage
    (work when there is one)."""
    last = args[-1] if args else None
    if isinstance(last, np.ndarray) and last.dtype == bool:
        return not bool(last.all())
    try:
        return len(last) > 0
    except TypeError:
        return True


class SyncCensus:
    """Counts, while active, the dispatched ops, the data-dependent reads
    and host reads with their sites, and the host seams entered (with the
    MoE layer ``lid`` each was called for)."""

    def __init__(self):
        self.n_ops = 0
        self.syncs: List[Tuple[str, str]] = []
        self.reads: List[Tuple[str, str]] = []
        self.kind_breaks: List[Tuple[str, str, str]] = []
        self.seams: List[Dict[str, Any]] = []
        self._stack: list = []
        census = self

        class _Dispatch(TorchDispatchMode):
            def __torch_dispatch__(self, func, types_, args=(), kwargs=None):
                census.n_ops += 1
                if not census._stack and _op_syncs(func, args, kwargs):
                    plain, site = _site()
                    if not plain:
                        census.syncs.append((str(func), site))
                return func(*args, **(kwargs or {}))

        class _Function(TorchFunctionMode):
            def __torch_function__(self, func, types_, args=(), kwargs=None):
                name = getattr(func, "__name__", "")
                if name in HOST_READS:
                    plain, site = _site()
                    top = census._stack[-1] if census._stack else None
                    if top is None and not plain:
                        census.reads.append((f".{name}()", site))
                    elif top is not None and top.kind == "stage":
                        census.kind_breaks.append((f".{name}()", site,
                                                   top.name))
                return func(*args, **(kwargs or {}))

        self._modes = (_Function(), _Dispatch())

    # the seam-listener protocol (models/moe.py::callback_seam)
    def enter(self, seam, args):
        lid = args[1] if len(args) > 1 and isinstance(args[1], int) else None
        self.seams.append({"name": seam.name, "kind": seam.kind,
                           "cond_required": seam.cond_required, "lid": lid,
                           "work": True if seam.kind == "read"
                           else _seam_work(args[1:])})
        self._stack.append(seam)

    def exit(self, seam):
        self._stack.pop()

    def __enter__(self):
        add_seam_listener(self)
        for m in self._modes:
            m.__enter__()
        return self

    def __exit__(self, *exc):
        for m in reversed(self._modes):
            m.__exit__(*exc)
        remove_seam_listener(self)
        return False


# --------------------------------------------------------------------------
# const capture
# --------------------------------------------------------------------------

_ATOMS = (str, bytes, int, float, bool, complex, type(None), type,
          types.ModuleType, torch.dtype, torch.device, torch.Generator)


def store_buffers(store) -> List[torch.Tensor]:
    """The tensors an expert store owns by design: its host stacks, its
    staging rows (miss staging, the overlap stage buffer) and its int8
    twins."""
    bufs = list(store.host.values())
    for d in (store._miss_buf, store._stage_buf, store._little):
        if d:
            bufs.extend(v for v in d.values() if torch.is_tensor(v))
    return bufs


def closure_tensors(root, max_depth: int = 8):
    """Every tensor and numpy array reachable from ``root``'s closure cells,
    bound ``self``, partial arguments and object attributes -> (list of
    (path, array), the buffers of every expert store met on the way)."""
    seen, found, owned = set(), [], []

    def visit(obj, path, depth):
        if isinstance(obj, _ATOMS) or id(obj) in seen or depth > max_depth:
            return
        seen.add(id(obj))
        if isinstance(obj, (torch.Tensor, np.ndarray)):
            found.append((path, obj))
            return
        if isinstance(obj, dict):
            for k, v in obj.items():
                visit(v, f"{path}[{k!r}]", depth + 1)
            return
        if isinstance(obj, (list, tuple, set, frozenset)):
            for i, v in enumerate(obj):
                visit(v, f"{path}[{i}]", depth + 1)
            return
        if isinstance(obj, types.FunctionType):
            for name, cell in zip(obj.__code__.co_freevars,
                                  obj.__closure__ or ()):
                try:
                    v = cell.cell_contents
                except ValueError:          # an empty cell
                    continue
                visit(v, f"{path}.{name}", depth + 1)
            return
        if isinstance(obj, types.MethodType):
            visit(obj.__self__, f"{path}.__self__", depth + 1)
            visit(obj.__func__, path, depth + 1)
            return
        if isinstance(obj, functools.partial):
            visit((obj.func, obj.args, obj.keywords), path, depth + 1)
            return
        if type(obj).__module__.split(".")[0] == "torch":
            return
        if hasattr(obj, "build_view") and isinstance(
                getattr(obj, "host", None), dict):
            owned.extend(store_buffers(obj))
        attrs = getattr(obj, "__dict__", None)
        if attrs:
            for k, v in attrs.items():
                visit(v, f"{path}.{k}", depth + 1)

    visit(root, "fn", 0)
    return found, owned


# --------------------------------------------------------------------------
# per-entry audit
# --------------------------------------------------------------------------

def _storage(t) -> Tuple[int, int]:
    return (t.untyped_storage().data_ptr(), t.data_ptr())


def audit_entry(ep: EntryPoint) -> Dict[str, Any]:
    """Run one entry point under the census and check its contract.
    Returns ``{"name", "n_ops", "callbacks", "consts", "in_place",
    "violations"}`` with violations as :class:`Violation` (never raises on a
    contract failure; a failed run is itself a violation, so a broken entry
    point fails loudly instead of vanishing)."""
    violations: List[Violation] = []
    record: Dict[str, Any] = {"name": ep.name, "callbacks": [],
                              "consts": [], "in_place": [],
                              "violations": violations}
    try:
        before = ({k: _storage(t) for k, t in ep.kept(ep.args, None).items()}
                  if ep.kept is not None else {})
        with SyncCensus() as census:
            result = ep.fn(*ep.args)
        after = ({k: _storage(t) for k, t in ep.kept(ep.args, result).items()}
                 if ep.kept is not None else {})
    except Exception as e:              # noqa: BLE001 — reported, not hidden
        violations.append(Violation(
            E_ENTRY_BUILD, ep.name,
            f"entry point failed to run: {type(e).__name__}: {e}"))
        return record
    record["n_ops"] = census.n_ops

    # the sync census
    for op, site in census.syncs:
        violations.append(Violation(
            E_SYNC_CENSUS, ep.name,
            f"{op} at {site} reads device data on the host outside any "
            f"registered seam — every step would wait on the device"))
    for what, site in census.reads:
        violations.append(Violation(
            E_CALLBACK_UNREGISTERED, ep.name,
            f"{what} at {site} reads a tensor on the host outside the "
            f"registered seams — move the read into a seam "
            f"(repro_torch.models.moe.callback_seam) or off the step"))
    for what, site, seam in census.kind_breaks:
        violations.append(Violation(
            E_CALLBACK_KIND, ep.name,
            f"seam {seam!r} is registered as a stage seam but {what} at "
            f"{site} reads device data on the host inside it"))
    served = {s["lid"] for s in census.seams
              if s["kind"] != "read" and s["work"]}
    n_unguarded = 0
    for s in census.seams:
        needed = s["work"] if s["kind"] != "read" else s["lid"] in served
        record["callbacks"].append({"seam": s["name"], "kind": s["kind"],
                                    "lid": s["lid"], "needed": needed})
        if ep.contract.require_guarded and s["cond_required"] \
                and not needed:
            n_unguarded += 1
            violations.append(Violation(
                E_CALLBACK_UNGUARDED, ep.name,
                f"seam {s['name']!r} entered for MoE layer {s['lid']} on a "
                f"step that did not need it (no row of the layer missed) — "
                f"every step pays the host round trip; an all-hit step "
                f"must not leave the device"))
    record["n_callbacks"] = len(census.seams)
    record["n_unguarded"] = n_unguarded

    # weight capture
    if ep.check_consts:
        found, owned = closure_tensors(ep.fn)
        contract = GraphContract(
            max_const_bytes=ep.contract.max_const_bytes,
            allow_consts=ep.contract.allow_consts + tuple(owned))
        for path, c in found:
            rec = {"path": path, "nbytes": int(c.nbytes),
                   "shape": tuple(c.shape), "dtype": str(c.dtype)}
            record["consts"].append(rec)
            if not contract.const_allowed(c):
                violations.append(Violation(
                    E_CONST_CAPTURE, ep.name,
                    f"the step closes over a {rec['nbytes']}-byte tensor "
                    f"{rec['dtype']}{list(rec['shape'])} at {path} (budget "
                    f"{contract.max_const_bytes}B) — an expert weight "
                    f"captured by the step defeats strip_expert_params; "
                    f"pass it through params/state instead"))

    # in place
    for name in ep.contract.in_place:
        if name in before and after.get(name) == before[name]:
            record["in_place"].append(name)
        else:
            violations.append(Violation(
                E_DONATION_DROPPED, ep.name,
                f"{name!r} did not keep its storage across the call "
                f"(kept: {sorted(record['in_place'])}) — the update "
                f"reallocated; write the rows into the existing tensor"))
    return record


# --------------------------------------------------------------------------
# entry-point enumeration for a resolved server
# --------------------------------------------------------------------------

def _example_tokens(cfg, batch: int, seq: int, device, seed: int = 7):
    rng = np.random.default_rng(seed)
    return torch.as_tensor(rng.integers(1, cfg.vocab, (batch, seq)),
                           dtype=torch.int32, device=device)


def _leaves(prefix: str, tree) -> Dict[str, torch.Tensor]:
    from repro_torch.tree import tree_map_with_path
    out = {}
    tree_map_with_path(lambda path, t: out.__setitem__(
        prefix + "/" + "/".join(map(str, path)), t), tree)
    return out


def _in_place(kept, args) -> GraphContract:
    return GraphContract(in_place=tuple(kept(args, None)))


def decode_entry(rs, rung: str, state) -> EntryPoint:
    """The decode step of one ladder rung on ``state``: its cache leaves
    stay in place."""
    mode = rs.spec.offload.mode

    def kept(args, result):
        st = args[1] if result is None else result[0]
        return _leaves("caches", st["caches"])

    args = (rs.params, state, None)
    return EntryPoint(name=f"decode[{mode}/{rung}]",
                      fn=rs.resilient_decode().variant(rung), args=args,
                      contract=_in_place(kept, args), kept=kept)


def _fresh_target(store) -> np.ndarray:
    """An (L, E) pool target that differs from the pool's residents in
    every layer, so a plan toward it copies rows."""
    L, E, S = store.n_layers, store.E, store.n_slots
    target = np.zeros((L, E), bool)
    for l in range(L):
        held = [int(e) for e in store._cur[l] if e >= 0]
        out = [e for e in range(E) if e not in held]
        target[l, (out + held)[:S]] = True
    return target


POOL = ("gate", "up", "down", "cur")


def store_entries(store, off) -> List[EntryPoint]:
    """The store's pool updates: ``step_update`` (plan and copy straight
    into the pool), ``_copy_rows`` (the row copies) and, in overlap mode,
    ``commit`` (the staged rows scattered into the pool)."""
    def pool(keys):
        return lambda args, result: {k: args[0][k] for k in keys}

    entries = []
    args = (off, _fresh_target(store))
    entries.append(EntryPoint(
        name="store.step_update", fn=store.step_update, args=args,
        contract=GraphContract(in_place=POOL), kept=pool(POOL)))
    S = store.n_slots
    held = [int(e) for e in store._cur[0] if e >= 0]
    rows = [(0, s % S, e) for s, e in enumerate(
        [e for e in range(store.E) if e not in held][:2] or [0, 0])]
    entries.append(EntryPoint(
        name="store._copy_rows", fn=store._copy_rows, args=(off, rows),
        contract=GraphContract(in_place=POOL[:3]), kept=pool(POOL[:3])))
    if store.mode == "overlap":
        def stage_commit(off, target):
            store.stage(target)
            return store.commit(off)

        entries.append(EntryPoint(
            name="store.commit", fn=stage_commit,
            args=(off, _fresh_target(store)),
            contract=GraphContract(in_place=POOL), kept=pool(POOL)))
    return entries


def build_entry_points(rs, rungs: Optional[Tuple[str, ...]] = None,
                       prompt_len: int = 8, state=None) -> List[EntryPoint]:
    """Every serving function a ``ResolvedServe`` can dispatch: the decode
    step per ladder rung, the wave prefill, the admission prefill, the
    admit scatter, the store's pool updates and the policy ``step``.
    ``state`` (default: a fresh slot table, every row dead, so every row
    of a decode hits) is the serve state the decode entries run on."""
    from repro_torch.core.policy import Observation
    from repro_torch.models.config import layer_pattern
    from repro_torch.models.model import init_caches
    from repro_torch.serving.steps import make_admit_step

    spec = rs.spec
    cfg = spec.cfg
    store = rs.store
    mode = spec.offload.mode
    B, dev = spec.batch_size, rs.device
    if rungs is None:
        rungs = default_rungs(mode)
    if state is None:
        state = rs.init_state(per_slot=True)

    entries: List[EntryPoint] = []
    for rung in rungs:
        if mode == "modeled" and rung != "healthy":
            continue
        entries.append(decode_entry(rs, rung, state))

    def caches_of(get):
        """The cache leaves the entry must write in place: ``get(args)``'s
        tree, read from the arguments before and after the call."""
        return lambda args, result: _leaves("caches", get(args))

    prefill_caches = caches_of(lambda args: args[2])
    off0 = state.get("offload")
    args = (rs.params, _example_tokens(cfg, B, prompt_len, dev),
            init_caches(cfg, B, spec.max_len, device=dev), off0)
    entries.append(EntryPoint(
        name=f"prefill[{mode}]", fn=rs.prefill_step(), args=args,
        contract=_in_place(prefill_caches, args), kept=prefill_caches))
    caches1 = init_caches(cfg, 1, spec.max_len, device=dev)
    toks1 = _example_tokens(cfg, 1, max(prompt_len, spec.min_bucket), dev)
    args = (rs.params, toks1, caches1, prompt_len, off0)
    entries.append(EntryPoint(
        name=f"admit_prefill[{mode}]", fn=rs.admit_prefill(), args=args,
        contract=_in_place(prefill_caches, args), kept=prefill_caches))
    first_tok = torch.zeros((1, 1), dtype=torch.int32, device=dev)
    args = (state, caches1, first_tok, 0, prompt_len)
    state_caches = caches_of(lambda args: args[0]["caches"])
    entries.append(EntryPoint(
        name="admit_step", fn=make_admit_step(cfg), args=args,
        contract=_in_place(state_caches, args), kept=state_caches))

    if store is not None:
        entries.extend(store_entries(store, off0))

    policy = rs.policy
    if getattr(policy, "schedules", False) and cfg.moe is not None \
            and "dali" in state:
        n_moe = sum(1 for _, mlp in layer_pattern(cfg) if mlp == "moe")
        E, d = cfg.moe.n_routed, cfg.d_model
        z = functools.partial(torch.zeros, device=dev)
        obs = Observation(gate_in=z((n_moe, B, d)), routers=z((n_moe, d, E)),
                          res_vecs=z((n_moe, d)),
                          token_mask=z((B,), dtype=torch.bool))
        entries.append(EntryPoint(
            name=f"policy.step[{type(policy).__name__}]", fn=policy.step,
            args=(state["dali"], z((n_moe, E), dtype=torch.int32), obs)))
    return entries


# --------------------------------------------------------------------------
# the resolved-server audit (ResolvedServe.audit backs onto this)
# --------------------------------------------------------------------------

def audit_resolved(rs, rungs: Optional[Tuple[str, ...]] = None,
                   raise_on_violation: bool = True, prompt_len: int = 8,
                   state=None) -> Dict[str, Any]:
    """Audit every serving entry point of one resolved server against the
    contracts.  Returns the machine-readable report; raises
    :class:`GraphContractError` on any violation unless told not to."""
    mode = rs.spec.offload.mode
    entries = build_entry_points(rs, rungs=rungs, prompt_len=prompt_len,
                                 state=state)
    records, violations = [], []
    for ep in entries:
        rec = audit_entry(ep)
        violations.extend(rec.pop("violations"))
        records.append(rec)
    report = {"mode": mode,
              "rungs": list(rungs or default_rungs(mode)),
              "entries": records,
              "violations": [v.asdict() for v in violations]}
    report["ok"] = not violations
    return maybe_raise(report, raise_on_violation)
