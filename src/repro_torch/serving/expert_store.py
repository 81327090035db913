"""Physical expert residency: pinned host store + device slot pool (port of
``repro/serving/expert_store.py``).

* **Host store** — the routed experts' gate/up/down stacks as ``(L, E, d,
  f)`` / ``(L, E, f, d)`` tensors in page-locked CPU memory (when the pool
  lives on a card), so every copy to the card is a DMA that does not block
  the host.  Params whose expert stacks already sit on the host (``init_model
  (experts="host")``, ``bridge.to_torch(experts="host")``) are adopted without
  a copy where their layout is already ``(L, E, ...)``; for a pool on a card
  any other host layout raises rather than being copied a second time.
* **Device slot pool** — ``(L, n_slots, ...)`` per matrix plus the slot table
  ``cur (L, n_slots)`` (expert id per slot, -1 free).  The store keeps a host
  mirror of the table (``_cur``, planned against) and a host copy of the table
  the card reads (``_dev_cur``), so no plan and no miss decision reads the
  table back from the card.
* **Slot plans** — ``lower_slot_plan_np`` (a copy of the reference's)
  lowers a policy target to at most ``max_moves`` evict-slot ->
  insert-expert moves per layer.

Streaming, with the reference's semantics and CUDA's mechanisms (one pool
generation; the decode step ends in a token sync, after which nothing reads
the pool, so plans write slot rows in place):

* ``blocking`` — ``pre_step`` plans, copies the rows from the pinned store
  into the pool on a side stream and waits for them: step t's decision is
  readable by step t+1, with the copy on the critical path.
* ``overlap`` — ``post_dispatch`` plans and copies the rows into a staging
  buffer on the side stream while the step just dispatched runs (it may
  still read the slots the plan overwrites); the next ``pre_step`` (or a
  ``prefill_barrier``) scatters them into the pool behind an event: readable
  at t+2.
* ``pipelined`` — ``pre_step`` plans and copies the rows straight into the
  pool on the side stream, layer by layer, recording one event per layer;
  layer l's MoE waits on its own event (``wait_layer``), so its copy overlaps
  layers < l: readable by step t+1, off the critical path.

Misses (experts a step routes to that are not pooled) take one of two tiers:

* ``fetch`` — the missing experts are copied from the pinned store into a
  small miss-staging buffer and K2 runs over them with ``expert_ids`` = staging
  rows, so every row's arithmetic is the full-resident one (bit-equal).
* ``host`` — the missing rows' FFN runs on the CPU in float32 and only the
  ``(d,)`` rows go back (the paper's CPU execution tier; close, not equal).

* ``little`` — the missing experts are dequantized from an int8 twin of
  every (L, E) expert that stays on the device (``little_view``) into the
  miss-staging rows, and K2 runs over them as in the fetch tier: no host
  read, int8 quality.  It is the bottom rung of the degradation ladder.

Learning which rows miss costs one small device-to-host read per MoE layer
(``miss_reads``): the eager counterpart of the reference's ``lax.cond`` +
``pure_callback``.  Nothing falls back quietly: a failed pin, copy or launch
raises.

Robustness (the reference's DESIGN.md §10): with ``faults=...`` the store
consults a seeded ``FaultInjector`` (serving/faults.py) before the host
reads of every plan and miss fetch, retrying injected transient faults
with a doubling backoff (``_guard_transient``); it flips bits in staged
device rows when a ``corrupt_rows`` fault is active (a bad transfer),
checks every staged row's checksum against the pinned store's and copies
the flagged rows again; it waits on each plan's copies and times them
against a ``LinkWatchdog`` deadline budgeted from the cost model's link
constants (an injected ``link_degrade`` pads the wait); and it drives a
``DegradationLadder`` once per step:

  healthy -> degraded (halve the move budget; the serving tier swaps in a
  policy re-solved with the re-fit ``t_trans`` and no prefetch) -> little
  (streaming suspended, misses served by the int8 twins) -> healthy once
  an expert-sized health probe sees the link heal.

The retry loop catches only the injector's own exceptions.  Without
``faults`` no checksum is taken and nothing waits that would not wait
anyway.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time

import numpy as np
import torch

from repro_torch.core.cost_model import CostModel
from repro_torch.device import pinned_empty
from repro_torch.kernels.expert_ffn.ops import ACTS
from repro_torch.models.config import ModelConfig, scan_pattern
from repro_torch.models.moe import EXPERT_KEYS, callback_seam
from repro_torch.serving.faults import (DEGRADED, HEALTHY, LITTLE,
                                        DegradationLadder, FaultInjector,
                                        HostReadError, LinkWatchdog,
                                        TransientFault)
from repro_torch.spans import span

FALLBACKS = ("fetch", "host", "little")
STORE_MODES = ("blocking", "overlap", "pipelined")


# --------------------------------------------------------------------------
# Row checksums (host truth vs. staged device rows)
# --------------------------------------------------------------------------
# A cheap per-row integrity check: the xor-fold of a row's raw bits, each
# 16-bit (or 32-bit) word zero-extended to 32 bits, as the reference's
# ``_row_checksums_np`` computes it: a staged row matches its host source
# bit for bit iff the checksums match, NaN payloads and -0.0 included.

def _xor_fold(v: torch.Tensor) -> torch.Tensor:
    """(R, n) integer tensor -> (R,): the xor of each row (pairwise halves;
    xor's order does not matter)."""
    while v.shape[1] > 1:
        h = v.shape[1] // 2
        w = v[:, :h] ^ v[:, h:2 * h]
        if v.shape[1] % 2:
            w[:, :1] ^= v[:, 2 * h:]
        v = w
    return v[:, 0]


def _row_fold(t: torch.Tensor) -> torch.Tensor:
    """(R,) int64 checksum of each leading-axis row of one tensor."""
    two = t.element_size() == 2
    v = t.contiguous().reshape(t.shape[0], -1).view(
        torch.int16 if two else torch.int32)
    lanes, bits = (4, 16) if two else (2, 32)
    mask = (1 << bits) - 1
    if v.shape[1] % lanes == 0 and v.storage_offset() % lanes == 0:
        # fold 64-bit words of ``lanes`` words each, then the lanes
        w = _xor_fold(v.view(torch.int64))
        x = w
        for i in range(1, lanes):
            x = x ^ (w >> (bits * i))
        return x & mask
    return _xor_fold(v).to(torch.int64) & mask


def row_checksums(*tensors) -> torch.Tensor:
    """(R,) int64 checksums of the leading-axis rows of ``tensors`` (xor-ed
    across them), on their device; equal to the reference's
    ``_row_checksums_np`` (uint32) value for value."""
    out = None
    for t in tensors:
        x = _row_fold(t)
        out = x if out is None else out ^ x
    return out


def moe_layer_layout(cfg: ModelConfig):
    """(prefix_moe_blocks, scan_moe_positions, n_super): which prefix blocks
    / scan pattern positions are MoE, in the canonical layer order every
    (L, ...) stack uses (prefix first, then scan super-block-major)."""
    prefix_pat, period_pat, n_super = scan_pattern(cfg)
    prefix_moe = [i for i, (_, mlp) in enumerate(prefix_pat) if mlp == "moe"]
    scan_moe = [p for p, (_, mlp) in enumerate(period_pat) if mlp == "moe"]
    return prefix_moe, scan_moe, n_super


def _interleaved_base(stacks):
    """The (n_super * P, ...) host tensor whose views ``[j::P]`` are the P
    ``stacks`` (each (n_super, ...)), or None when they are not laid out
    so (on the device, copies, or another order)."""
    first = stacks[0]
    if first.device.type != "cpu" or not first[0].is_contiguous():
        return None
    P, row = len(stacks), first[0].numel()
    shape = (first.shape[0] * P,) + tuple(first.shape[1:])
    for j, t in enumerate(stacks):
        if (t.device.type != "cpu" or tuple(t.shape) != tuple(first.shape)
                or t.dtype != first.dtype
                or t.untyped_storage().data_ptr()
                != first.untyped_storage().data_ptr()
                or t.storage_offset() != first.storage_offset() + j * row
                or (t.shape[0] > 1 and t.stride(0) != P * row)
                or not t[0].is_contiguous()):
            return None
    return first.as_strided(shape, (row,) + first[0].stride(),
                            first.storage_offset())


def lower_slot_plan_np(cur, target, max_moves: int):
    """Lower a per-layer target resident set to a bounded slot plan.

    cur (L, S) int32 — expert id per slot (-1 free); target (L, E) bool.
    Returns ``(new_cur, ins_experts, ins_slots, valid)`` with plan arrays
    (L, max_moves): up to ``max_moves`` inserts per layer, each pairing a
    wanted-but-missing expert (ascending id) with an available slot — free
    slots first, then slots whose expert fell out of the target (ascending
    slot id).  Experts evicted from the target but not overwritten stay
    pooled.  A copy of the reference's NumPy lowering, plan for plan."""
    cur = np.asarray(cur)
    target = np.asarray(target, bool)
    L, S = cur.shape
    M = max_moves
    new_cur = cur.copy()
    ins_e = np.full((L, M), -1, np.int32)
    ins_s = np.full((L, M), S, np.int32)
    valid = np.zeros((L, M), bool)
    for l in range(L):
        c = cur[l]
        want = target[l]
        pooled = np.zeros(target.shape[1], bool)
        pooled[c[c >= 0]] = True
        free = np.where(c < 0)[0]
        evict = np.where((c >= 0) & ~want[np.clip(c, 0, None)])[0]
        slots = np.concatenate([free, evict])[:M]
        exps = np.where(want & ~pooled)[0][:M]
        n = min(len(slots), len(exps), M)
        ins_e[l, :n] = exps[:n]
        ins_s[l, :n] = slots[:n]
        valid[l, :n] = True
        new_cur[l, slots[:n]] = exps[:n]
    return new_cur, ins_e, ins_s, valid


def _slot_of(cur, E: int) -> np.ndarray:
    """(L, S) slot table -> (L, E) expert -> slot map (-1 = not pooled)."""
    L, S = cur.shape
    out = np.full((L, E), -1, np.int32)
    for l in range(L):
        ok = cur[l] >= 0
        out[l, cur[l][ok]] = np.nonzero(ok)[0]
    return out


class ExpertStore:
    """Pinned host expert weights + device slot pool for one model's MoE
    layers.

    ``init_device_state`` seeds the pool from the policy's initial resident
    set and returns ``state["offload"]`` (``{"gate","up","down","cur"}``);
    ``build_view`` gives the model each MoE layer's pool slice and slot map;
    ``pre_step`` / ``post_dispatch`` / ``next_target`` are the serving loop's
    hooks and ``prefill_barrier`` makes the pool coherent before an admission
    prefill.  ``device`` is where the pool lives (default: the router's).

    The fault seam (module docstring): ``faults`` (a schedule or a
    ``FaultInjector``) arms it, with a ``LinkWatchdog`` budgeted from
    ``cost_model``'s link constants and a ``DegradationLadder`` unless
    given; ``verify`` (default: on with faults) checksums staged rows;
    ``little`` builds the int8 twins at construction (False keeps the
    ladder off its little rung); ``max_retries`` / ``retry_backoff_s`` bound
    the transient retries, ``probe_interval`` the steps between health
    probes."""

    def __init__(self, params, cfg: ModelConfig, n_slots: int,
                 max_moves: int = 4, fallback: str = "fetch",
                 mode: str = "overlap", faults=None, cost_model=None,
                 watchdog=None, ladder=None, little=None, verify=None,
                 max_retries: int = 3, retry_backoff_s: float = 2e-3,
                 probe_interval: int = 3, seed: int = 0,
                 prefill_rows=None, device=None, clock=time.perf_counter,
                 sleep=time.sleep):
        if cfg.moe is None:
            raise ValueError("ExpertStore needs an MoE architecture")
        if fallback not in FALLBACKS:
            raise ValueError(f"fallback must be one of "
                             f"{'|'.join(FALLBACKS)}, got {fallback!r}")
        if mode not in STORE_MODES:
            raise ValueError(f"mode must be one of "
                             f"{'|'.join(STORE_MODES)}, got {mode!r}")
        self.mode = mode
        self.cfg = cfg
        m = cfg.moe
        self.E = m.n_routed
        self.d = cfg.d_model
        self.f = m.d_expert or cfg.d_ff
        self.n_slots = n_slots
        self.max_moves = max_moves
        self.fallback = fallback
        self.prefill_rows = int(prefill_rows) if prefill_rows else n_slots
        if not 0 < self.prefill_rows <= self.E:
            raise ValueError(f"prefill_rows={self.prefill_rows} must be in "
                             f"1..n_experts={self.E}")
        if self.n_slots > self.E:
            raise ValueError(f"n_slots={n_slots} exceeds n_experts={self.E}")
        self._act = ACTS[cfg.act]
        prefix_moe, scan_moe, n_super = moe_layer_layout(cfg)
        self._prefix_moe = prefix_moe
        self._scan_moe = scan_moe
        self._n_super = n_super
        self.n_layers = len(prefix_moe) + n_super * len(scan_moe)
        router = (params["prefix"][prefix_moe[0]] if prefix_moe
                  else params["scan"][scan_moe[0]])["mlp"]["router"]
        self.device = torch.device(device) if device is not None \
            else router.device
        self.host = {k: self._host_stack(params, k) for k in EXPERT_KEYS}
        self.dtype = self.host["gate"].dtype
        self.expert_bytes = int(sum(self.host[k][0, 0].numel()
                                    * self.host[k].element_size()
                                    for k in EXPERT_KEYS))
        self._tel = {
            "fallback_rows": 0,        # (token, k) rows served by misses
            "fallback_fetches": 0,     # experts demand-fetched
            "h2d_rows": 0,             # experts streamed into the pool
            "h2d_bytes": 0,
            "miss_reads": 0,           # decode: per-layer miss reads
            "prefill_miss_reads": 0,   # prefill: per-layer miss reads
            "prefill_fetch_rows": 0,   # experts wave-streamed into sweeps
            "prefill_waves": 0,
            "prefill_host_rows": 0,    # (token, k) rows the host tier ran
            "retries": 0,              # transient-fault retries that fired
            "stalls": 0,               # injected stage stalls hit
            "read_errors": 0,          # injected host read errors hit
            "stage_aborts": 0,         # plans dropped after retry exhaustion
            "corrupt_caught": 0,       # staged rows the checksums flagged
            "restaged_rows": 0,        # flagged rows copied again
            "probes": 0,               # health-probe copies
            "little_steps": 0,         # steps served with streaming suspended
            "host_syncs": 0,           # host waits on the card (reads,
                                       # pageable uploads, stream syncs)
        }
        self._drained = dict(self._tel)
        self._cur = np.full((self.n_layers, n_slots), -1, np.int32)
        self._dev_cur = self._cur.copy()
        self._slot_of = _slot_of(self._dev_cur, self.E)
        self._slot_of_dev = None
        cuda = self.device.type == "cuda"
        self._copy_stream = torch.cuda.Stream(self.device) if cuda else None
        self._layer_events = {}      # pipelined: layer -> copy event
        self._staged = None          # overlap: (rows, new_cur, event)
        self._stage_buf = None       # overlap: staging rows
        self._stage_free = None      # overlap: event after the last commit
        self._miss_buf = None        # fetch tier / prefill waves: staging
        # -- robustness seam (the reference's DESIGN.md §10) ----------------
        # ``clock`` / ``sleep`` time the copies and pad them under an
        # injected slowdown (tests pass a simulated pair)
        self._clock, self._sleep = clock, sleep
        self.injector = (faults if isinstance(faults, FaultInjector)
                         else FaultInjector(faults, seed=seed)
                         if faults is not None else None)
        self.max_retries = int(max_retries)
        self.retry_backoff_s = float(retry_backoff_s)
        self.probe_interval = max(1, int(probe_interval))
        if watchdog is None and self.injector is not None:
            cm = cost_model or CostModel.for_config(cfg)
            gbps = (cm.link_gbps if cm.link_gbps is not None
                    else cm.profile.link_gbps)
            lat = (cm.link_latency_s if cm.link_latency_s is not None
                   else cm.profile.link_latency_s)
            watchdog = LinkWatchdog(self.expert_bytes, gbps, lat)
        self.watchdog = watchdog
        if ladder is None and self.watchdog is not None:
            ladder = DegradationLadder(self.watchdog,
                                       enable_little=little is not False)
        self.ladder = ladder
        self._verify = bool(verify if verify is not None
                            else self.injector is not None)
        self._move_cap = None        # max_moves override while DEGRADED
        self._suspended = False      # streaming off while LITTLE
        self._steps_since_obs = 0
        self._truth = {}             # (layer, expert) -> host checksum
        self._little = None
        if little is True or fallback == "little":
            self._build_little()

    # -- host store ----------------------------------------------------------

    def _host_stack(self, params, name):
        """(L, E, ...) host tensor of one expert matrix, pinned when the pool
        lives on a card.  Scan stacks that already lie on the host in that
        layout (no MoE prefix; one contiguous stack, or the P MoE positions'
        views ``[j::P]`` of one tensor, as ``init_model(experts="host")``
        draws a hybrid) are adopted without a copy.  For a pool on a card,
        stacks that already lie on the host in any other way raise: the
        store would hold a second host copy of them (Jamba's 77.3 GB do not
        fit twice on a 96 GiB host)."""
        pin = self.device.type == "cuda"
        chunks = [params["prefix"][i]["mlp"][name]
                  for i in self._prefix_moe]
        per_pos = [params["scan"][p]["mlp"][name] for p in self._scan_moe]
        whole = None if chunks else _interleaved_base(per_pos)
        if whole is not None and (not pin or whole.is_pinned()):
            return whole
        if pin and any(t.device.type == "cpu" for t in chunks + per_pos):
            raise ValueError(
                f"the routed {name!r} stacks lie in host memory, but not as "
                "one pinned (L, E, ...) tensor whose views [j::P] are the P "
                "MoE positions' stacks: the store would need a second host "
                "copy of them; draw the params with init_model(experts="
                "'host') or keep the experts on the card")
        for s in range(self._n_super):
            chunks += [p[s] for p in per_pos]
        shape = (len(chunks),) + tuple(chunks[0].shape)
        out = (pinned_empty(shape, chunks[0].dtype) if pin
               else torch.empty(shape, dtype=chunks[0].dtype))
        for l, c in enumerate(chunks):
            out[l].copy_(c)
        return out

    # -- telemetry -----------------------------------------------------------

    def _bump(self, name: str, v=1):
        self._tel[name] += v

    def count_sync(self, n: int = 1):
        """Count ``n`` host waits on the card made at a site of the slot
        path outside the store (``models/moe.py`` uploads the miss rows'
        staging indices from pageable memory)."""
        self._bump("host_syncs", n)

    def stats(self) -> dict:
        """Monotonic counter totals."""
        return dict(self._tel)

    def drain(self) -> dict:
        """Counter deltas since the previous drain (snapshot-and-reset)."""
        out = {k: self._tel[k] - self._drained[k] for k in self._tel}
        self._drained = dict(self._tel)
        return out

    def health(self) -> dict:
        """Ladder / watchdog view for reports."""
        out = {"ladder_state": self.ladder.state if self.ladder else HEALTHY,
               "transitions": list(self.ladder.transitions)
               if self.ladder else [],
               "suspended": self._suspended,
               "move_cap": self._move_cap}
        if self.watchdog is not None:
            out.update(link_gbps=self.watchdog.gbps,
                       link_latency_s=self.watchdog.latency_s,
                       deadline_misses=self.watchdog.deadline_misses,
                       links={self.watchdog.name: self.watchdog.report()})
        return out

    def reset_stats(self):
        """Zero every counter (after a calibration run through the store, so
        that a server built on it counts its own serve only)."""
        self._tel = {k: 0 for k in self._tel}
        self._drained = dict(self._tel)

    # -- robustness seam (the reference's DESIGN.md §10) ---------------------

    def _observe(self, nbytes: int, seconds: float):
        if self.watchdog is not None:
            self.watchdog.observe(nbytes, seconds)
        self._steps_since_obs = 0

    def _fault_sleep(self, nbytes: int):
        """Model an injected link slowdown: pad the just-finished copy to
        ``factor x`` the healthy baseline (the watchdog's calibrated
        expectation, floored at its observed median), so the slowdown is
        detectable against the deadline whatever the real link's rate."""
        if self.injector is None or self.watchdog is None:
            return
        k = self.injector.link_factor()
        if k > 1.0:
            base = max(self.watchdog.expected_s(nbytes),
                       self.watchdog.floor_s)
            self._sleep(base * (k - 1.0))

    def _guard_transient(self, what: str) -> bool:
        """Run the injected transient checks with bounded retry and a
        doubling backoff.  Returns True once clear; False when retries are
        exhausted — the caller then skips this step's plan, which is always
        safe (the mirror has not advanced, so misses take the tier).  Only
        the injector's own exceptions are caught."""
        if self.injector is None:
            return True
        delay = self.retry_backoff_s
        for _ in range(self.max_retries + 1):
            try:
                self.injector.maybe_stall()
                self.injector.maybe_read_error()
                return True
            except HostReadError:
                self._bump("read_errors")
            except TransientFault:
                self._bump("stalls")
            self._bump("retries")
            self._sleep(delay)
            delay *= 2.0
        self._bump("stage_aborts")
        return False

    def _probe(self):
        """One expert-sized copy to the device (into miss-staging row 0,
        which nothing reads between steps), waited on and timed under the
        injected link factor: keeps the watchdog observed while staging is
        idle or suspended.  Expert-sized on purpose: a small probe would be
        latency-bound and a bandwidth slowdown would hide under the
        deadline's floor."""
        buf = self._miss_staging(1)
        t0 = self._clock()
        for k in EXPERT_KEYS:
            buf[k][0].copy_(self.host[k][0, 0], non_blocking=True)
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()
        self._bump("host_syncs")
        self._fault_sleep(self.expert_bytes)
        self._bump("probes")
        self._observe(self.expert_bytes, self._clock() - t0)

    def _health_tick(self):
        """Once per serving step, from ``pre_step``: advance the injector
        clock, keep the watchdog fed (a probe when staging has gone quiet
        or is suspended, on the observation cadence) and drive the ladder.
        A transition flips store-side switches only; the serving tier
        follows the state by switching decode variants
        (``steps.ResilientDecode``)."""
        if self.injector is not None:
            self.injector.tick()
        if self.watchdog is None or self.ladder is None:
            return
        self._steps_since_obs += 1
        if self._steps_since_obs >= self.probe_interval:
            self._probe()
        if self._suspended:
            self._bump("little_steps")
        step = (self.injector.step if self.injector is not None
                else len(self.watchdog._samples))
        tr = self.ladder.on_step(step)
        if tr is None:
            return
        _, to = tr
        if to == DEGRADED:
            self._move_cap = max(1, self.max_moves // 2)
        elif to == LITTLE:
            self._suspended = True
        elif to == HEALTHY:
            self._move_cap = None
            self._suspended = False

    def _effective_moves(self) -> int:
        return (self.max_moves if self._move_cap is None
                else min(self.max_moves, self._move_cap))

    def degraded_dcfg(self, dcfg):
        """The DaliConfig the serving tier re-solves with while DEGRADED:
        ``t_trans`` from the watchdog's online re-fit of the link as it is
        now (never below the healthy value) and no prefetch."""
        t_deg = dcfg.t_trans
        if self.watchdog is not None:
            gbps, lat, _rejected = self.watchdog.refit()
            t_deg = lat + self.expert_bytes / (gbps * 1e9)
        return dataclasses.replace(dcfg,
                                   t_trans=max(float(t_deg), dcfg.t_trans),
                                   prefetch_size=0)

    def degraded_policy(self, policy):
        """``policy`` with its DaliConfig swapped for the degraded one (the
        policy itself for policies without cost constants)."""
        if not hasattr(policy, "with_dcfg"):
            return policy
        return policy.with_dcfg(self.degraded_dcfg(policy.dcfg))

    def _truths(self, experts) -> np.ndarray:
        """The pinned store's checksums of ``experts`` ((layer, expert)
        pairs); the store never changes, so each is computed once."""
        for key in experts:
            if key not in self._truth:
                l, e = key
                self._truth[key] = int(row_checksums(
                    *(self.host[k][l, e][None] for k in EXPERT_KEYS))[0])
        return np.asarray([self._truth[key] for key in experts], np.int64)

    def _verify_rows(self, dst, experts, truth):
        """Integrity check of staged rows that landed on the copy stream:
        ``dst`` maps each key to the staged row tensors (``dst[k][i]`` holds
        host expert ``experts[i] = (layer, expert)``, whose pinned-store
        checksum is ``truth[i]``).  An active ``corrupt_rows`` fault first
        flips a bit in one of them (a bad transfer); every row's checksum
        is then read back and compared, and the flagged rows are copied
        again.  Returns the indices of the flagged rows."""
        with self._side():
            if self.injector is not None:
                self.injector.corrupt(dst, len(experts))
            got = torch.cat([row_checksums(*(dst[k][i][None]
                                             for k in EXPERT_KEYS))
                             for i in range(len(experts))]).cpu().numpy()
        self._bump("host_syncs")
        bad = np.nonzero(got != truth)[0]
        if len(bad):
            self._bump("corrupt_caught", len(bad))
            with self._side():
                for i in bad:
                    l, e = experts[i]
                    for k in EXPERT_KEYS:
                        dst[k][i].copy_(self.host[k][l, e], non_blocking=True)
            self._bump("restaged_rows", len(bad))
        return bad

    def _land(self, t0: float, nbytes: int):
        """With a watchdog: wait for the copies just issued, pad the wait
        under an injected slowdown and time it from ``t0``."""
        if self.watchdog is None:
            return
        self._sync_copies()
        self._fault_sleep(nbytes)
        self._observe(nbytes, self._clock() - t0)

    # -- the little tier (int8 twins, the reference's DESIGN.md §10) ---------

    def _little_bytes(self) -> int:
        d, f = self.d, self.f
        return self.n_layers * self.E * (3 * d * f + (2 * f + d) * 4)

    def _build_little(self):
        """Quantize every (L, E) expert to a per-output-column symmetric int8
        twin on the device, layer by layer and expert by expert from the
        pinned store: ``*_q`` int8 in the store's layout, ``*_s`` float32
        scales ``max|w| / 127`` over the contraction axis (at least 1e-8),
        ``q = round(w / s)`` clipped to +-127 — the reference's quantizer
        value for value.  Raises before allocating when the device lacks the
        room."""
        if self._little is not None:
            return
        need = self._little_bytes()
        if self.device.type == "cuda":
            free = torch.cuda.mem_get_info(self.device)[0]
            # one expert matrix in float32 twice over, for the quantizer's
            # temporaries
            work = 2 * self.d * self.f * 4 * 2
            if need + work > free:
                raise RuntimeError(
                    f"the int8 little tier of {self.n_layers} layers x "
                    f"{self.E} experts needs {need / 1e9:.2f} GB on "
                    f"{self.device}; {free / 1e9:.2f} GB are free")
        out = {}
        for k in EXPERT_KEYS:
            h = self.host[k]
            q = torch.empty(h.shape, dtype=torch.int8, device=self.device)
            s = torch.empty(tuple(h.shape[:2]) + (1, h.shape[3]),
                            dtype=torch.float32, device=self.device)
            for l in range(self.n_layers):
                for e in range(self.E):
                    w = h[l, e].to(self.device, non_blocking=True).float()
                    # divisions by tensors: CUDA divides by a host scalar
                    # through its reciprocal, which is not correctly rounded
                    sc = w.abs().amax(dim=-2, keepdim=True) / w.new_tensor(
                        127.0)
                    sc = sc.clamp_min(1e-8)
                    q[l, e] = torch.round(w / sc).clamp_(-127, 127)
                    s[l, e] = sc
            out[k + "_q"] = q
            out[k + "_s"] = s
        self._little = out

    def little_view(self):
        """The device-resident int8 twins of every expert, built at the
        first call: ``{"gate_q", "gate_s", "up_q", ...}``."""
        self._build_little()
        return self._little

    # -- device state --------------------------------------------------------

    def _side(self):
        """The copy stream's context (nothing on the CPU)."""
        if self._copy_stream is None:
            return contextlib.nullcontext()
        return torch.cuda.stream(self._copy_stream)

    def _event(self):
        if self._copy_stream is None:
            return None
        ev = torch.cuda.Event()
        ev.record(self._copy_stream)
        return ev

    def _set_dev_cur(self, off, cur):
        """Point the card's slot table (and both slot maps) at ``cur``,
        ordered on the current stream before anything that reads it."""
        self._dev_cur = cur.copy()
        self._slot_of = _slot_of(self._dev_cur, self.E)
        off["cur"].copy_(torch.from_numpy(self._dev_cur))
        self._slot_of_dev.copy_(torch.from_numpy(self._slot_of))
        self._bump("host_syncs", 2)          # two pageable uploads

    def init_device_state(self, resident):
        """Seed the pool from an initial (L, E) bool resident set (the
        policy's random initial cache) and return ``state["offload"]``."""
        resident = np.asarray(resident, bool)
        L, S = self.n_layers, self.n_slots
        if resident.shape != (L, self.E):
            raise ValueError(
                f"resident set must be (n_layers, n_experts) = "
                f"({L}, {self.E}), got {resident.shape} — pass the "
                f"policy's initial (L, E) bool cache mask")
        cur = np.full((L, S), -1, np.int32)
        for l in range(L):
            ids = np.where(resident[l])[0]
            if len(ids) > S:
                raise ValueError(
                    f"layer {l}: {len(ids)} initial residents exceed "
                    f"n_slots={S} (size the pool to cache+prefetch)")
            cur[l, :len(ids)] = ids
        dev = self.device
        off = {k: torch.zeros((L, S) + tuple(self.host[k].shape[2:]),
                              dtype=self.dtype, device=dev)
               for k in EXPERT_KEYS}
        off["cur"] = torch.empty((L, S), dtype=torch.int32, device=dev)
        self._slot_of_dev = torch.empty((L, self.E), dtype=torch.int32,
                                        device=dev)
        rows = [(l, s, int(cur[l, s])) for l in range(L) for s in range(S)
                if cur[l, s] >= 0]
        self._copy_rows(off, rows)
        self._sync_copies()
        self._cur = cur.copy()
        self._set_dev_cur(off, cur)
        self._layer_events = {}
        self._staged = None
        self._stage_free = None
        if self.mode == "overlap":
            # every plan fits: at most max_moves rows per layer
            self._stage_buf = {k: torch.empty(
                (L * self.max_moves,) + tuple(self.host[k].shape[2:]),
                dtype=self.dtype, device=dev) for k in EXPERT_KEYS}
        return off

    def _copy_rows(self, off, rows):
        """Copy (layer, slot, expert) rows from the host store into the pool
        on the copy stream; in pipelined mode, one event per layer."""
        if not rows:
            return
        main = torch.cuda.current_stream(self.device) \
            if self._copy_stream is not None else None
        with self._side():
            if main is not None:
                self._copy_stream.wait_stream(main)
            last = None
            for l, s, e in rows:
                if last is not None and l != last:
                    self._layer_events[last] = self._event()
                for k in EXPERT_KEYS:
                    off[k][l, s].copy_(self.host[k][l, e], non_blocking=True)
                last = l
            self._layer_events[last] = self._event()

    def _sync_copies(self):
        """Block the host until every pool copy started has landed."""
        if self._copy_stream is not None:
            self._copy_stream.synchronize()
        self._bump("host_syncs")
        self._layer_events = {}

    def wait_layer(self, lid: int):
        """Make the current stream wait for layer ``lid``'s pool copies
        (pipelined mode; a no-op once they are known to have landed)."""
        ev = self._layer_events.pop(lid, None)
        if ev is not None:
            torch.cuda.current_stream(self.device).wait_event(ev)

    # -- the slot view the model consumes ------------------------------------

    @span("store.build_view")
    def build_view(self, off):
        """params-shaped per-layer slot view for ``apply_model``:
        ``{"prefix": (...), "scan": (...)}``.  Each MoE layer's entry holds
        its pool slices ``gate``/``up``/``down`` (n_slots, ...), its expert ->
        slot map on the card (``slot_of``) and on the host
        (``slot_of_np``) and its layer id ``lid``; a scan position holds one
        entry per super-block."""
        prefix_pat, period_pat, _ = scan_pattern(self.cfg)

        def entry(l):
            return {"gate": off["gate"][l], "up": off["up"][l],
                    "down": off["down"][l], "slot_of": self._slot_of_dev[l],
                    "slot_of_np": self._slot_of[l], "lid": l}

        prefix = [None] * len(prefix_pat)
        for l, i in enumerate(self._prefix_moe):
            prefix[i] = entry(l)
        scan = [None] * len(period_pat)
        n_pre, P = len(self._prefix_moe), len(self._scan_moe)
        for j, p in enumerate(self._scan_moe):
            scan[p] = tuple(entry(n_pre + s * P + j)
                            for s in range(self._n_super))
        return {"prefix": tuple(prefix), "scan": tuple(scan)}

    # -- misses --------------------------------------------------------------

    @callback_seam("read_misses", kind="read")
    def read_misses(self, lid: int, t: torch.Tensor, prefill: bool = False
                    ) -> np.ndarray:
        """The per-layer device-to-host read that tells the host which rows
        of MoE layer ``lid`` miss (counted in ``miss_reads`` /
        ``prefill_miss_reads``).  Every slot-path layer enters it, also on a
        step where every row hits: the serving-path audit reports that
        (``E_CALLBACK_UNGUARDED``)."""
        self._bump("prefill_miss_reads" if prefill else "miss_reads")
        self._bump("host_syncs")
        return t.cpu().numpy()

    def _miss_staging(self, n: int):
        """The global miss-staging buffer with room for ``n`` experts.  It
        is written and read on the compute stream only, and it stays put
        between calls (so the kernel's tensor maps stay cached)."""
        if self._miss_buf is None or self._miss_buf["gate"].shape[0] < n:
            n = max(n, self.prefill_rows)
            self._miss_buf = {k: torch.empty(
                (n,) + tuple(self.host[k].shape[2:]), dtype=self.dtype,
                device=self.device) for k in EXPERT_KEYS}
        return self._miss_buf

    def _stage_experts(self, l: int, ids):
        """Copy experts ``ids`` of layer ``l`` into staging rows 0..n-1 on
        the compute stream (after the injected transient checks, which
        retry as the reference's host reads do); returns the whole staging
        triple."""
        self._guard_transient("fetch")
        buf = self._miss_staging(len(ids))
        for r, e in enumerate(ids):
            for k in EXPERT_KEYS:
                buf[k][r].copy_(self.host[k][l, int(e)], non_blocking=True)
        return buf["gate"], buf["up"], buf["down"]

    def _little_experts(self, l: int, ids):
        """Dequantize the int8 twins of experts ``ids`` of layer ``l`` into
        staging rows 0..n-1, ``(q.float() * s).to(dtype)`` as the
        reference's ``deq``; returns the whole staging triple."""
        buf = self._miss_staging(len(ids))
        lv = self.little_view()
        for r, e in enumerate(ids):
            for k in EXPERT_KEYS:
                buf[k][r].copy_(lv[k + "_q"][l, int(e)].float()
                                * lv[k + "_s"][l, int(e)])
        return buf["gate"], buf["up"], buf["down"]

    def _miss_weights(self, lid: int, flat_e, hit, stage):
        """The missing experts of one decode layer staged by ``stage`` ->
        (staging triple, (T*K,) staging row of each row, 0 for hits, the
        miss rows, the distinct missing experts)."""
        e = np.asarray(flat_e)
        rows = np.nonzero(~np.asarray(hit))[0]
        ids = np.unique(e[rows])
        wg, wu, wd = stage(lid, ids)
        row_of = np.zeros(self.E, np.int32)
        row_of[ids] = np.arange(len(ids), dtype=np.int32)
        srow = np.zeros(e.shape[0], np.int32)
        srow[rows] = row_of[e[rows]]
        self._bump("fallback_rows", len(rows))
        return wg, wu, wd, srow, ids

    @callback_seam("fetch_weights", kind="stage")
    def fetch_weights(self, lid: int, flat_e, hit):
        """Demand-fetch the missing experts of one decode layer.  ``flat_e``
        (T*K,) and ``hit`` (T*K,) are host arrays.  Returns the staging
        triple and the (T*K,) staging row of each row (0 for hits)."""
        wg, wu, wd, srow, ids = self._miss_weights(lid, flat_e, hit,
                                                   self._stage_experts)
        self._bump("fallback_fetches", len(ids))
        return wg, wu, wd, srow

    @callback_seam("little_weights", kind="stage")
    def little_weights(self, lid: int, flat_e, hit):
        """``fetch_weights``' contract with the missing experts dequantized
        from the int8 twins: no host read."""
        return self._miss_weights(lid, flat_e, hit, self._little_experts)[:4]

    def _host_rows(self, l: int, xf, flat_e, rows):
        """float32 FFN of (token, k) rows ``rows`` on the CPU: (n, d)."""
        K = flat_e.shape[0] // xf.shape[0]
        x = xf.float()
        out = torch.zeros((len(rows), self.d), dtype=torch.float32)
        for e in np.unique(flat_e[rows]):
            sel = np.nonzero(flat_e[rows] == e)[0]
            xs = x[torch.from_numpy(rows[sel] // K)]
            wg, wu, wd = (self.host[k][l, int(e)].float()
                          for k in EXPERT_KEYS)
            out[torch.from_numpy(sel)] = (self._act(xs @ wg) * (xs @ wu)) @ wd
        return out

    @callback_seam("host_ffn", kind="host")
    def host_ffn(self, lid: int, xf, flat_e, hit):
        """The CPU execution tier: run the missing (token, k) rows' expert
        FFN on the host in float32.  ``xf`` (T, d) is the layer's input on
        its device (read to the host here), ``flat_e`` / ``hit`` (T*K,)
        host arrays.  Returns (T*K, d) on the host in xf's dtype with miss
        rows filled and hit rows zero (the reference's ``host_ffn_cb``
        contract)."""
        return self._host_ffn(lid, xf, flat_e, hit)

    def _host_ffn(self, lid: int, xf, flat_e, hit):
        xf = xf.cpu()
        self._bump("host_syncs")
        e = np.asarray(flat_e)
        rows = np.nonzero(~np.asarray(hit))[0]
        self._guard_transient("host-ffn")
        ys = torch.zeros((e.shape[0], self.d), dtype=xf.dtype)
        if len(rows):
            ys[torch.from_numpy(rows)] = self._host_rows(
                lid, xf, e, rows).to(xf.dtype)
        self._bump("fallback_rows", len(rows))
        return ys

    @callback_seam("prefill_fetch", kind="stage")
    def prefill_fetch(self, lid: int, ids):
        """One prefill wave: copy the wave's experts ``ids`` (ascending) of
        layer ``lid`` into staging rows 0..len(ids)-1."""
        self._bump("prefill_fetch_rows", len(ids))
        self._bump("prefill_waves", 1)
        return self._stage_experts(lid, ids)

    @callback_seam("prefill_little", kind="stage")
    def prefill_little(self, lid: int, ids):
        """One prefill wave from the int8 twins: experts ``ids`` of layer
        ``lid`` dequantized into staging rows 0..len(ids)-1 (each counted
        in ``fallback_rows``, as the reference's little sweep counts its
        needed experts)."""
        self._bump("fallback_rows", len(ids))
        return self._little_experts(lid, ids)

    @callback_seam("prefill_host", kind="host")
    def prefill_host(self, lid: int, xf, flat_e, hit):
        """The prefill host tier: ``host_ffn``'s row-wise contract under the
        prefill counters."""
        ys = self._host_ffn(lid, xf, flat_e, hit)
        self._bump("prefill_host_rows", int((~np.asarray(hit)).sum()))
        return ys

    @span("store.prefill_barrier")
    def prefill_barrier(self, off):
        """Make the pool coherent before a prefill reads it: overlap commits
        a staged plan now (admission runs at the step boundary); blocking
        and pipelined are always coherent (pipelined's layer events are
        waited on by the sweep's own layers)."""
        if self._staged is not None:
            return self.commit(off)
        return off

    def memory_layout(self) -> dict:
        """Device bytes: the resident pool, the prefill wave staging, the
        overlap stage buffer (overlap mode only), the int8 little twins
        (once built) and the full-resident stack the offload replaces.  The
        port's prefill sweep reads pool and staging rows in place, so it
        assembles no (E, ...) stack."""
        pool = self.n_layers * self.n_slots * self.expert_bytes
        staging = self.prefill_rows * self.expert_bytes
        stage = (self.n_layers * self.max_moves * self.expert_bytes
                 if self.mode == "overlap" else 0)
        little = self._little_bytes() if self._little is not None else 0
        return {"pool_bytes": pool,
                "prefill_staging_bytes": staging,
                "overlap_stage_bytes": stage,
                "little_bytes": little,
                "prefill_peak_bytes": pool + staging + stage + little,
                "full_resident_bytes": self.n_layers * self.E
                * self.expert_bytes}

    # -- streaming updates ---------------------------------------------------

    def _plan_rows(self, target):
        """Lower a (L, E) bool target against the host slot-table mirror
        (at most half the moves per layer while the ladder is DEGRADED);
        advance the mirror; return the (layer, slot, expert) rows in layer
        order and the new table."""
        new_cur, ins_e, ins_s, valid = lower_slot_plan_np(
            self._cur, target, self._effective_moves())
        lay, mv = np.nonzero(valid)
        rows = [(int(l), int(ins_s[l, j]), int(ins_e[l, j]))
                for l, j in zip(lay, mv)]
        self._cur = new_cur
        self._bump("h2d_rows", len(rows))
        self._bump("h2d_bytes", len(rows) * self.expert_bytes)
        return rows, new_cur

    def stage(self, target) -> bool:
        """Overlap: plan toward ``target`` and copy the rows into the stage
        buffer on the copy stream, behind the step in flight.  Returns
        False when the pool is already at target.  The next ``commit``
        (guaranteed before the next ``stage``) writes them into the pool."""
        if self._staged is not None:
            raise RuntimeError("stage() called twice without commit()")
        # suspended (LITTLE rung) or retries exhausted: skip the plan —
        # nothing has mutated yet, so skipping is always safe
        if self._suspended or not self._guard_transient("stage"):
            return False
        rows, new_cur = self._plan_rows(target)
        if not rows:
            return False
        experts = [(l, e) for l, _, e in rows]
        truth = self._truths(experts) if self._verify else None
        t0 = self._clock()
        buf = self._stage_buf
        with self._side():
            if self._stage_free is not None:     # the last commit read it
                self._copy_stream.wait_event(self._stage_free)
            for i, (l, _, e) in enumerate(rows):
                for k in EXPERT_KEYS:
                    buf[k][i].copy_(self.host[k][l, e], non_blocking=True)
        if self._verify:
            self._verify_rows(buf, experts, truth)
        self._land(t0, len(rows) * self.expert_bytes)
        self._staged = (rows, new_cur, self._event())
        return True

    def commit(self, off):
        """Overlap: scatter the staged rows into the pool (in place, on the
        compute stream, behind the stage's event) and point the card's
        table at the staged plan.  Runs at the step boundary, when nothing
        reads the pool.  No-op when nothing is staged."""
        if self._staged is None:
            return off
        rows, new_cur, ev = self._staged
        if ev is not None:
            torch.cuda.current_stream(self.device).wait_event(ev)
        buf = self._stage_buf
        for i, (l, s, _) in enumerate(rows):
            for k in EXPERT_KEYS:
                off[k][l, s].copy_(buf[k][i])
        self._set_dev_cur(off, new_cur)
        if self._copy_stream is not None:
            self._stage_free = torch.cuda.Event()
            self._stage_free.record(torch.cuda.current_stream(self.device))
        self._staged = None
        return off

    def step_update(self, off, target, wait: bool = True):
        """Plan toward ``target`` and copy the rows straight into the pool
        (blocking and pipelined).  ``wait`` blocks the host until they have
        landed (blocking mode: the copy on the critical path); otherwise
        each layer's MoE waits on its own event (pipelined)."""
        self._layer_events = {}
        # suspended (LITTLE rung), nothing to plan or retries exhausted:
        # skip the plan — the mirror has not advanced
        if (self._suspended or not self._guard_transient("stage")
                or target is None):
            return off
        rows, new_cur = self._plan_rows(target)
        experts = [(l, e) for l, _, e in rows]
        truth = self._truths(experts) if self._verify else None
        t0 = self._clock()
        self._copy_rows(off, rows)
        if rows:
            if self._verify:
                dst = {k: [off[k][l, s] for l, s, _ in rows]
                       for k in EXPERT_KEYS}
                bad = self._verify_rows(dst, experts, truth)
                if len(bad) and self._layer_events:
                    ev = self._event()           # the copies made again
                    for i in bad:
                        self._layer_events[rows[i][0]] = ev
            self._land(t0, len(rows) * self.expert_bytes)
            self._set_dev_cur(off, new_cur)
        if wait:
            self._sync_copies()
        return off

    # -- serving-loop orchestration -----------------------------------------
    # the ordering-critical per-step protocol, driven by the server:
    # pre_step before the decode dispatch, post_dispatch right after it,
    # next_target after the step's token sync

    @span("store.pre_step")
    def pre_step(self, off, mode: str, target):
        """Before the decode dispatch: "blocking" -> plan, copy and wait;
        "overlap" -> commit the rows staged behind the previous step;
        "pipelined" -> plan and start the copies layer by layer, which the
        dispatched step's MoE layers wait on one by one.

        Also the robustness heartbeat: the injector clock, the health probe
        and the degradation ladder advance here, once per step, in every
        mode (``_health_tick``)."""
        self._health_tick()
        if mode == "overlap":
            return self.commit(off)
        if mode == "blocking" and target is None:
            return off
        return self.step_update(off, target, wait=mode == "blocking")

    @span("store.post_dispatch")
    def post_dispatch(self, mode: str, target):
        """Right after the decode dispatch: in "overlap" mode, stage the
        next plan behind the step in flight."""
        if mode == "overlap" and target is not None:
            self.stage(target)

    @span("policy.next_target")
    def next_target(self, state, tel):
        """The next step's pool target — this step's cache ∪ prefetch (one
        read back to the host)."""
        self._bump("host_syncs")
        return (state["dali"]["resident"] | tel["prefetched"]).cpu().numpy()


def strip_expert_params(params, cfg: ModelConfig):
    """Params with the routed experts' gate/up/down stacks removed — the
    slot path never reads them.  Returns a new tree; the original is
    untouched."""
    prefix_moe, scan_moe, _ = moe_layer_layout(cfg)

    def strip_mlp(mlp):
        return {k: v for k, v in mlp.items() if k not in EXPERT_KEYS}

    out = dict(params)
    out["prefix"] = tuple(
        dict(b, mlp=strip_mlp(b["mlp"])) if i in prefix_moe else b
        for i, b in enumerate(params["prefix"]))
    out["scan"] = tuple(
        dict(b, mlp=strip_mlp(b["mlp"])) if p in scan_moe else b
        for p, b in enumerate(params["scan"]))
    return out
