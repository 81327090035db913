"""Physical expert residency: pinned host store + device slot pool (port of
``repro/serving/expert_store.py``).

* **Host store** — the routed experts' gate/up/down stacks as ``(L, E, d,
  f)`` / ``(L, E, f, d)`` tensors in page-locked CPU memory (when the pool
  lives on a card), so every copy to the card is a DMA that does not block
  the host.  Params whose expert stacks already sit on the host (``init_model
  (experts="host")``, ``bridge.to_torch(experts="host")``) are adopted without
  a copy where their layout is already ``(L, E, ...)``.
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

Learning which rows miss costs one small device-to-host read per MoE layer
(``miss_reads``): the eager counterpart of the reference's ``lax.cond`` +
``pure_callback``.  Nothing falls back quietly: a failed pin, copy or launch
raises.  The reference's fault seam (faults, watchdog, degradation ladder,
checksums, health probe, the ``little`` tier) raises ``NotImplementedError``.
"""
from __future__ import annotations

import contextlib

import numpy as np
import torch

from repro_torch.device import pinned_empty
from repro_torch.kernels.expert_ffn.ops import ACTS
from repro_torch.models.config import ModelConfig, scan_pattern
from repro_torch.models.moe import EXPERT_KEYS

FALLBACKS = ("fetch", "host", "little")
STORE_MODES = ("blocking", "overlap", "pipelined")
FAULT_SEAM = ("the offload fault seam (faults, watchdog, degradation ladder, "
              "checksums, health probe and the 'little' tier) is ported with "
              "fault tolerance (ROADMAP.md queue item 3)")


def moe_layer_layout(cfg: ModelConfig):
    """(prefix_moe_blocks, scan_moe_positions, n_super): which prefix blocks
    / scan pattern positions are MoE, in the canonical layer order every
    (L, ...) stack uses (prefix first, then scan super-block-major)."""
    prefix_pat, period_pat, n_super = scan_pattern(cfg)
    prefix_moe = [i for i, (_, mlp) in enumerate(prefix_pat) if mlp == "moe"]
    scan_moe = [p for p, (_, mlp) in enumerate(period_pat) if mlp == "moe"]
    return prefix_moe, scan_moe, n_super


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
    prefill.  ``device`` is where the pool lives (default: the router's)."""

    def __init__(self, params, cfg: ModelConfig, n_slots: int,
                 max_moves: int = 4, fallback: str = "fetch",
                 mode: str = "overlap", prefill_rows=None, device=None):
        if cfg.moe is None:
            raise ValueError("ExpertStore needs an MoE architecture")
        if fallback not in FALLBACKS:
            raise ValueError(f"fallback must be one of "
                             f"{'|'.join(FALLBACKS)}, got {fallback!r}")
        if mode not in STORE_MODES:
            raise ValueError(f"mode must be one of "
                             f"{'|'.join(STORE_MODES)}, got {mode!r}")
        if fallback == "little":
            raise NotImplementedError(FAULT_SEAM)
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

    # -- host store ----------------------------------------------------------

    def _host_stack(self, params, name):
        """(L, E, ...) host tensor of one expert matrix, pinned when the pool
        lives on a card.  A scan stack that already is ``(L, E, ...)`` on the
        host (one MoE position, no MoE prefix) is adopted as it is."""
        pin = self.device.type == "cuda"
        chunks = [params["prefix"][i]["mlp"][name]
                  for i in self._prefix_moe]
        per_pos = [params["scan"][p]["mlp"][name] for p in self._scan_moe]
        if len(per_pos) == 1 and not chunks:
            src = per_pos[0]                       # (n_super, E, ...)
            if src.device.type == "cpu" and src.is_contiguous() and (
                    not pin or src.is_pinned()):
                return src
            chunks = list(src)
        else:
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

    def stats(self) -> dict:
        """Monotonic counter totals."""
        return dict(self._tel)

    def drain(self) -> dict:
        """Counter deltas since the previous drain (snapshot-and-reset)."""
        out = {k: self._tel[k] - self._drained[k] for k in self._tel}
        self._drained = dict(self._tel)
        return out

    def reset_stats(self):
        """Zero every counter (after a calibration run through the store, so
        that a server built on it counts its own serve only)."""
        self._tel = {k: 0 for k in self._tel}
        self._drained = dict(self._tel)

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
        self._layer_events = {}

    def wait_layer(self, lid: int):
        """Make the current stream wait for layer ``lid``'s pool copies
        (pipelined mode; a no-op once they are known to have landed)."""
        ev = self._layer_events.pop(lid, None)
        if ev is not None:
            torch.cuda.current_stream(self.device).wait_event(ev)

    # -- the slot view the model consumes ------------------------------------

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

    def read_misses(self, t: torch.Tensor, prefill: bool = False
                    ) -> np.ndarray:
        """The per-layer device-to-host read that tells the host which rows
        miss (counted in ``miss_reads`` / ``prefill_miss_reads``)."""
        self._bump("prefill_miss_reads" if prefill else "miss_reads")
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
        the compute stream; returns the whole staging triple."""
        buf = self._miss_staging(len(ids))
        for r, e in enumerate(ids):
            for k in EXPERT_KEYS:
                buf[k][r].copy_(self.host[k][l, int(e)], non_blocking=True)
        return buf["gate"], buf["up"], buf["down"]

    def fetch_weights(self, lid: int, flat_e, hit):
        """Demand-fetch the missing experts of one decode layer.  ``flat_e``
        (T*K,) and ``hit`` (T*K,) are host arrays.  Returns the staging
        triple and the (T*K,) staging row of each row (0 for hits)."""
        e = np.asarray(flat_e)
        rows = np.nonzero(~np.asarray(hit))[0]
        ids = np.unique(e[rows])
        wg, wu, wd = self._stage_experts(lid, ids)
        row_of = np.zeros(self.E, np.int32)
        row_of[ids] = np.arange(len(ids), dtype=np.int32)
        srow = np.zeros(e.shape[0], np.int32)
        srow[rows] = row_of[e[rows]]
        self._bump("fallback_rows", len(rows))
        self._bump("fallback_fetches", len(ids))
        return wg, wu, wd, srow

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

    def host_ffn(self, lid: int, xf, flat_e, hit):
        """The CPU execution tier: run the missing (token, k) rows' expert
        FFN on the host in float32.  ``xf`` (T, d) is a CPU tensor,
        ``flat_e`` / ``hit`` (T*K,) host arrays.  Returns (T*K, d) in xf's
        dtype with miss rows filled and hit rows zero (the reference's
        ``host_ffn_cb`` contract)."""
        e = np.asarray(flat_e)
        rows = np.nonzero(~np.asarray(hit))[0]
        ys = torch.zeros((e.shape[0], self.d), dtype=xf.dtype)
        if len(rows):
            ys[torch.from_numpy(rows)] = self._host_rows(
                lid, xf, e, rows).to(xf.dtype)
        self._bump("fallback_rows", len(rows))
        return ys

    def prefill_fetch(self, lid: int, ids):
        """One prefill wave: copy the wave's experts ``ids`` (ascending) of
        layer ``lid`` into staging rows 0..len(ids)-1."""
        self._bump("prefill_fetch_rows", len(ids))
        self._bump("prefill_waves", 1)
        return self._stage_experts(lid, ids)

    def prefill_host(self, lid: int, xf, flat_e, hit):
        """The prefill host tier: ``host_ffn``'s row-wise contract under the
        prefill counters."""
        ys = self.host_ffn(lid, xf, flat_e, hit)
        self._bump("prefill_host_rows", int((~np.asarray(hit)).sum()))
        return ys

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
        overlap stage buffer (overlap mode only) and the full-resident stack
        the offload replaces.  The port's prefill sweep reads pool and
        staging rows in place, so it assembles no (E, ...) stack."""
        pool = self.n_layers * self.n_slots * self.expert_bytes
        staging = self.prefill_rows * self.expert_bytes
        stage = (self.n_layers * self.max_moves * self.expert_bytes
                 if self.mode == "overlap" else 0)
        return {"pool_bytes": pool,
                "prefill_staging_bytes": staging,
                "overlap_stage_bytes": stage,
                "prefill_peak_bytes": pool + staging + stage,
                "full_resident_bytes": self.n_layers * self.E
                * self.expert_bytes}

    # -- streaming updates ---------------------------------------------------

    def _plan_rows(self, target):
        """Lower a (L, E) bool target against the host slot-table mirror;
        advance the mirror; return the (layer, slot, expert) rows in layer
        order and the new table."""
        new_cur, ins_e, ins_s, valid = lower_slot_plan_np(
            self._cur, target, self.max_moves)
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
        rows, new_cur = self._plan_rows(target)
        if not rows:
            return False
        buf = self._stage_buf
        with self._side():
            if self._stage_free is not None:     # the last commit read it
                self._copy_stream.wait_event(self._stage_free)
            for i, (l, _, e) in enumerate(rows):
                for k in EXPERT_KEYS:
                    buf[k][i].copy_(self.host[k][l, e], non_blocking=True)
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
        rows, new_cur = self._plan_rows(target)
        self._copy_rows(off, rows)
        if rows:
            self._set_dev_cur(off, new_cur)
        if wait:
            self._sync_copies()
        return off

    # -- serving-loop orchestration -----------------------------------------
    # the ordering-critical per-step protocol, driven by the server:
    # pre_step before the decode dispatch, post_dispatch right after it,
    # next_target after the step's token sync

    def pre_step(self, off, mode: str, target):
        """Before the decode dispatch: "blocking" -> plan, copy and wait;
        "overlap" -> commit the rows staged behind the previous step;
        "pipelined" -> plan and start the copies layer by layer, which the
        dispatched step's MoE layers wait on one by one."""
        if mode == "overlap":
            return self.commit(off)
        if target is None:
            return off
        return self.step_update(off, target, wait=mode == "blocking")

    def post_dispatch(self, mode: str, target):
        """Right after the decode dispatch: in "overlap" mode, stage the
        next plan behind the step in flight."""
        if mode == "overlap" and target is not None:
            self.stage(target)

    @staticmethod
    def next_target(state, tel):
        """The next step's pool target — this step's cache ∪ prefetch."""
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
