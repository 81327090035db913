"""Serving schedulers (port of ``repro/serving/scheduler.py``):
slot-level continuous batching (default) and the wave scheduler.

``ContinuousBatchServer`` keeps a slot table of ``batch_size`` independent
sequences.  Every step it (1) admits queued requests into free slots —
each admission is a B = 1 right-padded prefill whose KV rows are copied
into the batch cache at the slot index, (2) runs ONE batched decode step in
which every slot sits at its own position, and (3) retires slots whose
request hit EOS, its token budget or the cache horizon.

``BatchServer`` is the reference's wave scheduler: requests are grouped
into waves of ``batch_size``, left-padded to the longest prompt's bucket,
prefilled once and decoded in lockstep at one shared position until the
whole wave drains.  Each wave starts from a fresh serve state (a fresh
policy state and, with physical offload, a freshly seeded slot pool) and
closes its telemetry epoch.  It pads every request to the wave's longest
prompt and keeps finished requests' rows idle: the baseline the
continuous server is compared against.

The offload policy runs after every decode step on the device; its
telemetry accumulates there and is drained once per flush interval
(``TelemetryAggregator``), so a decode loop's only host read per step is
the batch's new tokens (and, with physical offload, the next pool target
and the per-layer miss reads).  With a physical-offload store both servers
drive its hooks where the reference does: ``prefill_barrier`` before each
prefill, then per step ``pre_step``, ``ResilientDecode.react`` (which
follows the store's degradation ladder), the decode dispatch,
``post_dispatch``, the token sync and ``next_target``; the store's
counters fold into ``ServeMetrics.offload_tel`` once per step, and its
link watchdog's report into ``ServeMetrics.links`` at the end of a run
(continuous) or of a wave.

Every host wait on the card is counted where it happens, the scheduler's
in ``ServeMetrics.host_syncs`` and the store's and the slot path's in the
store's ``host_syncs``; with the span recorder on (``repro_torch.spans``)
admissions, decode steps and their layers are spanned on the device
trace's clock.
"""
from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np
import torch

from repro_torch.core.engine import TelemetryAggregator
from repro_torch.models.config import ModelConfig, layer_pattern
from repro_torch.models.model import init_caches
from repro_torch.serving.spec import (ResolvedServe, ServeSpec, build_store,
                                     warn_legacy)
from repro_torch.serving.steps import make_admit_step, retire_slot
from repro_torch.spans import span


def make_store(offload: str, params, cfg, policy, fallback: str = "fetch",
               faults=None, cost_model=None, device="cuda"):
    """Legacy surface over ``spec.build_store`` (deprecated: construct
    through ``ServeSpec.resolve()``)."""
    warn_legacy("make_store")
    return build_store(offload, params, cfg, policy, fallback=fallback,
                       faults=faults, cost_model=cost_model, device=device)


class PromptTooLongError(ValueError):
    """A submitted prompt does not fit the server's KV budget."""

    def __init__(self, n_tokens: int, max_len: int):
        self.n_tokens = int(n_tokens)
        self.max_len = int(max_len)
        super().__init__(
            f"prompt of {n_tokens} tokens exceeds max_len={max_len} "
            f"(prompts must be < max_len so at least one generated "
            f"token fits the cache)")


@dataclass
class Request:
    rid: int
    prompt: np.ndarray                  # (S,) int32
    max_new_tokens: int = 32
    submitted_at: float = 0.0
    not_before: float = 0.0             # virtual arrival time (0 = now)
    output: List[int] = field(default_factory=list)
    first_token_at: float = 0.0
    done_at: float = 0.0

    @property
    def ttft(self) -> float:
        return self.first_token_at - self.submitted_at

    @property
    def latency(self) -> float:
        return self.done_at - self.submitted_at


@dataclass
class ServeMetrics:
    prefill_tokens: int = 0
    decode_tokens: int = 0
    prefill_s: float = 0.0
    decode_s: float = 0.0
    waves: int = 0                      # wave server: waves; cont.: unused
    steps: int = 0                      # decode steps
    occupancy_sum: int = 0              # live slots summed over steps
    requests: int = 0                   # finished requests
    # host waits on the card at the scheduler's sites: each step's token
    # read, each admission's prompt upload, slot writes and first token, each
    # retirement's slot write, the policy telemetry's reads (the store counts
    # its own in stats()["host_syncs"])
    host_syncs: int = 0
    # physical-offload counters folded from ExpertStore.drain()
    offload_tel: dict = field(default_factory=dict)
    # per-link watchdog counter snapshots keyed by link name ("host>0"):
    # monotonic totals from LinkWatchdog.report(), the latest one wins
    links: dict = field(default_factory=dict)
    dali: TelemetryAggregator = field(default_factory=TelemetryAggregator)

    def fold_offload(self, deltas: dict):
        for k, v in deltas.items():
            self.offload_tel[k] = self.offload_tel.get(k, 0) + v

    def fold_links(self, links: Optional[dict]):
        """Merge per-link watchdog reports (``ExpertStore.health()
        ["links"]``): cumulative snapshots, so a merge replaces per link."""
        if not links:
            return
        for name, rep in links.items():
            self.links[name] = dict(rep)

    def fallback_rate(self) -> float:
        """Miss (token, k) rows per finished request."""
        if not self.requests:
            return 0.0
        return self.offload_tel.get("fallback_rows", 0) / self.requests

    def mean_occupancy(self) -> float:
        return self.occupancy_sum / self.steps if self.steps else 0.0

    def summary(self) -> str:
        pf = self.prefill_tokens / self.prefill_s if self.prefill_s else 0
        dc = self.decode_tokens / self.decode_s if self.decode_s else 0
        s = (f"steps={self.steps} prefill={pf:.1f} tok/s "
             f"decode={dc:.1f} tok/s occ={self.mean_occupancy():.2f}")
        if self.dali.lookups:
            s += " | " + self.dali.summary()
        if self.offload_tel:
            ot = self.offload_tel
            s += (f" | fb_rows/req={self.fallback_rate():.2f}"
                  f" fetches={ot.get('fallback_fetches', 0)}")
            extras = [(k, ot[k]) for k in ("retries", "stage_aborts",
                                           "corrupt_caught",
                                           "restaged_rows", "little_steps")
                      if ot.get(k)]
            if extras:
                s += " " + " ".join(f"{k}={v}" for k, v in extras)
        hot = [(n, r) for n, r in sorted(self.links.items())
               if r.get("refit_rejections") or r.get("degrade_events")
               or r.get("deadline_misses")]
        if hot:
            s += " | links " + " ".join(
                f"{n}[miss={r.get('deadline_misses', 0)}"
                f" refit={r.get('refits', 0)}"
                f"/rej={r.get('refit_rejections', 0)}"
                f" degr={r.get('degrade_events', 0)}]" for n, r in hot)
        return s


def _pop_arrived(queue: deque, now: float) -> Optional[Request]:
    """FIFO pop of the head request iff its arrival time has passed."""
    if queue and queue[0].not_before <= now:
        return queue.popleft()
    return None


def _bucket_len(n: int, min_bucket: int, cap: int) -> int:
    """Power-of-two padding bucket for prompt lengths."""
    b = min_bucket
    while b < n:
        b *= 2
    return max(n, min(b, cap))


class _Server:
    """What both servers share: construction from a resolved spec or from
    keyword arguments (which build that spec; ``device`` defaults to
    ``"cuda"``) and submission."""
    preset = ""

    def __init__(self, params, cfg: Optional[ModelConfig] = None,
                 batch_size: int = 8, max_len: int = 256, eos_id: int = 1,
                 dali_cfg=None, res_vecs=None, min_bucket: int = 16,
                 policy=None, offload: str = "modeled", faults=None,
                 device="cuda",
                 resolved: Optional[ResolvedServe] = None):
        if resolved is None:
            if cfg is None:
                raise TypeError(f"{type(self).__name__} needs cfg or "
                                "resolved= (ServeSpec.resolve(params))")
            from repro_torch.serving.spec import OffloadSpec
            warn_legacy(f"{type(self).__name__}(params, cfg, ...)")
            resolved = ServeSpec(
                cfg=cfg, server=self.preset, policy=policy,
                dali_cfg=dali_cfg, batch_size=batch_size, max_len=max_len,
                eos_id=eos_id, min_bucket=min_bucket,
                offload=OffloadSpec(mode=offload, faults=faults),
                device=device).resolve(params)
        spec = resolved.spec
        self._resolved = resolved
        self.params = resolved.params   # expert stacks stripped (physical)
        self.cfg = spec.cfg
        self.device = resolved.device
        self.batch = spec.batch_size
        self.max_len = spec.max_len
        self.eos = spec.eos_id
        self.policy = resolved.policy
        self.offload = spec.offload.mode
        self.store = resolved.store
        self.res_vecs = (None if res_vecs is None else torch.as_tensor(
            np.asarray(res_vecs, np.float32), device=self.device))
        self.min_bucket = spec.min_bucket
        self.queue: deque[Request] = deque()
        self.metrics = ServeMetrics()
        # the decode follows the store's degradation ladder: healthy,
        # degraded and little variants, switched by react()
        self._decode = resolved.resilient_decode()

    def submit(self, req: Request):
        if not req.submitted_at:
            req.submitted_at = req.not_before or time.perf_counter()
        if len(req.prompt) >= self.max_len:
            raise PromptTooLongError(len(req.prompt), self.max_len)
        self.queue.append(req)


class ContinuousBatchServer(_Server):
    """Slot-level continuous batching with prefill-on-admit.

    Request outputs INCLUDE the token sampled by the prefill (the first
    token, which TTFT refers to); ``max_new_tokens`` bounds the total.
    Build it from a resolved spec (``ServeSpec(...).resolve(params)
    .server(res_vecs)``) or from keyword arguments."""
    preset = "continuous"

    def __init__(self, params, cfg: Optional[ModelConfig] = None, **kw):
        super().__init__(params, cfg, **kw)
        if any(mixer == "mamba" for mixer, _ in layer_pattern(self.cfg)):
            # attention masks hide right-pad slots (pos = -1); a recurrent
            # SSM state has no such mask, so pad tokens would corrupt it
            raise ValueError(
                "continuous batching requires attention caches; serve "
                "SSM/hybrid archs with the 'wave' preset")
        self._prefill = self._resolved.admit_prefill()
        self._admit = make_admit_step(self.cfg)
        a = self.cfg.attn
        # rolling (sliding-window) caches keep the LAST S_c positions of a
        # prefill; right-pad past the window would evict real prompt
        # tokens, so such configs prefill at exact length
        self._exact_prefill = bool(a is not None and a.sliding_window
                                   and a.sliding_window < self.max_len)
        # B = 1 cache the admission prefill writes into (in place); its
        # pos rows are reset to empty before every admission
        self._fresh_caches = init_caches(self.cfg, 1, self.max_len,
                                         device=self.device)

    def _admit_request(self, state, req: Request, slot: int):
        t0 = time.perf_counter()
        L = len(req.prompt)
        Sb = L if self._exact_prefill else \
            _bucket_len(L, self.min_bucket, self.max_len)
        with span("scheduler.admit", rid=req.rid, prompt_len=L, bucket=Sb):
            toks = np.zeros((1, Sb), np.int32)
            toks[0, :L] = req.prompt                 # RIGHT-pad (see steps)
            fresh = self._fresh_caches
            for c in list(fresh["prefix"]) + list(fresh["scan"]):
                if "pos" in c:          # cross caches have no positions
                    c["pos"].fill_(-1)
            off = None
            if self.store is not None:
                # overlap may hold a staged plan: commit it so the admission
                # sweep reads a coherent pool
                off = state["offload"] = self.store.prefill_barrier(
                    state["offload"])
            with span("scheduler.prompt_upload"):
                toks = torch.as_tensor(toks, device=self.device)
            first_tok, fresh = self._prefill(self.params, toks, fresh, L, off)
            with span("scheduler.admit_copy"):
                state = self._admit(state, fresh, first_tok, slot, L)
            with span("scheduler.first_token"):
                tok = int(first_tok[0, 0])           # waits for the device
            # the prompt's upload, the slot's position and live flag
            # written from the host, the first token
            self.metrics.host_syncs += 4
        t1 = time.perf_counter()
        self.metrics.prefill_s += t1 - t0
        self.metrics.prefill_tokens += L
        req.output.append(tok)
        req.first_token_at = t1
        return state

    def _should_retire(self, req: Request) -> bool:
        return (req.output[-1] == self.eos
                or len(req.output) >= req.max_new_tokens
                or len(req.prompt) + len(req.output) >= self.max_len)

    def run(self) -> List[Request]:
        B = self.batch
        finished: List[Request] = []
        state = self._resolved.init_state(per_slot=True)
        slot_req: List[Optional[Request]] = [None] * B
        # physical offload: the previous step's cache ∪ prefetch, pending
        # lowering to a slot plan
        pool_target = None

        while self.queue or any(slot_req):
            now = time.perf_counter()
            # -- admission: fill freed slots from the queue ----------------
            for slot in range(B):
                if slot_req[slot] is not None:
                    continue
                req = _pop_arrived(self.queue, now)
                if req is None:
                    break
                state = self._admit_request(state, req, slot)
                if self._should_retire(req):         # EOS on first token
                    req.done_at = req.first_token_at
                    finished.append(req)
                    state = retire_slot(state, slot)
                    self.metrics.host_syncs += 1     # the live flag's write
                else:
                    slot_req[slot] = req

            busy = [i for i in range(B) if slot_req[i] is not None]
            if not busy:
                if not self.queue:
                    break
                time.sleep(max(0.0,
                               self.queue[0].not_before - time.perf_counter()))
                continue

            # -- one decode step over the whole slot table -----------------
            with span("scheduler.decode_step", step=self.metrics.steps,
                      live=len(busy)):
                t0 = time.perf_counter()
                if self.store is not None:
                    state["offload"] = self.store.pre_step(
                        state["offload"], self.offload, pool_target)
                    self._decode.react()     # follow the degradation ladder
                state, _, tel = self._decode(self.params, state,
                                             self.res_vecs)
                if self.store is not None:
                    self.store.post_dispatch(self.offload, pool_target)
                with span("scheduler.token_sync"):
                    toks = state["tokens"][:, 0].tolist()
                self.metrics.host_syncs += 1
                t1 = time.perf_counter()
                if self.store is not None:
                    pool_target = self.store.next_target(state, tel)
                with span("scheduler.retire"):
                    emitted = len(busy)
                    for i in busy:
                        r = slot_req[i]
                        r.output.append(int(toks[i]))
                        if self._should_retire(r):
                            r.done_at = t1
                            finished.append(r)
                            slot_req[i] = None
                            state = retire_slot(state, i)
                            self.metrics.host_syncs += 1   # its live flag
                    self.metrics.decode_tokens += emitted
                    self.metrics.decode_s += t1 - t0
                    self.metrics.steps += 1
                    self.metrics.occupancy_sum += emitted
                    if self.store is not None:
                        self.metrics.fold_offload(self.store.drain())
                    self.metrics.host_syncs += self.metrics.dali.observe(
                        state.get("dali"), n_active=emitted)
        self.metrics.host_syncs += self.metrics.dali.end_epoch()
        if self.store is not None:
            self.metrics.fold_offload(self.store.drain())
            self.metrics.fold_links(self.store.health().get("links"))
        self.metrics.requests += len(finished)
        return finished


class BatchServer(_Server):
    """Wave scheduler: equal-padded waves decoded in lockstep (see the
    module docstring; ContinuousBatchServer is the default).  Outputs
    include the prefill's token, as in the continuous server."""
    preset = "wave"

    def __init__(self, params, cfg: Optional[ModelConfig] = None, **kw):
        super().__init__(params, cfg, **kw)
        self._prefill = self._resolved.prefill_step()

    def run(self) -> List[Request]:
        finished: List[Request] = []
        while self.queue:
            now = time.perf_counter()
            wave = []
            while len(wave) < self.batch:
                req = _pop_arrived(self.queue, now)
                if req is None:
                    break
                wave.append(req)
            if not wave:        # the next request has not "arrived" yet
                time.sleep(max(0.0,
                               self.queue[0].not_before - time.perf_counter()))
                continue
            finished.extend(self._run_wave(wave))
        return finished

    def _done(self, req: Request, tok: int) -> bool:
        return tok == self.eos or len(req.output) >= req.max_new_tokens

    def _run_wave(self, wave: List[Request]) -> List[Request]:
        B = self.batch
        S_raw = max(len(r.prompt) for r in wave)
        budget = max(r.max_new_tokens for r in wave)
        # the bucket bounds the distinct prefill shapes across waves, but
        # never at the cost of decode budget: it is capped so S + budget
        # still fits the KV horizon whenever S_raw would
        S = _bucket_len(S_raw, self.min_bucket,
                        max(S_raw, self.max_len - budget - 1))
        prompts = np.zeros((B, S), np.int32)
        for i, r in enumerate(wave):
            prompts[i, S - len(r.prompt):] = r.prompt   # LEFT-pad

        # a fresh serve state per wave also re-seeds the slot pool (the
        # fresh policy state draws its initial resident set again)
        state = self._resolved.init_state(batch=B)
        t0 = time.perf_counter()
        with span("scheduler.admit", rid=wave[0].rid, prompt_len=S_raw,
                  bucket=S, rows=len(wave)):
            off = None
            if self.store is not None:
                off = state["offload"] = self.store.prefill_barrier(
                    state["offload"])
            with span("scheduler.prompt_upload"):
                prompts = torch.as_tensor(prompts, device=self.device)
                pos = torch.tensor(S, dtype=torch.int32, device=self.device)
            tok, caches = self._prefill(self.params, prompts,
                                        state["caches"], off)
            with span("scheduler.first_token"):
                toks0 = tok[:, 0].tolist()           # waits for the device
            t_pf = time.perf_counter()
            self.metrics.prefill_s += t_pf - t0
            self.metrics.prefill_tokens += B * S
            # the prompts' and the position's uploads, the first tokens
            self.metrics.host_syncs += 3
        state = dict(state, tokens=tok, caches=caches, pos=pos)

        live = np.arange(B) < len(wave)
        for i, r in enumerate(wave):
            r.output.append(int(toks0[i]))
            r.first_token_at = t_pf
            if self._done(r, toks0[i]):
                live[i] = False
                r.done_at = t_pf
        t0 = time.perf_counter()
        pool_target = None
        for _ in range(min(budget, self.max_len - S - 1)):
            if not live.any():        # the whole wave done at prefill
                break
            # every row live at the top of the step emits one token
            emitted = int(live.sum())
            with span("scheduler.decode_step", step=self.metrics.steps,
                      live=emitted):
                if self.store is not None:
                    state["offload"] = self.store.pre_step(
                        state["offload"], self.offload, pool_target)
                    self._decode.react()     # follow the degradation ladder
                state, _, tel = self._decode(self.params, state,
                                             self.res_vecs)
                if self.store is not None:
                    self.store.post_dispatch(self.offload, pool_target)
                with span("scheduler.token_sync"):
                    toks = state["tokens"][:, 0].tolist()
                self.metrics.host_syncs += 1
                t_step = time.perf_counter()
                if self.store is not None:
                    pool_target = self.store.next_target(state, tel)
                with span("scheduler.retire"):
                    for i, r in enumerate(wave):
                        if live[i]:
                            r.output.append(int(toks[i]))
                            if self._done(r, toks[i]):
                                live[i] = False
                                r.done_at = t_step
                    self.metrics.decode_tokens += emitted
                    self.metrics.steps += 1
                    self.metrics.occupancy_sum += emitted
                    if self.store is not None:
                        self.metrics.fold_offload(self.store.drain())
                    self.metrics.host_syncs += self.metrics.dali.observe(
                        state.get("dali"), n_active=emitted)
        self.metrics.decode_s += time.perf_counter() - t0
        # each wave re-inits its policy state: close the epoch so the next
        # wave's accumulator drains from zero again
        self.metrics.host_syncs += self.metrics.dali.end_epoch()
        if self.store is not None:
            self.metrics.fold_offload(self.store.drain())
            self.metrics.fold_links(self.store.health().get("links"))
        self.metrics.waves += 1
        self.metrics.requests += len(wave)
        for r in wave:
            if not r.done_at:
                r.done_at = time.perf_counter()
        return wave


SERVER_PRESETS = {
    "continuous": ContinuousBatchServer,
    "wave": BatchServer,
}


def make_server(preset: str, params, cfg: ModelConfig, **kw):
    """Factory over SERVER_PRESETS ('continuous' | 'wave')."""
    try:
        cls = SERVER_PRESETS[preset]
    except KeyError:
        raise ValueError(f"unknown server preset {preset!r}; "
                         f"choose from {sorted(SERVER_PRESETS)}") from None
    return cls(params, cfg, **kw)
