"""Serving step functions (port of ``repro/serving/steps.py``): the wave
prefill, the admission prefill, admission into the slot table, retirement,
the decode step with the in-graph offload policy, greedy or sampled, and
``ResilientDecode``, which switches decode variants as an expert store's
degradation ladder moves.

Two serve-state layouts share the same decode step, as in the reference:

wave (shared position)::

  state = {
    "tokens": (B, 1) int32  — last generated token per sequence
    "pos":    ()     int32  — the position every row decodes at
    "caches": model caches (see models/model.py)
    "dali":   policy state (when the policy schedules)
    "offload": the device slot pool and slot table (physical offload, see
              serving/expert_store.py)
    "rng":    torch.Generator on the serve device (sampled decoding)
  }

per-slot (continuous batching)::

  state = {
    "tokens": (B, 1) int32
    "pos":    (B,)   int32  — every slot at its own sequence offset
    "active": (B,)   bool   — live slots (admitted, not yet retired)
    "caches" / "dali" / "offload" / "rng" as above
  }

The decode step dispatches on ``state["pos"].dim()``.  Unlike the
reference, whose steps are pure functions, the prefills and the decode
write the cache tensors in place (a step then never copies the whole batch
cache to change one slot's rows), ``retire_slot`` and ``admit`` update
``state``'s tensors in place, and sampling advances ``state["rng"]`` in
place where the reference splits a key.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.policy import DaliConfig
from repro_torch.device import resolve_device
from repro_torch.models.config import ModelConfig, layer_pattern
from repro_torch.models.model import apply_model, collect_policy_obs, init_caches
from repro_torch.spans import span


def resolve_policy(policy, cfg: ModelConfig,
                   dali_cfg: Optional[DaliConfig] = None):
    """str | policy instance | None -> policy.  ``None`` means "dali" when
    a ``DaliConfig`` is given, else scheduling off.  Names are checked
    against the registry here, at server / step construction; a missing
    ``dali_cfg`` is filled from ``default_dali_config``; non-MoE
    architectures resolve to the null policy."""
    from repro_torch.core.policy import make_policy, policy_names
    if policy is None:
        policy = "dali" if dali_cfg is not None else "none"
    if isinstance(policy, str):
        names = policy_names()
        if policy not in names:
            raise ValueError(f"policy must be one of {'|'.join(names)}, "
                             f"got {policy!r}")
        if policy == "none" or cfg.moe is None:
            return make_policy("none")
        if dali_cfg is None:
            dali_cfg = default_dali_config(cfg)
        return make_policy(policy, dali_cfg, top_k=cfg.moe.top_k,
                           router_type=cfg.moe.router_type)
    return policy


class _FallbackView:
    """Proxy over an ExpertStore presenting another miss ``fallback``: one
    store backs several decode variants (the full-quality "fetch" and the
    ladder's "little" rung) without being rebuilt.  Every other attribute
    (methods, counters) is the store's own."""

    def __init__(self, store, fallback: str):
        from repro_torch.serving.expert_store import FALLBACKS
        if fallback not in FALLBACKS:
            raise ValueError(f"fallback must be one of "
                             f"{'|'.join(FALLBACKS)}, got {fallback!r}")
        self._store = store
        self.fallback = fallback

    def __getattr__(self, name):
        return getattr(self._store, name)


def _offload_consts(offload, fallback):
    """What a slot-reading step closes over: the store, or a view of it with
    another ``fallback``.  An effective "little" builds the store's int8
    twins now (the first entry into the ladder's little rung, or a store
    built with ``fallback="little"``)."""
    if offload is None:
        return None
    slot_fetch = offload
    if fallback is not None and fallback != offload.fallback:
        slot_fetch = _FallbackView(offload, fallback)
    if slot_fetch.fallback == "little":
        offload.little_view()
    return slot_fetch


def _slot_kw(offload, slot_fetch, off, **kw):
    """The slot-path arguments of ``apply_model`` for a store (none
    without one)."""
    if offload is None:
        return {}
    return dict(expert_slots=offload.build_view(off), slot_fetch=slot_fetch,
                **kw)


def make_prefill_step(cfg: ModelConfig, moe_capacity: Optional[int] = None,
                      offload=None, fallback=None):
    """Wave prefill: returns prefill(params, tokens (B, S), caches,
    off=None, cross_src=None) -> (next_token (B, 1), caches), the caches
    written in place.  The prompts arrive LEFT-padded to one length S and
    every row runs at positions 0..S-1, as in the reference (pad tokens
    are attended to, and feed a Mamba layer's state).  ``cross_src`` is
    the cross-attention source (the servers pass none, as the reference's
    do: cross layers then read their empty caches).

    ``offload`` (an ``ExpertStore``) runs the sweep through the slot pool
    (call with ``off=state["offload"]``; params may be stripped of expert
    stacks), bit-equal to the full-resident sweep; ``fallback`` overrides
    the store's miss tier for this step."""
    slot_fetch = _offload_consts(offload, fallback)

    def prefill(params, tokens, caches, off=None, cross_src=None):
        S = tokens.shape[1]
        positions = torch.arange(S, dtype=torch.int32, device=tokens.device)
        kw = _slot_kw(offload, slot_fetch, off, slot_phase="prefill")
        with span("model.prefill"):
            logits, caches, _ = apply_model(
                params, tokens, cfg, positions=positions, caches=caches,
                cross_src=cross_src, moe_capacity=moe_capacity,
                last_logit_only=True, **kw)
            return logits[:, -1:].argmax(-1).to(torch.int32), caches

    return prefill


def make_admit_prefill(cfg: ModelConfig,
                       moe_capacity: Optional[int] = None, offload=None,
                       fallback=None):
    """Prefill for admission into a continuous batch.  The prompt arrives
    RIGHT-padded to a bucket length, so positions 0..length-1 are real and
    the first token is sampled from the logit at ``length - 1``.  Returns
    prefill(params, tokens (1, Sb), caches, length: int, off=None) ->
    (next_token (1, 1), caches), the caches written in place.

    ``offload`` (an ``ExpertStore``) runs the sweep through the slot pool
    (call with ``off=state["offload"]``; params may be stripped of expert
    stacks): right-pad tokens route and stream like real ones, as in the
    full-resident admission.  ``fallback`` overrides the store's miss
    tier for this step."""
    slot_fetch = _offload_consts(offload, fallback)

    def prefill(params, tokens, caches, length: int, off=None):
        S = tokens.shape[1]
        positions = torch.arange(S, dtype=torch.int32, device=tokens.device)
        kw = _slot_kw(offload, slot_fetch, off, slot_phase="prefill")
        with span("model.prefill"):
            logits, caches, _ = apply_model(
                params, tokens, cfg, positions=positions, caches=caches,
                moe_capacity=moe_capacity, logit_index=length - 1, **kw)
            next_tok = logits[:, -1:].argmax(-1).to(torch.int32)
        return next_tok, caches

    return prefill


def make_admit_step(cfg: ModelConfig):
    """Returns admit(state, fresh_caches, first_tok, slot, length) -> state,
    inserting a freshly prefilled request (B = 1 caches) into batch row
    ``slot`` in place.  Prefix caches hold the batch on axis 0, stacked
    caches on axis 1 (axis 0 is the super-block).  ``pos`` rows are
    re-masked so cache slots holding right-pad garbage (position >=
    length) read as empty (-1): later decode masks never attend to them."""

    def admit(state, fresh_caches, first_tok, slot: int, length: int):
        for group, axis in (("prefix", 0), ("scan", 1)):
            for big_c, small_c in zip(state["caches"][group],
                                      fresh_caches[group]):
                for key, small in small_c.items():
                    if key == "pos":
                        small = torch.where((small >= 0) & (small < length),
                                            small, -1)
                    big_c[key].select(axis, slot).copy_(small.select(axis, 0))
        state["tokens"][slot] = first_tok[0].to(torch.int32)
        with span("scheduler.slot_write"):     # host scalars: each waits
            state["pos"][slot] = length
            state["active"][slot] = True
        return state

    return admit


def retire_slot(state, slot: int):
    """Mark a slot free; its cache rows are overwritten on next admit."""
    with span("scheduler.slot_write"):         # a host scalar: it waits
        state["active"][slot] = False
    return state


def sample_tokens(logits, temperature: float, generator):
    """One draw per row from ``softmax(logits / temperature)``: (B, V) ->
    (B, 1) int32, from ``generator`` (on the logits' device), with no read
    back to the host."""
    probs = torch.softmax(logits.float() / temperature, dim=-1)
    return torch.multinomial(probs, 1, generator=generator).to(torch.int32)


def make_decode_step(cfg: ModelConfig, dali_cfg: Optional[DaliConfig] = None,
                     moe_capacity: Optional[int] = None,
                     sample: bool = False, temperature: float = 1.0,
                     policy=None, offload=None, fallback=None):
    """Returns decode(params, state, res_vecs=None) -> (state', logits,
    telemetry).  ``policy`` (name, policy instance or None — see
    ``resolve_policy``) is the offload scheduler run after the forward;
    ``sample`` draws each next token from ``softmax(logits /
    temperature)`` with ``state["rng"]`` instead of taking the argmax.

    ``offload`` (an ``ExpertStore``) switches MoE layers to the physical
    slot-pool path: weights come from ``state["offload"]``'s pool, misses
    from the store's tier, and dead batch slots never count as misses.  It
    needs a scheduling policy: slot plans are lowered from its decisions.

    Both serve-state layouts: a per-slot ``pos`` (B,) decodes every row at
    its own position and masks the routing observables by
    ``state["active"]``, so the policy sees the actual per-step token mix; a
    scalar ``pos`` decodes the wave way, every row at the shared position,
    with nothing masked (every row counts, finished requests' rows too, as
    in the reference).

    ``fallback`` overrides the store's miss tier for this decode variant
    (see ``_FallbackView``): the ladder's "little" rung reads the store's
    int8 twins."""
    from repro_torch.serving.spec import require_offload_policy, warn_legacy
    policy = resolve_policy(policy, cfg, dali_cfg)
    use_policy = policy.schedules and cfg.moe is not None
    if offload is not None:
        # legacy construction; ResolvedServe.decode_step() builds this
        # variant without warning
        warn_legacy("make_decode_step(offload=...)")
        require_offload_policy(policy, cfg)
    slot_fetch = _offload_consts(offload, fallback)

    def decode(params, state, res_vecs=None):
        if state["pos"].dim() == 1:
            positions = state["pos"][:, None]                  # (B, 1)
            active = state["active"]
        else:
            # the shared position broadcast to every row: the caches'
            # per-row scatter writes where a shared write would, and the
            # position is never read on the host
            positions = state["pos"].reshape(1, 1).expand(
                state["tokens"].shape[0], 1)
            active = None
        kw = _slot_kw(offload, slot_fetch, state.get("offload"),
                      slot_live=active)
        with span("model.decode"):
            logits, caches, infos = apply_model(
                params, state["tokens"], cfg, positions=positions,
                caches=state["caches"], moe_capacity=moe_capacity,
                trace=use_policy, **kw)
        with span("model.sample"):
            if sample:
                nxt = sample_tokens(logits[:, -1], temperature,
                                    state["rng"])
            else:
                nxt = logits[:, -1:].argmax(-1).to(torch.int32)
            # retired/empty slots hold position (their cache row is dead
            # weight until the next admission overwrites it)
            new_pos = (state["pos"] + 1 if active is None
                       else state["pos"] + active.to(torch.int32))
        new_state = dict(state, tokens=nxt, pos=new_pos, caches=caches)
        telemetry = {}
        if use_policy:
            with span("policy.observe"):
                workloads, obs = collect_policy_obs(
                    params, infos, cfg, token_mask=active,
                    res_vecs=res_vecs)
            with span("policy.step"):
                new_pstate, decisions = policy.step(state["dali"],
                                                    workloads, obs)
            telemetry = decisions.tel
            new_state["dali"] = new_pstate
        return new_state, logits, telemetry

    return decode


class ResilientDecode:
    """Decode-variant switchboard driven by the store's degradation ladder
    (the reference's DESIGN.md §10).  The serving tier keeps at most three
    decode variants and calls one per step:

      * ``healthy``  — the base policy, the store's own fallback;
      * ``degraded`` — the policy re-solved with the watchdog's re-fit
        ``t_trans`` and no prefetch (``ExpertStore.degraded_policy``);
      * ``little``   — the degraded policy plus ``fallback="little"``
        (misses read the int8 twins; the store suspends streaming itself).

    The port's step is eager, so a variant is a closure over a policy and a
    fallback, built at the first entry into its rung.  The policy state
    keeps its structure across variants (only cost constants change), so
    ``state["dali"]`` flows through transitions untouched.  ``react()``
    aligns the active variant with the ladder after each ``pre_step``;
    with no ladder (no faults) only the healthy variant ever runs."""

    RUNGS = ("healthy", "degraded", "little")

    def __init__(self, cfg: ModelConfig,
                 dali_cfg: Optional[DaliConfig] = None,
                 moe_capacity: Optional[int] = None, sample: bool = False,
                 temperature: float = 1.0, policy=None, offload=None):
        self.cfg = cfg
        self.offload = offload
        self.policy = resolve_policy(policy, cfg, dali_cfg)
        self._kw = dict(moe_capacity=moe_capacity, sample=sample,
                        temperature=temperature)
        self._variants = {}
        self.active = "healthy"

    def variant(self, rung: str):
        """A freshly built decode variant for ``rung`` (not cached)."""
        if rung not in self.RUNGS:
            raise ValueError(f"rung must be one of {'|'.join(self.RUNGS)}, "
                             f"got {rung!r}")
        if rung == "healthy" or self.offload is None:
            pol, fb = self.policy, None
        else:
            pol = self.offload.degraded_policy(self.policy)
            fb = "little" if rung == "little" else None
        from repro_torch.serving.spec import _internal
        with _internal():      # variant builds are not legacy call sites
            return make_decode_step(self.cfg, policy=pol,
                                    offload=self.offload, fallback=fb,
                                    **self._kw)

    def react(self):
        """Align the active variant with the store's ladder state.  Returns
        the (from, to) rung transition when it changed, None otherwise.
        Call after ``store.pre_step`` (where the ladder advances) and before
        the decode."""
        store = self.offload
        if store is None or getattr(store, "ladder", None) is None:
            return None
        want = store.ladder.state
        if want == self.active:
            return None
        frm, self.active = self.active, want
        return (frm, want)

    def __call__(self, params, state, res_vecs=None):
        rung = self.active
        fn = self._variants.get(rung)
        if fn is None:
            fn = self._variants[rung] = self.variant(rung)
        return fn(params, state, res_vecs)


def init_serve_state(cfg: ModelConfig, batch: int, max_len: int,
                     dali_cfg: Optional[DaliConfig] = None, dtype=None,
                     n_cross: Optional[int] = None, seed: int = 0,
                     per_slot: bool = False, policy=None, device="cuda",
                     offload=None):
    """The serve state of a wave (``per_slot=False``: one shared position)
    or of an empty slot table (``per_slot=True``); ``seed`` seeds the
    policy's initial state and the sampling generator; ``n_cross`` sizes
    the cross-attention caches (``init_caches``).  With ``offload``
    (an ``ExpertStore``) ``state["offload"]`` holds its slot pool, seeded
    from the policy's initial resident set."""
    dev = resolve_device(device)
    rng = torch.Generator(device=dev)
    rng.manual_seed(seed)
    state = {
        "tokens": torch.zeros((batch, 1), dtype=torch.int32, device=dev),
        "pos": torch.zeros((batch,) if per_slot else (), dtype=torch.int32,
                           device=dev),
        "caches": init_caches(cfg, batch, max_len, device=dev, dtype=dtype,
                              n_cross=n_cross),
        "rng": rng,
    }
    if per_slot:
        state["active"] = torch.zeros((batch,), dtype=torch.bool, device=dev)
    policy = resolve_policy(policy, cfg, dali_cfg)
    if policy.schedules and cfg.moe is not None:
        state["dali"] = policy.init(seed=seed, device=dev)
    if offload is not None:
        from repro_torch.serving.spec import (require_offload_policy,
                                              warn_legacy)
        # legacy construction; ResolvedServe.init_state() reaches this
        # without warning
        warn_legacy("init_serve_state(offload=...)")
        require_offload_policy(policy, cfg)
        state["offload"] = offload.init_device_state(
            state["dali"]["resident"].cpu().numpy())
        offload.count_sync()                # the resident set read back
    return state


def default_dali_config(cfg: ModelConfig, cache_ratio: float = 0.25,
                        prefetch_size: int = 1, w_size: int = 4,
                        u_size: int = 1) -> Optional[DaliConfig]:
    """Paper defaults: cache 25-50% of experts/layer; (w,u)=(4,1) Mixtral-
    like, (4,8) for many-expert models (§6.4).  None for an arch without
    MoE layers (dense, SSM); a hybrid counts only its MoE layers."""
    if cfg.moe is None:
        return None
    from repro_torch.core.cost_model import LOCAL_PC, CostModel
    n_moe = sum(1 for _, mlp in layer_pattern(cfg) if mlp == "moe")
    E = cfg.moe.n_routed
    cm = CostModel.for_config(cfg, LOCAL_PC)
    return DaliConfig.from_cost_model(
        cm, n_moe_layers=n_moe, n_experts=E,
        cache_size=max(1, int(E * cache_ratio)),
        prefetch_size=prefetch_size, w_size=w_size,
        u_size=min(u_size, max(1, E // 2)))
