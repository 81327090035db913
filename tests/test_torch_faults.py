"""Fault-tolerant offload streaming in the port (``repro_torch/serving/
faults.py``, the store's fault seam, the int8 little tier and
``ResilientDecode``) against the JAX package's ``tests/test_faults.py``
scenarios, on the smoke Mixtral (float32, CPU, two layers, 8 experts;
parameters and the initial policy state carried over with
``repro_torch.bridge``).

With the JAX package as the oracle: the schedule grammar and its errors,
the injector's firing and the element ``corrupt`` flips, the guarded link
fit, the watchdog's and the ladder's misses, refits and transitions on one
timing sequence, the row checksums (NaN payloads and -0.0 included), the
int8 twins (exactly), the little tier's decode (within 3e-5), the degraded
DaliConfig and the ``faults`` on ``"modeled"`` error.

Port against port, bit for bit: transient, read-error and corrupt-row runs
in all three modes equal full-resident decode; a persistent slowdown
degrades and heals exactly; the full ladder reaches the little rung and
recovers, exact before the little rung and again on fresh state after
recovery.  The store's clock and sleep are simulated (``SimClock``): a copy
takes no time unless an injected slowdown pads it, so every watchdog
decision is deterministic.
"""
import dataclasses

import jax
import ml_dtypes
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
import repro.core.cost_model as jcost
import repro.models.model as jmodel
import repro.serving.expert_store as jstore
import repro.serving.faults as jfaults
import repro.serving.spec as jspec
import repro_torch.configs as tconfigs
import repro_torch.core.cost_model as tcost
import repro_torch.models.model as tmodel
import repro_torch.serving.expert_store as tstore
import repro_torch.serving.faults as tfaults
import repro_torch.serving.scheduler as tsched
import repro_torch.serving.spec as tspec
import repro_torch.serving.steps as tsteps
from repro_torch import bridge
from repro_torch.tree import tree_map

MODES = ("blocking", "overlap", "pipelined")
MAX_LEN = 64


def _cfg(mod):
    cfg = mod.make_smoke(mod.get_config("mixtral_8x7b")).replace(n_layers=2)
    return cfg.replace(moe=dataclasses.replace(cfg.moe, n_routed=8))


@pytest.fixture(scope="module")
def model():
    jc, tc = _cfg(jconfigs), _cfg(tconfigs)
    jp = jmodel.init_model(jax.random.PRNGKey(0), jc)
    tp = bridge.to_torch(jax.tree.map(np.asarray, jp), "cpu")
    return jc, tc, jp, tp


class SimClock:
    """A clock that only a sleep moves: the store's copies take no time
    unless an injected slowdown pads them."""

    def __init__(self):
        self.t = 0.0

    def now(self):
        return self.t

    def sleep(self, s):
        self.t += s


def _spec_tuple(s):
    return (s.kind, s.start, s.stop, s.factor, s.link)


# --------------------------------------------------------------------------
# (a) schedule grammar, injector, guarded link fit — against the reference
# --------------------------------------------------------------------------

GOOD_SPECS = ["link_degrade:x12@8-26,transient_stall@5-7", "read_error@5",
              "corrupt_rows", "link_degrade", "transient_stall",
              "link_degrade[0>3]:x8@20-60", "link_degrade[host>*]:x4",
              "transient_stall[*>2]@5", " , read_error@1-4 , ", "",
              "link_degrade:x2.5@3"]
BAD_SPECS = ["meteor_strike@3", "link_degrade:x12@abc-",
             "link_degrade[0-3]:x8", "link_degrade[0>]:x8",
             "link_degrade[a>b]:x8", "read_error[0>3]@5",
             "corrupt_rows[host>0]"]


@pytest.mark.parametrize("text", GOOD_SPECS)
def test_parse_faults_equals_reference(text):
    got = [_spec_tuple(s) for s in tfaults.parse_faults(text)]
    assert got == [_spec_tuple(s) for s in jfaults.parse_faults(text)]
    specs = tfaults.parse_faults(text)
    assert tfaults.parse_faults(specs) == specs
    assert tfaults.parse_faults(None) == []


@pytest.mark.parametrize("text", BAD_SPECS)
def test_parse_faults_errors_equal_reference(text):
    with pytest.raises(jfaults.FaultParseError) as ref:
        jfaults.parse_faults(text)
    with pytest.raises(tfaults.FaultParseError) as got:
        tfaults.parse_faults(text)
    assert str(got.value) == str(ref.value)
    assert issubclass(tfaults.FaultParseError, ValueError)


def test_injector_firing_and_link_factors_equal_reference():
    sched = ("transient_stall@1-3,transient_stall@2-4,read_error@2-5,"
             "link_degrade[0>3]:x4@0-10,link_degrade[0>3]:x8@3-6,"
             "link_degrade:x2@7-9")
    tj, tt = jfaults.FaultInjector(sched), tfaults.FaultInjector(sched)
    for _ in range(11):
        assert tj.tick() == tt.tick()
        for name in ("maybe_stall", "maybe_read_error"):
            fired = []
            for inj in (tj, tt):
                n = 0
                for _ in range(4):      # each call fires at most one spec
                    try:
                        getattr(inj, name)()
                    except jfaults.TransientFault:
                        n += 1
                    except tfaults.TransientFault:
                        n += 1
                fired.append(n)
            assert fired[0] == fired[1]
        for pair in ((0, 3), (3, 0), None):
            assert tt.link_factor(pair) == tj.link_factor(pair)
    assert tt.last_fault_step() == tj.last_fault_step() == 9
    assert issubclass(tfaults.HostReadError, tfaults.TransientFault)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_corrupt_flips_the_reference_element(dtype):
    """Same staged layout and seed: the port's ``corrupt`` on torch rows
    flips exactly the bits the reference's flips in numpy rows."""
    npdt = np.float32 if dtype == "float32" else ml_dtypes.bfloat16
    rng = np.random.default_rng(4)
    arrs = {k: rng.standard_normal((6, 5, 7)).astype(npdt)
            for k in ("gate", "up", "down")}
    jinj = jfaults.FaultInjector("corrupt_rows@0-3", seed=9)
    tinj = tfaults.FaultInjector("corrupt_rows@0-3", seed=9)
    ref = {k: v.copy() for k, v in arrs.items()}
    got = {k: torch.from_numpy(v.copy().view(
        np.int32 if dtype == "float32" else np.int16)).view(
        getattr(torch, dtype)) for k, v in arrs.items()}
    # rows as a list of row tensors (the pool-slot layout) for one name
    got_rows = dict(got, up=list(got["up"]))
    for step in range(4):
        jinj.tick()
        tinj.tick()
        assert jinj.corrupt(ref, 4) == tinj.corrupt(got_rows, 4) == (
            1 if step < 3 else 0)
        assert tinj.corrupt(got_rows, 4) == 0          # once per step
        for k in ref:
            bits = np.int32 if dtype == "float32" else np.int16
            assert np.array_equal(
                got[k].view(torch.int32 if dtype == "float32"
                            else torch.int16).numpy(), ref[k].view(bits))
    changed = sum(int((ref[k].view(np.uint8) != arrs[k].view(np.uint8))
                      .any(axis=(1, 2)).sum()) for k in ref)
    assert changed >= 3


def test_fit_link_constants_equals_reference():
    prof = tcost.LOCAL_PC
    sizes = np.asarray([1e6, 2e6, 4e6, 8e6])
    cases = [([1e6, 1e6, 1e6], [1e-3, 2e-3, 1.5e-3]),      # no slope
             ([1e6, 2e6, 4e6], [4e-3, 2e-3, 1e-3]),        # negative slope
             (sizes, 1e-4 + sizes / 8e9),                  # a sane line
             ([5e5], [1e-3])]                              # one sample
    for sz, ts in cases:
        for p_t, p_j in ((prof, jcost.LOCAL_PC), (None, None)):
            assert tcost.fit_link_constants(sz, ts, p_t) \
                == jcost.fit_link_constants(sz, ts, p_j)
    gbps, lat, rejected = tcost.fit_link_constants(sizes, 1e-4 + sizes / 8e9,
                                                   prof)
    assert not rejected
    assert gbps == pytest.approx(8.0, rel=1e-6)
    assert lat == pytest.approx(1e-4, rel=1e-6)
    assert tcost.fit_link_constants(*cases[0][:2], prof) == (
        prof.link_gbps, prof.link_latency_s, True)


def test_calibrate_link_records_rejection(model):
    _, tc, _, _ = model
    cm = tcost.CostModel.for_config(tc)
    # constant transfer sizes carry no slope: degenerate by construction
    fitted = cm.calibrate_link(n_experts=(4, 4, 4), repeats=1, device="cpu")
    assert fitted.link_fit_rejected
    assert fitted.link_gbps == cm.profile.link_gbps
    assert fitted.link_latency_s == cm.profile.link_latency_s
    assert fitted.trans_time == cm.trans_time
    cpu = cm.calibrate_cpu(workloads=(1, 4), repeats=1)
    assert cpu.cpu_alpha > 0 and cpu.cpu_beta > 0
    assert cpu.t_cpu(2) == pytest.approx(cpu.cpu_alpha + 2 * cpu.cpu_beta)


# --------------------------------------------------------------------------
# (b) watchdog and ladder on one timing sequence
# --------------------------------------------------------------------------

def _timings(n=40, nbytes=1 << 20, seed=2):
    """(nbytes, seconds) pairs: healthy jitter, a 20x slowdown over steps
    12-24, healthy again."""
    rng = np.random.default_rng(seed)
    out = []
    for t in range(n):
        nb = nbytes * int(rng.integers(1, 4))
        s = 1e-4 + nb / 10e9 * (1 + 0.2 * rng.random())
        out.append((nb, s * (20 if 12 <= t < 24 else 1)))
    return out


@pytest.mark.parametrize("kw", [
    dict(),
    dict(margin=2.0, patience=2, recover_patience=2, calib_n=2,
         floor_s=0.0),
    dict(margin=3.0, patience=2, recover_patience=2, calib_n=2)])
@pytest.mark.parametrize("little_after", [1, 6])
def test_watchdog_and_ladder_equal_reference(kw, little_after):
    runs = []
    for mod in (jfaults, tfaults):
        wd = mod.LinkWatchdog(1 << 20, 25.0, 20e-6, **kw)
        lad = mod.DegradationLadder(wd, little_after=little_after)
        seen = []
        for step, (nb, s) in enumerate(_timings()):
            missed = wd.observe(nb, s)
            seen.append((missed, lad.on_step(step), wd.degraded, wd.healed,
                         wd.refit() if step % 5 == 4 else None))
        runs.append((seen, wd.report(), list(lad.transitions),
                     lad.time_to_recover()))
    assert runs[0] == runs[1]
    seen, rep, transitions, ttr = runs[1]
    assert rep["deadline_misses"] > 0 and rep["degrade_events"] >= 1
    assert [(a, b) for _, a, b in transitions][0] == (tfaults.HEALTHY,
                                                     tfaults.DEGRADED)
    assert transitions[-1][2] == tfaults.HEALTHY and ttr > 0


def test_degraded_dcfg_equals_reference(model):
    jc, tc, jp, tp = model
    jpol = jspec.ServeSpec(cfg=jc, policy="dali").resolve(jp).policy
    tpol = tsteps.resolve_policy("dali", tc)
    js = jstore.ExpertStore(jp, jc, n_slots=4, faults="link_degrade")
    ts = tstore.ExpertStore(tp, tc, n_slots=4, faults="link_degrade")
    for i in range(8):          # a slow-link window for refit() to see
        for st in (js, ts):
            st.watchdog.observe(st.expert_bytes * (1 + i % 3),
                                1e-3 * (1 + i % 3))
    jd, td = js.degraded_dcfg(jpol.dcfg), ts.degraded_dcfg(tpol.dcfg)
    assert td.t_trans == jd.t_trans > tpol.dcfg.t_trans
    assert td.prefetch_size == jd.prefetch_size == 0
    assert ts.health()["links"]["host>0"] == js.health()["links"]["host>0"]
    assert ts.degraded_policy(tpol).dcfg == td
    none_pol = tsteps.resolve_policy("none", tc)
    assert ts.degraded_policy(none_pol) is none_pol


# --------------------------------------------------------------------------
# (c) row checksums, (d) the int8 twins — bit for bit
# --------------------------------------------------------------------------

def _special_rows(dtype, shape, seed=0):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal(shape).astype(np.float32)
    flat = a.reshape(shape[0], -1)
    flat[0, :3] = [-0.0, np.nan, np.inf]
    flat[1, -1] = -np.inf
    a = a.astype(dtype)
    bits = a.reshape(shape[0], -1).view(
        np.uint32 if a.dtype.itemsize == 4 else np.uint16)
    bits[2, 0] = 0x7FC1 if a.dtype.itemsize == 2 else 0x7FC00123  # payload
    bits[2, 1] = 0xFFFF if a.dtype.itemsize == 2 else 0xFFFFFFFF
    return a


def _to_torch(a):
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


@pytest.mark.parametrize("dtype", [np.float32, ml_dtypes.bfloat16])
@pytest.mark.parametrize("shape", [(4, 6, 8), (3, 5, 7), (5, 3)])
def test_row_checksums_equal_reference(dtype, shape):
    a = _special_rows(dtype, shape)
    b = _special_rows(dtype, shape, seed=1)
    ref = jstore._row_checksums_np(a, b)
    got = tstore.row_checksums(_to_torch(a), _to_torch(b)).numpy()
    assert got.dtype == np.int64
    np.testing.assert_array_equal(got, ref.astype(np.int64))
    # one bit anywhere in a row changes only that row's checksum
    t = _to_torch(a)
    t.view(torch.int16 if t.element_size() == 2 else torch.int32) \
        .reshape(shape[0], -1)[1, -1] ^= 0x4000
    flipped = tstore.row_checksums(t, _to_torch(b)).numpy()
    assert (flipped != got).tolist() == [i == 1 for i in range(shape[0])]
    # a slice with an odd offset folds the narrow way, to the same values
    big = np.concatenate([a[:1], a], axis=0)
    np.testing.assert_array_equal(
        tstore.row_checksums(_to_torch(big)[1:]).numpy(),
        jstore._row_checksums_np(a).astype(np.int64))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_little_twins_equal_reference(model, dtype):
    jc, tc, jp, tp = model
    if dtype == "bfloat16":
        jp = jax.tree.map(lambda x: x.astype(jax.numpy.bfloat16), jp)
        tp = tree_map(lambda x: x.to(torch.bfloat16), tp)
    js = jstore.ExpertStore(jp, jc, n_slots=4)
    ts = tstore.ExpertStore(tp, tc, n_slots=4)
    assert ts.memory_layout()["little_bytes"] == 0
    ref = jax.tree.map(np.asarray, js.little_view())
    got = ts.little_view()
    assert ts.little_view() is got                # built once
    for k in ref:
        assert got[k].dtype == (torch.int8 if k.endswith("_q")
                                else torch.float32)
        np.testing.assert_array_equal(got[k].numpy(), ref[k], err_msg=k)
    js_lay, ts_lay = js.memory_layout(), ts.memory_layout()
    assert ts_lay["little_bytes"] == js_lay["little_bytes"] > 0


# --------------------------------------------------------------------------
# (e) the little tier's decode against the JAX package's
# --------------------------------------------------------------------------

class _Carried:
    """The port's policy started from a carried-over reference state."""
    schedules = True

    def __init__(self, policy, state):
        self.policy, self.state, self.dcfg = policy, state, policy.dcfg

    def init(self, seed=0, device="cpu"):
        return tree_map(torch.clone, self.state)

    def step(self, state, workloads, obs):
        return self.policy.step(state, workloads, obs)


def _rel_err(ref, got):
    ref, got = np.asarray(ref, np.float64), np.asarray(got, np.float64)
    return float(np.linalg.norm(got - ref) / max(np.linalg.norm(ref), 1e-9))


def test_little_decode_matches_jax_little_tier(model):
    """Decode with ``fallback="little"`` from a pool of 5 of 8 experts (a
    batch-2 step routes to up to 4 per layer, so rows miss): every step's
    logits within 3e-5 of the JAX package's little tier, the misses
    counted alike and served without a host fetch, and the twins' error
    against full-resident decode clearly int8-sized."""
    jc, tc, jp, tp = model
    kw = dict(batch_size=2, max_len=48)
    jres = jspec.ServeSpec(cfg=jc, policy="dali", offload=jspec.OffloadSpec(
        mode="blocking", fallback="little"), **kw).resolve(jp)
    carried = bridge.to_torch(jax.tree.map(np.asarray, jres.policy.init()),
                              "cpu")
    tpol = _Carried(tsteps.resolve_policy("dali", tc), carried)
    tres = tspec.ServeSpec(cfg=tc, policy=tpol, device="cpu",
                           offload=tspec.OffloadSpec(mode="blocking",
                                                     fallback="little"),
                           **kw).resolve(tp)
    assert tres.store._little is not None          # built for the tier
    jdec = jax.jit(jres.decode_step())
    tdec = tres.decode_step()
    tref = tsteps.make_decode_step(tc, policy=tpol)
    js, ts = jres.init_state(), tres.init_state()
    s_ref = tsteps.init_serve_state(tc, 2, 48, policy=tpol, device="cpu")
    rng = np.random.default_rng(3)
    errs = []
    for t in range(6):
        tok = rng.integers(0, tc.vocab, (2, 1)).astype(np.int32)
        js["tokens"] = jax.numpy.asarray(tok)
        ts["tokens"] = torch.from_numpy(tok)
        s_ref["tokens"] = torch.from_numpy(tok)
        js, jlg, jtel = jdec(jres.params, js)
        ts, tlg, ttel = tdec(tres.params, ts)
        s_ref, lg_ref, _ = tref(tp, s_ref)
        jlg, tlg = np.asarray(jlg), tlg.numpy()
        assert np.abs(tlg - jlg).max() <= 3e-5 * np.abs(jlg).max(), t
        errs.append(_rel_err(lg_ref.numpy(), tlg))
        jt = (np.asarray(js["dali"]["resident"])
              | np.asarray(jtel["prefetched"]))
        tt = tres.store.next_target(ts, ttel)
        np.testing.assert_array_equal(tt, jt)
        js["offload"] = jres.store.step_update(js["offload"], jt)
        ts["offload"] = tres.store.step_update(ts["offload"], tt)
    st = tres.store.stats()
    assert st["fallback_rows"] == jres.store.stats()["fallback_rows"] > 0
    assert st["fallback_fetches"] == 0
    assert 0.0 < max(errs) < 0.2


# --------------------------------------------------------------------------
# (f) faulted runs, port against port, bit for bit
# --------------------------------------------------------------------------

def _tight_watchdog(store, *, margin=3.0, patience=2, recover_patience=2,
                    calib_n=2, little_after=3, enable_little=True):
    """Swap the store's watchdog and ladder for short test ones."""
    wd = tfaults.LinkWatchdog(store.expert_bytes, store.watchdog.gbps,
                              store.watchdog.latency_s, margin=margin,
                              patience=patience,
                              recover_patience=recover_patience,
                              calib_n=calib_n)
    store.watchdog = wd
    store.ladder = tfaults.DegradationLadder(wd, little_after=little_after,
                                             enable_little=enable_little)
    return store


def _force_miss(store, off):
    """Every activated expert of the next step misses."""
    store._cur[:] = -1
    store._set_dev_cur(off, store._cur)


def _run_faulted(tc, tp, mode, faults, n_steps=10, B=2, tighten=None,
                 force_miss_at=None, seed=7):
    """One physical mode with injected faults through the serving hooks
    (pre_step / react / decode / post_dispatch / next_target) beside
    full-resident decode on the same token trace.  Returns the per-step
    logits pairs, the store, the decode and the rung of each step."""
    pol = tsteps.resolve_policy("dali", tc)
    clock = SimClock()
    store = tstore.ExpertStore(
        tp, tc, n_slots=pol.dcfg.cache_size + pol.dcfg.prefetch_size,
        mode=mode, faults=faults, retry_backoff_s=1e-4, clock=clock.now,
        sleep=clock.sleep)
    if tighten is not None:
        _tight_watchdog(store, **tighten)
    dec_ref = tsteps.make_decode_step(tc, policy=pol)
    decode = tsteps.ResilientDecode(tc, policy=pol, offload=store)
    s_ref = tsteps.init_serve_state(tc, B, MAX_LEN, policy=pol, device="cpu")
    s_slot = tsteps.init_serve_state(tc, B, MAX_LEN, policy=pol, device="cpu",
                                     offload=store)
    slim = tstore.strip_expert_params(tp, tc)
    rng = np.random.default_rng(seed)
    target, out, rungs = None, [], []
    for t in range(n_steps):
        tok = torch.as_tensor(rng.integers(0, tc.vocab, (B, 1)),
                              dtype=torch.int32)
        s_ref["tokens"] = tok
        s_slot["tokens"] = tok.clone()
        if t == force_miss_at:
            _force_miss(store, s_slot["offload"])
        s_slot["offload"] = store.pre_step(s_slot["offload"], mode, target)
        decode.react()
        rungs.append(decode.active)
        s_ref, lg_ref, _ = dec_ref(tp, s_ref)
        s_slot, lg_slot, tel = decode(slim, s_slot)
        store.post_dispatch(mode, target)
        target = store.next_target(s_slot, tel)
        out.append((lg_ref, lg_slot))
    return out, store, decode, rungs


def _assert_exact(pairs):
    for i, (ref, slot) in enumerate(pairs):
        assert torch.equal(ref, slot), f"step {i}"


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("faults,n_steps,counter", [
    ("transient_stall@2-5", 8, "stalls"),
    ("read_error@1-4", 7, "read_errors")])
def test_transient_faults_retry_bit_identical(model, mode, faults, n_steps,
                                              counter):
    _, tc, _, tp = model
    pairs, store, _, _ = _run_faulted(tc, tp, mode, faults, n_steps=n_steps)
    st = store.stats()
    assert st[counter] >= 3 and st["retries"] >= 3
    assert st["stage_aborts"] == 0        # fire once -> the first retry clears
    assert store.ladder.state == tfaults.HEALTHY
    _assert_exact(pairs)


@pytest.mark.parametrize("mode", MODES)
def test_corrupt_rows_caught_and_restaged(model, mode):
    _, tc, _, tp = model
    # the forced miss mid-window keeps the plans full, so every corrupt step
    # stages rows for the injector to flip bits in
    pairs, store, _, _ = _run_faulted(tc, tp, mode, "corrupt_rows@1-8",
                                      n_steps=10, force_miss_at=3)
    st = store.stats()
    assert st["corrupt_caught"] > 0
    assert st["restaged_rows"] >= st["corrupt_caught"]
    _assert_exact(pairs)


def test_exhausted_retries_skip_the_plan_exactly(model):
    """More transient faults a step than retries: the plan is dropped (the
    mirror does not advance) and decode stays exact through the misses."""
    _, tc, _, tp = model
    faults = ",".join(["transient_stall@2-4"] * 3 + ["read_error@2-4"] * 2)
    store = tstore.ExpertStore(tp, tc, n_slots=3, mode="blocking",
                               faults=faults, max_retries=3,
                               retry_backoff_s=0.0)
    assert store._guard_transient("stage")              # step -1: quiet
    store.injector.tick()
    store.injector.tick()
    store.injector.tick()                               # step 2
    assert not store._guard_transient("stage")
    st = store.stats()
    assert (st["retries"], st["stage_aborts"]) == (4, 1)
    assert store._guard_transient("stage")   # one spec left: retried, clear
    pairs, store, _, _ = _run_faulted(tc, tp, "blocking", faults, n_steps=6)
    assert store.stats()["stage_aborts"] >= 1
    _assert_exact(pairs)


@pytest.mark.parametrize("mode", ["overlap", "pipelined"])
def test_persistent_slowdown_degrades_and_heals_exact(model, mode):
    _, tc, _, tp = model
    pairs, store, decode, rungs = _run_faulted(
        tc, tp, mode, "link_degrade:x25@4-14", n_steps=22,
        tighten=dict(enable_little=False))
    assert tfaults.DEGRADED in rungs and tfaults.LITTLE not in rungs
    assert store.ladder.state == tfaults.HEALTHY
    assert store.watchdog.deadline_misses > 0
    frm_to = [(a, b) for _, a, b in store.ladder.transitions]
    assert (tfaults.HEALTHY, tfaults.DEGRADED) in frm_to
    assert (tfaults.DEGRADED, tfaults.HEALTHY) in frm_to
    assert store.ladder.time_to_recover() > 0
    assert "degraded" in decode._variants
    _assert_exact(pairs)           # the fetch tier: exact, degraded or not


def test_full_ladder_to_little_and_recover(model):
    _, tc, _, tp = model
    mode = "pipelined"
    pairs, store, decode, rungs = _run_faulted(
        tc, tp, mode, "link_degrade:x25@4-18", n_steps=28,
        tighten=dict(little_after=2))
    assert tfaults.DEGRADED in rungs and tfaults.LITTLE in rungs
    assert store.ladder.state == tfaults.HEALTHY and rungs[-1] == "healthy"
    st = store.stats()
    assert st["little_steps"] > 0 and st["probes"] > 0
    frm_to = [(a, b) for _, a, b in store.ladder.transitions]
    assert (tfaults.DEGRADED, tfaults.LITTLE) in frm_to
    assert (tfaults.LITTLE, tfaults.HEALTHY) in frm_to
    assert store.memory_layout()["little_bytes"] > 0
    # exact until the little rung; after it the caches carry int8-quality
    # history, so the stream stays close
    first = rungs.index(tfaults.LITTLE)
    assert first > 0
    _assert_exact(pairs[:first])
    for i, (ref, slot) in enumerate(pairs[first:]):
        assert _rel_err(ref.numpy(), slot.numpy()) < 0.2, first + i
    # healed: fresh state decodes bit for bit again
    pol = tsteps.resolve_policy("dali", tc)
    dec_ref = tsteps.make_decode_step(tc, policy=pol)
    s_ref = tsteps.init_serve_state(tc, 2, 48, policy=pol, device="cpu")
    s_slot = tsteps.init_serve_state(tc, 2, 48, policy=pol, device="cpu",
                                     offload=store)
    slim = tstore.strip_expert_params(tp, tc)
    rng = np.random.default_rng(11)
    target = None
    for t in range(4):
        tok = torch.as_tensor(rng.integers(0, tc.vocab, (2, 1)),
                              dtype=torch.int32)
        s_ref["tokens"], s_slot["tokens"] = tok, tok.clone()
        s_slot["offload"] = store.pre_step(s_slot["offload"], mode, target)
        decode.react()
        assert decode.active == tfaults.HEALTHY
        s_ref, lg_ref, _ = dec_ref(tp, s_ref)
        s_slot, lg_slot, tel = decode(slim, s_slot)
        store.post_dispatch(mode, target)
        target = store.next_target(s_slot, tel)
        assert torch.equal(lg_ref, lg_slot), f"post-recovery step {t}"


def test_prefill_sweep_little_tier_close(model):
    """An admission prefill through the little tier with the pool emptied:
    every activated expert's bucket runs over dequantized twins in
    2-expert waves, close to full-resident and without a host fetch."""
    _, tc, _, tp = model
    L, Sb = 11, 16
    toks = np.zeros((1, Sb), np.int32)
    toks[0, :L] = np.random.default_rng(5).integers(1, tc.vocab, L)
    toks = torch.as_tensor(toks)

    def caches():
        return tmodel.init_caches(tc, 1, MAX_LEN, device="cpu")

    pos = torch.arange(Sb, dtype=torch.int32)
    ref, _, _ = tmodel.apply_model(tp, toks, tc, positions=pos,
                                   caches=caches(), logit_index=L - 1)
    rs = tspec.ServeSpec(cfg=tc, policy="dali", batch_size=1, max_len=MAX_LEN,
                         device="cpu", offload=tspec.OffloadSpec(
                             mode="pipelined", prefill_rows=2)).resolve(tp)
    off = rs.init_state(batch=1)["offload"]
    _force_miss(rs.store, off)
    got, _, _ = tmodel.apply_model(
        rs.params, toks, tc, positions=pos, caches=caches(),
        logit_index=L - 1, expert_slots=rs.store.build_view(off),
        slot_fetch=tsteps._FallbackView(rs.store, "little"),
        slot_phase="prefill")
    assert 0.0 < _rel_err(ref.numpy(), got.numpy()) < 0.2
    st = rs.store.stats()
    assert st["fallback_rows"] > rs.store.n_layers
    assert st["prefill_fetch_rows"] == st["prefill_waves"] == 0
    prefill = tsteps.make_admit_prefill(tc, offload=rs.store,
                                        fallback="little")
    tok, _ = prefill(rs.params, toks, caches(), L, off)
    assert tuple(tok.shape) == (1, 1)


# --------------------------------------------------------------------------
# (g) telemetry, servers, construction
# --------------------------------------------------------------------------

def test_drain_windows_partition_counters(model):
    _, tc, _, tp = model
    store = tstore.ExpertStore(tp, tc, n_slots=4)
    store._bump("fallback_rows", 3)
    store._bump("retries", 2)
    d1 = store.drain()
    assert d1["fallback_rows"] == 3 and d1["retries"] == 2
    d2 = store.drain()                    # an empty window drains zeros
    assert all(v == 0 for v in d2.values())
    store._bump("fallback_rows", 4)
    assert store.drain()["fallback_rows"] == 4
    assert store.stats()["fallback_rows"] == 7      # totals stay monotonic
    for k in ("retries", "stalls", "read_errors", "stage_aborts",
              "corrupt_caught", "restaged_rows", "probes", "little_steps"):
        assert k in d1


def _serve(tc, tp, faults, server="continuous", mode="pipelined"):
    rng = np.random.default_rng(5)
    srv = tsched.make_server(server, tp, tc, batch_size=2, max_len=32,
                             policy="dali", offload=mode, faults=faults,
                             device="cpu")
    for i in range(3):
        srv.submit(tsched.Request(
            rid=i, prompt=rng.integers(1, tc.vocab, 10).astype(np.int32),
            max_new_tokens=4))
    done = srv.run()
    return srv, [r.output for r in sorted(done, key=lambda r: r.rid)]


def test_server_reports_fallback_rate_and_links(model):
    _, tc, _, tp = model
    srv, outs = _serve(tc, tp, "transient_stall@1-3")
    assert len(outs) == 3 and srv.metrics.requests == 3
    assert srv.metrics.offload_tel.get("h2d_rows", 0) > 0
    assert "fb_rows/req" in srv.metrics.summary()
    assert "retries=" in srv.metrics.summary()
    assert (srv.metrics.offload_tel["fallback_rows"]
            == srv.store.stats()["fallback_rows"])
    assert set(srv.metrics.links) == {"host>0"}
    srv.metrics.fold_links({"host>0": dict(srv.metrics.links["host>0"],
                                           deadline_misses=2)})
    assert "links host>0[miss=2" in srv.metrics.summary()


@pytest.mark.parametrize("server", ["continuous", "wave"])
def test_server_transient_faults_identical_outputs(model, server):
    """The same workload with and without injected transient faults gives
    identical per-request outputs."""
    _, tc, _, tp = model
    _, clean = _serve(tc, tp, None, server)
    srv, faulted = _serve(tc, tp, "transient_stall@2-4,read_error@1-3",
                          server)
    assert srv.metrics.offload_tel.get("stalls", 0) > 0
    assert srv.metrics.offload_tel.get("read_errors", 0) > 0
    assert faulted == clean


def _recorded_cost_models(monkeypatch, store_mod):
    """The ``cost_model`` each ExpertStore of ``store_mod`` is built with."""
    seen = []

    class Recording(store_mod.ExpertStore):
        def __init__(self, *args, cost_model=None, **kw):
            seen.append(cost_model)
            super().__init__(*args, cost_model=cost_model, **kw)

    monkeypatch.setattr(store_mod, "ExpertStore", Recording)
    return seen


def test_spec_faults_topology_and_modeled_contract(model, monkeypatch):
    jc, tc, jp, tp = model
    jpol = jspec.ServeSpec(cfg=jc, policy="dali").resolve(jp).policy
    with pytest.raises(ValueError) as ref:
        jspec.build_store("modeled", jp, jc, jpol, faults="transient_stall")
    with pytest.raises(ValueError) as got:
        tspec.ServeSpec(cfg=tc, policy="dali", device="cpu",
                        offload=tspec.OffloadSpec(
                            faults="transient_stall")).resolve(tp)
    assert str(got.value) == str(ref.value)
    # topology: the store's cost model carries the parsed fabric, as the
    # reference's does (one device on the CPU)
    t_seen = _recorded_cost_models(monkeypatch, tstore)
    j_seen = _recorded_cost_models(monkeypatch, jstore)
    tspec.ServeSpec(cfg=tc, policy="dali", device="cpu",
                    offload=tspec.OffloadSpec(mode="overlap",
                                              topology="flat")).resolve(tp)
    jspec.build_store("overlap", jp, jc, jpol, topology="flat")
    t_topo, j_topo = t_seen[0].topology, j_seen[0].topology
    assert t_topo.n == j_topo.n == 1 and t_topo.name == j_topo.name
    for k in ("gbps", "latency_s", "rejected"):
        np.testing.assert_array_equal(getattr(t_topo, k), getattr(j_topo, k))
    assert t_seen[0].trans_time == pytest.approx(j_seen[0].trans_time)
    with pytest.raises(tcost.TopologyParseError):
        tspec.ServeSpec(cfg=tc, policy="dali", device="cpu",
                        offload=tspec.OffloadSpec(
                            mode="overlap", topology="flat,0>1:x8")
                        ).resolve(tp)
    with pytest.raises(jcost.TopologyParseError):
        jspec.build_store("overlap", jp, jc, jpol, topology="flat,0>1:x8")
    monkeypatch.undo()
    cm = tcost.CostModel.for_config(tc)
    cm = dataclasses.replace(cm, link_gbps=3.0, link_latency_s=1e-4)
    rs = tspec.ServeSpec(cfg=tc, policy="dali", device="cpu",
                         offload=tspec.OffloadSpec(
                             mode="overlap", faults="link_degrade",
                             cost_model=cm)).resolve(tp)
    assert (rs.store.watchdog.gbps, rs.store.watchdog.latency_s) == (3.0,
                                                                    1e-4)
    assert rs.store.injector.schedule == tfaults.parse_faults(
        "link_degrade:x12@8-26")
    rd = rs.resilient_decode()
    assert rd.react() is None and rd.active == "healthy"
    with pytest.raises(ValueError, match="rung"):
        rd.variant("bogus")
    # without faults there is no ladder: the switchboard never moves
    plain = tspec.ServeSpec(cfg=tc, policy="dali", device="cpu",
                            offload=tspec.OffloadSpec(mode="pipelined")
                            ).resolve(tp)
    assert plain.store.watchdog is None and plain.store.ladder is None
    assert plain.store.health()["ladder_state"] == tfaults.HEALTHY
    assert plain.resilient_decode().react() is None
