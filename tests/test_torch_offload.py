"""Physical expert offload in the port (``repro_torch/serving/expert_store.py``
and the slot paths of ``models/moe.py``) against the JAX package's and
against the port's own full-resident execution, on the smoke Mixtral with
Mixtral's 8 experts (float32, CPU, two layers; parameters and the initial
policy state carried over with ``repro_torch.bridge``).

* slot plans: the port's ``lower_slot_plan_np`` equals both JAX lowerings;
* bit for bit, port against port: slot-pool decode at batch 2 (where
  full-resident decode also takes the grouped path) and admission prefill
  equal full-resident execution in every mode, with stripped params, also
  on a forced-miss step and with a dead batch slot (which never fetches);
* the host tier equals the JAX store's ``host_ffn_cb`` / ``prefill_host_cb``
  within 3e-5 relative;
* whole servers: the port's tokens equal the JAX server's in the same mode
  at batch 1 and 4, and after every step the host slot-table mirror and the
  row counters equal the JAX store's;
* the contract errors: ``policy="none"`` raises the reference's message,
  ``faults`` on ``"modeled"`` the reference's ``ValueError``, and
  ``topology`` (links between devices) resolves with the fabric on the
  store's cost model and serves the same tokens; ``faults`` and
  ``fallback="little"`` resolve and serve in every physical mode (their
  scenarios: test_torch_faults.py).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
import repro.models.model as jmodel
import repro.serving.expert_store as jstore
import repro.serving.scheduler as jsched
import repro.serving.spec as jspec
import repro.serving.steps as jsteps
import repro_torch.configs as tconfigs
import repro_torch.models.model as tmodel
import repro_torch.serving.expert_store as tstore
import repro_torch.serving.scheduler as tsched
import repro_torch.serving.spec as tspec
import repro_torch.serving.steps as tsteps
from repro_torch import bridge, kernels
from repro_torch.tree import tree_leaves, tree_map

MODES = ("blocking", "overlap", "pipelined")
NO_EOS = 10_000_000
MAX_LEN = 48
COUNTERS = ("h2d_rows", "fallback_rows", "fallback_fetches",
            "prefill_fetch_rows", "prefill_waves", "prefill_host_rows")


def _cfg(mod):
    cfg = mod.make_smoke(mod.get_config("mixtral_8x7b")).replace(n_layers=2)
    return cfg.replace(moe=dataclasses.replace(cfg.moe, n_routed=8))


@pytest.fixture(scope="module")
def model():
    jc, tc = _cfg(jconfigs), _cfg(tconfigs)
    jp = jmodel.init_model(jax.random.PRNGKey(0), jc)
    tp = bridge.to_torch(jax.tree.map(np.asarray, jp), "cpu")
    return jc, tc, jp, tp


def _store(tc, tp, pol, mode, fallback="fetch", **kw):
    d = pol.dcfg
    return tstore.ExpertStore(tp, tc, n_slots=d.cache_size + d.prefetch_size,
                              mode=mode, fallback=fallback, **kw)


def _empty_pool(store, off):
    """Every activated expert of the next step must miss."""
    store._cur[:] = -1
    store._set_dev_cur(off, store._cur)


def _equal_trees(a, b):
    for x, y in zip(tree_leaves(a), tree_leaves(b)):
        assert torch.equal(x, y)


# --------------------------------------------------------------------------
# slot plans
# --------------------------------------------------------------------------

def _plan_cases():
    rng = np.random.default_rng(11)
    L, E, S = 3, 8, 5
    cases = []
    for _ in range(12):
        cur = np.full((L, S), -1, np.int32)
        for l in range(L):
            n = rng.integers(0, S + 1)
            cur[l, :n] = rng.choice(E, n, replace=False)
            rng.shuffle(cur[l])
        cases.append((cur, rng.random((L, E)) < 0.5))
    full = np.tile(np.arange(S, dtype=np.int32), (L, 1))
    empty = np.full((L, S), -1, np.int32)
    cases += [(full, np.zeros((L, E), bool)),           # all evict
              (full, ~np.isin(np.arange(E), np.arange(S))[None]
               .repeat(L, 0)),                          # all replaced
              (empty, np.ones((L, E), bool)),           # fill from empty
              (empty, np.zeros((L, E), bool)),          # nothing wanted
              (full, np.ones((L, E), bool))]            # already full
    return cases


@pytest.mark.parametrize("moves", [1, 2, 4])
def test_slot_plan_equals_both_jax_lowerings(moves):
    lower_j = jax.jit(jstore.lower_slot_plan, static_argnums=2)
    for cur, target in _plan_cases():
        got = tstore.lower_slot_plan_np(cur, target, moves)
        ref_np = jstore.lower_slot_plan_np(cur, target, moves)
        ref_j = jax.tree.map(np.asarray, lower_j(jnp.asarray(cur),
                                                 jnp.asarray(target), moves))
        for a, b, c in zip(got, ref_np, ref_j):
            np.testing.assert_array_equal(a, b)
            np.testing.assert_array_equal(a, c)


# --------------------------------------------------------------------------
# bit for bit against the port's own full-resident execution
# --------------------------------------------------------------------------

def _run_decode(tc, tp, mode, n_steps=8, B=2, fallback="fetch",
                force_miss_at=None, active=None):
    """Full-resident and slot-pool decode on the same token trace, the pool
    streamed through the serving loop's hooks.  Returns per-step logits
    pairs and the store."""
    pol = tsteps.resolve_policy("dali", tc)
    store = _store(tc, tp, pol, mode, fallback)
    dec_ref = tsteps.make_decode_step(tc, policy=pol)
    dec_slot = tsteps.make_decode_step(tc, policy=pol, offload=store)
    s_ref = tsteps.init_serve_state(tc, B, MAX_LEN, policy=pol, device="cpu",
                                    per_slot=True)
    s_slot = tsteps.init_serve_state(tc, B, MAX_LEN, policy=pol,
                                     device="cpu", offload=store,
                                     per_slot=True)
    for s in (s_ref, s_slot):
        s["active"][:] = torch.tensor(active or [True] * B)
    slim = tstore.strip_expert_params(tp, tc)
    rng = np.random.default_rng(7)
    target, out = None, []
    for t in range(n_steps):
        tok = torch.as_tensor(rng.integers(0, tc.vocab, (B, 1)),
                              dtype=torch.int32)
        s_ref["tokens"] = tok
        s_slot["tokens"] = tok.clone()
        if t == force_miss_at:
            _empty_pool(store, s_slot["offload"])
        s_slot["offload"] = store.pre_step(s_slot["offload"], mode, target)
        s_ref, lg_ref, _ = dec_ref(tp, s_ref)
        s_slot, lg_slot, tel = dec_slot(slim, s_slot)
        store.post_dispatch(mode, target)
        target = store.next_target(s_slot, tel)
        out.append((lg_ref, lg_slot))
    assert torch.equal(s_ref["dali"]["resident"], s_slot["dali"]["resident"])
    return out, store


@pytest.mark.parametrize("mode", MODES)
def test_slot_decode_bit_identical_to_full_resident(model, mode):
    _, tc, _, tp = model
    kernels.reset_launch_counts()
    pairs, store = _run_decode(tc, tp, mode)
    for i, (ref, slot) in enumerate(pairs):
        assert torch.equal(ref, slot), f"step {i}"
    # the pool is smaller than the working set: misses were fetched and
    # plans streamed, so the parity is load-bearing
    st = store.stats()
    assert st["fallback_rows"] > 0 and st["h2d_rows"] > 0
    assert store.stats()["miss_reads"] == 8 * store.n_layers
    assert kernels.launch_counts() == {k: 0 for k in kernels.LAUNCHES}


@pytest.mark.parametrize("mode", ["blocking", "pipelined"])
def test_forced_miss_step_fetches_bitwise(model, mode):
    _, tc, _, tp = model
    pairs, store = _run_decode(tc, tp, mode, n_steps=5, force_miss_at=2)
    for i, (ref, slot) in enumerate(pairs):
        assert torch.equal(ref, slot), f"step {i}"
    assert store.stats()["fallback_fetches"] > 0


def test_dead_slot_never_fetches(model):
    _, tc, _, tp = model
    pol = tsteps.resolve_policy("dali", tc)
    store = _store(tc, tp, pol, "blocking")
    dec = tsteps.make_decode_step(tc, policy=pol, offload=store)
    state = tsteps.init_serve_state(tc, 2, 32, policy=pol, device="cpu",
                                    offload=store, per_slot=True)
    state["active"][:] = torch.tensor([True, False])
    _empty_pool(store, state["offload"])
    dec(tstore.strip_expert_params(tp, tc), state)
    live_rows = 1 * tc.moe.top_k * store.n_layers      # one live slot
    assert store.stats()["fallback_rows"] == live_rows


def _admit(tc, tp, Sb=16, L=11, seed=5):
    toks = np.zeros((1, Sb), np.int32)
    toks[0, :L] = np.random.default_rng(seed).integers(1, tc.vocab, L)
    toks = torch.as_tensor(toks)
    caches = tmodel.init_caches(tc, 1, MAX_LEN, device="cpu")
    tok, caches = tsteps.make_admit_prefill(tc)(tp, toks, caches, L)
    return toks, L, tok, caches


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("prefill_rows,empty", [(None, False), (2, True)])
def test_admit_prefill_bit_identical_to_full_resident(model, mode,
                                                      prefill_rows, empty):
    """Right-padded admission through the slot pool (pad tokens route and
    stream like real ones); with an emptied pool and 2-expert waves every
    activated expert streams in several waves per layer."""
    _, tc, _, tp = model
    toks, L, ref_tok, ref_caches = _admit(tc, tp)
    rs = tspec.ServeSpec(cfg=tc, policy="dali", batch_size=1, max_len=MAX_LEN,
                         device="cpu", offload=tspec.OffloadSpec(
                             mode=mode, prefill_rows=prefill_rows)
                         ).resolve(tp)
    assert "gate" not in rs.params["scan"][0]["mlp"]    # stripped
    state = rs.init_state(batch=1)
    off = state["offload"]
    if empty:
        _empty_pool(rs.store, off)
    caches = tmodel.init_caches(tc, 1, MAX_LEN, device="cpu")
    tok, caches = rs.admit_prefill()(rs.params, toks, caches, L, off)
    assert torch.equal(ref_tok, tok)
    _equal_trees(ref_caches, caches)
    st = rs.store.stats()
    assert st["prefill_fetch_rows"] > 0 and st["prefill_host_rows"] == 0
    assert st["prefill_miss_reads"] == rs.store.n_layers
    assert st["miss_reads"] == 0
    if empty:
        assert st["prefill_waves"] > rs.store.n_layers


# --------------------------------------------------------------------------
# the host tier against the JAX store's callbacks
# --------------------------------------------------------------------------

def test_host_tier_matches_jax_callbacks(model):
    jc, tc, jp, tp = model
    js = jstore.ExpertStore(jp, jc, n_slots=3, fallback="host",
                            mode="blocking")
    ts = tstore.ExpertStore(tp, tc, n_slots=3, fallback="host",
                            mode="blocking")
    rng = np.random.default_rng(3)
    for T, K in ((2, 2), (4, 2), (24, 2)):
        xf = rng.standard_normal((T, tc.d_model)).astype(np.float32)
        flat_e = rng.integers(0, 8, T * K).astype(np.int32)
        hit = rng.random(T * K) < 0.4
        for lid in range(ts.n_layers):
            for jfn, tfn in ((js.host_ffn_cb, ts.host_ffn),
                             (js.prefill_host_cb, ts.prefill_host)):
                ref = np.asarray(jfn(np.int32(lid), xf, flat_e, hit))
                got = tfn(lid, torch.from_numpy(xf), flat_e, hit).numpy()
                assert np.abs(got - ref).max() <= 3e-5 * np.abs(ref).max()
                assert not got[hit].any()
    for k in ("fallback_rows", "prefill_host_rows"):
        assert ts.stats()[k] == js.stats()[k] > 0


def test_host_tier_decode_close_and_exercised(model):
    _, tc, _, tp = model
    pairs, store = _run_decode(tc, tp, "blocking", n_steps=4,
                               fallback="host", force_miss_at=1)
    st = store.stats()
    assert st["fallback_rows"] > 0 and st["fallback_fetches"] == 0
    for ref, slot in pairs:
        assert float((ref - slot).abs().max()) \
            <= 3e-5 * float(ref.abs().max())


# --------------------------------------------------------------------------
# whole servers against the JAX package's, mirror and counters per step
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


PROMPTS = [(5, 6), (12, 4), (20, 8), (9, 5), (17, 3)]


def _requests(mod, vocab):
    rng = np.random.default_rng(11)
    return [mod.Request(rid=i, prompt=rng.integers(0, vocab, n)
                        .astype(np.int32), max_new_tokens=m)
            for i, (n, m) in enumerate(PROMPTS)]


def _record_drains(store):
    """After every server step (each ``drain``), the slot-table mirror and
    the cumulative row counters."""
    seen, real = [], store.drain

    def drain():
        out = real()
        st = store.stats()
        seen.append((store._cur.copy(), {k: st[k] for k in COUNTERS}))
        return out

    store.drain = drain
    return seen


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("batch", [1, 4])
def test_server_matches_jax_server_step_by_step(model, mode, batch):
    jc, tc, jp, tp = model
    res = (np.random.default_rng(1).standard_normal((2, jc.d_model)) * 0.1
           ).astype(np.float32)
    kw = dict(batch_size=batch, max_len=MAX_LEN, eos_id=NO_EOS)
    jd = jsteps.default_dali_config(jc, cache_ratio=0.25)
    td = tsteps.default_dali_config(tc, cache_ratio=0.25)
    jres = jspec.ServeSpec(cfg=jc, policy="dali", dali_cfg=jd,
                           offload=jspec.OffloadSpec(mode=mode), **kw
                           ).resolve(jp)
    carried = bridge.to_torch(jax.tree.map(np.asarray, jres.policy.init()),
                              "cpu")
    tpol = _Carried(tsteps.resolve_policy("dali", tc, td), carried)
    tres = tspec.ServeSpec(cfg=tc, policy=tpol, device="cpu",
                           offload=tspec.OffloadSpec(mode=mode), **kw
                           ).resolve(tp)
    assert tres.store.n_slots == jres.store.n_slots == 5
    js = jres.server(res_vecs=jnp.asarray(res))
    ts = tres.server(res_vecs=res)
    seen_j, seen_t = _record_drains(js.store), _record_drains(ts.store)
    for r in _requests(jsched, jc.vocab):
        js.submit(r)
    for r in _requests(tsched, tc.vocab):
        ts.submit(r)
    dj = {r.rid: r.output for r in js.run()}
    dt = {r.rid: r.output for r in ts.run()}
    assert dt == dj
    assert len(seen_t) == len(seen_j) == ts.metrics.steps + 1
    for i, ((cur_t, c_t), (cur_j, c_j)) in enumerate(zip(seen_t, seen_j)):
        np.testing.assert_array_equal(cur_t, cur_j, err_msg=f"step {i}")
        assert c_t == c_j, f"step {i}"
    st = ts.store.stats()
    assert st["h2d_rows"] > 0 and st["fallback_rows"] > 0
    assert st["prefill_fetch_rows"] > 0
    for k in COUNTERS:
        assert ts.metrics.offload_tel[k] == js.metrics.offload_tel[k]


# --------------------------------------------------------------------------
# construction: contracts, the fault seam, host-resident experts
# --------------------------------------------------------------------------

def test_offload_spec_contract_errors(model):
    _, tc, _, tp = model
    with pytest.raises(ValueError) as e:
        tspec.ServeSpec(cfg=tc, policy="none", device="cpu",
                        offload=tspec.OffloadSpec(mode="overlap")).resolve(tp)
    assert str(e.value) == jspec.OFFLOAD_POLICY_ERROR
    with pytest.raises(ValueError, match="modeled"):
        tspec.ServeSpec(cfg=tc, policy="dali", device="cpu",
                        offload=tspec.OffloadSpec(mode="bogus")).resolve(tp)
    jc, _, jp, _ = model
    jpol = jspec.ServeSpec(cfg=jc, policy="dali").resolve(jp).policy
    with pytest.raises(ValueError) as ref:
        jspec.build_store("modeled", jp, jc, jpol, faults="read_error")
    with pytest.raises(ValueError) as got:
        tspec.ServeSpec(cfg=tc, policy="dali", device="cpu",
                        offload=tspec.OffloadSpec(faults="read_error")
                        ).resolve(tp)
    assert str(got.value) == str(ref.value)
    # a topology prices the links between devices; on one device it
    # changes nothing the store serves
    tokens = []
    for topology in (None, "flat"):
        rs = tspec.ServeSpec(cfg=tc, policy="dali", device="cpu",
                             batch_size=2, max_len=MAX_LEN, eos_id=NO_EOS,
                             offload=tspec.OffloadSpec(mode="overlap",
                                                       topology=topology)
                             ).resolve(tp)
        srv = rs.server()
        for r in _requests(tsched, tc.vocab)[:2]:
            srv.submit(r)
        tokens.append({r.rid: list(r.output) for r in srv.run()})
    assert tokens[0] == tokens[1]
    # the fault seam and the little tier resolve and serve in every mode
    for mode in MODES:
        for off in (tspec.OffloadSpec(mode=mode, faults="read_error@0-3"),
                    tspec.OffloadSpec(mode=mode, fallback="little")):
            rs = tspec.ServeSpec(cfg=tc, policy="dali", device="cpu",
                                 batch_size=2, max_len=MAX_LEN,
                                 eos_id=NO_EOS, offload=off).resolve(tp)
            assert (rs.store.injector is not None) == (off.faults is not None)
            assert (rs.store._little is not None) == (off.fallback
                                                      == "little")
            srv = rs.server()
            for r in _requests(tsched, tc.vocab)[:2]:
                srv.submit(r)
            assert len(srv.run()) == 2
    with pytest.raises(ValueError, match="fetch"):
        tstore.ExpertStore(tp, tc, n_slots=4, fallback="bogus")


def test_memory_layout_and_pool_rows_hold_the_table(model):
    _, tc, _, tp = model
    _, store = _run_decode(tc, tp, "overlap", n_steps=4)
    lay = store.memory_layout()
    eb = store.expert_bytes
    assert eb == 3 * tc.d_model * tc.moe.d_expert * 4
    assert lay["pool_bytes"] == store.n_layers * store.n_slots * eb
    assert lay["full_resident_bytes"] == store.n_layers * 8 * eb
    assert lay["overlap_stage_bytes"] == store.n_layers * store.max_moves * eb


def test_experts_on_host_are_the_same_weights_and_adopted(model, tmp_path):
    jc, tc, jp, tp = model
    dev = tmodel.init_model(tc, seed=3, device="cpu")
    host = tmodel.init_model(tc, seed=3, device="cpu", experts="host")
    _equal_trees(dev, host)
    path = tmp_path / "w.npz"
    bridge.save_npz(path, jax.tree.map(np.asarray, jp))
    for p in (bridge.to_torch(jax.tree.map(np.asarray, jp), "cpu",
                              experts="host", cfg=tc),
              bridge.load_npz(path, device="cpu", experts="host", cfg=tc)):
        _equal_trees(tp, p)
        pol = tsteps.resolve_policy("dali", tc)
        store = _store(tc, p, pol, "pipelined")
        # one MoE position, no MoE prefix: the (L, E, ...) stack is adopted
        assert store.host["gate"].data_ptr() \
            == p["scan"][0]["mlp"]["gate"].data_ptr()
    # a stack that cannot be adopted (here: not contiguous) is copied
    odd = tree_map(lambda t: t.transpose(-1, -2).contiguous()
                   .transpose(-1, -2) if t.dim() == 4 else t, tp)
    store = _store(tc, odd, tsteps.resolve_policy("dali", tc), "blocking")
    for k in ("gate", "up", "down"):
        assert store.host[k].is_contiguous()
        assert torch.equal(store.host[k], tp["scan"][0]["mlp"][k])
    with pytest.raises(ValueError, match="experts"):
        tmodel.init_model(tc, device="cpu", experts="disk")


def test_launcher_check_exact_passes_in_every_mode():
    from repro_torch.launch import serve
    for mode in MODES:
        server, done = serve.main([
            "--device", "cpu", "--dtype", "float32", "--layers", "2",
            "--train-steps", "2",
            "--offload", mode, "--check-exact", "--cache-ratio", "0.25",
            "--requests", "3", "--batch", "2", "--prompt-len", "10",
            "--max-new", "4"])
        assert len(done) == 3 and server.store.mode == mode
    with pytest.raises(SystemExit, match="physical"):
        serve.main(["--device", "cpu", "--check-exact"])
