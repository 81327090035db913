"""The port's servers against the JAX package's, on the smoke Mixtral
(two layers, float32, CPU): the same parameters, initial DALI policy state
and residual vectors (carried over with ``repro_torch.bridge``) and the
same requests (``not_before = 0``).

Every request's greedy token list must be equal, and so must the DALI
telemetry counters, for the continuous server and for the wave server.
Batch 1 decodes through the sparse (grouped) expert path, batch 4 through
the dense capacity sweep.  The modeled times are float32 sums compared
within 1e-6 relative.  Port against port: the wave server offloaded
(pipelined) gives its full-resident tokens bit for bit, every registered
policy gives ``dali``'s tokens through both servers, and sampled decoding
is deterministic under its seed and draws from ``softmax(logits / T)``
(``jax.random.categorical`` cannot be matched draw for draw).
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
import repro.core.residual as jresidual
import repro.core.tracing as jtracing
import repro.models.model as jmodel
import repro.serving.scheduler as jsched
import repro.serving.spec as jspec
import repro.serving.steps as jsteps
import repro_torch.configs as tconfigs
import repro_torch.core.residual as tresidual
import repro_torch.core.tracing as ttracing
import repro_torch.models.model as tmodel
import repro_torch.models.moe as tmoe
import repro_torch.serving.scheduler as tsched
import repro_torch.serving.spec as tspec
import repro_torch.serving.steps as tsteps
from repro_torch import bridge, kernels
from repro_torch.tree import tree_map

NO_EOS = 10_000_000


@pytest.fixture(scope="module")
def model():
    jc = jconfigs.make_smoke(jconfigs.get_config("mixtral_8x7b")) \
        .replace(n_layers=2)
    tc = tconfigs.make_smoke(tconfigs.get_config("mixtral_8x7b")) \
        .replace(n_layers=2)
    jp = jmodel.init_model(jax.random.PRNGKey(0), jc)
    tp = bridge.to_torch(jax.tree.map(np.asarray, jp), "cpu")
    return jc, tc, jp, tp


def test_decode_trace_and_residual_calibration_match(model):
    jc, tc, jp, tp = model
    prompt = np.random.default_rng(0).integers(0, jc.vocab, (3, 10)) \
        .astype(np.int32)
    jtr = jtracing.capture_decode_trace(jp, jc, jax.numpy.asarray(prompt),
                                        n_decode=4)
    ttr = ttracing.capture_decode_trace(tp, tc, prompt, n_decode=4,
                                        device="cpu")
    assert ttr.n_steps == jtr.n_steps == 4
    assert ttr.n_moe_layers == jtr.n_moe_layers == 2
    for s in range(4):
        for l in range(2):
            np.testing.assert_array_equal(ttr.workload[s][l],
                                          jtr.workload[s][l])
            np.testing.assert_allclose(ttr.gate_in[s][l], jtr.gate_in[s][l],
                                       rtol=3e-5, atol=3e-5)
    rt = np.stack(tresidual.calibrate_residuals([ttr]))
    rj = np.stack(jresidual.calibrate_residuals([jtr]))
    assert float(np.abs(rt - rj).max()) < 3e-5 * float(np.abs(rj).max())


def test_default_dali_config_matches(model):
    jc, tc, _, _ = model
    for ratio in (0.25, 0.5):
        assert dataclasses.asdict(jsteps.default_dali_config(jc, ratio)) \
            == dataclasses.asdict(tsteps.default_dali_config(tc, ratio))


class _Carried:
    """The port's policy started from a carried-over reference state."""
    schedules = True

    def __init__(self, policy, state):
        self.policy, self.state = policy, state

    def init(self, seed=0, device="cpu"):
        return tree_map(torch.clone, self.state)

    def step(self, state, workloads, obs):
        return self.policy.step(state, workloads, obs)


PROMPTS = [(5, 6), (12, 4), (20, 8), (9, 5), (30, 3), (14, 7)]


def _requests(mod, vocab):
    rng = np.random.default_rng(11)
    return [mod.Request(rid=i, prompt=rng.integers(0, vocab, n)
                        .astype(np.int32), max_new_tokens=m)
            for i, (n, m) in enumerate(PROMPTS)]


def _servers(model, batch, server="continuous"):
    """The reference's and the port's server over the same weights, the
    same initial policy state and residual vectors, each with the same
    requests submitted."""
    jc, tc, jp, tp = model
    res = (np.random.default_rng(1).standard_normal((2, jc.d_model)) * 0.1
           ).astype(np.float32)
    jd = jsteps.default_dali_config(jc, cache_ratio=0.5)
    td = tsteps.default_dali_config(tc, cache_ratio=0.5)
    kw = dict(batch_size=batch, max_len=64, eos_id=NO_EOS, server=server)
    jres = jspec.ServeSpec(cfg=jc, policy="dali", dali_cfg=jd, **kw) \
        .resolve(jp)
    tpol = tsteps.resolve_policy("dali", tc, td)
    carried = bridge.to_torch(jax.tree.map(np.asarray, jres.policy.init()),
                              "cpu")
    tres = tspec.ServeSpec(cfg=tc, policy=_Carried(tpol, carried),
                           device="cpu", **kw).resolve(tp)
    js = jres.server(res_vecs=jax.numpy.asarray(res))
    ts = tres.server(res_vecs=res)
    for r in _requests(jsched, jc.vocab):
        js.submit(r)
    for r in _requests(tsched, tc.vocab):
        ts.submit(r)
    return js, ts


def _same_telemetry(mt, mj):
    assert (mt.steps, mt.decode_tokens, mt.prefill_tokens, mt.waves,
            mt.requests) == (mj.steps, mj.decode_tokens, mj.prefill_tokens,
                             mj.waves, mj.requests)
    for k in ("steps", "hits", "misses", "swaps", "active_tokens"):
        assert getattr(mt.dali, k) == getattr(mj.dali, k), k
    assert mt.dali.lookups > 0
    for k in ("moe_time_est", "link_time_est"):
        assert getattr(mt.dali, k) == pytest.approx(getattr(mj.dali, k),
                                                    rel=1e-6)


@pytest.mark.parametrize("batch", [1, 4])
def test_server_tokens_and_telemetry_match_reference(model, batch):
    js, ts = _servers(model, batch)
    kernels.reset_launch_counts()
    dj = {r.rid: r.output for r in js.run()}
    dt = {r.rid: r.output for r in ts.run()}
    assert kernels.launch_counts() == {k: 0 for k in kernels.LAUNCHES}
    assert dt == dj
    assert [len(dt[i]) for i in range(len(PROMPTS))] == [m for _, m in
                                                         PROMPTS]
    _same_telemetry(ts.metrics, js.metrics)


@pytest.mark.parametrize("batch", [1, 4])
def test_wave_server_tokens_and_telemetry_match_reference(model, batch):
    """Left-padded waves at one shared position: batch 1 runs six waves of
    one request, batch 4 a full wave and a wave with two idle rows."""
    js, ts = _servers(model, batch, server="wave")
    assert isinstance(ts, tsched.BatchServer)
    kernels.reset_launch_counts()
    dj = {r.rid: r.output for r in js.run()}
    dt = {r.rid: r.output for r in ts.run()}
    assert kernels.launch_counts() == {k: 0 for k in kernels.LAUNCHES}
    assert dt == dj
    assert [len(dt[i]) for i in range(len(PROMPTS))] == [m for _, m in
                                                         PROMPTS]
    assert ts.metrics.waves == -(-len(PROMPTS) // batch)
    _same_telemetry(ts.metrics, js.metrics)


def _prompts(vocab, lengths, seed=3):
    rng = np.random.default_rng(seed)
    return [rng.integers(2, vocab, n).astype(np.int32) for n in lengths]


def test_wave_bucketing_never_truncates_budget(model):
    """The wave bucket is capped so S + budget fits the KV horizon whenever
    the raw prompt length would: max_len=96, prompt 48, budget 32 must
    yield 32 tokens (a 64-token bucket would cap decode at 31)."""
    _, tc, _, tp = model
    server = tsched.BatchServer(tp, tc, batch_size=1, max_len=96,
                                eos_id=NO_EOS, device="cpu")
    server.submit(tsched.Request(rid=0, prompt=_prompts(tc.vocab, [48])[0],
                                 max_new_tokens=32))
    done = server.run()
    assert len(done[0].output) == 32
    assert server.metrics.prefill_tokens == 63       # the capped bucket


def test_wave_decode_token_accounting_no_double_count(model):
    """decode_tokens equals the decode emissions exactly (the first token
    comes from the prefill, so each request emits len(output) - 1)."""
    _, tc, _, tp = model
    server = tsched.BatchServer(tp, tc, batch_size=4, max_len=64,
                                eos_id=NO_EOS, device="cpu")
    for i, (p, b) in enumerate(zip(_prompts(tc.vocab, [8, 8, 12, 12]),
                                   [1, 3, 5, 2])):
        server.submit(tsched.Request(rid=i, prompt=p, max_new_tokens=b))
    done = server.run()
    assert all(len(r.output) == r.max_new_tokens for r in done)
    assert server.metrics.decode_tokens == \
        sum(len(r.output) - 1 for r in done)
    assert server.metrics.steps == 4 and server.metrics.waves == 1


def test_make_server_presets(model):
    _, tc, _, tp = model
    assert sorted(tsched.SERVER_PRESETS) == sorted(jsched.SERVER_PRESETS)
    kw = dict(batch_size=1, max_len=32, device="cpu")
    assert isinstance(tsched.make_server("continuous", tp, tc, **kw),
                      tsched.ContinuousBatchServer)
    assert isinstance(tsched.make_server("wave", tp, tc, **kw),
                      tsched.BatchServer)
    with pytest.raises(ValueError, match="continuous"):
        tsched.make_server("nope", tp, tc, **kw)
    with pytest.raises(ValueError, match="wave"):
        tspec.ServeSpec(cfg=tc, server="nope", device="cpu").resolve(tp) \
            .server()


def _serve(tp, tc, server, policy, mode, batch, **spec_kw):
    spec = tspec.ServeSpec(cfg=tc, server=server, policy=policy,
                           batch_size=batch, max_len=64, eos_id=NO_EOS,
                           offload=tspec.OffloadSpec(mode=mode),
                           device="cpu", **spec_kw)
    srv = spec.resolve(tp).server()
    for r in _requests(tsched, tc.vocab):
        srv.submit(r)
    return srv, {r.rid: r.output for r in srv.run()}


@pytest.mark.parametrize("batch", [1, 4])
def test_wave_pipelined_bit_identical_to_full_resident(model, batch):
    """The wave server through the slot pool (stripped params, prefill
    sweeps streamed, decode misses fetched) gives the full-resident
    wave's tokens; its pool is re-seeded every wave."""
    _, tc, _, tp = model
    _, ref = _serve(tp, tc, "wave", "dali", "modeled", batch)
    srv, got = _serve(tp, tc, "wave", "dali", "pipelined", batch)
    assert got == ref
    st = srv.store.stats()
    assert st["prefill_miss_reads"] > 0 and st["miss_reads"] > 0
    assert srv.metrics.offload_tel["miss_reads"] == st["miss_reads"]
    assert srv.metrics.waves == -(-len(PROMPTS) // batch)


def test_wave_batch8_capacity_drops_match_reference():
    """At batch 8 with Mixtral's capacity factor (1.25) and 8 experts, the
    full-resident decode (T = 8: the capacity sweep with C = 4) drops rows
    past its capacity and the offloaded decode (the grouped slot path)
    never does, so their tokens part, in the JAX package as in the port,
    which match each other mode for mode.  With the capacity pinned at the
    wave prefill's own, the full-resident decode keeps every row and the
    two modes give the same tokens (the comparison chip_smoke's wave phase
    makes)."""
    def cfg(mod):
        c = mod.make_smoke(mod.get_config("mixtral_8x7b")).replace(
            n_layers=2)
        return c.replace(moe=dataclasses.replace(
            c.moe, n_routed=8, capacity_factor=1.25))
    jc, tc = cfg(jconfigs), cfg(tconfigs)
    jp = jmodel.init_model(jax.random.PRNGKey(0), jc)
    tp = bridge.to_torch(jax.tree.map(np.asarray, jp), "cpu")
    rng = np.random.default_rng(1)
    prompts = [rng.integers(2, jc.vocab, int(n)).astype(np.int32)
               for n in rng.integers(8, 30, 8)]
    S = tsched._bucket_len(max(map(len, prompts)), 16, 64 - 12 - 1)
    pinned = tmoe.expert_capacity(tc.moe, 8 * S)

    def run(spec, sched, c, p, mode, **kw):
        srv = spec.ServeSpec(cfg=c, server="wave", policy="dali",
                             batch_size=8, max_len=64, eos_id=NO_EOS,
                             offload=spec.OffloadSpec(mode=mode),
                             **kw).resolve(p).server()
        for i, pr in enumerate(prompts):
            srv.submit(sched.Request(rid=i, prompt=pr, max_new_tokens=12))
        return {r.rid: r.output for r in srv.run()}

    jm, jo = (run(jspec, jsched, jc, jp, m) for m in ("modeled", "pipelined"))
    tm, to = (run(tspec, tsched, tc, tp, m, device="cpu")
              for m in ("modeled", "pipelined"))
    assert tm == jm and to == jo
    assert tm != to
    pm, po = (run(tspec, tsched, tc, tp, m, device="cpu",
                  moe_capacity=pinned) for m in ("modeled", "pipelined"))
    assert pm == po


@pytest.mark.parametrize("server", ["continuous", "wave"])
def test_every_policy_gives_dalis_tokens(model, server):
    """Placement never changes a token: every registered policy, offloaded
    (pipelined; "none" cannot drive a store and serves modeled), gives the
    tokens of ``dali`` full-resident."""
    _, tc, _, tp = model
    _, ref = _serve(tp, tc, server, "dali", "modeled", 2)
    from repro_torch.core.policy import policy_names
    fetched = {}
    for name in policy_names():
        mode = "modeled" if name == "none" else "pipelined"
        srv, got = _serve(tp, tc, server, name, mode, 2)
        assert got == ref, name
        if srv.store is not None:
            fetched[name] = srv.store.stats()["fallback_fetches"]
    assert len(fetched) == 7 and all(v > 0 for v in fetched.values())


def test_sample_tokens_follow_softmax_over_temperature():
    """With fixed logits, the frequencies of 40000 draws match
    softmax(logits / T): Pearson's chi-square over the 8 categories stays
    below 24.32, its 0.999 quantile at 7 degrees of freedom."""
    logits = torch.tensor([2.0, 1.0, 0.5, 0.0, -0.5, -1.0, 1.5, -1e30])
    T, N = 0.7, 40000
    gen = torch.Generator().manual_seed(0)
    draws = tsteps.sample_tokens(logits.expand(N, -1), T, gen)
    assert draws.shape == (N, 1) and draws.dtype == torch.int32
    counts = torch.bincount(draws[:, 0].long(), minlength=8).double()
    p = torch.softmax(logits.double() / T, -1)
    assert counts[7] == 0                     # a padded column: never
    chi2 = float((((counts - N * p) ** 2 / (N * p))[:7]).sum())
    assert chi2 < 24.32, chi2
    again = tsteps.sample_tokens(logits.expand(N, -1), T,
                                 torch.Generator().manual_seed(0))
    assert torch.equal(draws, again)


@pytest.mark.parametrize("server", ["continuous", "wave"])
def test_sampled_decode_is_deterministic_under_its_seed(model, server):
    _, tc, _, tp = model
    kw = dict(sample=True, temperature=1.3)
    _, a = _serve(tp, tc, server, "dali", "modeled", 2, **kw)
    _, b = _serve(tp, tc, server, "dali", "modeled", 2, **kw)
    _, greedy = _serve(tp, tc, server, "dali", "modeled", 2)
    _, greedy_off = _serve(tp, tc, server, "dali", "modeled", 2,
                           sample=False, temperature=1.3)
    assert a == b
    assert greedy_off == greedy
    assert a != greedy
    # the first token comes from the prefill's argmax in both
    assert all(a[i][0] == greedy[i][0] for i in a)


def test_sparse_and_dense_paths_are_both_served(model, monkeypatch):
    """Batch 1 decodes on the grouped sparse path, batch 4 on the dense
    sweep (the switch is T*K*4 < E*4, so T = 1 for the smoke config)."""
    _, tc, _, tp = model
    import repro_torch.models.moe as tmoe
    seen = []
    real = tmoe.use_sparse_path
    monkeypatch.setattr(tmoe, "use_sparse_path", lambda m, T, c: seen.append(
        (T, real(m, T, c))) or real(m, T, c))
    for batch in (1, 4):
        srv = tsched.ContinuousBatchServer(tp, tc, batch_size=batch,
                                           max_len=64, eos_id=NO_EOS,
                                           policy="dali", device="cpu")
        for r in _requests(tsched, tc.vocab)[:3]:
            srv.submit(r)
        srv.run()
    assert (1, True) in seen and (4, False) in seen and (16, False) in seen


def test_entry_points_default_to_cuda_and_raise_without_a_card(model):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the defaults run on it")
    _, tc, _, tp = model
    from repro_torch.launch import serve
    calls = [
        lambda: tspec.ServeSpec(cfg=tc).resolve(tp),
        lambda: tsched.ContinuousBatchServer(tp, tc),
        lambda: tsched.BatchServer(tp, tc),
        lambda: tsched.make_server("wave", tp, tc),
        lambda: tsteps.init_serve_state(tc, 1, 8, per_slot=True),
        lambda: tmodel.init_model(tc),
        lambda: tmodel.init_caches(tc, 1, 8),
        lambda: tsteps.init_serve_state(tc, 1, 8),
        lambda: ttracing.capture_decode_trace(tp, tc, np.zeros((1, 4),
                                                               np.int32), 1),
        lambda: bridge.to_torch({"a": np.zeros(2)}),
        lambda: serve.main(["--requests", "1"]),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="cuda"):
            call()


def test_unported_options_raise_not_implemented(model):
    _, tc, _, tp = model
    # the link topology is ported with expert parallelism: it resolves,
    # and a malformed spec raises the typed parse error
    rs = tspec.ServeSpec(cfg=tc, device="cpu", policy="dali",
                         offload=tspec.OffloadSpec(mode="pipelined",
                                                   topology="island:1")
                         ).resolve(tp)
    assert rs.store is not None
    with pytest.raises(ValueError, match="bad topology base"):
        tspec.ServeSpec(cfg=tc, device="cpu", policy="dali",
                        offload=tspec.OffloadSpec(mode="pipelined",
                                                  topology="mesh")
                        ).resolve(tp)
    # the little tier is ported: it resolves with its int8 twins built
    rs = tspec.ServeSpec(cfg=tc, device="cpu", policy="dali",
                         offload=tspec.OffloadSpec(mode="pipelined",
                                                   fallback="little")
                         ).resolve(tp)
    assert rs.store.little_view()["gate_q"].dtype == torch.int8
    with pytest.raises(tsched.PromptTooLongError):
        tsched.ContinuousBatchServer(tp, tc, max_len=8, device="cpu").submit(
            tsched.Request(rid=0, prompt=np.zeros(8, np.int32)))


def test_weights_carried_through_npz_serve_the_same(model, tmp_path):
    jc, tc, jp, tp = model
    path = tmp_path / "w.npz"
    bridge.save_npz(path, jax.tree.map(np.asarray, jp))
    loaded = bridge.load_npz(path, device="cpu")
    flat_a = bridge.flatten(tree_map(lambda t: t.numpy(), tp))
    flat_b = bridge.flatten(tree_map(lambda t: t.numpy(), loaded))
    assert flat_a.keys() == flat_b.keys()
    for k in flat_a:
        np.testing.assert_array_equal(flat_a[k], flat_b[k])
    from repro_torch.launch import serve
    server, done = serve.main(["--device", "cpu", "--dtype", "float32",
                               "--layers", "2", "--weights", str(path),
                               "--train-steps", "0",
                               "--requests", "2", "--batch", "2",
                               "--prompt-len", "8", "--max-new", "3"])
    assert len(done) == 2 and all(len(r.output) >= 1 for r in done)
