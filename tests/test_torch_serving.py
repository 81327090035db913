"""The port's continuous-batching server against the JAX package's, on
the smoke Mixtral (two layers, float32, CPU): the same parameters, initial
DALI policy state and residual vectors (carried over with
``repro_torch.bridge``) and the same requests (``not_before = 0``).

Every request's greedy token list must be equal, and so must the DALI
telemetry counters.  Batch 1 decodes through the sparse (grouped) expert
path, batch 4 through the dense capacity sweep.  The modeled times are
float32 sums compared within 1e-6 relative.
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


@pytest.mark.parametrize("batch", [1, 4])
def test_server_tokens_and_telemetry_match_reference(model, batch):
    jc, tc, jp, tp = model
    res = (np.random.default_rng(1).standard_normal((2, jc.d_model)) * 0.1
           ).astype(np.float32)
    jd = jsteps.default_dali_config(jc, cache_ratio=0.5)
    td = tsteps.default_dali_config(tc, cache_ratio=0.5)
    kw = dict(batch_size=batch, max_len=64, eos_id=NO_EOS)
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
    kernels.reset_launch_counts()
    dj = {r.rid: r.output for r in js.run()}
    dt = {r.rid: r.output for r in ts.run()}
    assert kernels.launch_counts() == {k: 0 for k in kernels.LAUNCHES}
    assert dt == dj
    assert [len(dt[i]) for i in range(len(PROMPTS))] == [m for _, m in
                                                         PROMPTS]
    mj, mt = js.metrics, ts.metrics
    assert (mt.steps, mt.decode_tokens, mt.prefill_tokens) \
        == (mj.steps, mj.decode_tokens, mj.prefill_tokens)
    for k in ("steps", "hits", "misses", "swaps", "active_tokens"):
        assert getattr(mt.dali, k) == getattr(mj.dali, k), k
    assert mt.dali.lookups > 0
    for k in ("moe_time_est", "link_time_est"):
        assert getattr(mt.dali, k) == pytest.approx(getattr(mj.dali, k),
                                                    rel=1e-6)


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
    for kw in ({"server": "wave"},
               {"policy": "dali",
                "offload": tspec.OffloadSpec(mode="pipelined",
                                             fallback="little")}):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            tspec.ServeSpec(cfg=tc, device="cpu", **kw).resolve(tp)
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
                               "--requests", "2", "--batch", "2",
                               "--prompt-len", "8", "--max-new", "3"])
    assert len(done) == 2 and all(len(r.output) >= 1 for r in done)
