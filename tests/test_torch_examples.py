"""The port's examples (``repro_torch/examples``) and the core functions
they and the benchmarks read, against the JAX package on the same inputs
(parameters and policy states carried over with ``repro_torch.bridge``),
on the smoke configs, float32, on the CPU.

Integers (workloads, layer indices, parameter counts, policy decisions)
and copied numpy functions exactly; float32 values within 3e-5 relative
to max |ref| (the repo's kernel tolerance, tests/test_kernels.py:17).  A
sampled decode trace draws from a ``torch.Generator`` (the reference's
``jax.random.categorical`` cannot be matched draw for draw), so it is held
to determinism under its seed and to the greedy trace's shapes.  Each
example's ``main`` runs with ``--device cpu`` and few steps.
"""
import dataclasses
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
import repro.core.cost_model as jcost
import repro.core.engine as jengine
import repro.core.residual as jresidual
import repro.core.tracing as jtracing
import repro.launch.sharding as jsharding
import repro.models.model as jmodel
import repro.serving.steps as jsteps
import repro_torch.configs as tconfigs
import repro_torch.core.cost_model as tcost
import repro_torch.core.engine as tengine
import repro_torch.core.residual as tresidual
import repro_torch.core.tracing as ttracing
import repro_torch.launch.sharding as tsharding
import repro_torch.models.model as tmodel
import repro_torch.serving.scheduler as tsched
import repro_torch.serving.spec as tspec
import repro_torch.serving.steps as tsteps
from repro_torch import bridge
from repro_torch.examples import (offload_ablation, quickstart, serve_moe,
                                  train_tiny)
from repro_torch.tree import tree_map

F32_TOL = 3e-5
ARCHS = ("mixtral_8x7b", "qwen3_30b_a3b", "deepseek_v2_lite_16b")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """Torch's many small ops on one thread: under a parallel test run the
    CPU is shared, and torch's own thread pool then slows them down far
    more than it speeds them up."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _model(arch="mixtral_8x7b"):
    jc = jconfigs.make_smoke(jconfigs.get_config(arch)).replace(n_layers=2)
    tc = tconfigs.make_smoke(tconfigs.get_config(arch)).replace(n_layers=2)
    jp = jax.jit(jmodel.init_model, static_argnums=1)(jax.random.PRNGKey(0),
                                                       jc)
    return jc, tc, jp, bridge.to_torch(jax.tree.map(np.asarray, jp), "cpu")


@pytest.fixture(scope="module")
def model():
    return _model()


def _close(t, j, tol=F32_TOL, what=""):
    t = t.detach().float().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t, np.float32)
    j = np.asarray(j, np.float32)
    assert t.shape == j.shape, (what, t.shape, j.shape)
    err = float(np.abs(t - j).max(initial=0)) / (float(np.abs(j).max(
        initial=0)) + 1e-6)
    assert err < tol, (what, err)


# --------------------------------------------------------------------------
# core functions
# --------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("smoke", [False, True])
def test_estimate_params_and_moe_layers_of_every_config(arch, smoke):
    jc, tc = jconfigs.get_config(arch), tconfigs.get_config(arch)
    if smoke:
        jc, tc = jconfigs.make_smoke(jc), tconfigs.make_smoke(tc)
    assert tsharding.estimate_params(tc) == jsharding.estimate_params(jc)
    assert ttracing.moe_layer_indices(tc) == jtracing.moe_layer_indices(jc)


def test_gate_weights_in_layer_order():
    """DeepSeek-V2-Lite's smoke model has a dense first layer (a prefix
    block without a router) before the scanned MoE blocks."""
    jc, tc, jp, tp = _model("deepseek_v2_lite_16b")
    gt, gj = ttracing.gate_weights(tp, tc), jtracing.gate_weights(jp, jc)
    assert len(gt) == len(gj) == len(ttracing.moe_layer_indices(tc))
    for a, b in zip(gt, gj):
        np.testing.assert_array_equal(a, np.asarray(b))


def test_collect_workloads_and_prefill_trace_match(model):
    jc, tc, jp, tp = model
    toks = np.random.default_rng(0).integers(0, jc.vocab, (2, 12)) \
        .astype(np.int32)
    _, _, ij = jax.jit(lambda p, t: jmodel.apply_model(p, t, jc,
                                                       trace=True))(
        jp, jnp.asarray(toks))
    _, _, it = tmodel.apply_model(tp, torch.from_numpy(toks), tc, trace=True)
    np.testing.assert_array_equal(tmodel.collect_workloads(it).numpy(),
                                  np.asarray(jmodel.collect_workloads(ij)))
    tr_t = ttracing.capture_prefill_trace(tp, tc, toks, device="cpu")
    tr_j = jtracing.capture_prefill_trace(jp, jc, jnp.asarray(toks))
    assert tr_t.n_steps == tr_j.n_steps == 1
    assert tr_t.n_tokens == tr_j.n_tokens == 24
    for l in range(tr_j.n_moe_layers):
        np.testing.assert_array_equal(tr_t.workload[0][l],
                                      tr_j.workload[0][l])
        _close(tr_t.gate_in[0][l], tr_j.gate_in[0][l])
        _close(tr_t.gates_sum[0][l], tr_j.gates_sum[0][l])


def test_decode_traces_greedy_exact_and_sampled_deterministic(model):
    jc, tc, jp, tp = model
    prompt = np.random.default_rng(1).integers(0, jc.vocab, (2, 8)) \
        .astype(np.int32)
    greedy = ttracing.capture_decode_trace(tp, tc, prompt, n_decode=4,
                                           device="cpu")
    ref = jtracing.capture_decode_trace(jp, jc, jnp.asarray(prompt),
                                        n_decode=4)
    for s in range(4):
        for l in range(ref.n_moe_layers):
            np.testing.assert_array_equal(greedy.workload[s][l],
                                          ref.workload[s][l])
            _close(greedy.gate_in[s][l], ref.gate_in[s][l])
    draw = lambda seed: ttracing.capture_decode_trace(
        tp, tc, prompt, n_decode=4, greedy=False, seed=seed, device="cpu")
    a, b = draw(7), draw(7)
    assert (a.n_steps, a.n_moe_layers, a.n_tokens) == (
        greedy.n_steps, greedy.n_moe_layers, greedy.n_tokens)
    for s in range(4):
        for l in range(a.n_moe_layers):
            np.testing.assert_array_equal(a.workload[s][l], b.workload[s][l])
            np.testing.assert_array_equal(a.gate_in[s][l], b.gate_in[s][l])
            assert a.gate_in[s][l].shape == greedy.gate_in[s][l].shape
    # the first decode step reads the prefill's argmax in both modes
    np.testing.assert_array_equal(a.workload[0][0], greedy.workload[0][0])


def test_cosine_similarity_is_the_reference_copy():
    rng = np.random.default_rng(3)
    a, b = rng.standard_normal((2, 7, 16)).astype(np.float32)
    assert tresidual.cosine_similarity(a, b) \
        == jresidual.cosine_similarity(a, b)
    assert tresidual.cosine_similarity(a, a) == pytest.approx(1.0)


def test_dali_schedule_matches_the_live_reference(model):
    """``dali_schedule`` on the legacy flat state, two steps, the state
    carried from the reference's ``init_dali_state``: decisions and
    counters exactly, modeled times within 3e-5."""
    jc, tc, jp, tp = model
    jd = jsteps.default_dali_config(jc, cache_ratio=0.5)
    td = tsteps.default_dali_config(tc, cache_ratio=0.5)
    js = jengine.init_dali_state(jd, jax.random.PRNGKey(3))
    ts = bridge.to_torch(jax.tree.map(np.asarray, js), "cpu")
    mine = tengine.init_dali_state(td, device="cpu")
    assert tree_map(lambda t: (tuple(t.shape), t.dtype), mine) \
        == tree_map(lambda t: (tuple(t.shape), t.dtype), ts)
    assert (mine["resident"].sum(-1) == td.cache_size).all()
    L, E, d = jd.n_moe_layers, jd.n_experts, jc.d_model
    routers = np.array(jmodel.stack_routers(jp, jc))
    jstep = jax.jit(lambda s, *a: jengine.dali_schedule(
        s, *a, jd, top_k=jc.moe.top_k))
    rng = np.random.default_rng(4)
    res = (rng.standard_normal((L, d)) * 0.1).astype(np.float32)
    for _ in range(2):
        w = rng.integers(0, 9, (L, E)).astype(np.int32)
        g = rng.standard_normal((L, 4, d)).astype(np.float32)
        js, tj = jstep(js, *map(jnp.asarray, (w, g, routers, res)))
        ts, tt = tengine.dali_schedule(ts, *map(torch.from_numpy, (w, g,
                                                                   routers,
                                                                   res)),
                                       td, top_k=tc.moe.top_k)
        for k in ("on_gpu", "on_cpu", "hits", "misses", "swaps",
                  "prefetched"):
            np.testing.assert_array_equal(tt[k].numpy(), np.asarray(tj[k]),
                                          err_msg=k)
        for k in ("T_cpu", "T_gpu", "step_moe_time", "link_seconds"):
            _close(tt[k], tj[k], what=k)
        for k in ("resident", "tick"):
            np.testing.assert_array_equal(ts[k].numpy(), np.asarray(js[k]))
        _close(ts["scores"], js["scores"])
        assert int(ts["acc"]["hits"]) == int(js["acc"]["hits"])


def test_profiles_carry_the_local_pc_only():
    assert set(tcost.PROFILES) == {jcost.LOCAL_PC.name}
    assert dataclasses.asdict(tcost.PROFILES[jcost.LOCAL_PC.name]) \
        == dataclasses.asdict(jcost.LOCAL_PC)


def test_legacy_surface_warns_once_and_not_under_the_spec(model):
    jc, tc, jp, tp = model
    pol = tsteps.resolve_policy("dali", tc,
                                tsteps.default_dali_config(tc, 0.25))
    with pytest.warns(DeprecationWarning, match="legacy"):
        tspec.warn_legacy("an entry point of this test")
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        tspec.warn_legacy("an entry point of this test")       # once only
        with tspec._internal():
            tspec.warn_legacy("another entry point of this test")
    store = tsched.make_store("pipelined", tp, tc, pol, device="cpu")
    ref = tspec.build_store("pipelined", tp, tc, pol, device="cpu")
    assert (store.n_slots, store.max_moves, store.mode) \
        == (ref.n_slots, ref.max_moves, ref.mode)
    assert tsched.make_store("modeled", tp, tc, pol, device="cpu") is None


# --------------------------------------------------------------------------
# the examples
# --------------------------------------------------------------------------

CPU = ["--device", "cpu", "--dtype", "float32"]


def test_quickstart_runs_on_the_cpu():
    out = quickstart.main(CPU)
    assert out["greedy_makespan"] >= out["optimal_makespan"] > 0
    assert out["hits"] + out["misses"] > 0


def test_train_tiny_reduces_the_loss():
    hist = train_tiny.main(["--tiny", "--steps", "8"] + CPU)
    assert len(hist) == 8 and hist[-1] < hist[0]


def test_offload_ablation_prints_every_row():
    out = offload_ablation.main(["--steps", "3"] + CPU)
    assert [r[0] for r in out["ablation"]][0] == "Naive (all CPU)"
    assert len(out["ablation"]) == 4
    assert [r[0] for r in out["policies"]] == [
        "none", "all_gpu", "static", "lru", "score", "dali"]
    modes = {r[0]: r for r in out["offload"]}
    assert list(modes) == ["modeled", "blocking", "overlap", "pipelined"]
    assert modes["modeled"][2] == 0
    for m in ("blocking", "overlap", "pipelined"):
        assert modes[m][2] > 0                  # streamed MB


def test_serve_moe_wraps_the_launcher():
    server, done = serve_moe.main(["--train-steps", "2", "--requests", "3",
                                   "--max-new", "4"] + CPU)
    assert len(done) == 3 and all(len(r.output) == 4 for r in done)


def test_examples_default_to_cuda_and_raise_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the defaults run on it")
    for main in (quickstart.main, lambda a: train_tiny.main(["--tiny"] + a),
                 offload_ablation.main, serve_moe.main):
        with pytest.raises(RuntimeError, match="cuda"):
            main([])
