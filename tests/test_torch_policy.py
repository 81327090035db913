"""The port's ``dali`` policy against the JAX package's, step for step:
the jitted JAX ``step`` and the NumPy mirror ``step_np``, from the same
initial state (carried over with ``repro_torch.bridge``) on the same
seeded workloads and observations, with and without a live-token mask.

Decisions (on_gpu, on_cpu, prefetched, resident, hits, misses, swaps,
pf_pred) must match exactly; the float accumulators within 1e-6
relative.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.engine as jengine
import repro.core.policy as jpolicy
import repro_torch.core.engine as tengine
import repro_torch.core.policy as tpolicy
from repro_torch import bridge

L, E, T, D = 4, 8, 6, 16
EXACT = ("on_gpu", "on_cpu", "prefetched", "hits", "misses", "swaps",
         "pf_pred")
FLOAT = ("T_cpu", "T_gpu", "layer_time", "link_seconds", "step_moe_time")


def _dcfgs(**kw):
    base = dict(n_moe_layers=L, n_experts=E, cache_size=3, prefetch_size=2,
                w_size=2, u_size=1)
    base.update(kw)
    return jpolicy.DaliConfig(**base), tpolicy.DaliConfig(**base)


def _trace(kind, n_steps=10, seed=1):
    rng = np.random.default_rng(seed)
    routers = (rng.standard_normal((L, D, E)) * 0.3).astype(np.float32)
    res_vecs = (rng.standard_normal((L, D)) * 0.1).astype(np.float32)
    steps = []
    for s in range(n_steps):
        if kind == "zipf":
            draws = np.minimum(rng.zipf(1.5, (L, T * 2)) - 1, E - 1)
            wl = np.stack([np.bincount(d, minlength=E) for d in draws])
        else:
            wl = rng.integers(0, 5, (L, E))
        gi = rng.standard_normal((L, T, D)).astype(np.float32)
        mask = (np.arange(T) < 4) if kind == "masked" and s % 3 else None
        steps.append((wl.astype(np.int32), gi, mask))
    return routers, res_vecs, steps


def _same(t, r, what):
    np.testing.assert_array_equal(t.numpy(), np.asarray(r), err_msg=what)


@pytest.mark.parametrize("kind", ["zipf", "uniform", "masked"])
@pytest.mark.parametrize("dkw", [{}, {"u_size": 2, "w_size": 3,
                                      "prefetch_size": 1}])
def test_dali_step_matches_jax_step_and_step_np(kind, dkw):
    jd, td = _dcfgs(**dkw)
    jpol = jpolicy.make_policy("dali", jd, top_k=2,
                               router_type="topk_softmax")
    tpol = tpolicy.make_policy("dali", td, top_k=2,
                               router_type="topk_softmax")
    routers, res_vecs, steps = _trace(kind)
    sj = jpol.init(jax.random.PRNGKey(3))
    sn = jpol.init_np(jax.random.PRNGKey(3))
    st = bridge.to_torch(jax.tree.map(np.asarray, sj), "cpu")
    step_j = jax.jit(jpol.step)
    for i, (wl, gi, mask) in enumerate(steps):
        obs_j = jpolicy.Observation(
            jnp.asarray(gi), jnp.asarray(routers), jnp.asarray(res_vecs),
            None if mask is None else jnp.asarray(mask))
        obs_n = jpolicy.Observation(gi, routers, res_vecs, mask)
        obs_t = tpolicy.Observation(
            torch.from_numpy(gi), torch.from_numpy(routers),
            torch.from_numpy(res_vecs),
            None if mask is None else torch.from_numpy(mask))
        sj, dj = step_j(sj, jnp.asarray(wl), obs_j)
        sn, dn = jpol.step_np(sn, wl, obs_n)
        st, dt = tpol.step(st, torch.from_numpy(wl), obs_t)
        for ref, name in ((dj, "jax"), (dn, "numpy")):
            for k in EXACT:
                _same(dt.tel[k], ref.tel[k], f"{name} step {i} {k}")
            _same(dt.assign_mask, ref.assign_mask, f"{name} step {i} mask")
            _same(dt.resident, ref.resident, f"{name} step {i} resident")
            for k in FLOAT:
                np.testing.assert_allclose(dt.tel[k].numpy(),
                                           np.asarray(ref.tel[k]),
                                           rtol=1e-6, err_msg=k)
        for ref in (sj, sn):
            _same(st["resident"], ref["resident"], f"step {i} resident'")
            _same(st["tick"], ref["tick"], "tick")
            np.testing.assert_allclose(st["cache"]["scores"].numpy(),
                                       np.asarray(ref["cache"]["scores"]),
                                       rtol=1e-6)
            for k in ("steps", "hits", "misses", "swaps"):
                _same(st["acc"][k], ref["acc"][k], k)
            for k in ("moe_time", "link_time"):
                np.testing.assert_allclose(float(st["acc"][k]),
                                           float(ref["acc"][k]), rtol=1e-6)
    # the trace exercised every mechanism
    assert int(st["acc"]["swaps"]) > 0 and int(st["acc"]["misses"]) > 0


def test_masked_workloads_and_aggregator_match_reference():
    rng = np.random.default_rng(0)
    topk = rng.integers(0, E, (L, T, 2)).astype(np.int32)
    mask = np.arange(T) % 2 == 0
    _same(tengine.masked_workloads(torch.from_numpy(topk), E,
                                   torch.from_numpy(mask)),
          jengine.masked_workloads(jnp.asarray(topk), E, jnp.asarray(mask)),
          "masked workloads")
    jd, td = _dcfgs()
    jpol = jpolicy.make_policy("dali", jd, top_k=2)
    tpol = tpolicy.make_policy("dali", td, top_k=2)
    routers, res_vecs, steps = _trace("zipf", n_steps=5)
    sj = jpol.init()
    st = bridge.to_torch(jax.tree.map(np.asarray, sj), "cpu")
    agg_j = jengine.TelemetryAggregator(flush_interval=2)
    agg_t = tengine.TelemetryAggregator(flush_interval=2)
    step_j = jax.jit(jpol.step)
    for wl, gi, _ in steps:
        sj, _ = step_j(sj, jnp.asarray(wl), jpolicy.Observation(
            jnp.asarray(gi), jnp.asarray(routers), jnp.asarray(res_vecs)))
        st, _ = tpol.step(st, torch.from_numpy(wl), tpolicy.Observation(
            torch.from_numpy(gi), torch.from_numpy(routers),
            torch.from_numpy(res_vecs)))
        agg_j.observe(sj, n_active=3)
        agg_t.observe(st, n_active=3)
    agg_j.end_epoch()
    agg_t.end_epoch()
    for k in ("steps", "hits", "misses", "swaps", "active_tokens"):
        assert getattr(agg_t, k) == getattr(agg_j, k), k
    for k in ("moe_time_est", "link_time_est"):
        assert getattr(agg_t, k) == pytest.approx(getattr(agg_j, k),
                                                  rel=1e-6)
    assert agg_t.lookups > 0


def test_registry_ports_dali_and_none_only():
    assert tpolicy.policy_names() == ["dali", "none"]
    assert not tpolicy.make_policy("none").schedules
    for name in tpolicy.NOT_PORTED:
        assert name in jpolicy.POLICY_COMPOSITIONS
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            tpolicy.make_policy(name, _dcfgs()[1], top_k=2)
    with pytest.raises(ValueError):
        tpolicy.make_policy("bogus")


def test_init_draws_cache_size_residents_per_layer():
    _, td = _dcfgs()
    s = tpolicy.make_policy("dali", td, top_k=2).init(seed=4, device="cpu")
    assert s["resident"].shape == (L, E)
    assert (s["resident"].sum(-1) == td.cache_size).all()
    with pytest.raises(RuntimeError, match="cuda"):
        tpolicy.make_policy("dali", td, top_k=2).init(seed=4)
