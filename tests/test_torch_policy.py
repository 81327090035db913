"""The port's policies against the JAX package's, step for step: the
jitted JAX ``step`` and the NumPy mirror ``step_np``, from the same
initial state (carried over with ``repro_torch.bridge``) on the same
seeded workloads and observations, with and without a live-token mask.

Decisions (on_gpu, on_cpu, prefetched, resident, hits, misses, swaps,
pf_pred) and integer state must match exactly; the float accumulators
within 1e-6 relative for ``dali``, 3e-5 for the other compositions and
overrides.  ``random`` draws from ``jax.random`` in the reference, so it
is held to the invariants of the reference's own test: at most
``prefetch_size`` experts per layer, none for layer 0, and the same draws
under the same seed.
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
    """The port registers every policy the reference does (the test's
    name is historical)."""
    assert tpolicy.policy_names() == jpolicy.policy_names()
    assert not hasattr(tpolicy, "NOT_PORTED")
    assert not tpolicy.make_policy("none").schedules
    for reg in ("ASSIGNMENTS", "PREFETCHES", "CACHES",
                "POLICY_COMPOSITIONS"):
        assert sorted(getattr(tpolicy, reg)) == sorted(getattr(jpolicy, reg))
    assert tpolicy.POLICY_COMPOSITIONS == jpolicy.POLICY_COMPOSITIONS
    with pytest.raises(ValueError, match="all_gpu|dali|lru|none"):
        tpolicy.make_policy("bogus")
    with pytest.raises(ValueError, match="greedy|static"):
        tpolicy.make_policy("dali", _dcfgs()[1], assignment="bogus")
    with pytest.raises(ValueError, match="no sub-policies"):
        tpolicy.make_policy("none", cache="lru")
    with pytest.raises(ValueError, match="DaliConfig"):
        tpolicy.make_policy("lru")


def test_init_draws_cache_size_residents_per_layer():
    _, td = _dcfgs()
    s = tpolicy.make_policy("dali", td, top_k=2).init(seed=4, device="cpu")
    assert s["resident"].shape == (L, E)
    assert (s["resident"].sum(-1) == td.cache_size).all()
    with pytest.raises(RuntimeError, match="cuda"):
        tpolicy.make_policy("dali", td, top_k=2).init(seed=4)


# --------------------------------------------------------------------------
# every composition, the overrides and the sub-policies
# --------------------------------------------------------------------------

def _leaves(tree, prefix=""):
    """{path: numpy array} of a (nested) policy state."""
    return bridge.flatten(jax.tree.map(
        lambda x: x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x),
        tree, is_leaf=lambda x: isinstance(x, torch.Tensor)))


def _states_match(st, ref, what, skip=()):
    lt, lr = _leaves(st), _leaves(ref)
    assert set(lt) == set(lr), what
    for k in lt:
        if k.startswith(skip):
            continue
        if np.issubdtype(lr[k].dtype, np.floating):
            np.testing.assert_allclose(lt[k], lr[k], rtol=3e-5,
                                       err_msg=f"{what} {k}")
        else:
            np.testing.assert_array_equal(lt[k], lr[k], err_msg=f"{what} {k}")


def _decisions_match(dt, ref, what):
    """Decisions exact; floats (a statistical prediction is one) within
    3e-5 relative."""
    for k in EXACT:
        if dt.tel[k].is_floating_point():
            np.testing.assert_allclose(dt.tel[k].numpy(),
                                       np.asarray(ref.tel[k]), rtol=3e-5,
                                       err_msg=f"{what} {k}")
            continue
        _same(dt.tel[k], ref.tel[k], f"{what} {k}")
    _same(dt.assign_mask, ref.assign_mask, f"{what} mask")
    _same(dt.resident, ref.resident, f"{what} resident")
    for k in FLOAT:
        np.testing.assert_allclose(dt.tel[k].numpy(), np.asarray(ref.tel[k]),
                                   rtol=3e-5, err_msg=f"{what} {k}")


def _obs(gi, routers, res_vecs, mask):
    return (jpolicy.Observation(
                jnp.asarray(gi), jnp.asarray(routers), jnp.asarray(res_vecs),
                None if mask is None else jnp.asarray(mask)),
            jpolicy.Observation(gi, routers, res_vecs, mask),
            tpolicy.Observation(
                torch.from_numpy(gi), torch.from_numpy(routers),
                torch.from_numpy(res_vecs),
                None if mask is None else torch.from_numpy(mask)))


def _run_against_reference(jpol, tpol, kind, n_steps=10):
    """Step both from the reference's initial state; every decision and
    the whole state must match after every step.  Returns the port's final
    state."""
    routers, res_vecs, steps = _trace(kind, n_steps=n_steps)
    sj = jpol.init(jax.random.PRNGKey(3))
    sn = jpol.init_np(jax.random.PRNGKey(3))
    st = bridge.to_torch(jax.tree.map(np.asarray, sj), "cpu")
    step_j = jax.jit(jpol.step)
    for i, (wl, gi, mask) in enumerate(steps):
        obs_j, obs_n, obs_t = _obs(gi, routers, res_vecs, mask)
        sj, dj = step_j(sj, jnp.asarray(wl), obs_j)
        sn, dn = jpol.step_np(sn, wl, obs_n)
        st, dt = tpol.step(st, torch.from_numpy(wl), obs_t)
        for ref, name in ((dj, "jax"), (dn, "numpy")):
            _decisions_match(dt, ref, f"{jpol.name} {kind} {name} step {i}")
        _states_match(st, sj, f"{jpol.name} {kind} jax state {i}")
        _states_match(st, sn, f"{jpol.name} {kind} numpy state {i}")
    return st


@pytest.mark.parametrize("kind", ["zipf", "uniform", "masked"])
@pytest.mark.parametrize("name", ["static", "all_gpu", "lru", "score",
                                  "statistical"])
def test_composition_matches_jax_step_and_step_np(name, kind):
    jd, td = _dcfgs()
    jpol = jpolicy.make_policy(name, jd, top_k=2, router_type="topk_softmax")
    tpol = tpolicy.make_policy(name, td, top_k=2, router_type="topk_softmax")
    st = _run_against_reference(jpol, tpol, kind)
    assert int(st["acc"]["hits"]) + int(st["acc"]["misses"]) > 0


OVERRIDES = [
    ("dali", dict(cache="lru"), dict(cache="lru")),
    ("dali", dict(cache="score"), dict(cache="score")),
    ("dali", dict(cache="none", prefetch="none"),
     dict(cache="none", prefetch="none")),
    ("dali", dict(assignment="all_cpu"), dict(assignment="all_cpu")),
    ("static", dict(assignment=jpolicy.StaticAssign(threshold=1.0)),
     dict(assignment=tpolicy.StaticAssign(threshold=1.0))),
    ("lru", dict(cache=jpolicy.ScoreCachePolicy(decay=0.5),
                 prefetch=jpolicy.StatisticalPrefetch(decay=0.9)),
     dict(cache=tpolicy.ScoreCachePolicy(decay=0.5),
          prefetch=tpolicy.StatisticalPrefetch(decay=0.9))),
]


@pytest.mark.parametrize("case", range(len(OVERRIDES)))
def test_overrides_match_reference(case):
    name, jkw, tkw = OVERRIDES[case]
    jd, td = _dcfgs()
    jpol = jpolicy.make_policy(name, jd, top_k=2, **jkw)
    tpol = tpolicy.make_policy(name, td, top_k=2, **tkw)
    for part in ("assignment", "prefetch", "cache"):
        assert getattr(tpol, part).name == getattr(jpol, part).name
    _run_against_reference(jpol, tpol, "zipf", n_steps=8)


def test_no_prefetch_prefetches_nothing_and_with_dcfg_keeps_subpolicies():
    _, td = _dcfgs(prefetch_size=3)
    pol = tpolicy.make_policy("lru", td, top_k=2)
    assert not pol.prefetch.enabled
    routers, res_vecs, steps = _trace("zipf", n_steps=4)
    state = pol.init(device="cpu")
    for wl, gi, mask in steps:
        state, dec = pol.step(state, torch.from_numpy(wl),
                              _obs(gi, routers, res_vecs, mask)[2])
        assert not dec.prefetch_set.any()
        assert not dec.tel["prefetched"].any()
    td2 = tpolicy.DaliConfig(**{**td.__dict__, "t_trans": 0.5})
    pol2 = pol.with_dcfg(td2)
    assert pol2.dcfg.t_trans == 0.5 and pol2.cache is pol.cache
    assert pol2.assignment is pol.assignment and pol2.name == "lru"
    state2, _ = pol2.step(state, torch.from_numpy(steps[0][0]),
                          _obs(*steps[0][1:2], routers, res_vecs, None)[2])
    assert set(state2) == set(state)


def test_random_prefetch_invariants_and_determinism():
    jd, td = _dcfgs(prefetch_size=2)
    routers, res_vecs, steps = _trace("uniform", n_steps=6)

    def run(seed):
        pol = tpolicy.make_policy("random", td, top_k=2,
                                  prefetch=tpolicy.RandomPrefetch(seed=seed))
        state = pol.init(seed=1, device="cpu")
        out = []
        for wl, gi, mask in steps:
            state, dec = pol.step(state, torch.from_numpy(wl),
                                  _obs(gi, routers, res_vecs, mask)[2])
            pf = dec.prefetch_set
            assert not pf[0].any()
            assert (pf.sum(-1) <= td.prefetch_size).all()
            assert (pf[1:].sum(-1) == td.prefetch_size).all()
            p = dec.tel["pf_pred"]
            assert p.dtype == torch.float32
            assert bool(((p >= 0) & (p < 1)).all())
            out.append((pf.clone(), p.clone()))
        return out

    a, b, c = run(0), run(0), run(1)
    for (pa, qa), (pb, qb) in zip(a, b):
        assert torch.equal(pa, pb) and torch.equal(qa, qb)
    assert any(not torch.equal(qa, qc) for (_, qa), (_, qc) in zip(a, c))
    # the steps differ from each other, too
    assert not torch.equal(a[0][1], a[1][1])
    # the reference's own invariants, on its jitted step and NumPy mirror
    jpol = jpolicy.make_policy("random", jd, top_k=2)
    sj, sn = jpol.init(), jpol.init_np()
    for wl, gi, mask in steps:
        obs_j, obs_n, _ = _obs(gi, routers, res_vecs, mask)
        sj, dj = jax.jit(jpol.step)(sj, jnp.asarray(wl), obs_j)
        sn, dn = jpol.step_np(sn, wl, obs_n)
        for dec in (dj, dn):
            pf = np.asarray(dec.prefetch_set)
            assert not pf[0].any()
            assert (pf.sum(-1) <= jd.prefetch_size).all()


@pytest.mark.parametrize("cache", ["lru", "score"])
def test_scan_caches_break_ties_at_the_lowest_index(cache):
    """All stamps / scores equal: the victim is the lowest-index resident,
    in the reference and in the port."""
    jd, td = _dcfgs(cache_size=3)
    resident = np.zeros((L, E), bool)
    resident[:, [1, 4, 6]] = True
    used = np.zeros((L, E), bool)
    used[:, 0] = True                           # one miss per layer
    w = used.astype(np.float32) * 0 + 1.0       # equal scores everywhere
    jc = jpolicy.CACHES[cache]()
    tc = tpolicy.CACHES[cache]()
    _, jsub = jc.init(jd, jax.random.PRNGKey(0))
    jsub = jax.tree.map(np.asarray, jsub)
    _, tsub = tc.init(td, torch.Generator().manual_seed(0), "cpu")
    jr, _, _ = jc.update(jsub, jnp.asarray(resident), jnp.asarray(w),
                         jnp.asarray(used), jnp.asarray(1, jnp.int32), jd)
    tr, _, _ = tc.update(tsub, torch.from_numpy(resident),
                         torch.from_numpy(w), torch.from_numpy(used),
                         torch.tensor(1, dtype=torch.int32), td)
    _same(tr, jr, cache)
    if cache == "lru":                          # lru always swaps a miss
        assert tr[:, 0].all() and not tr[:, 1].any()
