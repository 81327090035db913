"""The port's simulator stack against the JAX package's, on the CPU: the
numpy cost model, assignment solvers, caches and prefetchers (copies), the
framework simulator ``simulate`` over ``paper_frameworks`` and
``simulate_policy`` for every registered policy.

Both simulators replay the same synthetic routing trace.  ``simulate``
measures its solvers' wall-clock time, which no two runs share, so it runs
with ``solve_time_scale=0``.  ``simulate_policy`` replays the port's
policies through their ``step`` on CPU tensors and the reference's through
``step_np``, from the same initial state (carried over with
``repro_torch.bridge``).  Counts and decisions must match exactly; hit
rates, prefetch accuracies and modeled times within 3e-5 relative.
``random`` cannot match ``jax.random`` draw for draw and is held to its
invariants.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
import repro.core.assignment as jassign
import repro.core.cache as jcache
import repro.core.cost_model as jcost
import repro.core.policy as jpolicy
import repro.core.prefetch as jprefetch
import repro.core.simulator as jsim
import repro.core.tracing as jtracing
import repro_torch.configs as tconfigs
import repro_torch.core.assignment as tassign
import repro_torch.core.cache as tcache
import repro_torch.core.cost_model as tcost
import repro_torch.core.policy as tpolicy
import repro_torch.core.prefetch as tprefetch
import repro_torch.core.simulator as tsim
import repro_torch.core.tracing as ttracing
from repro_torch import bridge
from repro_torch.tree import tree_map

L_MOE = 4
RTOL = 3e-5


def _cfgs():
    mk = lambda m: m.make_smoke(m.get_config("mixtral_8x7b")).replace(
        n_layers=L_MOE)
    return mk(jconfigs), mk(tconfigs)


def _cost_models():
    return (jcost.CostModel.for_config(jconfigs.get_config("mixtral_8x7b"),
                                       jcost.LOCAL_PC),
            tcost.CostModel.for_config(tconfigs.get_config("mixtral_8x7b"),
                                       tcost.LOCAL_PC))


def _traces(jc, tc, n_steps=12, seed=0, skew=3.0):
    """One synthetic trace with temporally correlated hot experts, as the
    reference's simulator tests draw it, for both packages."""
    rng = np.random.default_rng(seed)
    E = jc.moe.n_routed
    jt, tt = jtracing.RoutingTrace(jc), ttracing.RoutingTrace(tc)
    hot = rng.choice(E, max(1, E // 4), replace=False)
    for t in range(n_steps):
        if t % 8 == 7:
            hot = (hot + 1) % E
        wls, gis, gss = [], [], []
        for _ in range(L_MOE):
            w = rng.poisson(1.0, E).astype(np.int64)
            w[hot] += rng.poisson(skew * 3, len(hot))
            wls.append(w)
            gis.append(rng.standard_normal((8, jc.d_model))
                       .astype(np.float32))
            gss.append(w.astype(np.float64))
        for tr in (jt, tt):
            tr.workload.append([a.copy() for a in wls])
            tr.gate_in.append([a.copy() for a in gis])
            tr.gates_sum.append([a.copy() for a in gss])
            tr.n_tokens = 8
    return jt, tt


def _results_match(rt, rj, what):
    at, aj = dataclasses.asdict(rt), dataclasses.asdict(rj)
    assert at.keys() == aj.keys()
    for k, v in aj.items():
        if isinstance(v, str) or isinstance(v, int):
            assert at[k] == v, f"{what} {k}"
        else:
            assert at[k] == pytest.approx(v, rel=RTOL, abs=1e-12), \
                f"{what} {k}"


def test_cost_model_matches_reference():
    jm, tm = _cost_models()
    w = np.array([0, 1, 2, 4, 16, 64, 256, 4096])
    for fn in ("expert_flops", "t_cpu", "t_gpu_compute"):
        np.testing.assert_array_equal(getattr(tm, fn)(w), getattr(jm, fn)(w),
                                      err_msg=fn)
    for cached in (False, True):
        mask = np.full(w.shape, cached)
        np.testing.assert_array_equal(tm.t_gpu(w, mask), jm.t_gpu(w, mask))
        assert tm.break_even_workload(cached) \
            == jm.break_even_workload(cached)
    assert tm.trans_time == jm.trans_time
    assert tm.expert_bytes == jm.expert_bytes


def _times(rng, n, frac_active=0.7):
    act = rng.random(n) < frac_active
    tc = np.where(act, rng.uniform(1e-4, 5e-3, n), 0.0)
    tg = np.where(act, rng.uniform(1e-4, 5e-3, n), 0.0)
    return tc, tg


@pytest.mark.parametrize("n", [8, 16, 40])
def test_assignment_solvers_match_reference(n):
    """n = 40 with most experts active takes ``optimal_assign``'s DP."""
    rng = np.random.default_rng(n)
    for trial in range(4):
        tc, tg = _times(rng, n)
        w = rng.integers(0, 6, n) * (tc > 0)
        cases = [("greedy", lambda m: m.greedy_assign(tc, tg)),
                 ("optimal", lambda m: m.optimal_assign(tc, tg)),
                 ("beam", lambda m: m.beam_search_assign(tc, tg, beam=3)),
                 ("static", lambda m: m.static_assign(w, tc, tg, 2.0)),
                 ("all_cpu", lambda m: m.all_cpu(tc, tg)),
                 ("all_gpu", lambda m: m.all_gpu(tc, tg))]
        for name, solve in cases:
            at, aj = solve(tassign), solve(jassign)
            np.testing.assert_array_equal(at.on_cpu, aj.on_cpu, err_msg=name)
            np.testing.assert_array_equal(at.on_gpu, aj.on_gpu, err_msg=name)
            assert (at.t_cpu, at.t_gpu, at.makespan, at.imbalance) == \
                pytest.approx((aj.t_cpu, aj.t_gpu, aj.makespan,
                               aj.imbalance), rel=RTOL), name


def test_caches_and_prefetchers_match_reference():
    jc, tc = _cfgs()
    E = jc.moe.n_routed
    rng = np.random.default_rng(3)
    for name in jcache.POLICIES:
        kw = {"w_size": 3, "u_size": 2} if name == "workload" else {}
        cj = jcache.POLICIES[name](E, 3, seed=7, **kw)
        ct = tcache.POLICIES[name](E, 3, seed=7, **kw)
        for _ in range(20):
            w = rng.poisson(1.5, E)
            gates = rng.random(E)
            used = rng.random(E) < 0.5
            assert ct.observe(w, gates, used) == cj.observe(w, gates, used)
            np.testing.assert_array_equal(ct.resident, cj.resident,
                                          err_msg=name)
            assert ct.transfers == cj.transfers
            np.testing.assert_array_equal(ct.resident_set(),
                                          cj.resident_set())
            assert ct.hit(3) == cj.hit(3)
    gws = [rng.standard_normal((jc.d_model, E)) for _ in range(L_MOE)]
    res = [rng.standard_normal(jc.d_model) * 0.1 for _ in range(L_MOE)]
    pairs = [(jprefetch.ResidualPrefetcher(gws, res, jc.moe),
              tprefetch.ResidualPrefetcher(gws, res, tc.moe)),
             (jprefetch.FeaturePrefetcher(gws, jc.moe),
              tprefetch.FeaturePrefetcher(gws, tc.moe)),
             (jprefetch.StatisticalPrefetcher(L_MOE, E, decay=0.8),
              tprefetch.StatisticalPrefetcher(L_MOE, E, decay=0.8)),
             (jprefetch.RandomPrefetcher(E, seed=4),
              tprefetch.RandomPrefetcher(E, seed=4))]
    for pj, pt in pairs:
        assert pt.name == pj.name
        for step in range(6):
            for layer in range(L_MOE):
                h = rng.standard_normal((6, jc.d_model))
                wl = rng.poisson(2.0, E)
                pj.observe(layer, wl)
                pt.observe(layer, wl)
                a, b = pt.predict(layer, h), pj.predict(layer, h)
                np.testing.assert_array_equal(a, b, err_msg=pj.name)
                for k in (1, 2, 3):
                    np.testing.assert_array_equal(
                        tprefetch.top_workload_experts(a, k),
                        jprefetch.top_workload_experts(b, k))
                    assert tprefetch.prefetch_accuracy(a, wl, k) == \
                        jprefetch.prefetch_accuracy(b, wl, k)


def test_simulate_paper_frameworks_matches_reference():
    jc, tc = _cfgs()
    jm, tm = _cost_models()
    jt, tt = _traces(jc, tc)
    E = jc.moe.n_routed
    rng = np.random.default_rng(5)
    gws = [rng.standard_normal((jc.d_model, E)) * 0.2 for _ in range(L_MOE)]
    res = [rng.standard_normal(jc.d_model) * 0.1 for _ in range(L_MOE)]

    def prefetchers(mod):
        return {"residual": mod.ResidualPrefetcher(gws, res, jc.moe),
                "feature": mod.FeaturePrefetcher(gws, jc.moe),
                "statistical": mod.StatisticalPrefetcher(L_MOE, E),
                "random": mod.RandomPrefetcher(E, seed=2)}

    def specs(mod):
        return mod.paper_frameworks(cache_size=E // 2, prefetch_size=2) + [
            mod.FrameworkSpec("optimal", assignment="optimal",
                              prefetch="statistical", cache_policy="lru",
                              cache_size=3),
            mod.FrameworkSpec("beam", assignment="beam", prefetch="random",
                              cache_policy="workload", cache_size=3),
            mod.FrameworkSpec("all_cpu", assignment="all_cpu")]

    seen = set()
    for sj, st in zip(specs(jsim), specs(tsim)):
        assert dataclasses.asdict(sj) == dataclasses.asdict(st)
        kw = dict(batch=4, ctx_len=32, seed=3, solve_time_scale=0.0)
        rj = jsim.simulate(jt, jc, jm, sj, prefetchers=prefetchers(jprefetch),
                           **kw)
        rt = tsim.simulate(tt, tc, tm, st, prefetchers=prefetchers(tprefetch),
                           **kw)
        _results_match(rt, rj, sj.name)
        assert rt.row() == rj.row()
        seen.add(rt.cache_hit_rate > 0)
    assert seen == {True, False}
    for batch in (1, 8):
        assert tsim.nonmoe_time_per_step(tc, tm, batch, 64) == \
            jsim.nonmoe_time_per_step(jc, jm, batch, 64)


class _Carried:
    """A port policy started from a reference initial state."""

    def __init__(self, policy, state):
        self.policy, self.state = policy, state
        self.name, self.dcfg = policy.name, policy.dcfg
        self.schedules = True

    def init(self, seed=0, device="cpu"):
        return tree_map(torch.clone, self.state)

    def step(self, state, workloads, obs):
        return self.policy.step(state, workloads, obs)


@pytest.mark.parametrize("name", [n for n in tpolicy.policy_names()
                                  if n != "random"])
def test_simulate_policy_matches_reference(name):
    jc, tc = _cfgs()
    jm, tm = _cost_models()
    jt, tt = _traces(jc, tc)
    E = jc.moe.n_routed
    rng = np.random.default_rng(6)
    gws = [rng.standard_normal((jc.d_model, E)) * 0.2 for _ in range(L_MOE)]
    res = [rng.standard_normal(jc.d_model) * 0.1 for _ in range(L_MOE)]
    kw = dict(gate_ws=gws, res_vecs=res, batch=4, ctx_len=32)
    dk = dict(n_moe_layers=L_MOE, n_experts=E, cache_size=3,
              prefetch_size=2, w_size=2)
    jd = jpolicy.DaliConfig.from_cost_model(jm, **dk)
    td = tpolicy.DaliConfig.from_cost_model(tm, **dk)
    if name == "none":
        rj = jsim.simulate_policy(jt, jc, jm, "none", dcfg=jd, **kw)
        rt = tsim.simulate_policy(tt, tc, tm, "none", dcfg=td, **kw)
    else:
        mk = dict(top_k=jc.moe.top_k, router_type=jc.moe.router_type)
        jpol = jpolicy.make_policy(name, jd, **mk)
        tpol = tpolicy.make_policy(name, td, **mk)
        carried = bridge.to_torch(jpol.init_np(), "cpu")
        rj = jsim.simulate_policy(jt, jc, jm, jpol, **kw)
        rt = tsim.simulate_policy(tt, tc, tm, _Carried(tpol, carried), **kw)
    _results_match(rt, rj, name)
    assert rt.n_steps == jt.n_steps
    # "none" is naive on-demand execution: an empty cache never hits
    assert (rt.cache_hit_rate > 0) == (name != "none")


def test_simulate_policy_random_invariants():
    jc, tc = _cfgs()
    _, tm = _cost_models()
    _, tt = _traces(jc, tc)
    runs = [tsim.simulate_policy(tt, tc, tm, "random", batch=4)
            for _ in range(2)]
    assert dataclasses.asdict(runs[0]) == dataclasses.asdict(runs[1])
    r = runs[0]
    assert 0.0 <= r.prefetch_acc <= 1.0 and 0.0 <= r.cache_hit_rate <= 1.0
    assert r.n_steps == tt.n_steps and r.pcie_time_s > 0
    assert np.isfinite(r.tokens_per_s) and r.tokens_per_s > 0
