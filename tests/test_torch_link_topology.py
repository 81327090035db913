"""The port's per-link cost topology (``repro_torch/core/cost_model.py``)
against the JAX package's (``repro/core/cost_model.py``), on the same
inputs: twins of ``tests/test_link_topology.py``'s eight tests and of
``tests/test_faults.py::test_watchdog_bank_degrade_heal_refit``, each
holding the port's objects to the reference's.

(a) constructors: homogeneous and hierarchical island fabrics, the island
    size validated;
(b) the ``--topology`` grammar: bases, per-pair overrides, bare override
    lists, and the typed ``TopologyParseError`` on malformed specs;
(c) per-pair timing (Eq. 6 per link), directed degradation, and the
    device-quality ranking the greedy placement reads;
(d) guarded per-pair refits: degenerate fits keep the prior constants and
    are recorded in ``rejected``; with fewer than two devices
    ``calibrate_links`` returns the prior;
(e) CostModel: ``with_topology`` + ``for_link`` give each directed pair
    its own ``trans_time``;
(f) the port's ``WatchdogBank`` (serving/faults.py) over a topology:
    degrade, heal and refit step for step with the reference's.
"""
import numpy as np
import pytest

import repro.configs as jconfigs
import repro.core.cost_model as jcost
import repro.serving.faults as jfaults
import repro_torch.configs as tconfigs
import repro_torch.core.cost_model as tcost
import repro_torch.serving.faults as tfaults


def same_topology(t, j):
    assert t.n == j.n and t.name == j.name
    for k in ("gbps", "latency_s", "rejected"):
        np.testing.assert_array_equal(getattr(t, k), getattr(j, k))


def test_homogeneous_uniform():
    t = tcost.LinkTopology.homogeneous(4, 8.0, 1e-5)
    same_topology(t, jcost.LinkTopology.homogeneous(4, 8.0, 1e-5))
    assert t.n == 4
    assert t.pair(0, 3) == (8.0, 1e-5)
    assert t.is_uniform()
    assert t.pairs() == jcost.LinkTopology.homogeneous(4, 8.0, 1e-5).pairs()
    assert len(t.pairs()) == 4 * 3


def test_hierarchical_islands():
    kw = dict(intra_gbps=64.0, inter_gbps=8.0, intra_latency_s=1e-6,
              inter_latency_s=1e-5)
    t = tcost.LinkTopology.hierarchical(8, 4, **kw)
    same_topology(t, jcost.LinkTopology.hierarchical(8, 4, **kw))
    assert t.pair(0, 3) == (64.0, 1e-6)
    assert t.pair(0, 4) == (8.0, 1e-5)
    assert t.is_uniform()
    with pytest.raises(tcost.TopologyParseError) as got:
        tcost.LinkTopology.hierarchical(8, 3, intra_gbps=1, inter_gbps=1,
                                        intra_latency_s=0, inter_latency_s=0)
    with pytest.raises(jcost.TopologyParseError) as ref:
        jcost.LinkTopology.hierarchical(8, 3, intra_gbps=1, inter_gbps=1,
                                        intra_latency_s=0, inter_latency_s=0)
    assert str(got.value) == str(ref.value)


def test_pair_time_and_degrade():
    t = tcost.LinkTopology.homogeneous(4, 10.0, 1e-4)
    j = jcost.LinkTopology.homogeneous(4, 10.0, 1e-4)
    for nb in (0, 1 << 10, 1 << 20):
        for a, b in ((1, 1), (0, 1), (3, 2)):
            assert t.pair_time(a, b, nb) == j.pair_time(a, b, nb)
    d, dj = t.degrade(0, 1, 8.0), j.degrade(0, 1, 8.0)
    same_topology(d, dj)
    assert d.pair(0, 1) == (10.0 / 8, 8e-4)
    assert d.pair(1, 0) == (10.0, 1e-4)       # directed: reverse untouched
    assert t.pair(0, 1) == (10.0, 1e-4)       # original is unchanged
    assert not d.is_uniform() and not dj.is_uniform()
    np.testing.assert_array_equal(d.device_quality(), dj.device_quality())
    q = d.device_quality()
    assert q[0] < q[2] and q[1] < q[2]
    w, wj = d.with_pair(2, 3, 4.0, 5e-5, True), dj.with_pair(2, 3, 4.0, 5e-5,
                                                             True)
    same_topology(w, wj)
    same_topology(w.copy(), wj.copy())


@pytest.mark.parametrize("spec,n", [
    (None, 4), ("", 4), ("flat", 4), ("island:4", 8), ("flat,0>3:x8", 8),
    ("1>2:g4.0:l250", 4), ("island:2,0>1:x4,3>2:g1.5", 4)])
def test_parse_topology_grammar(spec, n):
    t = tcost.parse_topology(spec, n)
    same_topology(t, jcost.parse_topology(spec, n))
    assert tcost.parse_topology(t, n) is t    # passthrough
    if spec == "flat,0>3:x8":
        assert t.pair(0, 3)[0] == pytest.approx(tcost.LOCAL_PC.link_gbps / 8)
        assert t.pair(3, 0)[0] == tcost.LOCAL_PC.link_gbps
    if spec == "1>2:g4.0:l250":
        assert t.pair(1, 2) == (4.0, pytest.approx(250e-6))


@pytest.mark.parametrize("bad", [
    "mesh", "island:x", "flat,0>0:x8", "flat,0>9:x8", "flat,0-3:x8",
    "flat,0>3:q8", "flat,0>3", "island:3",
])
def test_parse_topology_malformed_typed(bad):
    with pytest.raises(tcost.TopologyParseError) as got:
        tcost.parse_topology(bad, 8)
    with pytest.raises(jcost.TopologyParseError) as ref:
        jcost.parse_topology(bad, 8)
    assert str(got.value) == str(ref.value)


def test_fit_topology_good_and_degenerate():
    sizes = np.array([1e6, 4e6, 16e6])
    good = 2e-4 + sizes / (5.0 * 1e9)         # clean 5 GB/s, 200 µs
    noisy = np.array([3e-3, 2e-3, 1e-3])      # bigger buffer "faster"
    samples = {(0, 1): (sizes, good), (1, 2): (sizes, noisy)}
    t = tcost.fit_topology(tcost.LinkTopology.homogeneous(3, 10.0, 1e-4),
                           samples)
    same_topology(t, jcost.fit_topology(
        jcost.LinkTopology.homogeneous(3, 10.0, 1e-4), samples))
    assert t.pair(0, 1)[0] == pytest.approx(5.0, rel=1e-3)
    assert not t.rejected[0, 1] and t.rejected[1, 2]
    assert t.pair(1, 2) == (10.0, 1e-4)       # the prior survives
    assert t.pair(2, 0) == (10.0, 1e-4) and not t.rejected[2, 0]


def test_calibrate_links_single_device_returns_prior():
    prior = tcost.LinkTopology.homogeneous(1, 10.0, 1e-4)
    t = tcost.calibrate_links(prior, devices=["cpu"])
    assert t is not prior
    same_topology(t, prior)
    # no card here: the default device list is empty, the prior comes back
    same_topology(tcost.calibrate_links(prior), prior)


def test_cost_model_per_link():
    tc = tconfigs.make_smoke(tconfigs.get_config("mixtral-8x7b"))
    jc = jconfigs.make_smoke(jconfigs.get_config("mixtral-8x7b"))
    cm = tcost.CostModel.for_config(tc).with_topology(
        tcost.parse_topology("flat,0>3:x8", 4))
    cj = jcost.CostModel.for_config(jc).with_topology(
        jcost.parse_topology("flat,0>3:x8", 4))
    for a, b in ((0, 3), (1, 2), (2, 2)):
        assert cm.trans_time_for(a, b) == pytest.approx(
            cj.trans_time_for(a, b), rel=1e-12)
        assert cm.for_link(a, b).trans_time == pytest.approx(
            cj.for_link(a, b).trans_time, rel=1e-12)
    assert cm.trans_time_for(0, 3) == pytest.approx(
        8 * cm.trans_time_for(1, 2), rel=0.2)
    assert cm.for_link(0, 3).trans_time > cm.for_link(1, 2).trans_time
    base = tcost.CostModel.for_config(tc)
    assert base.trans_time_for(0, 3) == base.trans_time
    assert base.for_link(0, 3) is base


def _drive_bank(mod, topo, steps, fault_steps):
    bank = mod.WatchdogBank(1 << 20, topo, margin=2.0, patience=2,
                            recover_patience=2, calib_n=2)
    nb = 1 << 20
    states = []
    for step in range(steps):
        for (i, j) in topo.pairs():
            t = topo.pair_time(i, j, nb)
            if (i, j) == (0, 3) and fault_steps(step):
                t *= 16                        # injected slow link
            bank.observe((i, j), nb, t)
        bank.on_step(step)
        states.append(bank.state((0, 3)))
    return bank, states


def test_watchdog_bank_degrade_heal_refit():
    tt = tcost.LinkTopology.homogeneous(4, 10.0, 1e-4)
    jt = jcost.LinkTopology.homogeneous(4, 10.0, 1e-4)
    window = lambda s: 4 <= s < 9              # noqa: E731
    tb, ts = _drive_bank(tfaults, tt, 14, window)
    jb, js = _drive_bank(jfaults, jt, 14, window)
    assert ts == js
    assert tfaults.DEGRADED in ts and ts[-1] == tfaults.HEALTHY
    assert tb.degraded_pairs() == jb.degraded_pairs() == []
    assert tb.transitions() == jb.transitions()
    assert tb.report() == jb.report()
    di = ts.index(tfaults.DEGRADED)
    tb2, _ = _drive_bank(tfaults, tt, di + 1, lambda s: s >= 4)
    jb2, _ = _drive_bank(jfaults, jt, di + 1, lambda s: s >= 4)
    assert tb2.state((0, 3)) == tfaults.DEGRADED
    now, now_j = tb2.refit_topology(tt), jb2.refit_topology(jt)
    same_topology(now, now_j)
    nb = 1 << 20
    assert now.pair_time(0, 3, nb) > 2 * tt.pair_time(0, 3, nb)
    assert now.pair(1, 2) == tt.pair(1, 2)
    assert tb2.report() == jb2.report()
