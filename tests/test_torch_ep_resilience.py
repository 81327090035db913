"""Topology-aware EP resilience in the port (``repro_torch/serving/
ep_resilience.py``, ``models/moe_ep.py``'s placement functions,
``launch/ep_serve.py``) against the JAX package's on the same inputs.

* twins of the numpy tests of ``tests/test_ep_resilience.py`` (placement
  against the topology, per-pair byte accounting, the controller's
  degrade -> re-route -> heal -> restore cycle, the no-re-route baseline,
  argument checks), each holding the port to the reference's result;
* the port's ``EPResilience`` fed the reference's demand sequence gives
  the reference's placements, events, reroutes and link reports;
* ``run_resilience_trials(device="cpu")`` on 4 gloo ranks: the five
  verdicts of the reference's trial (bit-exact outputs across trials, the
  re-route engaged, faster in the fault window, fewer bytes over the
  degraded pair) all pass.
"""
import numpy as np
import pytest

import repro.core.cost_model as jcost
import repro.models.moe_ep as jep
import repro.serving.ep_resilience as jres
import repro_torch.core.cost_model as tcost
import repro_torch.models.moe_ep as tep
import repro_torch.serving.ep_resilience as tres

FAULT = "link_degrade[0>3]:x8@5-14"


def _zipf_demand(n_dev=4, E=16, a=1.2):
    per_e = (1000 / np.arange(1, E + 1) ** a).astype(np.int64)
    return np.tile(per_e, (n_dev, 1))


def _topos(n=4, gbps=10.0, lat=1e-4):
    return (tcost.LinkTopology.homogeneous(n, gbps, lat),
            jcost.LinkTopology.homogeneous(n, gbps, lat))


def test_solve_placement_identity_under_homogeneous():
    tt, jt = _topos()
    p = tep.solve_placement(_zipf_demand(), tt)
    np.testing.assert_array_equal(p, jep.solve_placement(_zipf_demand(), jt))
    assert np.array_equal(p, np.arange(16))
    p = tep.solve_placement(_zipf_demand()[0], tt, tp=4)
    assert np.array_equal(p, np.arange(16))


def test_solve_placement_moves_hot_experts_off_degraded_link():
    tt, jt = _topos()
    bad = tt.degrade(0, 3, 8.0).degrade(3, 0, 8.0)
    bad_j = jt.degrade(0, 3, 8.0).degrade(3, 0, 8.0)
    demand = _zipf_demand()
    p = tep.solve_placement(demand, bad)
    np.testing.assert_array_equal(p, jep.solve_placement(demand, bad_j))
    assert not np.array_equal(p, np.arange(16))
    assert np.array_equal(np.sort(p), np.arange(16))
    per_e = demand.sum(0)
    load = [per_e[p[k * 4:(k + 1) * 4]].sum() for k in range(4)]
    assert max(load[0], load[3]) <= min(load[1], load[2])
    assert np.array_equal(tep.solve_placement(demand, tt), np.arange(16))


def test_solve_placement_validates():
    tt = tcost.LinkTopology.homogeneous(3, 10.0, 1e-4)
    jt = jcost.LinkTopology.homogeneous(3, 10.0, 1e-4)
    with pytest.raises(ValueError) as got:
        tep.solve_placement(_zipf_demand(3, 16), tt)
    with pytest.raises(ValueError) as ref:
        jep.solve_placement(_zipf_demand(3, 16), jt)
    assert str(got.value) == str(ref.value)


def test_placement_pair_bytes_accounting():
    E, d_model, itemsize = 16, 8, 4
    demand = np.zeros((4, E), np.int64)
    demand[:, 0] = 10
    ident = np.arange(E)
    pb = tep.placement_pair_bytes(demand, ident, d_model, itemsize)
    np.testing.assert_array_equal(
        pb, jep.placement_pair_bytes(demand, ident, d_model, itemsize))
    row = 10 * d_model * itemsize
    assert pb[1, 0] == row and pb[0, 1] == row and pb[2, 3] == 0
    assert np.array_equal(pb, pb.T) and np.all(np.diag(pb) == 0)
    perm = ident.copy()
    perm[[0, 12]] = perm[[12, 0]]
    pb2 = tep.placement_pair_bytes(demand, perm, d_model, itemsize)
    assert pb2[1, 3] == row and pb2[1, 0] == 0
    tt, _ = _topos()
    bad = tt.degrade(0, 3, 8.0).degrade(3, 0, 8.0)
    zd = _zipf_demand()
    p = tep.solve_placement(zd, bad)
    before = tep.placement_pair_bytes(zd, np.arange(E), d_model, itemsize)
    after = tep.placement_pair_bytes(zd, p, d_model, itemsize)
    assert after[0, 3] < before[0, 3]


def _run_both(steps, demands, **kw):
    """The port's and the reference's controllers over one demand
    sequence: their per-step placements and the controllers."""
    tt, jt = _topos(lat=1e-5)
    tc = tres.EPResilience(tt, n_experts=16, d_model=8, itemsize=4, **kw)
    jc = jres.EPResilience(jt, n_experts=16, d_model=8, itemsize=4, **kw)
    tp, jp = [], []
    for s in range(steps):
        rt, rj = tc.step(demands(s)), jc.step(demands(s))
        assert rt["placement_changed"] == rj["placement_changed"]
        np.testing.assert_array_equal(rt["pair_bytes"], rj["pair_bytes"])
        assert rt["transitions"] == rj["transitions"]
        tp.append(rt["placement"])
        jp.append(rj["placement"])
    np.testing.assert_array_equal(np.stack(tp), np.stack(jp))
    assert tc.events == jc.events and tc.reroutes == jc.reroutes
    assert tc.link_report() == jc.link_report()
    return tp, tc


def test_ep_resilience_cycle():
    placements, ctrl = _run_both(24, lambda s: _zipf_demand(),
                                 faults=FAULT, seed=0)
    ident = np.arange(16)
    assert np.array_equal(placements[3], ident)
    kinds = [(frm, to) for _, _, frm, to in ctrl.events]
    assert ("healthy", "degraded") in kinds
    assert ("degraded", "healthy") in kinds
    assert ctrl.reroutes == 2
    moved = [t for t, p in enumerate(placements)
             if not np.array_equal(p, ident)]
    assert moved and 5 <= moved[0] < 14
    assert np.array_equal(placements[-1], ident)
    assert ctrl.slept_s > 0.0
    rep = ctrl.link_report()
    assert rep["0>3"]["degrade_events"] == 1
    assert rep["0>3"]["state"] == "healthy"
    full = ctrl.report()
    assert full["reroutes"] == 2 and full["degraded_pairs"] == []


def test_ep_resilience_no_reroute_baseline_detects_only():
    placements, ctrl = _run_both(16, lambda s: _zipf_demand(),
                                 faults=FAULT, seed=0, reroute=False)
    assert all(np.array_equal(p, np.arange(16)) for p in placements)
    assert ctrl.reroutes == 0
    assert any(to == "degraded" for _, _, _, to in ctrl.events)


def test_ep_resilience_same_as_reference_on_a_demand_sequence():
    """A demand that shifts every step (zipf over a rotating expert order,
    with per-source noise): placements, events and links step for step."""
    rng = np.random.default_rng(0)
    seq = []
    for s in range(30):
        per_e = (1000 / np.arange(1, 17) ** 1.2)[np.roll(np.arange(16),
                                                         s // 6)]
        seq.append((per_e[None] * rng.uniform(0.5, 1.5, (4, 16)))
                   .astype(np.int64))
    _, ctrl = _run_both(30, lambda s: seq[s],
                        faults="link_degrade[0>3]:x8@4-20,"
                               "link_degrade[2>1]:x6@10-16", seed=0)
    assert ctrl.reroutes >= 1


def test_ep_resilience_validates_demand_shape():
    tt, jt = _topos(lat=1e-5)
    ctrl = tres.EPResilience(tt, n_experts=16, d_model=8, itemsize=4)
    with pytest.raises(ValueError, match="demand"):
        ctrl.step(np.zeros((3, 16)))
    with pytest.raises(ValueError) as got:
        tres.EPResilience(tt, n_experts=15, d_model=8, itemsize=4)
    with pytest.raises(ValueError) as ref:
        jres.EPResilience(jt, n_experts=15, d_model=8, itemsize=4)
    assert str(got.value) == str(ref.value)


def test_run_resilience_trials_on_cpu_ranks():
    from repro_torch.launch.ep_serve import run_resilience_trials
    res = run_resilience_trials(world=4, device="cpu")
    assert res["verdicts"] == {k: True for k in (
        "static_bit_exact", "reroute_bit_exact", "reroute_engaged",
        "reroute_faster", "degraded_bytes_drop")}
    assert res["ok"] and res["tp"] == 4 and res["dtype"] == "float32"
    assert res["fault_pairs"] == ["0>3"]
    assert [t["name"] for t in res["trials"]] == [
        "healthy", "fault_static", "fault_reroute"]
    assert res["trials"][2]["reroutes"] >= 1
    assert len(res["workers"]) == 4


def test_ep_serve_rejects_a_schedule_without_a_slow_link():
    from repro_torch.launch.ep_serve import run_resilience_trials
    with pytest.raises(SystemExit, match="link_degrade"):
        run_resilience_trials(faults="read_error@1-3", device="cpu")
