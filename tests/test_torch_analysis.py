"""The port's serving-path audit (repro_torch/analysis) against the JAX
package's graph-contract auditor (repro/analysis): the contract table and
codes, a green audit of the full-resident smoke server, the physical
mode's one finding (``read_misses`` entered on every step), the seeded
self-test, every lint rule and a clean tree, and the cost checks.

The smoke server is the reference test's: Mixtral at smoke scale, 2
layers, 4 routed experts, batch 2, max_len 32 (tests/test_analysis.py).
"""
import dataclasses

import numpy as np
import pytest
import torch

import repro.analysis.contracts as jcontracts
import repro.analysis.lint as jlint
from repro.configs import get_config as jget_config
from repro.configs import make_smoke as jmake_smoke
from repro.core.cost_model import CostModel as JCostModel
from repro_torch.analysis.contracts import (E_CALLBACK_UNGUARDED,
                                            E_CALLBACK_UNREGISTERED,
                                            E_CONST_CAPTURE,
                                            E_DONATION_DROPPED,
                                            E_SYNC_CENSUS, GraphContract,
                                            GraphContractError, Violation,
                                            maybe_raise)
import repro_torch.analysis.contracts as tcontracts
from repro_torch.analysis.lint import lint_source, lint_tree
from repro_torch.analysis.step_audit import POOL, audit_entry, decode_entry
from repro_torch.configs import get_config, make_smoke
from repro_torch.models.model import init_model
from repro_torch.serving.spec import OffloadSpec, ServeSpec


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(n_layers=2, n_routed=4):
    cfg = make_smoke(get_config("mixtral-8x7b")).replace(n_layers=n_layers)
    return cfg.replace(moe=dataclasses.replace(cfg.moe, n_routed=n_routed))


@pytest.fixture(scope="module")
def params_and_cfg():
    cfg = _cfg()
    return init_model(cfg, seed=0, device="cpu"), cfg


def _resolve(params, cfg, mode, **kw):
    return ServeSpec(cfg=cfg, policy="dali", batch_size=2, max_len=32,
                     device="cpu", offload=OffloadSpec(mode=mode),
                     **kw).resolve(params)


def _n_moe(cfg):
    from repro_torch.models.config import layer_pattern
    return sum(1 for _, mlp in layer_pattern(cfg) if mlp == "moe")


# ---------------------------------------------------------------------------
# the contract table is the reference's
# ---------------------------------------------------------------------------

def test_contract_table_matches_reference():
    assert tcontracts.ALL_CODES == jcontracts.ALL_CODES
    assert tcontracts.MAX_CONST_BYTES == jcontracts.MAX_CONST_BYTES
    for mode in ("modeled", "blocking", "overlap", "pipelined"):
        assert tcontracts.default_rungs(mode) == \
            jcontracts.default_rungs(mode)


def test_audit_raises_typed_error_on_violation():
    report = {"mode": "x", "violations": [
        Violation(E_CONST_CAPTURE, "e", "boom").asdict()], "ok": False}
    with pytest.raises(GraphContractError) as ei:
        maybe_raise(report, True)
    assert ei.value.violations[0].code == E_CONST_CAPTURE
    assert "boom" in str(ei.value)
    with pytest.raises(jcontracts.GraphContractError) as ej:
        jcontracts.maybe_raise(report, True)
    assert str(ej.value) == str(ei.value)


def test_const_allowed_by_budget_identity_and_shape():
    small = torch.zeros((4,))
    big = torch.zeros((64, 1024))                # 256 KiB
    twin = torch.zeros((64, 1024))
    c = GraphContract(allow_consts=(big,))
    assert c.const_allowed(small)                # under budget
    assert c.const_allowed(big)                  # identity
    assert c.const_allowed(twin)                 # shape+dtype allowlisted
    assert not c.const_allowed(torch.zeros((64, 1024), dtype=torch.int32))
    # the reference's rule on the same arrays
    jc = jcontracts.GraphContract(allow_consts=(big.numpy(),))
    for t in (small, big, twin, torch.zeros((64, 1024), dtype=torch.int32)):
        assert c.const_allowed(t) == jc.const_allowed(t.numpy())


# ---------------------------------------------------------------------------
# the audit itself
# ---------------------------------------------------------------------------

def test_audit_modeled_passes(params_and_cfg):
    params, cfg = params_and_cfg
    report = _resolve(params, cfg, "modeled").audit()
    assert report["ok"]
    assert report["violations"] == []
    names = [e["name"] for e in report["entries"]]
    assert any(n.startswith("decode[") for n in names)
    assert any(n.startswith("prefill[") for n in names)
    assert any(n.startswith("policy.step[") for n in names)
    by_name = {e["name"]: e for e in report["entries"]}
    # the decode keeps every cache leaf in place and leaves no seam
    dec = by_name["decode[modeled/healthy]"]
    assert dec["callbacks"] == [] and len(dec["in_place"]) > 0


def test_audit_pipelined_reports_only_unguarded_read_misses(params_and_cfg):
    params, cfg = params_and_cfg
    rs = _resolve(params, cfg, "pipelined")
    report = rs.audit(raise_on_violation=False)
    names = [e["name"] for e in report["entries"]]
    for expect in ("decode[pipelined/healthy]", "decode[pipelined/degraded]",
                   "decode[pipelined/little]", "store.step_update",
                   "store._copy_rows"):
        assert expect in names, names
    by_name = {e["name"]: e for e in report["entries"]}
    # pool updates in place (the reference's aliased [0,1,2,3] / [0,1,2])
    assert by_name["store.step_update"]["in_place"] == list(POOL)
    assert by_name["store._copy_rows"]["in_place"] == list(POOL[:3])
    # the audit's decode state has every row dead, so every row hits: each
    # rung's every MoE layer enters read_misses without needing it
    n_moe = _n_moe(cfg)
    viols = report["violations"]
    assert {v["code"] for v in viols} == {E_CALLBACK_UNGUARDED}
    assert all("'read_misses'" in v["detail"] for v in viols)
    dec = [v for v in viols if v["entry"].startswith("decode[")]
    assert len(dec) == 3 * n_moe
    with pytest.raises(GraphContractError):
        rs.audit()


def test_read_misses_is_guarded_only_on_steps_with_misses(params_and_cfg):
    """An all-hit step: one E_CALLBACK_UNGUARDED per MoE layer.  A step
    where every row misses (an empty pool, every slot live): the reads
    are needed, each layer fetches, no violation."""
    params, cfg = params_and_cfg
    rs = _resolve(params, cfg, "pipelined")
    n_moe = _n_moe(cfg)
    hit = audit_entry(decode_entry(rs, "healthy",
                                   rs.init_state(per_slot=True)))
    assert [v.code for v in hit["violations"]] == \
        [E_CALLBACK_UNGUARDED] * n_moe
    assert [c["seam"] for c in hit["callbacks"]] == ["read_misses"] * n_moe

    state = rs.init_state(per_slot=True)
    state["offload"] = rs.store.init_device_state(
        np.zeros((n_moe, cfg.moe.n_routed), bool))
    state["active"][:] = True
    miss = audit_entry(decode_entry(rs, "healthy", state))
    assert miss["violations"] == []
    seams = [c["seam"] for c in miss["callbacks"]]
    assert seams.count("read_misses") == n_moe
    assert seams.count("fetch_weights") == n_moe
    assert all(c["needed"] for c in miss["callbacks"])


def test_seam_registry_names_the_store_seams(params_and_cfg):
    """The store's host seams are registered with the reference's fields,
    found from bound methods (also through a fallback view), and counted
    on entry."""
    from repro_torch.models.moe import lookup_callback_seam
    from repro_torch.serving.steps import _FallbackView
    params, cfg = params_and_cfg
    store = _resolve(params, cfg, "pipelined").store
    kinds = {"read_misses": "read", "fetch_weights": "stage",
             "little_weights": "stage", "prefill_fetch": "stage",
             "prefill_little": "stage", "host_ffn": "host",
             "prefill_host": "host"}
    view = _FallbackView(store, "little")
    for name, kind in kinds.items():
        seam = lookup_callback_seam(getattr(store, name))
        assert (seam.name, seam.kind, seam.cond_required) == (name, kind,
                                                               True)
        assert lookup_callback_seam(getattr(view, name)) is seam
    seam = lookup_callback_seam(store.read_misses)
    n = seam.entries
    store.read_misses(0, torch.zeros((2, 4), dtype=torch.int32))
    assert seam.entries == n + 1
    assert lookup_callback_seam(store.commit) is None


def test_host_read_inside_a_stage_seam_is_a_kind_violation():
    """A seam registered as "stage" (copies host-chosen rows, reads nothing
    back) that reads device data on the host: E_CALLBACK_KIND."""
    from repro_torch.analysis.contracts import E_CALLBACK_KIND, EntryPoint
    from repro_torch.models.moe import callback_seam

    class Stager:
        @callback_seam("test_stage", kind="stage")
        def stage(self, lid, rows):
            return rows.cpu()

    stager = Stager()
    rec = audit_entry(EntryPoint(
        name="kind", fn=lambda x: stager.stage(0, x) + 1,
        args=(torch.ones((3,)),)))
    assert [v.code for v in rec["violations"]] == [E_CALLBACK_KIND]


# ---------------------------------------------------------------------------
# seeded violations: each defect class fails with its own code
# ---------------------------------------------------------------------------

def test_selftest_fixtures_each_fire_their_code():
    from repro_torch.analysis.selftest import run_selftest
    report = run_selftest()
    assert report["ok"], report["fixtures"]
    got = {r["fixture"]: r["expected"] for r in report["fixtures"]}
    assert set(got.values()) == {
        E_CONST_CAPTURE, E_DONATION_DROPPED, E_CALLBACK_UNREGISTERED,
        E_CALLBACK_UNGUARDED, E_SYNC_CENSUS}
    assert len(set(got.values())) == len(got)


# ---------------------------------------------------------------------------
# AST lint rules (unit level) + clean tree
# ---------------------------------------------------------------------------

def test_lint_a001_bare_assert_in_serving():
    src = "def f(x):\n    assert x > 0\n    return x\n"
    assert [f.code for f in lint_source(src, "repro_torch/serving/foo.py")] \
        == ["A001"] == [f.code for f in jlint.lint_source(
            src, "repro/serving/foo.py")]
    assert lint_source(src, "repro_torch/models/foo.py") == []


def test_lint_a002_sync_in_hot_hook():
    src = ("class H:\n"
           "    def pre_step(self, state):\n"
           "        x = state.loss.item()\n"
           "        y = float(state.t)\n"
           "        return x + y\n"
           "    def other(self, state):\n"
           "        return state.loss.item()\n")
    codes = [f.code for f in lint_source(src, "repro_torch/serving/h.py")]
    assert codes == ["A002", "A002"] == [
        f.code for f in jlint.lint_source(src, "repro/serving/h.py")]
    # the port's rule also covers the host reads a torch hook could hide
    src = ("class H:\n"
           "    def post_dispatch(self, mode, target):\n"
           "        a = target.cpu().numpy()\n"
           "        return bool(a.tolist())\n")
    assert [f.code for f in lint_source(src, "repro_torch/serving/h.py")] \
        == ["A002"] * 4


def test_lint_a003_seam_called_outside_moe():
    src = ("def f(store, t):\n"
           "    return store.read_misses(0, t)\n")
    assert [f.code for f in lint_source(src, "repro_torch/serving/foo.py")] \
        == ["A003"]
    assert lint_source(src, "repro_torch/models/moe.py") == []


def test_lint_a004_tel_mutation_outside_owners():
    src = ("class ExpertStore:\n"
           "    def _bump(self, k, v):\n"
           "        self._tel[k] += v\n"
           "    def reset_stats(self):\n"
           "        self._tel = {}\n"
           "    def rogue(self):\n"
           "        self._tel['h2d_bytes'] += 1\n"
           "        self._tel.clear()\n")
    findings = lint_source(src, "repro_torch/serving/expert_store.py")
    assert [f.code for f in findings] == ["A004", "A004"]
    assert [f.line for f in findings] == [7, 8]


def test_lint_tree_is_clean():
    findings = lint_tree()
    assert findings == [], [str(f) for f in findings]


# ---------------------------------------------------------------------------
# cost checks
# ---------------------------------------------------------------------------

def test_audit_cost_checks_pipelined(params_and_cfg):
    params, cfg = params_and_cfg
    from repro_torch.analysis.cost_audit import audit_costs
    rec = audit_costs(_resolve(params, cfg, "pipelined"))
    assert rec["ok"], rec["violations"]
    # expert bytes exact, and the reference's CostModel agrees
    jcfg = jmake_smoke(jget_config("mixtral-8x7b")).replace(n_layers=2)
    jcfg = jcfg.replace(moe=dataclasses.replace(jcfg.moe, n_routed=4))
    assert rec["store_expert_bytes"] == rec["cm_expert_bytes"] == \
        JCostModel.for_config(jcfg).expert_bytes
    # a stage copies Q x expert_bytes (the reference holds it within 1 %)
    assert rec["stage_h2d"]["drift"] < 0.01
    assert 1 / 8 < rec["flops_ratio"] < 8


@pytest.mark.parametrize("n_routed", [4, 8])
def test_decode_flops_across_offload_modes(n_routed):
    """The slot path's decode FLOPs against the full-resident decode's.  At
    the audit CLI's 8 experts both decode a batch of 2 on the grouped path
    (T K = 4 < E) and agree within the reference's 25 %.  At 4 experts the
    full-resident decode takes the capacity sweep (T K = E: E x C = 16
    rows) while the slot path always runs the 4 activated rows, 35 % fewer
    FLOPs: the check reports that drift (E_COST_DRIFT), as the reference's
    path rule does the same there."""
    from repro_torch.analysis.cost_audit import audit_costs
    cfg = _cfg(n_routed=n_routed)
    params = init_model(cfg, seed=0, device="cpu")
    modeled = audit_costs(_resolve(params, cfg, "modeled"))
    assert modeled["ok"], modeled["violations"]
    rec = audit_costs(_resolve(params, cfg, "pipelined"),
                      reference_flops=modeled["decode_flops"])
    if n_routed == 8:
        assert rec["ok"] and rec["vs_modeled"] <= 0.25, rec["violations"]
    else:
        assert rec["decode_flops"] < modeled["decode_flops"]
        assert [(v["code"], v["entry"]) for v in rec["violations"]] == \
            [("E_COST_DRIFT", "decode_flops[pipelined]")]


# ---------------------------------------------------------------------------
# CLI surface
# ---------------------------------------------------------------------------

def test_audit_cli_lint_only_and_self_test(capsys):
    from repro_torch.analysis.audit import main
    assert main(["--lint-only"]) == 0
    assert "0 finding(s)" in capsys.readouterr().out
    assert main(["--self-test"]) == 0


def test_audit_cli_rejects_unknown_mode():
    from repro_torch.analysis.audit import main
    with pytest.raises(SystemExit):
        main(["--modes", "warp-drive", "--device", "cpu"])
