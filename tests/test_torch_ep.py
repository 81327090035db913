"""The port's expert-parallel MoE (``repro_torch/models/moe_ep.py``) on
gloo ranks on the CPU, float32, against the JAX package's single-device
``apply_moe`` and against the port's own single-rank autograd.

The reference's own EP tests (``test_moe_ep.py``, ``test_moe_ep_ragged.py``,
``test_ep_resilience.py``'s subprocess test) cannot run on the installed
JAX: ``moe_ep.py:457`` reshapes a mesh-sharded array and raises.  So the
oracle here is what those tests compare with: the single-device
``apply_moe`` (outputs within 1e-4, workload exact), at their geometry
(``tests/test_moe_ep_ragged.py:32-68``; ``test_moe_ep.py``'s four
configurations), plus the reference's numpy placement functions called
directly.

Each mesh's ranks are spawned once per module (``launch/mesh.py::
run_ranks``, every spawn with its own timeout, so a hung collective fails
its tests instead of the suite); the rank bodies are in
``_torch_ep_ranks.py``.  Checked:

* mesh (2, 4), each routing kind (uniform, zipf, one expert, a shard with
  no tokens): EP against the single device; the ragged exchange against
  the dense one (1e-6, same workload, no drops); the shipped capacity
  ``ep_cx`` at or under the reference's expectation; ``count_overlap`` on
  against off, bit for bit; gradients through the all_to_all pair, ragged
  against dense (rtol 1e-4, atol 1e-5) and, summed over the ranks,
  against the port's single-rank autograd (same tolerance); the same
  output on every rank; under capacity pressure both exchanges drop the
  same rows;
* mesh (2, 2): ``test_moe_ep.py``'s four configurations (shared experts,
  three router types) against the single device, and ``wmode="fsdp"``
  against "tp", forward (1e-6) and gradients (rtol 1e-4, atol 1e-5);
* mesh (1, 4): a placed exchange bit-equal to the identity placement and
  the plain path, and the demand view;
* the numpy placement functions and the argument errors against the
  reference; ``run_ranks``'s failure contract.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_ep_ranks as R
import repro.core.cost_model as jcost
import repro.models.moe_ep as jep
from repro.models.config import ModelConfig as JConfig
from repro.models.config import MoEConfig as JMoE
from repro.models.moe import apply_moe as japply_moe
from repro.models.moe import init_moe as jinit_moe
import repro_torch.core.cost_model as tcost
import repro_torch.models.moe_ep as tep
from repro_torch.launch import sharding as tshd
from repro_torch.launch.mesh import run_ranks
from repro_torch.models.moe import apply_moe as tapply_moe

B, S, d, E, K = 4, 128, 64, 64, 2
C = (B // 2) * (S // 4)                       # cf=0: per-rank T_my
KINDS = ("uniform", "zipf", "one_expert", "zero_shard")
EXPECT_CX = {"uniform": C // 2, "zipf": C // 2, "one_expert": C,
             "zero_shard": C}
RANK_TIMEOUT = 300
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)


def routed_x(kind, seed=0):
    """The reference's routed inputs (tests/test_moe_ep_ragged.py)."""
    rng = np.random.default_rng(seed)
    T = B * S
    x = 0.05 * rng.standard_normal((T, d))
    if kind == "uniform":
        tgt = rng.integers(0, E, T)
    elif kind == "zipf":
        p = 1.0 / np.arange(1, E + 1) ** 1.2
        tgt = rng.choice(E, size=T, p=p / p.sum())
    elif kind == "one_expert":
        tgt = np.zeros(T, np.int64)
    else:                                     # zero_shard: experts 0/1 on
        tgt = rng.integers(0, 2, T)           # model rank 0; 1..3 get none
        x[:, :2] += 1.5
    x[np.arange(T), tgt] += 3.0
    return x.reshape(B, S, d).astype(np.float32)


def jax_cfg(d, E, K, d_expert, cf, n_shared=0, d_shared=None,
            router_type="topk_softmax"):
    return JConfig(d_model=d, d_ff=128, dtype="float32",
                   param_dtype="float32",
                   moe=JMoE(n_routed=E, top_k=K, d_expert=d_expert,
                            n_shared=n_shared, d_shared=d_shared,
                            router_type=router_type, capacity_factor=cf))


def jax_params(cfg, seed, eye_router=True):
    p = jinit_moe(jax.random.PRNGKey(seed), cfg)
    if eye_router:       # deterministic routing: logit_e = 6 * x[:, e]
        p = dict(p, router=6.0 * jnp.eye(cfg.d_model, cfg.moe.n_routed,
                                         dtype=jnp.float32))
    return jax.tree.map(lambda a: np.asarray(a, np.float32), p)


def jax_reference(params, x, cfg):
    y, info = japply_moe(jax.tree.map(jnp.asarray, params), jnp.asarray(x),
                         cfg)
    return np.asarray(y), np.asarray(info["workload"])


def assemble(runs):
    """The full gradient of one run from its ranks' results: expert slots
    from their model rank, every leaf summed over the ranks (the replicas
    over 'data')."""
    tp = max(r["coord"][1] for r in runs) + 1
    out = {}
    for r in runs:
        j = r["coord"][1]
        for name, g in r["grads"].items():
            if name in R.EXPERT_KEYS:
                full = out.setdefault(name, np.zeros(
                    (g.shape[0] * tp,) + g.shape[1:], np.float32))
                full[j * g.shape[0]:(j + 1) * g.shape[0]] += g
            else:
                out[name] = out.get(name, 0) + g
    return out


def single_rank_grads(params, x, cfg_kw):
    """The port's single-rank autograd of sum(y**2) (no mesh)."""
    p = R._params(params)
    y, _ = tapply_moe(p, torch.tensor(x), R.make_cfg(**cfg_kw))
    (y ** 2).sum().backward()
    return {name: t.grad.numpy() for name, t in R._leaves(p)}


# --------------------------------------------------------------------------
# mesh (2, 4): the reference's ragged-exchange geometry
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def ragged():
    cfg_kw = dict(d=d, E=E, K=K, d_expert=48, cf=0.0)
    cfg_t_kw = dict(cfg_kw, cf=2.0)
    params = jax_params(jax_cfg(**cfg_kw), 0)
    params_t = jax_params(jax_cfg(**cfg_t_kw), 1)
    xs = {k: routed_x(k) for k in KINDS}
    x_t = routed_x("zipf", seed=3)
    ranks = run_ranks(R.ragged_rank, 8, timeout_s=RANK_TIMEOUT,
                      args=(cfg_kw, params, xs, cfg_t_kw, params_t, x_t))
    ref = {k: jax_reference(params, xs[k], jax_cfg(**cfg_kw)) for k in KINDS}
    return dict(ranks=ranks, ref=ref, params=params, xs=xs, cfg_kw=cfg_kw)


def _run(ragged, kind, name, rank=0):
    return ragged["ranks"][rank]["kinds"][kind][name]


@pytest.mark.parametrize("kind", KINDS)
def test_ep_matches_single_device_reference(ragged, kind):
    y_ref, w_ref = ragged["ref"][kind]
    got = _run(ragged, kind, "ragged")
    assert float(np.abs(got["y"] - y_ref).max()) < 1e-4
    np.testing.assert_array_equal(got["workload"], w_ref)


@pytest.mark.parametrize("kind", KINDS)
def test_ep_ragged_equals_dense_exchange(ragged, kind):
    rag, dns = _run(ragged, kind, "ragged"), _run(ragged, kind, "dense")
    assert float(np.abs(rag["y"] - dns["y"]).max()) < 1e-6
    np.testing.assert_array_equal(rag["workload"], dns["workload"])
    assert int(rag["dropped"]) == int(dns["dropped"]) == 0
    assert int(dns["ep_cx"]) == C


@pytest.mark.parametrize("kind", KINDS)
def test_ep_ships_workload_sized_capacity(ragged, kind):
    assert tep.exchange_ladder(C) == jep.exchange_ladder(C)
    cx = int(_run(ragged, kind, "ragged")["ep_cx"])
    assert cx in jep.exchange_ladder(C) and cx <= EXPECT_CX[kind]


@pytest.mark.parametrize("kind", KINDS)
def test_ep_count_overlap_changes_no_bit(ragged, kind):
    for rank in range(8):
        on = _run(ragged, kind, "ragged", rank)
        off = _run(ragged, kind, "sequential", rank)
        np.testing.assert_array_equal(on["y"], off["y"])
        for k in ("ep_cx", "workload", "dropped"):
            np.testing.assert_array_equal(on[k], off[k])
        for name, g in on["grads"].items():
            np.testing.assert_allclose(g, off["grads"][name], rtol=1e-5,
                                       atol=1e-6)


@pytest.mark.parametrize("kind", KINDS)
def test_ep_grads_ragged_match_dense(ragged, kind):
    for rank in range(8):
        rag = _run(ragged, kind, "ragged", rank)["grads"]
        dns = _run(ragged, kind, "dense", rank)["grads"]
        for name, g in rag.items():
            assert np.isfinite(g).all()
            np.testing.assert_allclose(g, dns[name], **GRAD_TOL)


@pytest.mark.parametrize("kind", KINDS)
def test_ep_grads_match_single_rank_autograd(ragged, kind):
    got = assemble([r["kinds"][kind]["ragged"] for r in ragged["ranks"]])
    want = single_rank_grads(ragged["params"], ragged["xs"][kind],
                             ragged["cfg_kw"])
    assert set(got) == set(want)
    for name, g in want.items():
        np.testing.assert_allclose(got[name], g, **GRAD_TOL)


def test_ep_every_rank_holds_the_whole_output(ragged):
    coords = sorted(r["kinds"]["uniform"]["ragged"]["coord"]
                    for r in ragged["ranks"])
    assert coords == [(i, j) for i in range(2) for j in range(4)]
    for kind in KINDS:
        first = _run(ragged, kind, "ragged")
        for rank in range(1, 8):
            other = _run(ragged, kind, "ragged", rank)
            for k in ("y", "workload", "dropped", "ep_cx", "topk_idx",
                      "gates", "aux_loss", "z_loss"):
                np.testing.assert_array_equal(other[k], first[k])
        assert first["topk_idx"].shape == (B * S, K)


def test_ep_capacity_pressure_drops_the_same_rows(ragged):
    pr = ragged["ranks"][0]["pressure"]
    rag, dns, seq = pr["ragged"], pr["dense"], pr["sequential"]
    assert int(rag["dropped"]) == int(dns["dropped"]) > 0
    assert float(np.abs(rag["y"] - dns["y"]).max()) < 1e-6
    np.testing.assert_array_equal(rag["workload"], dns["workload"])
    np.testing.assert_array_equal(rag["y"], seq["y"])
    assert int(rag["dropped"]) == int(seq["dropped"])


# --------------------------------------------------------------------------
# mesh (2, 2): test_moe_ep.py's configurations, tp and fsdp
# --------------------------------------------------------------------------

FSDP_CASES = [(1, "tp", "softmax_topk"), (0, "tp", "topk_softmax"),
              (2, "fsdp", "softmax_topk"), (0, "fsdp", "sigmoid")]


@pytest.fixture(scope="module")
def fsdp():
    x = np.asarray(jax.random.normal(jax.random.PRNGKey(1), (4, 128, 64)),
                   np.float32)
    cases, refs, index = [], [], {}
    for n, (shared, mode, rt) in enumerate(FSDP_CASES):
        cfg_kw = dict(d=64, E=8, K=2, d_expert=96, cf=8.0, n_shared=shared,
                      d_shared=64, router_type=rt)
        jc = jax_cfg(**cfg_kw)
        params = jax_params(jc, 0, eye_router=False)
        refs.append(jax_reference(params, x, jc))
        for wmode in ("tp", "fsdp")[:1 + (mode == "fsdp")]:
            index[n, wmode] = len(cases)
            cases.append((cfg_kw, params, wmode))
    ranks = run_ranks(R.fsdp_rank, 4, timeout_s=RANK_TIMEOUT,
                      args=(cases, x))
    return {key: [r[k] for r in ranks] for key, k in index.items()}, refs


@pytest.mark.parametrize("n", range(len(FSDP_CASES)))
def test_ep_configs_match_single_device_reference(fsdp, n):
    runs, refs = fsdp
    y_ref, w_ref = refs[n]
    for (m, _), ranks in runs.items():
        if m != n:
            continue
        for got in ranks:
            assert float(np.abs(got["y"] - y_ref).max()) < 1e-4
            np.testing.assert_array_equal(got["workload"], w_ref)
            assert all(np.isfinite(g).all() for g in got["grads"].values())


@pytest.mark.parametrize("n", [2, 3])
def test_ep_fsdp_matches_tp(fsdp, n):
    runs, _ = fsdp
    tp_runs, fs_runs = runs[n, "tp"], runs[n, "fsdp"]
    assert float(np.abs(tp_runs[0]["y"] - fs_runs[0]["y"]).max()) < 1e-6
    got, want = assemble(fs_runs), assemble(tp_runs)
    assert set(got) == set(want)
    if FSDP_CASES[n][0]:
        assert any(k.startswith("shared/") for k in got)
    for name, g in want.items():
        np.testing.assert_allclose(got[name], g, **GRAD_TOL)


# --------------------------------------------------------------------------
# mesh (1, 4): placement
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def placed():
    from repro_torch.launch.ep_serve import E as E_BENCH
    from repro_torch.launch.ep_serve import zipf_request
    perm = np.random.default_rng(3).permutation(E_BENCH).astype(np.int32)
    x = zipf_request(4, 160, torch.float32, 11).numpy()
    ranks = run_ranks(R.placement_rank, 4, timeout_s=RANK_TIMEOUT,
                      args=(perm, x))
    return ranks


def test_ep_placed_exchange_bit_exact(placed):
    for r in placed:
        y0 = r["plain"]
        np.testing.assert_array_equal(r["ident_a"][0], r["ident_b"][0])
        np.testing.assert_array_equal(r["ident_a"][0], y0)
        np.testing.assert_array_equal(r["placed"][0], y0)
        np.testing.assert_array_equal(r["placed"][0], placed[0]["plain"])


def test_ep_demand_view_is_logical_demand(placed):
    for r in placed:
        dv, dv_placed = r["ident_a"][1], r["placed"][1]
        assert dv.shape == (4, 64) and dv.dtype == np.int32
        np.testing.assert_array_equal(dv_placed, dv)
        np.testing.assert_array_equal(dv.sum(0), r["ident_a"][2])


# --------------------------------------------------------------------------
# numpy functions, errors, rank processes (no ranks spawned)
# --------------------------------------------------------------------------

def _demands(tp, E_, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 200, (tp, E_)).astype(np.int64)


@pytest.mark.parametrize("spec,tp,E_", [
    ("flat", 4, 16), ("flat,0>3:x8,3>0:x8", 4, 16), ("island:2", 4, 8),
    ("island:4,0>5:x8", 8, 64), ("1>2:g4.0:l250", 4, 32)])
def test_placement_numpy_equals_reference(spec, tp, E_):
    tt = tcost.parse_topology(spec, tp)
    jt = jcost.parse_topology(spec, tp)
    for seed in range(3):
        dem = _demands(tp, E_, seed)
        for demand in (dem, dem.sum(0)):
            pt = tep.solve_placement(demand, tt)
            pj = jep.solve_placement(demand, jt)
            np.testing.assert_array_equal(pt, pj)
            assert pt.dtype == pj.dtype
        for perm in (np.arange(E_), pt,
                     np.random.default_rng(seed).permutation(E_)):
            np.testing.assert_array_equal(
                tep.placement_pair_bytes(dem, perm, 128, 2),
                jep.placement_pair_bytes(dem, perm, 128, 2))
    for c in (4, 5, 64, 96, 512, 2048):
        assert tep.exchange_ladder(c) == jep.exchange_ladder(c)


def test_permute_expert_params_equals_reference():
    cfg_kw = dict(d=16, E=8, K=2, d_expert=32, cf=0.0)
    params = jax_params(jax_cfg(**cfg_kw), 0)
    perm = np.random.default_rng(0).permutation(8)
    got = tep.permute_expert_params(
        {k: torch.tensor(v) for k, v in params.items()}, perm)
    want = jep.permute_expert_params(params, perm)
    for k in params:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


def test_ep_argument_errors_match_reference():
    cfg_kw = dict(d=16, E=8, K=2, d_expert=32, cf=0.0)
    params = jax_params(jax_cfg(**cfg_kw), 0)
    x = np.zeros((2, 4, 16), np.float32)
    tp = {k: torch.tensor(v) for k, v in params.items()}
    for kw in ({"placement": np.arange(8)}, {"demand_view": True}):
        with pytest.raises(ValueError) as ref:
            japply_moe(params, jnp.asarray(x), jax_cfg(**cfg_kw), **kw)
        with pytest.raises(ValueError) as got:
            tapply_moe(tp, torch.tensor(x), R.make_cfg(**cfg_kw), **kw)
        assert str(got.value) == str(ref.value)
    with pytest.raises(ValueError, match="force_exchange") as got:
        tep.apply_moe_ep(tp, torch.tensor(x), R.make_cfg(**cfg_kw),
                         force_exchange="bogus")
    assert str(got.value) == ("force_exchange must be None|'dense'|"
                              "'ragged', got 'bogus'")
    with pytest.raises(ValueError, match="wmode"):
        with tshd.rules(None, wmode="zero"):
            pass


@dataclasses.dataclass
class _StubMesh:
    """The two things ``ep_applicable`` reads of a mesh."""
    shape: tuple
    mesh_dim_names: tuple = ("data", "model")

    def size(self, i):
        return self.shape[i]


@pytest.mark.parametrize("mesh_shape,B_,S_,want", [
    ((2, 4), 4, 128, True), ((2, 4), 4, 4, False), ((2, 4), 3, 128, False),
    ((2, 4), 4, 126, False), ((1, 16), 4, 256, False), ((1, 8), 1, 512,
                                                         True)])
def test_ep_applicable_rules(mesh_shape, B_, S_, want):
    cfg = R.make_cfg(d=16, E=8, K=2, d_expert=32, cf=0.0)
    assert not tep.ep_applicable(cfg, B_, S_)          # no mesh: one device
    with tshd.rules(_StubMesh(mesh_shape)):
        assert tep.ep_applicable(cfg, B_, S_) == want


def test_run_ranks_rejects_nccl_beyond_the_cards():
    with pytest.raises(ValueError, match="one card per rank"):
        run_ranks(R.fail_rank, torch.cuda.device_count() + 1,
                  backend="nccl", device="cuda", args=("none",))
    with pytest.raises(ValueError, match="backend"):
        run_ranks(R.fail_rank, 2, backend="mpi", args=("none",))


@pytest.mark.parametrize("how,timeout_s,match", [
    ("raise", 120, "rank 1 fails on purpose"), ("hang", 8, "did not finish")])
def test_run_ranks_fails_with_a_failing_rank(how, timeout_s, match):
    with pytest.raises(RuntimeError, match=match):
        run_ranks(R.fail_rank, 2, timeout_s=timeout_s, args=(how,))
