"""The port's model against the JAX package on the same parameters
(carried over with ``repro_torch.bridge``), on the smoke Mixtral at two
layers, float32, on the CPU.

Tolerance: 3e-5 relative to max |ref| for float32 tensors (the repo's
kernel tolerance, tests/test_kernels.py:17); integers — top-k indices,
workloads, drops, greedy tokens — exactly.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
import repro.models.layers as jlayers
import repro.models.model as jmodel
import repro.models.moe as jmoe
import repro.serving.steps as jsteps
import repro_torch.configs as tconfigs
import repro_torch.models.layers as tlayers
import repro_torch.models.model as tmodel
import repro_torch.models.moe as tmoe
import repro_torch.serving.steps as tsteps
from repro_torch import bridge

F32_TOL = 3e-5
INFO_INT = ("workload", "topk_idx", "dropped")
INFO_FLOAT = ("gates", "probs", "gate_in", "aux_loss", "z_loss")


def _cfgs(**kw):
    j = jconfigs.make_smoke(jconfigs.get_config("mixtral_8x7b")).replace(**kw)
    t = tconfigs.make_smoke(tconfigs.get_config("mixtral_8x7b")).replace(**kw)
    return j, t


def _model(n_layers=2, first_dense=0, seed=0):
    jc, tc = _cfgs(n_layers=n_layers)
    if first_dense:
        jc = jc.replace(moe=dataclasses.replace(jc.moe,
                                                first_dense=first_dense))
        tc = tc.replace(moe=dataclasses.replace(tc.moe,
                                                first_dense=first_dense))
    jp = jmodel.init_model(jax.random.PRNGKey(seed), jc)
    tp = bridge.to_torch(jax.tree.map(np.asarray, jp), "cpu")
    return jc, tc, jp, tp


@pytest.fixture(scope="module")
def mixtral():
    return _model()


def _close(t, j, tol=F32_TOL, what=""):
    t = t.detach().float().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t, np.float32)
    j = np.asarray(j, np.float32)
    assert t.shape == j.shape, (what, t.shape, j.shape)
    err = float(np.abs(t - j).max(initial=0)) / (float(np.abs(j).max(
        initial=0)) + 1e-6)
    assert err < tol, (what, err)


def _same(t, j, what=""):
    np.testing.assert_array_equal(t.numpy(), np.asarray(j), err_msg=what)


def test_configs_are_identical_copies():
    for name in ("mixtral_8x7b",):
        j = jconfigs.get_config(name)
        t = tconfigs.get_config(name)
        assert dataclasses.asdict(j) == dataclasses.asdict(t)
        assert dataclasses.asdict(jconfigs.make_smoke(j)) \
            == dataclasses.asdict(tconfigs.make_smoke(t))


def test_layers_norm_rope_embed_unembed():
    jc, tc = _cfgs(n_layers=1, vocab=300)       # 300 pads to 512 columns
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, jc.d_model)).astype(np.float32)
    w = (rng.standard_normal(jc.d_model) * 0.1).astype(np.float32)
    _close(tlayers.apply_norm({"w": torch.from_numpy(w)},
                              torch.from_numpy(x), tc),
           jlayers.apply_norm({"w": jnp.asarray(w)}, jnp.asarray(x), jc))
    pos = np.array([[0, 3, 7, 100, 4095], [5, 6, 7, 8, 9]], np.int32)
    hd, theta = jc.head_dim(), jc.attn.rope_theta
    c_t, s_t = tlayers.rope_table(torch.from_numpy(pos), hd, theta)
    c_j, s_j = jlayers.rope_table(jnp.asarray(pos), hd, theta)
    _close(c_t, c_j)
    _close(s_t, s_j)
    q = rng.standard_normal((2, 5, 3, hd)).astype(np.float32)
    _close(tlayers.apply_rope(torch.from_numpy(q), c_t, s_t),
           jlayers.apply_rope(jnp.asarray(q), c_j, s_j))
    jp = jlayers.init_embedding(jax.random.PRNGKey(1), jc)
    tp = bridge.to_torch(jax.tree.map(np.asarray, jp), "cpu")
    toks = rng.integers(0, jc.vocab, (2, 5)).astype(np.int32)
    _close(tlayers.embed(tp, torch.from_numpy(toks), tc),
           jlayers.embed(jp, jnp.asarray(toks), jc))
    lt = tlayers.unembed(tp, torch.from_numpy(x), tc)
    lj = jlayers.unembed(jp, jnp.asarray(x), jc)
    assert lt.shape[-1] == 512
    _close(lt[..., :300], np.asarray(lj)[..., :300])
    assert (lt[..., 300:] == -1e30).all()


def _layer(params, i):
    return jax.tree.map(lambda a: a[i], params["scan"][0])


@pytest.mark.parametrize("T,path", [(1, None), (3, "sparse"), (6, None),
                                    (6, "dense"), (40, None)])
def test_apply_moe_matches_reference_on_both_paths(mixtral, T, path):
    jc, tc, jp, tp = mixtral
    mj = _layer(jp, 1)["mlp"]
    mt = {k: v[1] for k, v in tp["scan"][0]["mlp"].items()}
    x = np.random.default_rng(T).standard_normal((1, T, jc.d_model)) \
        .astype(np.float32)
    yj, ij = jax.jit(lambda m, v: jmoe.apply_moe(m, v, jc, force_path=path))(
        mj, jnp.asarray(x))
    yt, it = tmoe.apply_moe(mt, torch.from_numpy(x), tc, force_path=path)
    _close(yt, yj, what="y")
    for k in INFO_INT:
        _same(it[k], ij[k], k)
    for k in INFO_FLOAT:
        _close(it[k], ij[k], what=k)
    # the smoke config (E = 4, k = 2) takes the sparse path at T = 1 only
    assert tmoe.use_sparse_path(tc.moe, T, None) \
        == jmoe.use_sparse_path(jc.moe, T, None) == (T == 1)


def test_apply_moe_with_capacity_drops_like_the_reference(mixtral):
    """Mixtral's own capacity factor (1.25) on skewed routing drops tokens;
    the count of drops and every output must match."""
    jc, tc, jp, tp = mixtral
    m = dataclasses.replace(jc.moe, capacity_factor=1.25)
    jc2, tc2 = jc.replace(moe=m), tc.replace(
        moe=dataclasses.replace(tc.moe, capacity_factor=1.25))
    mj = _layer(jp, 0)["mlp"]
    mt = {k: v[0] for k, v in tp["scan"][0]["mlp"].items()}
    x = np.random.default_rng(7).standard_normal((2, 24, jc.d_model)) \
        .astype(np.float32)
    x += 3 * np.asarray(mj["router"])[:, 1]      # skew towards expert 1
    assert jmoe.expert_capacity(m, 48) == tmoe.expert_capacity(tc2.moe, 48)
    yj, ij = jax.jit(lambda m, v: jmoe.apply_moe(m, v, jc2))(mj,
                                                        jnp.asarray(x))
    yt, it = tmoe.apply_moe(mt, torch.from_numpy(x), tc2)
    assert int(ij["dropped"]) > 0
    _close(yt, yj, what="y")
    for k in INFO_INT:
        _same(it[k], ij[k], k)


def _infos_equal(it, ij, tc, jc):
    for k in INFO_INT + ("gate_in",):
        ft = tmodel.collect_field(it, k)
        fj = jmodel.collect_field(ij, k)
        if k in INFO_INT:
            _same(ft, fj, k)
        else:
            _close(ft, fj, what=k)


@pytest.mark.parametrize("first_dense", [0, 1])
def test_admission_prefill_right_padded(first_dense):
    """A right-padded prompt prefilled into a fresh B=1 cache: logits at
    ``logit_index = length - 1``, the cache where pos >= 0, and every
    routing observable, in the reference's super-block-major order."""
    jc, tc, jp, tp = _model(n_layers=3 if first_dense else 2,
                            first_dense=first_dense, seed=1)
    L, Sb, max_len = 11, 16, 32
    toks = np.zeros((1, Sb), np.int32)
    toks[0, :L] = np.random.default_rng(3).integers(0, jc.vocab, L)
    pos = np.arange(Sb, dtype=np.int32)
    lj, cj, ij = jax.jit(lambda p, t, c: jmodel.apply_model(
        p, t, jc, positions=jnp.asarray(pos), caches=c, trace=True,
        logit_index=L - 1))(jp, jnp.asarray(toks),
                            jmodel.init_caches(jc, 1, max_len))
    lt, ct, it = tmodel.apply_model(
        tp, torch.from_numpy(toks), tc, positions=torch.from_numpy(pos),
        caches=tmodel.init_caches(tc, 1, max_len, device="cpu"), trace=True,
        logit_index=L - 1)
    _close(lt, lj, what="logits")
    assert int(lt.argmax(-1)) == int(jnp.argmax(lj, -1)[0, 0])
    _infos_equal(it, ij, tc, jc)
    assert ct["scan"][0]["k"].shape == cj["scan"][0]["k"].shape
    for group in ("prefix", "scan"):
        for c_t, c_j in zip(ct[group], cj[group]):
            _same(c_t["pos"], c_j["pos"], "pos")
            live = np.asarray(c_j["pos"]) >= 0
            for k in ("k", "v"):
                _close(c_t[k].numpy()[live], np.asarray(c_j[k])[live],
                       what=k)
    np.testing.assert_array_equal(
        tmodel.stack_routers(tp, tc).numpy(),
        np.asarray(jmodel.stack_routers(jp, jc)))


def test_per_slot_decode_with_live_and_dead_slots(mixtral):
    """Admit two prompts of different lengths into slots 0 and 2 of a
    4-slot batch (slots 1 and 3 stay dead), then three per-slot greedy
    decode steps: logits, tokens, caches and routing observables."""
    jc, tc, jp, tp = mixtral
    B, max_len, Sb = 4, 40, 16
    rng = np.random.default_rng(5)
    prompts = {0: rng.integers(0, jc.vocab, 9), 2: rng.integers(0, jc.vocab,
                                                                  14)}
    js = jsteps.init_serve_state(jc, B, max_len, per_slot=True,
                                 policy="none")
    ts = tsteps.init_serve_state(tc, B, max_len, policy="none",
                                 device="cpu", per_slot=True)
    jpre = jax.jit(jsteps.make_admit_prefill(jc))
    jadm = jax.jit(jsteps.make_admit_step(jc))
    tpre = tsteps.make_admit_prefill(tc)
    tadm = tsteps.make_admit_step(tc)
    for slot, pr in prompts.items():
        toks = np.zeros((1, Sb), np.int32)
        toks[0, :len(pr)] = pr
        L = len(pr)
        ftj, fcj = jpre(jp, jnp.asarray(toks),
                        jmodel.init_caches(jc, 1, max_len),
                        jnp.asarray(L, jnp.int32))
        js = jadm(js, fcj, ftj, jnp.asarray(slot, jnp.int32),
                  jnp.asarray(L, jnp.int32))
        ftt, fct = tpre(tp, torch.from_numpy(toks),
                        tmodel.init_caches(tc, 1, max_len, device="cpu"), L)
        ts = tadm(ts, fct, ftt, slot, L)
        assert int(ftt[0, 0]) == int(ftj[0, 0])
    _same(ts["pos"], js["pos"], "pos")
    _same(ts["active"], js["active"], "active")
    jdec = jax.jit(lambda p, t, pos, c: jmodel.apply_model(
        p, t, jc, positions=pos[:, None], caches=c, trace=True))
    for step in range(3):
        lj, cj, ij = jdec(jp, js["tokens"], js["pos"], js["caches"])
        lt, ct, it = tmodel.apply_model(
            tp, ts["tokens"], tc, positions=ts["pos"][:, None],
            caches=ts["caches"], trace=True)
        _close(lt, lj, what=f"logits step {step}")
        _infos_equal(it, ij, tc, jc)
        live = np.asarray(cj["scan"][0]["pos"]) >= 0
        _same(ct["scan"][0]["pos"], cj["scan"][0]["pos"], "pos")
        for k in ("k", "v"):
            _close(ct["scan"][0][k].numpy()[live],
                   np.asarray(cj["scan"][0][k])[live], what=k)
        nj = jnp.argmax(lj[:, -1:], -1).astype(jnp.int32)
        nt = lt[:, -1:].argmax(-1).to(torch.int32)
        _same(nt, nj, "tokens")
        act = js["active"].astype(jnp.int32)
        js = dict(js, tokens=nj, pos=js["pos"] + act, caches=cj)
        ts = dict(ts, tokens=nt, pos=ts["pos"] + ts["active"].int(),
                  caches=ct)
