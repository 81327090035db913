"""Long prompts in the port: the MoE layer chunked every
``MOE_CHUNK_TOKENS`` tokens under a validity mask, and attention blockwise
from ``BLOCKWISE_KV_THRESHOLD`` keys on, against the JAX package on the
same numpy inputs, on the smoke Mixtral (float32, CPU; parameters and the
initial policy state carried over with ``repro_torch.bridge``).

The thresholds are made small in both packages (``monkeypatch``, as
tests/test_sparse_moe.py:307 does), so a prompt of a few dozen tokens runs
the paths a 20k-token prompt runs on the card.  The reference binds its KV
block into a default argument (1024 keys), so there it stays one block,
while the port's small blocks exercise the online softmax across blocks.

Tolerances: 3e-5 relative to max |ref| for float32 values (the repo's
kernel tolerance, tests/test_kernels.py:17); indices, workloads, drops,
store counters and greedy tokens exactly.  Port against port: the chunked
slot-pool prefill equals the chunked full-resident prefill bit for bit in
every physical mode.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
import repro.models.attention as jattn
import repro.models.model as jmodel
import repro.models.moe as jmoe
import repro.serving.scheduler as jsched
import repro.serving.spec as jspec
import repro.serving.steps as jsteps
import repro.training.train_step as jstep
import repro_torch.configs as tconfigs
import repro_torch.models.attention as tattn
import repro_torch.models.model as tmodel
import repro_torch.models.moe as tmoe
import repro_torch.serving.scheduler as tsched
import repro_torch.serving.spec as tspec
import repro_torch.serving.steps as tsteps
import repro_torch.training.train_step as tstep
from repro_torch import bridge
from repro_torch.data.pipeline import MarkovCorpus, batches
from repro_torch.kernels.flash_attention import ops as fa
from repro_torch.tree import tree_leaves, tree_map

F32_TOL = 3e-5
MODES = ("blocking", "overlap", "pipelined")
NO_EOS = 10_000_000
MAX_LEN = 48
CHUNK = 12                  # MoE chunk: buckets of 16 and 32 leave tails
INFO_INT = ("workload", "topk_idx", "dropped")
INFO_FLOAT = ("gates", "probs", "gate_in", "aux_loss", "z_loss")


def _cfg(mod, n_routed=8):
    cfg = mod.make_smoke(mod.get_config("mixtral_8x7b")).replace(n_layers=2)
    return cfg.replace(moe=dataclasses.replace(cfg.moe, n_routed=n_routed))


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """Torch's many small ops on one thread: under a parallel test run the
    CPU is shared, and torch's own thread pool then slows them down far
    more than it speeds them up."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def model():
    jc, tc = _cfg(jconfigs), _cfg(tconfigs)
    jp = jax.jit(jmodel.init_model, static_argnums=1)(jax.random.PRNGKey(0),
                                                       jc)
    tp = bridge.to_torch(jax.tree.map(np.asarray, jp), "cpu")
    return jc, tc, jp, tp


@pytest.fixture
def small(monkeypatch):
    """Chunk the MoE every ``CHUNK`` tokens and attend blockwise from 16
    keys on, in both packages (the port in blocks of 8 keys and slabs of
    16 queries)."""
    for mod in (jmoe, tmoe):
        monkeypatch.setattr(mod, "MOE_CHUNK_TOKENS", CHUNK)
    monkeypatch.setattr(jattn, "BLOCKWISE_KV_THRESHOLD", 16)
    monkeypatch.setattr(jattn, "BLOCKWISE_Q_CHUNK", 16)
    monkeypatch.setattr(fa, "BLOCKWISE_KV_THRESHOLD", 16)
    monkeypatch.setattr(fa, "BLOCKWISE_KV_BLOCK", 8)
    monkeypatch.setattr(fa, "BLOCKWISE_Q_CHUNK", 16)


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


def _equal_trees(a, b):
    for x, y in zip(tree_leaves(a), tree_leaves(b)):
        assert torch.equal(x, y)


# --------------------------------------------------------------------------
# the chunked MoE layer
# --------------------------------------------------------------------------

@pytest.mark.parametrize("B,S,capacity,masked", [
    (2, 25, None, False),       # 50 tokens: 4 chunks, a ragged tail of 2
    (2, 24, None, False),       # 48 tokens: 4 whole chunks
    (1, 40, 12, True),          # capacity split per chunk, drops, a mask
    (2, 25, None, True)])
def test_apply_moe_chunked_matches_reference(model, small, B, S, capacity,
                                             masked):
    jc, tc, jp, tp = model
    mj = jax.tree.map(lambda a: a[1], jp["scan"][0])["mlp"]
    mt = {k: v[1] for k, v in tp["scan"][0]["mlp"].items()}
    x = np.random.default_rng(S).standard_normal((B, S, jc.d_model)) \
        .astype(np.float32)
    valid = (np.random.default_rng(1).random(B * S) < 0.7) if masked \
        else None
    yj, ij = jax.jit(lambda m, x_, v_: jmoe.apply_moe(
        m, x_, jc, capacity=capacity, valid=v_))(
            mj, jnp.asarray(x), None if valid is None else jnp.asarray(valid))
    yt, it = tmoe.apply_moe(mt, torch.from_numpy(x), tc, capacity=capacity,
                            valid=None if valid is None
                            else torch.from_numpy(valid))
    _close(yt, yj, what="y")
    for k in INFO_INT:
        _same(it[k], ij[k], k)
    for k in INFO_FLOAT:
        _close(it[k], ij[k], what=k)
    assert it["topk_idx"].shape == (B * S, tc.moe.top_k)
    if capacity is not None:
        assert int(it["dropped"]) > 0
    if valid is not None:
        assert int(it["workload"].sum()) == int(valid.sum()) * tc.moe.top_k


def test_chunked_equals_unchunked_at_full_capacity(model, monkeypatch):
    """With "full" capacity no chunk drops, so chunking changes only the
    float order of the aux loss (a weighted sum of per-chunk means) and
    nothing else: outputs, workloads and z loss as the one-chunk run."""
    jc, tc, jp, tp = model
    cfg = tc.replace(moe=dataclasses.replace(tc.moe, capacity_factor=0.0))
    mt = {k: v[0] for k, v in tp["scan"][0]["mlp"].items()}
    x = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (2, 25, cfg.d_model)).astype(np.float32))
    y1, i1 = tmoe.apply_moe(mt, x, cfg)
    monkeypatch.setattr(tmoe, "MOE_CHUNK_TOKENS", 16)
    y2, i2 = tmoe.apply_moe(mt, x, cfg)
    _close(y2, y1.numpy(), what="y")
    assert torch.equal(i1["workload"], i2["workload"])
    assert torch.equal(i1["topk_idx"], i2["topk_idx"])
    assert int(i2["dropped"]) == 0
    _close(i2["z_loss"], i1["z_loss"].numpy(), tol=1e-4)


def test_valid_mask_zeroes_rows_and_counts_nothing(model):
    """A right-padded batch with ``valid`` reproduces the unpadded run on
    every observable, with zero output rows for the padding."""
    _, tc, _, tp = model
    mt = {k: v[0] for k, v in tp["scan"][0]["mlp"].items()}
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (1, 5, tc.d_model)).astype(np.float32))
    pad = torch.cat([x, torch.ones((1, 3, tc.d_model))], dim=1)
    valid = torch.arange(8) < 5
    for path in ("dense", "sparse"):
        y0, i0 = tmoe.apply_moe(mt, x, tc, force_path=path)
        y1, i1 = tmoe.apply_moe(mt, pad, tc, force_path=path, valid=valid)
        _close(y1[:, :5], y0.numpy(), what=path)
        assert not y1[:, 5:].any()
        assert torch.equal(i1["workload"], i0["workload"])
        _close(i1["aux_loss"], i0["aux_loss"].numpy(), what="aux")
        _close(i1["z_loss"], i0["z_loss"].numpy(), what="z")


def test_decode_slot_inputs_above_a_chunk_raise(model, small):
    _, tc, _, tp = model
    x = torch.zeros((1, CHUNK + 1, tc.d_model))
    with pytest.raises(ValueError, match="decode-sized"):
        tmoe.apply_moe({}, x, tc, slots={}, slot_fetch=None)


# --------------------------------------------------------------------------
# blockwise attention
# --------------------------------------------------------------------------

@pytest.mark.parametrize("Sq,Sk,window,softcap", [
    (12, 12, 0, 0.0),           # below the threshold: dense in both
    (40, 40, 0, 0.0),           # prefill: slabs of 16, blocks of 8
    (20, 37, 5, 0.0),           # a window, keys a block does not divide
    (33, 33, 0, 30.0),          # softcap
    (1, 40, 0, 0.0)])           # decode stays dense
def test_mha_across_the_threshold_matches_reference(small, Sq, Sk, window,
                                                    softcap):
    rng = np.random.default_rng(Sq + Sk)
    q = rng.standard_normal((2, Sq, 4, 8)).astype(np.float32)
    k = rng.standard_normal((2, Sk, 2, 8)).astype(np.float32)
    v = rng.standard_normal((2, Sk, 2, 8)).astype(np.float32)
    qp = np.arange(Sk - Sq, Sk, dtype=np.int32)
    kp = np.arange(Sk, dtype=np.int32)
    kw = dict(causal=True, window=window, softcap=softcap, scale=0.3)
    oj = jax.jit(lambda *a: jattn._mha(*a, **kw))(
        *map(jnp.asarray, (q, k, v, qp, kp)))
    ot = tattn._mha(*map(torch.from_numpy, (q, k, v, qp, kp)), **kw)
    _close(ot, oj)
    # K3's plain version takes the same path at the same threshold
    op = fa.flash_attention_plain(*map(torch.from_numpy, (q, k, v)),
                                  causal=True, window=window,
                                  softcap=softcap, scale=0.3)
    _close(op.reshape(2, Sq, -1), oj)


def test_mha_blockwise_per_row_positions_matches_reference(small):
    """Per-row positions with empty (-1) cache slots and values narrower
    than keys (MLA's shape), through the blockwise path directly."""
    rng = np.random.default_rng(9)
    B, Sq, Sk = 2, 20, 30
    q = rng.standard_normal((B, Sq, 4, 12)).astype(np.float32)
    k = rng.standard_normal((B, Sk, 4, 12)).astype(np.float32)
    v = rng.standard_normal((B, Sk, 4, 8)).astype(np.float32)
    kp = np.tile(np.arange(Sk, dtype=np.int32), (B, 1))
    kp[1, 25:] = -1
    qp = np.tile(np.arange(10, 30, dtype=np.int32), (B, 1))
    kw = dict(causal=True, window=0, softcap=0.0, scale=0.25)
    oj = jax.jit(lambda *a: jattn._mha_blockwise(*a, **kw))(
        *map(jnp.asarray, (q, k, v, qp, kp)))
    ot = fa.mha_blockwise(*map(torch.from_numpy, (q, k, v, qp, kp)), **kw)
    assert ot.shape == (B, Sq, 4 * 8)
    _close(ot, oj)


# --------------------------------------------------------------------------
# servers past the chunk size
# --------------------------------------------------------------------------

class _Carried:
    """The port's policy started from a carried-over reference state."""
    schedules = True

    def __init__(self, policy, state):
        self.policy, self.state, self.dcfg = policy, state, policy.dcfg

    def init(self, seed=0, device="cpu"):
        return tree_map(torch.clone, self.state)

    def step(self, state, workloads, obs):
        return self.policy.step(state, workloads, obs)


PROMPTS = [(20, 5), (9, 4), (27, 6), (14, 3)]


def _resolved(model, server, batch, mode="modeled", prefill_rows=None):
    """The reference's and the port's resolved specs over the same weights
    and the same initial policy state."""
    jc, tc, jp, tp = model
    kw = dict(batch_size=batch, max_len=MAX_LEN, eos_id=NO_EOS,
              server=server)
    jres = jspec.ServeSpec(
        cfg=jc, policy="dali",
        dali_cfg=jsteps.default_dali_config(jc, cache_ratio=0.25),
        offload=jspec.OffloadSpec(mode=mode, prefill_rows=prefill_rows),
        **kw).resolve(jp)
    carried = bridge.to_torch(jax.tree.map(np.asarray, jres.policy.init()),
                              "cpu")
    tpol = tsteps.resolve_policy(
        "dali", tc, tsteps.default_dali_config(tc, cache_ratio=0.25))
    tres = tspec.ServeSpec(
        cfg=tc, policy=_Carried(tpol, carried), device="cpu",
        offload=tspec.OffloadSpec(mode=mode, prefill_rows=prefill_rows),
        **kw).resolve(tp)
    return jres, tres


@pytest.mark.parametrize("server,batch", [("continuous", 2), ("wave", 4)])
def test_servers_past_the_chunk_size_match_reference(model, small, server,
                                                     batch):
    """The continuous server's admissions (buckets of 16 and 32 tokens:
    two and three MoE chunks, each with a ragged tail, and blockwise
    attention) and the wave server's one prefill of 4 x 32 tokens (11
    chunks) give the reference's tokens and DALI counters."""
    jres, tres = _resolved(model, server, batch)
    d = model[0].d_model
    res = (np.random.default_rng(1).standard_normal((2, d)) * 0.1
           ).astype(np.float32)
    js, ts = jres.server(res_vecs=jnp.asarray(res)), tres.server(
        res_vecs=res)
    rng = np.random.default_rng(4)
    for i, (n, m) in enumerate(PROMPTS):
        p = rng.integers(0, 256, n).astype(np.int32)
        js.submit(jsched.Request(rid=i, prompt=p, max_new_tokens=m))
        ts.submit(tsched.Request(rid=i, prompt=p, max_new_tokens=m))
    dj = {r.rid: r.output for r in js.run()}
    dt = {r.rid: r.output for r in ts.run()}
    assert dt == dj
    mt, mj = ts.metrics, js.metrics
    assert mt.prefill_tokens == mj.prefill_tokens > CHUNK
    for k in ("steps", "hits", "misses", "swaps"):
        assert getattr(mt.dali, k) == getattr(mj.dali, k), k


# --------------------------------------------------------------------------
# the chunked slot-pool prefill
# --------------------------------------------------------------------------

def _admission(tc, Sb=32, L=27, seed=5):
    toks = np.zeros((1, Sb), np.int32)
    toks[0, :L] = np.random.default_rng(seed).integers(1, tc.vocab, L)
    return toks, L


@pytest.mark.parametrize("mode", MODES)
def test_chunked_admit_prefill_slot_path_bit_equal(model, small, mode):
    """A 32-token admission (3 chunks, the last with 8 pad rows) through
    the slot pool in 2-expert waves equals the full-resident admission
    bit for bit: tokens and every cache leaf."""
    _, tc, _, tp = model
    toks, L = _admission(tc)
    t = torch.from_numpy(toks)
    ref_tok, ref_caches = tsteps.make_admit_prefill(tc)(
        tp, t, tmodel.init_caches(tc, 1, MAX_LEN, device="cpu"), L)
    _, tres = _resolved(model, "continuous", 1, mode, prefill_rows=2)
    assert "gate" not in tres.params["scan"][0]["mlp"]       # stripped
    off = tres.init_state(batch=1)["offload"]
    tok, caches = tres.admit_prefill()(
        tres.params, t, tmodel.init_caches(tc, 1, MAX_LEN, device="cpu"), L,
        off)
    assert torch.equal(ref_tok, tok)
    _equal_trees(ref_caches, caches)
    st = tres.store.stats()
    assert st["prefill_miss_reads"] == 3 * tres.store.n_layers
    assert st["prefill_waves"] > 0 and st["miss_reads"] == 0


def test_chunked_prefill_counts_waves_per_chunk_as_reference(model, small):
    """Each chunk derives its own activated set and streams its own waves:
    the wave prefill (2 x 20 tokens: 4 chunks, a tail of 4) and the
    admission (3 chunks) count the reference store's prefill rows and
    waves exactly, and give its tokens."""
    jc, tc, jp, tp = model
    jres, tres = _resolved(model, "continuous", 2, "pipelined",
                           prefill_rows=2)
    joff = jres.init_state(batch=2)["offload"]
    toff = tres.init_state(batch=2)["offload"]
    wave = np.random.default_rng(8).integers(1, jc.vocab, (2, 20)) \
        .astype(np.int32)
    jt, _ = jax.jit(jres.prefill_step())(
        jres.params, jnp.asarray(wave), jmodel.init_caches(jc, 2, MAX_LEN),
        None, joff)
    tt, _ = tres.prefill_step()(
        tres.params, torch.from_numpy(wave),
        tmodel.init_caches(tc, 2, MAX_LEN, device="cpu"), toff)
    _same(tt, jt, "wave tokens")
    toks, L = _admission(tc)
    jt, _ = jax.jit(jres.admit_prefill())(
        jres.params, jnp.asarray(toks), jmodel.init_caches(jc, 1, MAX_LEN),
        L, joff)
    tt, _ = tres.admit_prefill()(
        tres.params, torch.from_numpy(toks),
        tmodel.init_caches(tc, 1, MAX_LEN, device="cpu"), L, toff)
    _same(tt, jt, "admission tokens")
    sj, st = jres.store.stats(), tres.store.stats()
    for k in ("prefill_fetch_rows", "prefill_waves", "prefill_host_rows"):
        assert st[k] == sj[k], k
    assert st["prefill_waves"] > 2 * tres.store.n_layers


# --------------------------------------------------------------------------
# training past the chunk size
# --------------------------------------------------------------------------

def test_training_loss_and_gradients_past_the_chunk_size(model, small):
    """Batch 2 x 16 = 32 tokens: three MoE chunks (a tail of 8) and
    blockwise attention; the loss terms within 3e-5 and every gradient
    leaf within 3e-5 of its own max |g|, drops exactly."""
    jc, tc, jp, tp = model
    b = next(iter(batches(MarkovCorpus(vocab=tc.vocab, seed=2), 2, 16, 1,
                          seed=2)))
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    tb = {k: torch.as_tensor(v) for k, v in b.items()}
    (_, jm), jg = jax.jit(jax.value_and_grad(jstep.make_loss_fn(jc),
                                             has_aux=True))(jp, jb)
    (_, tm), tg = tstep.value_and_grad(tstep.make_loss_fn(tc), tp, tb)
    for k in ("loss", "ce", "aux", "router_z"):
        _close(tm[k], jm[k], what=k)
    assert int(tm["dropped"]) == int(jm["dropped"])
    ft = bridge.flatten(tg)
    fj = bridge.flatten(jax.tree.map(np.asarray, jg))
    assert ft.keys() == fj.keys()
    for k in ft:
        _close(ft[k], fj[k], what=k)
