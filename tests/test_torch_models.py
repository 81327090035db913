"""The paper's other two evaluation models in the port, Qwen3-30B-A3B
(qk-norm, 128 experts top-8) and DeepSeek-V2-Lite (MLA, a dense first
layer, shared experts), against the JAX package on their smoke configs
(float32, CPU), parameters carried over with ``repro_torch.bridge``.

Tolerances: 3e-5 relative to max |ref| for float32 tensors (the repo's
kernel tolerance, tests/test_kernels.py:17; each gradient leaf relative to
its own max |g|); routing ids, drops and greedy tokens exactly; the port's
offloaded serve equals its own full-resident serve bit for bit.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
import repro.core.tracing as jtracing
import repro.models.attention as jattn
import repro.models.blocks as jblocks
import repro.models.layers as jlayers
import repro.models.model as jmodel
import repro.models.moe as jmoe
import repro.serving.scheduler as jsched
import repro.serving.spec as jspec
import repro.serving.steps as jsteps
import repro.training.train_step as jstep
import repro_torch.bridge as tbridge
import repro_torch.configs as tconfigs
import repro_torch.core.tracing as ttracing
import repro_torch.models.attention as tattn
import repro_torch.models.blocks as tblocks
import repro_torch.models.layers as tlayers
import repro_torch.models.model as tmodel
import repro_torch.models.moe as tmoe
import repro_torch.serving.scheduler as tsched
import repro_torch.serving.spec as tspec
import repro_torch.serving.steps as tsteps
import repro_torch.training.train_step as tstep
from repro.kernels.flash_attention.kernel import flash_attention as jflash
from repro.kernels.flash_attention.ref import flash_attention_ref
from repro_torch import bridge, kernels
from repro_torch.kernels.flash_attention.ops import flash_attention_plain
from repro_torch.tree import tree_leaves, tree_map, tree_map_with_path

F32_TOL = 3e-5
ARCHS = ("qwen3_30b_a3b", "deepseek_v2_lite_16b")
# two MoE layers each: Qwen3 two scanned blocks, DeepSeek its dense prefix
# block then two scanned MoE blocks
LAYERS = {"qwen3_30b_a3b": 2, "deepseek_v2_lite_16b": 3}
INFO_INT = ("workload", "topk_idx", "dropped")
NO_EOS = 10_000_000


def _cfgs(arch, **kw):
    j = jconfigs.make_smoke(jconfigs.get_config(arch)).replace(**kw)
    t = tconfigs.make_smoke(tconfigs.get_config(arch)).replace(**kw)
    return j, t


def _carry(tree):
    return bridge.to_torch(jax.tree.map(np.asarray, tree), "cpu")


@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    arch = request.param
    jc, tc = _cfgs(arch, n_layers=LAYERS[arch])
    jp = jmodel.init_model(jax.random.PRNGKey(0), jc)
    return jc, tc, jp, _carry(jp)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """Torch's many small ops on one thread: under a parallel test run the
    CPU is shared, and torch's own thread pool then slows them down."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rel(t, j):
    t = t.detach().float().numpy() if torch.is_tensor(t) \
        else np.asarray(t, np.float32)
    j = np.asarray(j, np.float32)
    assert t.shape == j.shape, (t.shape, j.shape)
    return float(np.abs(t - j).max(initial=0)) / (
        float(np.abs(j).max(initial=0)) + 1e-30)


def _close(t, j, what=""):
    assert _rel(t, j) < F32_TOL, what


def _same(t, j, what=""):
    np.testing.assert_array_equal(t.numpy(), np.asarray(j), err_msg=what)


def _x(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape) \
        .astype(np.float32)


# --------------------------------------------------------------------------
# configs, norms
# --------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_configs_and_smoke_configs_equal_the_reference(arch):
    j, t = jconfigs.get_config(arch), tconfigs.get_config(arch)
    assert dataclasses.asdict(j) == dataclasses.asdict(t)
    js, ts = jconfigs.make_smoke(j), tconfigs.make_smoke(t)
    assert dataclasses.asdict(js) == dataclasses.asdict(ts)
    if arch == "deepseek_v2_lite_16b":
        assert ts.attn.mla == tconfigs.MLAConfig(64, 0, 32, 16, 32)
        assert ts.moe.first_dense == 1 and ts.n_layers == 2
    assert tconfigs.canonical(t.name) in tconfigs.ARCHS


def test_rms_norm_vec_matches_reference():
    x = _x((2, 5, 3, 48), 0)
    w = _x((48,), 1) * 0.1
    _close(tlayers.rms_norm_vec(torch.from_numpy(w), torch.from_numpy(x)),
           jlayers.rms_norm_vec(jnp.asarray(w), jnp.asarray(x)))


# --------------------------------------------------------------------------
# attention: qk-norm GQA and MLA
# --------------------------------------------------------------------------

def _attn_params(jc, seed):
    jp = jattn.init_attention(jax.random.PRNGKey(seed), jc)
    # non-zero norm weights so that they matter
    jp = {k: (v + 0.1 * jnp.asarray(_x(v.shape, seed + 7))
              if k.endswith("norm") else v) for k, v in jp.items()}
    return jp, _carry(jp)


def _attend(mod, cfg, p, x, pos, cache):
    if cfg.attn.mla is not None:
        return mod.mla_attention(p, x, cfg, positions=pos, cache=cache)
    return mod.gqa_attention(p, x, cfg, kind="attn", positions=pos,
                             cache=cache)


def _mla_cfgs(absorbed=True, q_lora=0):
    jc, tc = _cfgs("deepseek_v2_lite_16b")
    fix = lambda c: c.replace(attn=dataclasses.replace(
        c.attn, mla=dataclasses.replace(c.attn.mla, absorbed_decode=absorbed,
                                        q_lora_rank=q_lora)))
    return fix(jc), fix(tc)


ATTN_CASES = {
    "qk_norm": lambda: _cfgs("qwen3_30b_a3b"),
    "mla_absorbed": lambda: _mla_cfgs(True),
    "mla_naive": lambda: _mla_cfgs(False),
    "mla_q_lora": lambda: _mla_cfgs(True, q_lora=32),
}


@pytest.mark.parametrize("case", sorted(ATTN_CASES))
def test_attention_prefill_and_cached_decode_match_reference(case):
    """No cache; then a prefill into a cache and three decode steps: per
    slot at one position, per slot at different positions (row 1 skips two
    slots, which stay empty) and shared by the batch.  Outputs and the
    cache (latents for MLA) within 3e-5, positions exactly."""
    jc, tc = ATTN_CASES[case]()
    jp, tp = _attn_params(jc, 3)
    B, S, max_len = 2, 10, 16
    x = _x((B, S, jc.d_model), 4)
    pos = np.arange(S, dtype=np.int32)
    yj, _ = _attend(jattn, jc, jp, jnp.asarray(x), jnp.asarray(pos), None)
    yt, _ = _attend(tattn, tc, tp, torch.from_numpy(x),
                    torch.from_numpy(pos), None)
    _close(yt, yj, "no cache")
    kinds = ("attn", "moe")
    cj = jblocks.init_block_cache(jc, kinds, B, max_len)
    ct = tblocks.init_block_cache(tc, kinds, B, max_len, "cpu")
    assert set(ct) == set(cj)
    steps = [(x, pos),
             (_x((B, 1, jc.d_model), 5), np.array([[10], [10]], np.int32)),
             (_x((B, 1, jc.d_model), 6), np.array([[11], [13]], np.int32)),
             (_x((B, 1, jc.d_model), 7), np.array([14], np.int32))]
    for i, (xi, pi) in enumerate(steps):
        yj, cj = _attend(jattn, jc, jp, jnp.asarray(xi), jnp.asarray(pi), cj)
        yt, ct = _attend(tattn, tc, tp, torch.from_numpy(xi),
                         torch.from_numpy(pi), ct)
        _close(yt, yj, f"step {i}")
        _same(ct["pos"], cj["pos"], f"pos step {i}")
        for k in ct:
            if k != "pos":
                _close(ct[k], cj[k], f"cache {k} step {i}")


def test_mla_prefill_runs_k3_at_the_padded_head_width(monkeypatch):
    """MLA's prefill attends through the flash-attention wrapper at q/k
    width qk_nope + qk_rope with the values zero-padded to it; its output
    columns past v_head_dim are zero and dropped."""
    jc, tc = _mla_cfgs()
    _, tp = _attn_params(jc, 3)
    calls = []
    real = tattn.flash_attention

    def spy(q, k, v, **kw):
        o = real(q, k, v, **kw)
        calls.append((q.shape, k.shape, v.shape, o))
        return o

    monkeypatch.setattr(tattn, "flash_attention", spy)
    x = torch.from_numpy(_x((1, 12, tc.d_model), 8))
    tattn.mla_attention(tp, x, tc, positions=torch.arange(12))
    m = tc.attn.mla
    D = m.qk_nope_head_dim + m.qk_rope_head_dim
    (qs, ks, vs, o), = calls
    assert qs == ks == vs == (1, 12, tc.attn.n_heads, D)
    assert not bool(o[..., m.v_head_dim:].abs().sum())


def test_k3_plain_at_mla_width_matches_reference_and_pallas():
    """K3's plain version at D = 192 (MLA's q/k width) with the 128-wide
    values zero-padded and the output sliced back, against the JAX oracle
    and the Pallas kernel in interpret mode."""
    B, S, H, D, vd = 1, 128, 4, 192, 128
    q, k = _x((B, S, H, D), 9), _x((B, S, H, D), 10)
    v = np.concatenate([_x((B, S, H, vd), 11),
                        np.zeros((B, S, H, D - vd), np.float32)], -1)
    ot = flash_attention_plain(*map(torch.from_numpy, (q, k, v)),
                               causal=True)[..., :vd]
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    _close(ot, flash_attention_ref(jq, jk, jv, causal=True)[..., :vd])
    _close(ot, jflash(jq, jk, jv, causal=True, block_q=64, block_k=64,
                      interpret=True)[..., :vd])


# --------------------------------------------------------------------------
# MoE: shared experts, routers at the new widths
# --------------------------------------------------------------------------

@pytest.mark.parametrize("E,K", [(64, 6), (128, 8)])
def test_route_at_the_new_router_widths_matches_reference(E, K):
    """softmax then top-k, renormalised once (+1e-9) as the reference's
    ``route``: exact ids, gates and probs within 3e-5."""
    m = tconfigs.get_config("qwen3_30b_a3b").moe
    mt = dataclasses.replace(m, n_routed=E, top_k=K)
    mj = dataclasses.replace(jconfigs.get_config("qwen3_30b_a3b").moe,
                             n_routed=E, top_k=K)
    x, w = _x((40, 64), E), _x((64, E), K)
    gt, it, pt, _ = tmoe.route({"router": torch.from_numpy(w)},
                               torch.from_numpy(x), mt)
    gj, ij, pj, _ = jmoe.route({"router": jnp.asarray(w)}, jnp.asarray(x),
                               mj)
    _same(it, ij, "idx")
    _close(gt, gj, "gates")
    _close(pt, pj, "probs")
    assert torch.allclose(gt.sum(-1), torch.ones(40), atol=1e-6)


@pytest.mark.parametrize("T,path", [(1, None), (6, "sparse"), (6, None),
                                    (24, "dense")])
def test_apply_moe_with_shared_experts_matches_reference(T, path):
    """DeepSeek-V2-Lite's MoE layer (2 routed of 4 plus the shared FFN) on
    the sparse grouped path and the capacity sweep."""
    jc, tc = _cfgs("deepseek_v2_lite_16b")
    jp = jmoe.init_moe(jax.random.PRNGKey(2), jc)
    tp = _carry(jp)
    assert set(tp["shared"]) == {"gate", "up", "down"}
    x = _x((1, T, jc.d_model), T)
    yj, ij = jmoe.apply_moe(jp, jnp.asarray(x), jc, force_path=path)
    yt, it = tmoe.apply_moe(tp, torch.from_numpy(x), tc, force_path=path)
    _close(yt, yj, "y")
    for k in INFO_INT:
        _same(it[k], ij[k], k)
    for k in ("gates", "probs", "aux_loss", "z_loss"):
        _close(it[k], ij[k], k)
    # without the shared FFN the output moves: it is on every path
    tp0 = dict(tp, shared={k: torch.zeros_like(v)
                           for k, v in tp["shared"].items()})
    y0, _ = tmoe.apply_moe(tp0, torch.from_numpy(x), tc, force_path=path)
    assert not torch.equal(y0, yt)


# --------------------------------------------------------------------------
# R1: which leaves are routed expert stacks
# --------------------------------------------------------------------------

def _expert_paths(params, cfg):
    out = []
    tree_map_with_path(lambda p, t: out.append(p)
                       if tmoe.is_expert_leaf(p, cfg) else None, params)
    return sorted(out, key=str)


def test_expert_leaves_are_only_the_routed_stacks_of_moe_blocks():
    """DeepSeek-V2-Lite's tree: the dense prefix block's FFN has the same
    keys (``prefix[0]/mlp/{gate,up,down}``) as a routed stack, and the
    shared experts sit under ``mlp/shared``; only the MoE blocks' routed
    stacks are expert leaves."""
    _, tc = _cfgs("deepseek_v2_lite_16b", n_layers=3)
    tp = tmodel.init_model(tc, seed=0, device="cpu")
    assert set(tp["prefix"][0]["mlp"]) == {"gate", "up", "down"}
    assert set(tp["scan"][0]["mlp"]["shared"]) == {"gate", "up", "down"}
    assert _expert_paths(tp, tc) == sorted(
        [("scan", 0, "mlp", k) for k in ("gate", "up", "down")], key=str)
    for path in (("prefix", 0, "mlp", "gate"),
                 ("scan", 0, "mlp", "shared", "gate"),
                 ("scan", 0, "mlp", "router"), ("mlp", "gate")):
        assert not tmoe.is_expert_leaf(path, tc), path
    # a Mixtral layout (no prefix): every MoE block's stacks
    _, mc = _cfgs("mixtral_8x7b", n_layers=2)
    mp = tmodel.init_model(mc, seed=0, device="cpu")
    assert _expert_paths(mp, mc) == sorted(
        [("scan", 0, "mlp", k) for k in ("gate", "up", "down")], key=str)


@pytest.mark.parametrize("how", ["to_torch", "load_npz", "init_model",
                                 "experts_to_host"])
def test_host_placement_moves_exactly_the_expert_leaves(how, monkeypatch,
                                                        tmp_path):
    """With ``experts="host"`` each entry point puts into host memory
    (``host_empty``) exactly the leaves the predicate marks: the dense
    prefix FFN and the shared experts stay on the device."""
    jc, tc = _cfgs("deepseek_v2_lite_16b", n_layers=3)
    made = set()

    def tagged(shape, dtype, device):
        t = torch.empty(shape, dtype=dtype)
        made.add(t.data_ptr())
        return t

    monkeypatch.setattr(tbridge, "host_empty", tagged)
    monkeypatch.setattr(tmodel, "host_empty", tagged)
    if how in ("to_torch", "load_npz"):
        jp = jax.tree.map(np.asarray,
                          jmodel.init_model(jax.random.PRNGKey(0), jc))
        if how == "to_torch":
            tp = bridge.to_torch(jp, "cpu", experts="host", cfg=tc)
        else:
            bridge.save_npz(tmp_path / "w.npz", jp)
            tp = bridge.load_npz(tmp_path / "w.npz", device="cpu",
                                 experts="host", cfg=tc)
        with pytest.raises(ValueError, match="cfg"):
            bridge.to_torch(jp, "cpu", experts="host")
    elif how == "init_model":
        tp = tmodel.init_model(tc, seed=0, device="cpu", experts="host")
    else:
        tp = tmodel.experts_to_host(
            tmodel.init_model(tc, seed=0, device="cpu"), tc, "cpu")
    on_host = []
    tree_map_with_path(lambda p, t: on_host.append(p)
                       if t.data_ptr() in made else None, tp)
    assert sorted(on_host, key=str) == _expert_paths(tp, tc)
    assert len(on_host) == 3


# --------------------------------------------------------------------------
# whole models, servers, offload, training
# --------------------------------------------------------------------------

def test_apply_model_logits_and_policy_observations_match(model):
    jc, tc, jp, tp = model
    toks = np.random.default_rng(3).integers(0, jc.vocab, (2, 12)) \
        .astype(np.int32)
    lj, _, ij = jmodel.apply_model(jp, jnp.asarray(toks), jc, trace=True)
    lt, _, it = tmodel.apply_model(tp, torch.from_numpy(toks), tc,
                                   trace=True)
    _close(lt, lj, "logits")
    wj, oj = jmodel.collect_policy_obs(jp, ij, jc)
    wt, ot = tmodel.collect_policy_obs(tp, it, tc)
    n_moe = 2
    assert wt.shape[0] == ot.routers.shape[0] == n_moe
    _same(wt, wj, "workloads")
    _close(ot.gate_in, oj.gate_in, "gate_in")
    _same(ot.routers, oj.routers, "routers")
    for k in INFO_INT:
        _same(tmodel.collect_field(it, k), jmodel.collect_field(ij, k), k)
    # the decode trace the residual vectors are calibrated from skips the
    # dense prefix layer as the reference's does
    jtr = jtracing.capture_decode_trace(jp, jc, jnp.asarray(toks[:, :8]),
                                        n_decode=3)
    ttr = ttracing.capture_decode_trace(tp, tc, toks[:, :8], n_decode=3,
                                        device="cpu")
    assert ttr.n_moe_layers == jtr.n_moe_layers == n_moe
    for s in range(3):
        for layer in range(n_moe):
            np.testing.assert_array_equal(ttr.workload[s][layer],
                                          jtr.workload[s][layer])


class _Carried:
    """The port's policy started from a carried-over reference state."""
    schedules = True

    def __init__(self, policy, state):
        self.policy, self.state = policy, state

    def init(self, seed=0, device="cpu"):
        return tree_map(torch.clone, self.state)

    def step(self, state, workloads, obs):
        return self.policy.step(state, workloads, obs)


PROMPTS = [(5, 6), (12, 4), (20, 8), (9, 5)]


def _requests(mod, vocab):
    rng = np.random.default_rng(11)
    return [mod.Request(rid=i, prompt=rng.integers(0, vocab, n)
                        .astype(np.int32), max_new_tokens=m)
            for i, (n, m) in enumerate(PROMPTS)]


@pytest.mark.parametrize("server", ["continuous", "wave"])
def test_servers_give_the_reference_servers_tokens(model, server):
    """The same weights, initial DALI state, residual vectors and requests
    through the JAX server and the port's: identical greedy tokens and
    DALI counters.  Batch 2: the continuous server decodes on the sparse
    grouped path only when one slot is live (T * k * 4 < E * 4 needs T <
    2 at E = 4, k = 2), so both paths run."""
    jc, tc, jp, tp = model
    res = (_x((2, jc.d_model), 1) * 0.1).astype(np.float32)
    kw = dict(batch_size=2, max_len=48, eos_id=NO_EOS, server=server)
    jres = jspec.ServeSpec(
        cfg=jc, policy="dali",
        dali_cfg=jsteps.default_dali_config(jc, cache_ratio=0.5),
        **kw).resolve(jp)
    tpol = tsteps.resolve_policy(
        "dali", tc, tsteps.default_dali_config(tc, cache_ratio=0.5))
    tres = tspec.ServeSpec(cfg=tc, policy=_Carried(tpol, _carry(
        jres.policy.init())), device="cpu", **kw).resolve(tp)
    js = jres.server(res_vecs=jnp.asarray(res))
    ts = tres.server(res_vecs=res)
    for r in _requests(jsched, jc.vocab):
        js.submit(r)
    for r in _requests(tsched, tc.vocab):
        ts.submit(r)
    kernels.reset_launch_counts()
    dj = {r.rid: r.output for r in js.run()}
    dt = {r.rid: r.output for r in ts.run()}
    assert kernels.launch_counts() == {k: 0 for k in kernels.LAUNCHES}
    assert dt == dj
    assert [len(dt[i]) for i in range(len(PROMPTS))] == [m for _, m in
                                                         PROMPTS]
    for k in ("steps", "hits", "misses", "swaps"):
        assert getattr(ts.metrics.dali, k) == getattr(js.metrics.dali, k), k


@pytest.mark.parametrize("server", ["continuous", "wave"])
def test_pipelined_offload_equals_full_resident(model, server):
    """The port's ``pipelined`` slot pool (stripped params, prefill sweeps
    streamed, decode misses fetched) gives its full-resident tokens; the
    dense prefix block and the shared experts stay in the params the
    server reads."""
    _, tc, _, tp = model

    def serve(mode):
        spec = tspec.ServeSpec(cfg=tc, server=server, policy="dali",
                               batch_size=2, max_len=48, eos_id=NO_EOS,
                               offload=tspec.OffloadSpec(mode=mode),
                               device="cpu")
        rs = spec.resolve(tp)
        srv = rs.server()
        for r in _requests(tsched, tc.vocab):
            srv.submit(r)
        return rs, srv, {r.rid: r.output for r in srv.run()}

    _, _, ref = serve("modeled")
    rs, srv, got = serve("pipelined")
    assert got == ref
    st = srv.store.stats()
    assert st["miss_reads"] > 0 and st["prefill_miss_reads"] > 0
    assert srv.store.n_layers == 2
    slim = rs.params
    if tc.moe.first_dense:
        assert set(slim["prefix"][0]["mlp"]) == {"gate", "up", "down"}
        assert "shared" in slim["scan"][0]["mlp"]
    assert not {"gate", "up", "down"} & set(slim["scan"][0]["mlp"]) - {
        "shared"}


def test_one_training_step_gradients_match_reference(model):
    jc, tc, jp, tp = model
    from repro_torch.data.pipeline import MarkovCorpus, batches
    b = next(iter(batches(MarkovCorpus(vocab=jc.vocab, seed=0), 2, 24, 1,
                          seed=0)))
    (jl, jm), jg = jax.value_and_grad(jstep.make_loss_fn(jc), has_aux=True)(
        jp, {k: jnp.asarray(v) for k, v in b.items()})
    (tl, tm), tg = tstep.value_and_grad(
        tstep.make_loss_fn(tc), tp, {k: torch.as_tensor(v)
                                     for k, v in b.items()})
    _close(tl, jl, "loss")
    for k in ("ce", "aux", "router_z"):
        _close(tm[k], jm[k], k)
    assert int(tm["dropped"]) == int(jm["dropped"])
    ft, fj = bridge.flatten(tg), bridge.flatten(jax.tree.map(np.asarray, jg))
    assert ft.keys() == fj.keys()
    for k in ft:
        _close(ft[k], fj[k], k)
    assert all(float(g.abs().max()) > 0 for g in tree_leaves(tg))
