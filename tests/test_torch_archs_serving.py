"""The new architectures through the port's servers and cross-attention
pieces, against the JAX package where the two packages agree, and port
against port where the reference has no counterpart (float32, CPU, the
reference's parameters carried over by ``repro_torch.bridge``):

* greedy tokens equal the JAX servers': Gemma-2 continuous (prompts at or
  under the window, or a multiple of it: the reference's rolling-cache
  write is wrong for the others, see the ring tests below), Jamba and
  Mamba-2 through the wave server, OLMo without the DALI engine;
* offloaded serves equal the port's full-resident ones bit for bit: Jamba
  (four MoE layers between Mamba layers) and Llama-4 (a sigmoid top-1
  router and a shared expert);
* the continuous server refuses SSM and hybrid archs, as the reference's;
* ``build_cross_kv``, ``cross_attention``, ``apply_encoder`` and the gated
  FFN of a VLM cross layer equal the reference's within 3e-5;
* the ring repair: after a prompt longer than the sliding window whose
  length the window does not divide, the port's decode equals its own
  full recompute within 3e-5.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
import repro.models.attention as jattn
import repro.models.blocks as jblocks
import repro.models.model as jmodel
import repro.serving.scheduler as jsched
import repro.serving.spec as jspec
import repro.serving.steps as jsteps
import repro_torch.configs as tconfigs
import repro_torch.models.attention as tattn
import repro_torch.models.blocks as tblocks
import repro_torch.models.model as tmodel
import repro_torch.serving.scheduler as tsched
import repro_torch.serving.spec as tspec
import repro_torch.serving.steps as tsteps
from repro_torch import bridge, kernels
from repro_torch.models.config import layer_pattern, scan_pattern
from repro_torch.tree import tree_map
from test_torch_archs import (_close, _one_thread, _rel,  # noqa: F401
                              _tokens, carried, cross_src, open_gates)

NO_EOS = 10_000_000
PROMPTS = [(5, 6), (12, 4), (20, 8), (9, 5)]


def _requests(mod, vocab, prompts=PROMPTS, seed=11):
    rng = np.random.default_rng(seed)
    return [mod.Request(rid=i, prompt=rng.integers(0, vocab, n)
                        .astype(np.int32), max_new_tokens=m)
            for i, (n, m) in enumerate(prompts)]


class _Carried:
    """The port's policy started from a carried-over reference state."""
    schedules = True

    def __init__(self, policy, state):
        self.policy, self.state = policy, state

    def init(self, seed=0, device="cpu"):
        return tree_map(torch.clone, self.state)

    def step(self, state, workloads, obs):
        return self.policy.step(state, workloads, obs)


def _serve_both(arch, server, prompts=PROMPTS, max_len=48, batch=2):
    """The same requests through the JAX server and the port's, with the
    DALI policy from one initial state where the arch has MoE layers."""
    jc, tc, jp, tp = carried(arch)
    kw = dict(batch_size=batch, max_len=max_len, eos_id=NO_EOS,
              server=server)
    if jc.moe is None:
        jres = jspec.ServeSpec(cfg=jc, policy="none", **kw).resolve(jp)
        tpol = "none"
    else:
        jres = jspec.ServeSpec(
            cfg=jc, policy="dali",
            dali_cfg=jsteps.default_dali_config(jc, cache_ratio=0.5),
            **kw).resolve(jp)
        tpol = _Carried(tsteps.resolve_policy(
            "dali", tc, tsteps.default_dali_config(tc, cache_ratio=0.5)),
            bridge.to_torch(jax.tree.map(np.asarray, jres.policy.init()),
                            "cpu"))
    tres = tspec.ServeSpec(cfg=tc, policy=tpol, device="cpu",
                           **kw).resolve(tp)
    js, ts = jres.server(), tres.server()
    for r in _requests(jsched, jc.vocab, prompts):
        js.submit(r)
    for r in _requests(tsched, tc.vocab, prompts):
        ts.submit(r)
    kernels.reset_launch_counts()
    dj = {r.rid: r.output for r in js.run()}
    dt = {r.rid: r.output for r in ts.run()}
    assert kernels.launch_counts() == {k: 0 for k in kernels.LAUNCHES}
    return js, ts, dj, dt


@pytest.mark.parametrize("arch,server,prompts", [
    # prompts at or under the window (16) or a multiple of it
    ("gemma2_9b", "continuous", [(5, 6), (12, 4), (16, 8), (32, 5)]),
    ("gemma2_9b", "wave", PROMPTS),
    ("jamba_1_5_large_398b", "wave", PROMPTS),
    ("mamba2_780m", "wave", PROMPTS),
    ("olmo_1b", "continuous", PROMPTS),
    ("llama4_maverick_400b_a17b", "continuous", PROMPTS),
])
def test_servers_give_the_reference_servers_tokens(arch, server, prompts):
    js, ts, dj, dt = _serve_both(arch, server, prompts)
    assert dt == dj
    assert [len(dt[i]) for i in range(len(prompts))] == [m for _, m in
                                                         prompts]
    for k in ("steps", "hits", "misses", "swaps"):
        assert getattr(ts.metrics.dali, k) == getattr(js.metrics.dali, k), k


def test_dali_inapplicable_archs_serve_without_engine():
    """Twin of tests/test_system.py's: OLMo has no MoE layer, so no DALI
    config, and the wave server serves it without the engine."""
    _, tc, _, tp = carried("olmo_1b")
    assert tsteps.default_dali_config(tc) is None
    assert tsteps.default_dali_config(carried("mamba2_780m")[1]) is None
    server = tsched.BatchServer(tp, tc, batch_size=2, max_len=32,
                                device="cpu")
    server.submit(tsched.Request(rid=0, prompt=np.arange(8, dtype=np.int32),
                                 max_new_tokens=4))
    done = server.run()
    assert len(done) == 1 and len(done[0].output) >= 1
    assert server.metrics.dali.lookups == 0


def test_hybrid_dali_config_counts_only_moe_layers():
    jc, tc, _, _ = carried("jamba_1_5_large_398b")
    dt, dj = tsteps.default_dali_config(tc), jsteps.default_dali_config(jc)
    for k in ("n_moe_layers", "n_experts", "cache_size", "prefetch_size",
              "w_size", "u_size"):
        assert getattr(dt, k) == getattr(dj, k), k
    assert dt.n_moe_layers == 4


@pytest.mark.parametrize("arch", ["jamba_1_5_large_398b", "mamba2_780m"])
def test_continuous_server_refuses_ssm_and_hybrid_archs(arch):
    _, tc, _, tp = carried(arch)
    with pytest.raises(ValueError, match="continuous batching requires "
                       "attention caches"):
        tspec.ServeSpec(cfg=tc, server="continuous", policy="none",
                        device="cpu").resolve(tp).server()


@pytest.mark.parametrize("arch,server", [
    ("jamba_1_5_large_398b", "wave"),
    ("llama4_maverick_400b_a17b", "continuous"),
    ("llama4_maverick_400b_a17b", "wave"),
])
def test_offloaded_serve_equals_full_resident(arch, server):
    """The ``pipelined`` slot pool gives the full-resident tokens: Jamba's
    four MoE layers (positions 1, 3, 5, 7 of its period, between Mamba
    layers) map onto the store's layers, and Llama-4's shared expert stays
    in the params the server reads.  With the experts drawn on the host,
    the store adopts the period's interleaved stacks without a copy."""
    _, tc, _, tp = carried(arch)

    def serve(mode, params):
        spec = tspec.ServeSpec(cfg=tc, server=server, policy="dali",
                               batch_size=2, max_len=48, eos_id=NO_EOS,
                               offload=tspec.OffloadSpec(mode=mode),
                               device="cpu")
        rs = spec.resolve(params)
        srv = rs.server()
        for r in _requests(tsched, tc.vocab):
            srv.submit(r)
        return srv, {r.rid: r.output for r in srv.run()}

    _, ref = serve("modeled", tp)
    srv, got = serve("pipelined", tp)
    assert got == ref
    n_moe = sum(1 for _, m in layer_pattern(tc) if m == "moe")
    assert srv.store.n_layers == n_moe
    st = srv.store.stats()
    assert st["prefill_miss_reads"] > 0
    # the same weights drawn on the host: the store adopts them
    host = tmodel.init_model(tc, seed=5, device="cpu", experts="host")
    _, ref = serve("modeled", host)
    srv, got = serve("pipelined", host)
    assert got == ref
    per_pos = [host["scan"][p]["mlp"]["gate"]
               for p, (_, m) in enumerate(scan_pattern(tc)[1])
               if m == "moe"]
    assert all(t.untyped_storage().data_ptr()
               == srv.store.host["gate"].untyped_storage().data_ptr()
               for t in per_pos)
    for l in range(srv.store.n_layers):
        s, j = divmod(l, len(per_pos))
        assert torch.equal(srv.store.host["gate"][l], per_pos[j][s])


def test_store_refuses_a_second_host_copy_for_a_card_pool():
    """Host-resident expert stacks that the store cannot adopt (here
    Jamba's four MoE positions as separate host tensors, as the bridge
    places them) raise for a pool on a card instead of being copied."""
    from repro_torch.serving.expert_store import ExpertStore
    _, tc, _, tp = carried("jamba_1_5_large_398b")
    store = ExpertStore.__new__(ExpertStore)
    store.device = torch.device("cuda")
    store._prefix_moe, store._scan_moe = [], [
        p for p, (_, m) in enumerate(scan_pattern(tc)[1]) if m == "moe"]
    store._n_super = scan_pattern(tc)[2]
    with pytest.raises(ValueError, match="second host copy"):
        store._host_stack(tp, "gate")


# --------------------------------------------------------------------------
# cross-attention pieces
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def vision():
    jc, tc, jp, tp = carried("llama_3_2_vision_11b")
    p = 4                                       # the cross layer (i=4)
    assert scan_pattern(tc)[1][p] == ("cross", "dense")
    jl = jax.tree.map(lambda a: a[0], jp["scan"][p])
    tl = tree_map(lambda a: a[0], tp["scan"][p])
    return jc, tc, jl, tl


def _np(shape, seed, scale=0.5):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def test_build_cross_kv_and_cross_attention_match_reference(vision):
    jc, tc, jl, tl = vision
    src = _np((2, 16, jc.d_model), 1)
    kj = jattn.build_cross_kv(jl["mixer"], jnp.asarray(src), jc)
    kt = tattn.build_cross_kv(tl["mixer"], torch.from_numpy(src), tc)
    for k in ("k", "v"):
        _close(kt[k], kj[k], k)
    for S in (7, 1):                 # prefill (K3 non-causal), decode
        x = _np((2, S, jc.d_model), S + 2)
        yj = jattn.cross_attention(jl["mixer"], jnp.asarray(x), jc, kj)
        yt = tattn.cross_attention(tl["mixer"], torch.from_numpy(x), tc, kt)
        _close(yt, yj, f"cross_attention S={S}")


def test_cross_block_gated_ffn_matches_reference(vision):
    """A VLM cross layer: the gated cross-attention then the tanh-gated
    dense FFN (``mlp_gate``), with and without a cache."""
    jc, tc, jl, tl = vision
    src = _np((2, 16, jc.d_model), 3)
    x = _np((2, 6, jc.d_model), 4)
    pos = np.arange(6, dtype=np.int32)
    kinds = ("cross", "dense")
    yj, _, _ = jblocks.apply_block(jl, jnp.asarray(x), jc, kinds,
                                   positions=jnp.asarray(pos),
                                   cross_src=jnp.asarray(src))
    yt, _, _ = tblocks.apply_block(tl, torch.from_numpy(x), tc, kinds,
                                   positions=torch.from_numpy(pos),
                                   cross_src=torch.from_numpy(src))
    _close(yt, yj, "cross block")
    tcache = tblocks.init_block_cache(tc, kinds, 2, 32, "cpu", n_cross=16)
    yc, tcache, _ = tblocks.apply_block(tl, torch.from_numpy(x), tc, kinds,
                                        positions=torch.from_numpy(pos),
                                        cache=tcache,
                                        cross_src=torch.from_numpy(src))
    torch.testing.assert_close(yc, yt, rtol=0, atol=0)
    x1 = _np((2, 1, jc.d_model), 5)
    ckv = jattn.build_cross_kv(jl["mixer"], jnp.asarray(src), jc)
    jcache = {"xk": ckv["k"], "xv": ckv["v"]}
    d1, _, _ = jblocks.apply_block(jl, jnp.asarray(x1), jc, kinds,
                                   positions=jnp.asarray([6]), cache=jcache)
    t1, _, _ = tblocks.apply_block(tl, torch.from_numpy(x1), tc, kinds,
                                   positions=torch.tensor([6]), cache=tcache)
    _close(t1, d1, "cross block decode from the cache")
    with pytest.raises(ValueError, match="n_cross"):
        tblocks.apply_block(tl, torch.from_numpy(x), tc, kinds,
                            positions=torch.from_numpy(pos), cache=tcache,
                            cross_src=torch.from_numpy(src[:, :8]))


def test_apply_encoder_matches_reference():
    jc, tc, jp, tp = carried("seamless_m4t_large_v2")
    src = _np((2, 12, jc.d_model), 6)
    ej = jmodel.apply_encoder(jp["encoder"], jnp.asarray(src), jc)
    et = tmodel.apply_encoder(tp["encoder"], torch.from_numpy(src), tc)
    _close(et, ej, "encoder")


@pytest.mark.parametrize("arch", ["llama_3_2_vision_11b",
                                  "seamless_m4t_large_v2"])
def test_float32_source_promotes_the_cross_path_as_the_reference(arch):
    """A bfloat16 model fed a float32 source (the launchers' constant
    source is float32): the encoder's output and the cross keys and
    values are float32 in both packages and equal within 3e-5 (float32
    math over the same bfloat16 weights); the logits agree within the
    bfloat16 tolerance 3e-2."""
    bf16 = dict(dtype="bfloat16", param_dtype="bfloat16")
    jc = dataclasses.replace(
        jconfigs.make_smoke(jconfigs.get_config(arch)), **bf16)
    tc = dataclasses.replace(
        tconfigs.make_smoke(tconfigs.get_config(arch)), **bf16)
    jp = open_gates(jmodel.init_model(jax.random.PRNGKey(0), jc))
    tp = bridge.to_torch(jp, "cpu")
    jp = jax.tree.map(jnp.asarray, jp)
    src = cross_src(jc)
    sj, st = jnp.asarray(src), torch.from_numpy(src)
    if jc.encoder is not None:
        sj = jmodel.apply_encoder(jp["encoder"], sj, jc)
        st = tmodel.apply_encoder(tp["encoder"], st, tc)
        assert sj.dtype == jnp.float32 and st.dtype == torch.float32
        _close(st, sj, "encoder")
    p = next(i for i, (m, _) in enumerate(scan_pattern(tc)[1])
             if m in ("cross", "self_cross"))
    key = "mixer" if scan_pattern(tc)[1][p][0] == "cross" else "cross"
    kj = jattn.build_cross_kv(jax.tree.map(lambda a: a[0], jp["scan"][p])
                              [key], sj, jc)
    kt = tattn.build_cross_kv(tree_map(lambda a: a[0], tp["scan"][p])[key],
                              st, tc)
    for k in ("k", "v"):
        assert kj[k].dtype == jnp.float32 and kt[k].dtype == torch.float32
        _close(kt[k], kj[k], k)
    toks = _tokens(jc, 12)
    lj, _, _ = jmodel.apply_model(jp, jnp.asarray(toks), jc,
                                  cross_src=jnp.asarray(src))
    lt, _, _ = tmodel.apply_model(tp, torch.from_numpy(toks), tc,
                                  cross_src=torch.from_numpy(src))
    err = _rel(lt, np.asarray(lj, np.float32))
    assert err < 3e-2, f"logits {err:.3e}"


# --------------------------------------------------------------------------
# the ring repair: rolling caches after a prompt past the window
# --------------------------------------------------------------------------

def test_rolling_write_keeps_every_position_at_its_slot():
    """A shared-position write into an S_c = 8 buffer: each position at
    slot pos % 8, a wrapped chunk split in two, a chunk past the buffer
    keeping its last 8 positions."""
    cache = {"k": torch.zeros((1, 8, 1, 1)), "pos": torch.full((1, 8), -1)}
    for lo, hi in ((0, 5), (5, 11), (11, 12), (12, 31)):
        pos = torch.arange(lo, hi, dtype=torch.int32)
        tattn._update_cache(cache, pos, k=pos.float()[None, :, None, None])
        kept = torch.arange(max(0, hi - 8), hi)
        want = torch.full((8,), -1)
        want[kept % 8] = kept
        assert torch.equal(cache["pos"][0].long(), want), (lo, hi)
        assert torch.equal(cache["k"][0, :, 0, 0].long(), want.clamp(min=0)
                           * (want >= 0)), (lo, hi)


@pytest.mark.parametrize("L", [37, 40])
def test_decode_after_a_prompt_past_the_window_equals_recompute(L):
    """Gemma-2's smoke model (window 16, local and global layers): a
    prefill of L tokens into caches of max_len 48 (local caches of 16
    slots), then two decode steps, equal the full recompute within 3e-5.
    The reference's ``dynamic_update_slice`` lands such a prefill at slot
    0; its first decode step then lies 1.2e-2 (L = 37) and 1.9e-2 (L = 40)
    from its recompute (ROADMAP.md, "Notes on the reference")."""
    _, tc, _, tp = carried("gemma2_9b")
    assert tc.attn.sliding_window == 16
    toks = np.random.default_rng(L).integers(0, tc.vocab, (2, L)) \
        .astype(np.int32)
    caches = tmodel.init_caches(tc, 2, 48, device="cpu")
    assert caches["scan"][0]["k"].shape[2] == 16       # the local layer
    lg, caches, _ = tmodel.apply_model(
        tp, torch.from_numpy(toks), tc,
        positions=torch.arange(L, dtype=torch.int32), caches=caches)
    seq = torch.from_numpy(toks)
    for t in range(2):
        nxt = lg[:, -1:].argmax(-1).to(torch.int32)
        seq = torch.cat([seq, nxt], 1)
        lg, caches, _ = tmodel.apply_model(
            tp, nxt, tc, positions=torch.tensor([L + t], dtype=torch.int32),
            caches=caches)
        full, _, _ = tmodel.apply_model(tp, seq, tc)
        _close(lg[:, 0], full[:, -1].numpy(), f"decode step {t}")


def test_sliding_window_prompt_longer_than_window_matches_solo():
    """Twin of tests/test_continuous_batching.py's: prompts past the window
    (exact-length admission), late-admitted, give their solo tokens; in the
    port those are also the tokens of a greedy full recompute."""
    _, tc, _, tp = carried("gemma2_9b")
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, tc.vocab, n).astype(np.int32)
               for n in (40, 9, 37)]
    budgets = [12, 2, 8]

    def server(batch):
        return tspec.ServeSpec(cfg=tc, server="continuous", policy="none",
                               batch_size=batch, max_len=96, eos_id=NO_EOS,
                               device="cpu").resolve(tp).server()

    srv = server(2)
    for i, (p, b) in enumerate(zip(prompts, budgets)):
        srv.submit(tsched.Request(rid=i, prompt=p, max_new_tokens=b))
    done = {r.rid: r.output for r in srv.run()}
    for rid in (0, 2):                             # the long-prompt ones
        solo = server(1)
        solo.submit(tsched.Request(rid=0, prompt=prompts[rid],
                                   max_new_tokens=budgets[rid]))
        assert done[rid] == solo.run()[0].output
        seq = torch.from_numpy(prompts[rid])[None]
        greedy = []
        for _ in range(budgets[rid]):
            lg, _, _ = tmodel.apply_model(tp, seq, tc, last_logit_only=True)
            nxt = lg[:, -1:].argmax(-1).to(torch.int32)
            greedy.append(int(nxt))
            seq = torch.cat([seq, nxt], 1)
        assert done[rid] == greedy


def test_wave_prefill_and_serve_state_take_a_cross_source():
    """``init_serve_state(n_cross=...)`` sizes the cross caches, and the
    wave prefill's ``cross_src`` (which the servers leave None, as the
    reference's do) fills them: its first token is the full forward's, and
    the cached keys are ``build_cross_kv``'s."""
    jc, tc, _, tp = carried("llama_3_2_vision_11b")
    src = torch.from_numpy(_np((2, 16, tc.d_model), 8))
    toks = torch.from_numpy(np.random.default_rng(9).integers(
        0, tc.vocab, (2, 12)).astype(np.int32))
    state = tsteps.init_serve_state(tc, 2, 32, n_cross=16, device="cpu")
    p = 4                                       # the cross layer
    assert state["caches"]["scan"][p]["xk"].shape[2] == 16
    nxt, caches = tsteps.make_prefill_step(tc)(tp, toks, state["caches"],
                                               cross_src=src)
    lg, _, _ = tmodel.apply_model(tp, toks, tc, cross_src=src)
    assert torch.equal(nxt, lg[:, -1:].argmax(-1).to(torch.int32))
    layer = tree_map(lambda a: a[0], tp["scan"][p])
    kv = tattn.build_cross_kv(layer["mixer"], src, tc)
    assert torch.equal(caches["scan"][p]["xk"][0], kv["k"])
