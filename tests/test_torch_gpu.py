"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here carries the ``gpu`` marker and skips without a CUDA card
(decided inside the ``cuda`` fixture, never at import).  This file imports
no JAX, so it also runs on a machine that has only PyTorch:

  PYTHONPATH=src python -m pytest -q --noconftest -m gpu tests/test_torch_gpu.py

Tolerances: gating idx exact, gates atol 1e-5 (float32 in, float32 out);
bf16 kernels 3e-2 relative to max |ref| (tests/test_kernels.py's bf16
tolerance: the kernels round h and P to bf16 where the plain versions keep
float32).
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import kernels
from repro_torch.kernels.expert_ffn.ops import expert_ffn, expert_ffn_plain
from repro_torch.kernels.flash_attention.ops import (flash_attention,
                                                     flash_attention_plain)
from repro_torch.kernels.gating.ops import (LAUNCH_KEY, gating,
                                            gating_plain, plan)

pytestmark = pytest.mark.gpu
BF16_TOL = 3e-2


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _rel_err(y, r):
    r = r.float()
    return float((y.float() - r).abs().max()) / (float(r.abs().max()) + 1e-6)


def _row_rel_err(y, r):
    """The largest, over rows (every index but the last), of a row's max
    |y - r| over that row's max |r|: each query row and head of an
    attention output held to its own scale."""
    y, r = y.float().flatten(0, -2), r.float().flatten(0, -2)
    return float(((y - r).abs().amax(-1)
                  / (r.abs().amax(-1) + 1e-6)).max())


def _check_gating(lg, k, rt, renorm):
    """One launch of the variant ``plan`` picks, counted under its key; idx
    exact, gates atol 1e-5, probs atol 1e-6 / rtol 1e-5 against the plain
    version on the same card."""
    key = LAUNCH_KEY[plan(lg.shape[1], k)[0]]
    before = kernels.LAUNCHES[key]
    g1, i1, p1 = gating(lg, k, rt, renorm)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES[key] == before + 1
    g2, i2, p2 = gating_plain(lg, k, rt, renorm)
    assert torch.equal(i1, i2)
    torch.testing.assert_close(g1, g2, atol=1e-5, rtol=0)
    torch.testing.assert_close(p1, p2, atol=1e-6, rtol=1e-5)


@pytest.mark.parametrize("T,E,k,rt,renorm", [
    (128, 8, 2, "topk_softmax", True),
    (256, 64, 6, "softmax_topk", True),
    (64, 128, 1, "sigmoid", False),
    (100, 16, 4, "softmax_topk", False),
    (512, 128, 8, "softmax_topk", True),
])
def test_gating_kernel_matches_plain(cuda, T, E, k, rt, renorm):
    rng = np.random.default_rng(0)
    lg = torch.tensor(rng.standard_normal((T, E)) * 2, dtype=torch.float32,
                      device=cuda)
    _check_gating(lg, k, rt, renorm)


@pytest.mark.parametrize("rt,renorm", [("topk_softmax", True),
                                       ("softmax_topk", True),
                                       ("softmax_topk", False),
                                       ("sigmoid", False)])
@pytest.mark.parametrize("T,E,k", [
    (1, 8, 2), (2, 8, 2), (8, 8, 2), (256, 8, 2),   # the path's shapes
    (200, 8, 2), (129, 8, 8),        # T not a multiple of 128 rows per block
    (129, 16, 2), (77, 16, 16), (300, 32, 8), (64, 32, 16),
    (50, 5, 3), (50, 12, 1), (50, 30, 4),   # E below its padded width
    (96, 33, 2), (96, 33, 16),               # the first warp-variant width
    (64, 64, 6), (40, 256, 16),
])
def test_gating_variants_match_plain(cuda, T, E, k, rt, renorm):
    rng = np.random.default_rng(T * 1000 + E)
    lg = torch.tensor(rng.standard_normal((T, E)) * 2, dtype=torch.float32,
                      device=cuda)
    _check_gating(lg, k, rt, renorm)


@pytest.mark.parametrize("E", [8, 16, 32, 33, 64])
@pytest.mark.parametrize("rt", ["topk_softmax", "softmax_topk", "sigmoid"])
def test_gating_tied_integer_logits_match_plain(cuda, E, rt):
    """Rows of integer logits in -2..2 hold many exact ties, in the logits
    and in the probabilities: every variant gives them to the lowest index,
    as torch.argmax does."""
    rng = np.random.default_rng(E)
    lg = torch.tensor(rng.integers(-2, 3, (257, E)), dtype=torch.float32,
                      device=cuda)
    _check_gating(lg, min(E, 6), rt, True)


def test_gating_unaligned_logits_match_plain(cuda):
    """Logits 4 bytes past a 16-byte boundary take the scalar loads."""
    flat = torch.randn(1 + 130 * 8, device=cuda)
    lg = flat[1:].view(130, 8)
    assert lg.data_ptr() % 16
    _check_gating(lg, 2, "topk_softmax", True)


def test_gating_refuses_what_no_variant_takes(cuda):
    for E, k in ((257, 2), (8, 0), (8, 9), (64, 17)):
        with pytest.raises(ValueError):
            gating(torch.zeros((4, E), device=cuda), k)


def _ffn_inputs(dev, G, E, C, d, f, seed=0):
    rng = np.random.default_rng(seed)
    t = lambda shape, s: torch.tensor(rng.standard_normal(shape) * s,
                                      dtype=torch.bfloat16, device=dev)
    return t((G, C, d), 1.0), t((E, d, f), 0.05), t((E, d, f), 0.05), \
        t((E, f, d), 0.05)


@pytest.mark.parametrize("counts", [None, [0, 16, 37, 5], [0, 0, 0, 0],
                                    [64, 64, 64, 64], [70, 1, 0, 33]])
@pytest.mark.parametrize("act", ["silu", "gelu"])
def test_expert_ffn_dense_ragged_matches_plain(cuda, counts, act):
    E, C, d, f = 4, 64, 128, 256
    xe, wg, wu, wd = _ffn_inputs(cuda, E, E, C, d, f)
    cnt = None if counts is None else torch.tensor(counts, dtype=torch.int32,
                                                   device=cuda)
    key = "expert_ffn_dense" if cnt is None else "expert_ffn_ragged"
    before = kernels.LAUNCHES[key]
    y = expert_ffn(xe, wg, wu, wd, counts=cnt, act=act)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES[key] == before + 1
    r = expert_ffn_plain(xe, wg, wu, wd, counts=cnt, act=act)
    assert _rel_err(y, r) < BF16_TOL
    if cnt is not None:          # garbage tails never leak: rows are zero
        rows = torch.arange(C, device=cuda)[None, :] >= cnt[:, None]
        assert not y[rows].float().abs().sum()


def test_expert_ffn_grouped_matches_plain(cuda):
    E, G, C, d, f = 3, 6, 20, 64, 192
    xe, wg, wu, wd = _ffn_inputs(cuda, G, E, C, d, f, seed=1)
    cnt = torch.tensor([0, 20, 7, 0, 12, 1], dtype=torch.int32, device=cuda)
    eids = torch.tensor([0, 0, 1, 1, 2, 2], dtype=torch.int32, device=cuda)
    before = kernels.LAUNCHES["expert_ffn_grouped"]
    y = expert_ffn(xe, wg, wu, wd, counts=cnt, expert_ids=eids)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["expert_ffn_grouped"] == before + 1
    r = expert_ffn_plain(xe, wg, wu, wd, counts=cnt, expert_ids=eids)
    assert _rel_err(y, r) < BF16_TOL
    rows = torch.arange(C, device=cuda)[None, :] >= cnt[:, None]
    assert not y[rows].float().abs().sum()


@pytest.mark.parametrize("C", [12, 20, 40, 80, 150])
@pytest.mark.parametrize("f", [192, 256])
def test_expert_ffn_capacity_buckets_match_plain(cuda, C, f):
    """The path's prefill buckets (C = 12..80), one bucket past the 128-row
    M tile, and an f that is not a multiple of the 128-wide N tile; counts
    cover an empty, a partial and a full expert."""
    E, d = 4, 128
    xe, wg, wu, wd = _ffn_inputs(cuda, E, E, C, d, f, seed=C)
    cnt = torch.tensor([0, C // 3 + 1, C, C - 1], dtype=torch.int32,
                       device=cuda)
    y = expert_ffn(xe, wg, wu, wd, counts=cnt)
    torch.cuda.synchronize()
    r = expert_ffn_plain(xe, wg, wu, wd, counts=cnt)
    assert _rel_err(y, r) < BF16_TOL
    rows = torch.arange(C, device=cuda)[None, :] >= cnt[:, None]
    assert not y[rows].float().abs().sum()
    y = expert_ffn(xe, wg, wu, wd)                       # dense: every row
    torch.cuda.synchronize()
    assert _rel_err(y, expert_ffn_plain(xe, wg, wu, wd)) < BF16_TOL


@pytest.mark.parametrize("C", [1, 4, 80])
def test_expert_ffn_grouped_repeated_ids_match_plain(cuda, C):
    E, G, d, f = 4, 6, 128, 256
    xe, wg, wu, wd = _ffn_inputs(cuda, G, E, C, d, f, seed=3)
    cnt = torch.tensor([C, C, max(C - 1, 0), C, 0, C], dtype=torch.int32,
                       device=cuda)
    eids = torch.tensor([2, 2, 2, 0, 3, 0], dtype=torch.int32, device=cuda)
    y = expert_ffn(xe, wg, wu, wd, counts=cnt, expert_ids=eids)
    torch.cuda.synchronize()
    r = expert_ffn_plain(xe, wg, wu, wd, counts=cnt, expert_ids=eids)
    assert _rel_err(y, r) < BF16_TOL
    rows = torch.arange(C, device=cuda)[None, :] >= cnt[:, None]
    assert not y[rows].float().abs().sum()


@pytest.mark.parametrize("B,Sq,Sk,Hq,Hkv,D,causal,window,cap", [
    (1, 32, 32, 32, 8, 128, True, 0, 0.0),       # smallest path bucket
    (1, 256, 256, 32, 8, 128, True, 0, 0.0),     # largest path bucket
    (1, 20, 100, 8, 2, 128, True, 0, 0.0),       # Sk tail inside a TMA box
    (2, 77, 77, 8, 2, 64, False, 0, 0.0),
    (1, 48, 48, 6, 3, 48, True, 0, 0.0),         # D not a multiple of 64
    (1, 40, 130, 16, 2, 80, True, 32, 10.0),
    (1, 128, 128, 4, 2, 64, True, 0, 0.0),
    (2, 128, 256, 8, 8, 32, True, 0, 50.0),
    (1, 64, 192, 4, 1, 64, True, 64, 0.0),
    (2, 128, 128, 2, 2, 128, False, 0, 0.0),
    (1, 256, 256, 16, 2, 64, True, 0, 30.0),
    (1, 100, 100, 32, 8, 128, True, 0, 0.0),     # ragged admission bucket
    (1, 37, 37, 4, 1, 64, True, 0, 0.0),         # ragged, one query tile
])
def test_flash_attention_matches_plain(cuda, B, Sq, Sk, Hq, Hkv, D, causal,
                                       window, cap):
    rng = np.random.default_rng(2)
    t = lambda shape: torch.tensor(rng.standard_normal(shape),
                                   dtype=torch.bfloat16, device=cuda)
    q, k, v = t((B, Sq, Hq, D)), t((B, Sk, Hkv, D)), t((B, Sk, Hkv, D))
    before = kernels.LAUNCHES["flash_attention"]
    o = flash_attention(q, k, v, causal=causal, window=window, softcap=cap)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["flash_attention"] == before + 1
    r = flash_attention_plain(q, k, v, causal=causal, window=window,
                              softcap=cap)
    assert _rel_err(o, r) < BF16_TOL


def test_flash_attention_tail_never_reads_the_next_batch(cuda):
    """B = 2 with Sk = 77: batch 0's second key tile runs past Sk.  Batch
    1's first value rows are inf, so a tail that read them (0 * inf) would
    turn batch 0's output into NaN; the kernel must read zeros there."""
    B, S, Hq, Hkv, D = 2, 77, 8, 2, 128
    rng = np.random.default_rng(4)
    t = lambda shape: torch.tensor(rng.standard_normal(shape),
                                   dtype=torch.bfloat16, device=cuda)
    q, k, v = t((B, S, Hq, D)), t((B, S, Hkv, D)), t((B, S, Hkv, D))
    v[1, :64] = float("inf")
    o = flash_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    r = flash_attention_plain(q[:1], k[:1], v[:1], causal=True)
    assert bool(torch.isfinite(o[0]).all())
    assert _rel_err(o[:1], r) < BF16_TOL


def test_cuda_wrappers_refuse_unsupported_inputs(cuda):
    """A CUDA tensor launches the kernel or raises: never the plain path."""
    x = torch.zeros((2, 4, 64), dtype=torch.float32, device=cuda)
    w = torch.zeros((2, 64, 64), dtype=torch.float32, device=cuda)
    with pytest.raises(ValueError):
        expert_ffn(x, w, w, w)
    q = torch.zeros((1, 8, 4, 64), dtype=torch.float32, device=cuda)
    with pytest.raises(ValueError):
        flash_attention(q, q, q)


@pytest.mark.parametrize("C,G", [(1, 4), (1, 16), (80, 8), (20, 8)])
def test_expert_ffn_grouped_over_pool_and_staging_is_bitwise(cuda, C, G):
    """The offload path's K2 launches: over a slot-pool slice (expert_ids =
    slots) and over the miss-staging rows (expert_ids = staging rows), each
    at decode (C = 1) and prefill (C = 20, 80) shapes, equal K2 over the
    full-resident stack bit for bit, row group by row group."""
    E, S, d, f = 8, 5, 128, 256
    xe, wg, wu, wd = _ffn_inputs(cuda, G, E, C, d, f, seed=G + C)
    rng = np.random.default_rng(C)
    eids = torch.tensor(rng.integers(0, E, G), dtype=torch.int32,
                        device=cuda)
    cnt = torch.tensor(rng.integers(0, C + 1, G), dtype=torch.int32,
                       device=cuda)
    full = expert_ffn(xe, wg, wu, wd, counts=cnt, expert_ids=eids)
    pooled = torch.tensor(rng.permutation(E)[:S], device=cuda)
    slot_of = torch.full((E,), -1, dtype=torch.int32, device=cuda)
    slot_of[pooled] = torch.arange(S, dtype=torch.int32, device=cuda)
    pool = [w[pooled].contiguous() for w in (wg, wu, wd)]
    slot = slot_of[eids.long()]
    hit = slot >= 0
    y = expert_ffn(xe, *pool, counts=torch.where(hit, cnt, 0),
                   expert_ids=slot.clamp(min=0).contiguous())
    miss_ids = torch.unique(eids[~hit])
    staging = [torch.zeros((E,) + tuple(w.shape[1:]), dtype=w.dtype,
                           device=cuda) for w in (wg, wu, wd)]
    row_of = torch.zeros((E,), dtype=torch.int32, device=cuda)
    for r, e in enumerate(miss_ids.tolist()):
        row_of[e] = r
        for s_, w in zip(staging, (wg, wu, wd)):
            s_[r].copy_(w[e])
    ym = expert_ffn(xe, *staging, counts=torch.where(hit, 0, cnt),
                    expert_ids=row_of[eids.long()].contiguous())
    torch.cuda.synchronize()
    got = torch.where(hit[:, None, None], y, ym)
    assert torch.equal(got, full)


def test_offloaded_decode_on_the_card_equals_full_resident(cuda):
    """Two bfloat16 layers at small widths: prefill then decode steps with
    the experts in a pinned host store and a 3-slot pool (misses fetched,
    plans streamed in every mode) equal full-resident decode on the card."""
    from repro_torch.configs import get_config, make_smoke
    from repro_torch.models.model import init_caches, init_model
    from repro_torch.serving import expert_store as es
    from repro_torch.serving import steps
    cfg = make_smoke(get_config("mixtral-8x7b")).replace(
        n_layers=2, dtype="bfloat16", param_dtype="bfloat16")
    cfg = cfg.replace(moe=dataclasses.replace(cfg.moe, n_routed=8))
    params = init_model(cfg, seed=0, device="cuda")
    host = init_model(cfg, seed=0, device="cuda", experts="host")
    pol = steps.resolve_policy("dali", cfg)
    for mode in ("blocking", "overlap", "pipelined"):
        store = es.ExpertStore(host, cfg, n_slots=3, mode=mode)
        assert store.host["gate"].is_pinned()
        slim = es.strip_expert_params(host, cfg)
        toks = torch.tensor(np.random.default_rng(1).integers(
            1, cfg.vocab, (1, 16)), dtype=torch.int32, device=cuda)
        pre_ref = steps.make_admit_prefill(cfg)
        pre_slot = steps.make_admit_prefill(cfg, offload=store)
        dec_ref = steps.make_decode_step(cfg, policy=pol)
        dec_slot = steps.make_decode_step(cfg, policy=pol, offload=store)
        s_ref = steps.init_serve_state(cfg, 2, 32, policy=pol,
                                       per_slot=True)
        s_slot = steps.init_serve_state(cfg, 2, 32, policy=pol,
                                        offload=store, per_slot=True)
        c_ref = pre_ref(params, toks, init_caches(cfg, 1, 32), 13)
        c_slot = pre_slot(slim, toks, init_caches(cfg, 1, 32), 13,
                          s_slot["offload"])
        assert torch.equal(c_ref[0], c_slot[0])
        for s in (s_ref, s_slot):
            s["active"][:] = True
        rng, target = np.random.default_rng(2), None
        for _ in range(6):
            tok = torch.tensor(rng.integers(1, cfg.vocab, (2, 1)),
                               dtype=torch.int32, device=cuda)
            s_ref["tokens"], s_slot["tokens"] = tok, tok.clone()
            s_slot["offload"] = store.pre_step(s_slot["offload"], mode,
                                               target)
            s_ref, lg_ref, _ = dec_ref(params, s_ref)
            s_slot, lg_slot, tel = dec_slot(slim, s_slot)
            store.post_dispatch(mode, target)
            target = store.next_target(s_slot, tel)
            assert torch.equal(lg_ref, lg_slot), mode
        st = store.stats()
        assert st["fallback_rows"] > 0 and st["h2d_rows"] > 0


# --------------------------------------------------------------------------
# the wave server's shapes, the scan caches and sampling on the card
# --------------------------------------------------------------------------

def test_flash_attention_wave_prefill_shape_matches_plain(cuda):
    """The wave prefill's K3 call: 8 rows left-padded to S = 223 (a ragged
    tail), the pad rows all one token's, q/k/v made contiguous from the
    projections' views as the model makes them."""
    B, S, Hq, Hkv, D = 8, 223, 32, 8, 128
    rng = np.random.default_rng(8)
    x = torch.tensor(rng.standard_normal((B, S, 64)) * 0.5,
                     dtype=torch.bfloat16, device=cuda)
    for b, n in enumerate((223, 200, 129, 150, 24, 180, 223, 131)):
        x[b, :S - n] = x[0, 0]                  # left-pad: one token
    w = lambda n: torch.tensor(rng.standard_normal((64, n)) * 0.2,
                               dtype=torch.bfloat16, device=cuda)
    q = (x @ w(Hq * D)).reshape(B, S, Hq, D).contiguous()
    k = (x @ w(Hkv * D)).reshape(B, S, Hkv, D).contiguous()
    v = (x @ w(Hkv * D)).reshape(B, S, Hkv, D).contiguous()
    before = kernels.LAUNCHES["flash_attention"]
    o = flash_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["flash_attention"] == before + 1
    assert _rel_err(o, flash_attention_plain(q, k, v, causal=True)) \
        < BF16_TOL


@pytest.mark.parametrize("d,f", [(256, 512), (4096, 14336)])
def test_expert_ffn_ragged_wave_bucket_matches_plain(cuda, d, f):
    """K2 ragged at the wave prefill's bucket C = 560 (T = 8 * 223, five
    128-row M tiles), at small widths and at Mixtral's; counts cover an
    empty expert, one row, exact tile multiples, a partial last tile and
    the full bucket."""
    E, C = 8, 560
    xe, wg, wu, wd = _ffn_inputs(cuda, E, E, C, d, f, seed=560)
    cnt = torch.tensor([0, 1, 128, 129, 300, 447, 559, 560],
                       dtype=torch.int32, device=cuda)
    before = kernels.LAUNCHES["expert_ffn_ragged"]
    y = expert_ffn(xe, wg, wu, wd, counts=cnt)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["expert_ffn_ragged"] == before + 1
    r = expert_ffn_plain(xe, wg, wu, wd, counts=cnt)
    assert _rel_err(y, r) < BF16_TOL
    rows = torch.arange(C, device=cuda)[None, :] >= cnt[:, None]
    assert not y[rows].float().abs().sum()


@pytest.mark.parametrize("name", ["lru", "score", "statistical", "random"])
def test_policy_steps_on_the_card_equal_the_cpu(cuda, name):
    """The LRU and score scans (a loop over E of tensor ops over the
    layers), the statistical history and the hashed random draws give on
    the card exactly what they give on the CPU."""
    from repro_torch.core import policy as pol
    from repro_torch.tree import tree_leaves, tree_map
    L, E, T, Dm = 4, 8, 6, 16
    dcfg = pol.DaliConfig(n_moe_layers=L, n_experts=E, cache_size=3,
                          prefetch_size=2, w_size=2)
    p = pol.make_policy(name, dcfg, top_k=2)
    s_cpu = p.init(seed=1, device="cpu")
    s_gpu = tree_map(lambda t: t.to(cuda), s_cpu)
    rng = np.random.default_rng(3)
    routers = torch.tensor(rng.standard_normal((L, Dm, E)) * 0.3,
                           dtype=torch.float32)
    res = torch.zeros((L, Dm))
    for step in range(12):
        wl = torch.tensor(np.minimum(rng.zipf(1.5, (L, E)) - 1, 6),
                          dtype=torch.int32)
        gi = torch.tensor(rng.standard_normal((L, T, Dm)),
                          dtype=torch.float32)
        s_cpu, d_cpu = p.step(s_cpu, wl, pol.Observation(gi, routers, res))
        s_gpu, d_gpu = p.step(s_gpu, wl.to(cuda), pol.Observation(
            gi.to(cuda), routers.to(cuda), res.to(cuda)))
        # integer and bool state exactly; the float accumulators (sums
        # whose reduction order differs between devices) within 1e-6
        for a, b in zip(tree_leaves(s_cpu), tree_leaves(s_gpu)):
            if a.is_floating_point():
                torch.testing.assert_close(b.cpu(), a, rtol=1e-6, atol=0)
            else:
                assert torch.equal(a, b.cpu()), (name, step)
        for k in ("on_gpu", "prefetched", "pf_pred", "hits", "misses"):
            assert torch.equal(d_cpu.tel[k], d_gpu.tel[k].cpu()), (name, k)


def test_sampled_decode_on_the_card_is_deterministic(cuda):
    """Sampled decoding (``torch.multinomial`` from ``state["rng"]`` on the
    card) gives the same tokens under the same seed, through both
    servers."""
    from repro_torch.configs import get_config, make_smoke
    from repro_torch.models.model import init_model
    from repro_torch.serving.scheduler import Request
    from repro_torch.serving.spec import ServeSpec
    cfg = make_smoke(get_config("mixtral-8x7b")).replace(
        n_layers=2, dtype="bfloat16", param_dtype="bfloat16")
    params = init_model(cfg, seed=0, device=cuda)
    rng = np.random.default_rng(4)
    prompts = [rng.integers(1, cfg.vocab, n).astype(np.int32)
               for n in (9, 30, 17)]

    def serve(server, sample):
        srv = ServeSpec(cfg=cfg, server=server, policy="dali", batch_size=2,
                        max_len=64, eos_id=-1, sample=sample,
                        temperature=1.0, device=cuda).resolve(params).server()
        for i, p in enumerate(prompts):
            srv.submit(Request(rid=i, prompt=p, max_new_tokens=12))
        return {r.rid: r.output for r in srv.run()}

    for server in ("continuous", "wave"):
        a, b = serve(server, True), serve(server, True)
        assert a == b, server
        assert a != serve(server, False), server


# --------------------------------------------------------------------------
# autograd through the kernels (training): each Function against the plain
# version's own autograd on the card, at phase 9's training shapes
# --------------------------------------------------------------------------

def _leaf(t):
    return t.detach().requires_grad_()


def test_gating_function_matches_plain_autograd(cuda):
    """K1 at the training batch (T = 8 x 128, Mixtral's router)."""
    gen = torch.Generator(device=cuda).manual_seed(11)
    lg = _leaf(torch.randn((1024, 8), generator=gen, device=cuda) * 2)
    gg = torch.randn((1024, 2), generator=gen, device=cuda)
    gp = torch.randn((1024, 8), generator=gen, device=cuda)
    before = dict(kernels.LAUNCHES)
    g1, i1, p1 = gating(lg, 2, "topk_softmax", True)
    (d1,) = torch.autograd.grad((g1, p1), lg, (gg, gp))
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["gating"] == before["gating"] + 1
    assert kernels.LAUNCHES["gating_bwd"] == before["gating_bwd"] + 1
    assert not i1.requires_grad
    ref = _leaf(lg)
    g2, i2, p2 = gating_plain(ref, 2, "topk_softmax", True)
    (d2,) = torch.autograd.grad((g2, p2), ref, (gg, gp))
    assert torch.equal(i1, i2)
    assert _rel_err(d1, d2) < BF16_TOL


@pytest.mark.parametrize("form", ["ragged", "grouped"])
def test_expert_ffn_function_matches_plain_autograd(cuda, form):
    """K2 at the training bucket: Mixtral's experts, C = 320 (T = 1024)."""
    gen = torch.Generator(device=cuda).manual_seed(12)
    E, C, d, f = 8, 320, 4096, 14336
    bf = lambda *s, sc=1.0: (torch.randn(s, generator=gen, device=cuda)
                             * sc).bfloat16()
    xe = _leaf(bf(E, C, d))
    ws = [_leaf(bf(E, d, f, sc=d ** -0.5)), _leaf(bf(E, d, f, sc=d ** -0.5)),
          _leaf(bf(E, f, d, sc=f ** -0.5))]
    counts = torch.tensor([320, 0, 17, 256, 300, 1, 64, 200],
                          dtype=torch.int32, device=cuda)
    eids = (torch.tensor([3, 3, 0, 7, 1, 2, 6, 5], dtype=torch.int32,
                         device=cuda) if form == "grouped" else None)
    gy = bf(E, C, d)
    key = "expert_ffn_" + form
    before = dict(kernels.LAUNCHES)
    y = expert_ffn(xe, *ws, counts=counts, expert_ids=eids)
    g1 = torch.autograd.grad(y, [xe, *ws], gy)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES[key] == before[key] + 1
    assert kernels.LAUNCHES["expert_ffn_bwd"] == before["expert_ffn_bwd"] + 1
    ins = [_leaf(t) for t in (xe, *ws)]
    r = expert_ffn_plain(*ins, counts=counts, expert_ids=eids)
    g2 = torch.autograd.grad(r, ins, gy)
    assert _rel_err(y, r) < BF16_TOL
    for a, b in zip(g1, g2):
        assert _rel_err(a, b) < BF16_TOL


def test_flash_attention_function_matches_plain_autograd(cuda):
    """K3 at the training batch: B = 8, S = 128, Mixtral's heads."""
    gen = torch.Generator(device=cuda).manual_seed(13)
    bf = lambda *s: torch.randn(s, generator=gen, device=cuda).bfloat16()
    q, k, v = _leaf(bf(8, 128, 32, 128)), _leaf(bf(8, 128, 8, 128)), \
        _leaf(bf(8, 128, 8, 128))
    go = bf(8, 128, 32, 128)
    before = dict(kernels.LAUNCHES)
    o = flash_attention(q, k, v, causal=True)
    g1 = torch.autograd.grad(o, [q, k, v], go)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["flash_attention"] == \
        before["flash_attention"] + 1
    assert kernels.LAUNCHES["flash_attention_bwd"] == \
        before["flash_attention_bwd"] + 1
    ins = [_leaf(t) for t in (q, k, v)]
    r = flash_attention_plain(*ins, causal=True)
    g2 = torch.autograd.grad(r, ins, go)
    assert _rel_err(o, r) < BF16_TOL
    for a, b in zip(g1, g2):
        assert _rel_err(a, b) < BF16_TOL


def test_train_step_on_the_card_gives_every_leaf_a_gradient(cuda):
    """A bfloat16 smoke Mixtral's gradients through the kernels: every
    kernel and every backward recompute ran, and every leaf has a finite,
    non-zero gradient (``chip_smoke.py`` phase 9 holds them to the CPU's)."""
    from repro_torch.configs import get_config, make_smoke
    from repro_torch.data.pipeline import MarkovCorpus, batches
    from repro_torch.models.model import init_model
    from repro_torch.training.train_step import make_loss_fn, value_and_grad
    from repro_torch.tree import tree_leaves
    cfg = make_smoke(get_config("mixtral-8x7b")).replace(
        n_layers=2, dtype="bfloat16", param_dtype="bfloat16")
    params = init_model(cfg, seed=4, device=cuda)
    b = next(iter(batches(MarkovCorpus(vocab=cfg.vocab, seed=4), 2, 32, 1)))
    kernels.reset_launch_counts()
    (loss, m), grads = value_and_grad(
        make_loss_fn(cfg), params,
        {k: torch.as_tensor(v, device=cuda) for k, v in b.items()})
    torch.cuda.synchronize()
    for key in ("gating", "expert_ffn_ragged", "flash_attention",
                "gating_bwd", "expert_ffn_bwd", "flash_attention_bwd"):
        assert kernels.LAUNCHES[key] > 0, key
    assert bool(torch.isfinite(loss))
    for g in tree_leaves(grads):
        assert bool(torch.isfinite(g).all()) and float(g.abs().max()) > 0
    assert not any(p.requires_grad for p in tree_leaves(params))


# --------------------------------------------------------------------------
# Qwen3-30B-A3B's and DeepSeek-V2-Lite's shapes
# --------------------------------------------------------------------------

@pytest.mark.parametrize("B,S,Hq,Hkv,D,causal,window,cap", [
    (1, 128, 16, 16, 192, True, 0, 0.0),      # MLA prefill buckets
    (1, 512, 16, 16, 192, True, 0, 0.0),
    (2, 77, 16, 16, 192, True, 0, 0.0),       # ragged tail, G = 1
    (1, 100, 32, 4, 192, True, 0, 0.0),       # G = 8 at three slabs
    (1, 130, 8, 2, 176, False, 24, 20.0),     # D not a multiple of 64
    (1, 256, 16, 16, 256, True, 0, 0.0),      # four slabs, the limit
    (2, 70, 8, 4, 256, False, 0, 0.0),
    (1, 256, 32, 4, 128, True, 0, 0.0),       # Qwen3's prefill (qk-norm)
])
def test_flash_attention_wide_heads_match_plain(cuda, B, S, Hq, Hkv, D,
                                                causal, window, cap):
    """K3 at three and four 64-column slabs (one block per SM): MLA's
    q/k head width 192 with the values zero-padded to it, as
    ``mla_attention`` pads them, and the Pallas kernel's limit 256."""
    rng = np.random.default_rng(D + S)
    t = lambda shape: torch.tensor(rng.standard_normal(shape),
                                   dtype=torch.bfloat16, device=cuda)
    q, k, v = t((B, S, Hq, D)), t((B, S, Hkv, D)), t((B, S, Hkv, D))
    if D == 192:
        v[..., 128:] = 0                        # MLA's padded values
    before = kernels.LAUNCHES["flash_attention"]
    o = flash_attention(q, k, v, causal=causal, window=window, softcap=cap)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["flash_attention"] == before + 1
    r = flash_attention_plain(q, k, v, causal=causal, window=window,
                              softcap=cap)
    assert _rel_err(o, r) < BF16_TOL
    if D == 192:
        assert not bool(o[..., 128:].float().abs().sum())


@pytest.mark.parametrize("D", [272, 320, 200])
def test_flash_attention_refuses_heads_past_its_limit(cuda, D):
    q = torch.zeros((1, 8, 2, D), dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError, match="D <= 256"):
        flash_attention(q, q, q)


@pytest.mark.parametrize("T,E,k", [(2, 64, 6), (8, 64, 6), (48, 64, 6),
                                   (2, 128, 8), (8, 128, 8), (256, 128, 8)])
def test_gating_warp_at_the_new_routers_matches_plain(cuda, T, E, k):
    """K1's warp variant at DeepSeek-V2-Lite's (64, top-6) and
    Qwen3-30B-A3B's (128, top-8) routers, softmax then top-k,
    renormalised: decode batches and the 256-token admission bucket."""
    rng = np.random.default_rng(T * E)
    lg = torch.tensor(rng.standard_normal((T, E)) * 2, dtype=torch.float32,
                      device=cuda)
    assert plan(E, k)[0] == "warp"
    _check_gating(lg, k, "softmax_topk", True)


@pytest.mark.parametrize("f,E,K", [(768, 128, 8), (1408, 64, 6)])
def test_expert_ffn_at_the_new_expert_widths_matches_plain(cuda, f, E, K):
    """K2 ragged over an admission bucket and grouped over a batch-8
    decode (G = 8 K groups of one row, repeated expert ids) at d = 2048 and
    Qwen3-30B-A3B's / DeepSeek-V2-Lite's expert widths."""
    d = 2048
    rng = np.random.default_rng(f)
    T = 256
    C = max(4, -(-T * K // E) * 5 // 4)
    xe, wg, wu, wd = _ffn_inputs(cuda, E, E, C, d, f, seed=f)
    idx = rng.integers(0, E, (T * K,))
    cnt = torch.tensor(np.minimum(np.bincount(idx, minlength=E), C),
                       dtype=torch.int32, device=cuda)
    y = expert_ffn(xe, wg, wu, wd, counts=cnt)
    torch.cuda.synchronize()
    assert _rel_err(y, expert_ffn_plain(xe, wg, wu, wd, counts=cnt)) \
        < BF16_TOL
    G = 8 * K
    xs = xe[:G, :1].contiguous()
    eids = torch.tensor(rng.integers(0, E, (G,)), dtype=torch.int32,
                        device=cuda)
    ones = torch.ones((G,), dtype=torch.int32, device=cuda)
    y = expert_ffn(xs, wg, wu, wd, counts=ones, expert_ids=eids)
    torch.cuda.synchronize()
    r = expert_ffn_plain(xs, wg, wu, wd, counts=ones, expert_ids=eids)
    assert _rel_err(y, r) < BF16_TOL


@pytest.mark.parametrize("arch", ["qwen3-30b-a3b", "deepseek-v2-lite-16b"])
def test_new_models_prefill_through_the_kernels(cuda, arch):
    """A bfloat16 smoke model of each family: the prefill launches K1 and
    K3 in every layer (MLA's at its padded head width; never SDPA or the
    plain version) and gives finite logits; the first layer's attention
    (qk-norm GQA, or MLA) is within 3e-2 of the same layer on the CPU."""
    from repro_torch.configs import get_config, make_smoke
    from repro_torch.models.attention import gqa_attention, mla_attention
    from repro_torch.models.model import apply_model, init_model
    from repro_torch.tree import tree_map
    cfg = make_smoke(get_config(arch)).replace(dtype="bfloat16",
                                               param_dtype="bfloat16")
    cpu = init_model(cfg, seed=0, device="cpu")
    gpu = tree_map(lambda t: t.to(cuda), cpu)
    toks = torch.tensor(np.random.default_rng(0).integers(
        0, cfg.vocab, (1, 40)), dtype=torch.int32)
    kernels.reset_launch_counts()
    lg, _, _ = apply_model(gpu, toks.to(cuda), cfg)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["flash_attention"] == cfg.n_layers
    assert kernels.LAUNCHES["gating"] + kernels.LAUNCHES["gating_warp"] > 0
    assert bool(torch.isfinite(lg[..., :cfg.vocab]).all())
    x = torch.tensor(np.random.default_rng(1).standard_normal(
        (1, 40, cfg.d_model)), dtype=torch.bfloat16)
    pos = torch.arange(40, dtype=torch.int32)
    attn = (mla_attention if cfg.attn.mla is not None else
            lambda p, h, c, **kw: gqa_attention(p, h, c, kind="attn", **kw))
    mixer = lambda tree: tree["prefix"][0]["mixer"] if tree["prefix"] \
        else tree_map(lambda t: t[0], tree["scan"][0]["mixer"])
    yc, _ = attn(mixer(cpu), x, cfg, positions=pos)
    yg, _ = attn(mixer(gpu), x.to(cuda), cfg, positions=pos.to(cuda))
    assert _rel_err(yg.cpu(), yc) < BF16_TOL


# --------------------------------------------------------------------------
# fault-tolerant offload streaming on the card
# --------------------------------------------------------------------------

def _small_bf16_model(seed=0):
    from repro_torch.configs import get_config, make_smoke
    from repro_torch.models.model import init_model
    cfg = make_smoke(get_config("mixtral-8x7b")).replace(
        n_layers=2, dtype="bfloat16", param_dtype="bfloat16")
    cfg = cfg.replace(moe=dataclasses.replace(cfg.moe, n_routed=8))
    params = init_model(cfg, seed=seed, device="cuda")
    host = init_model(cfg, seed=seed, device="cuda", experts="host")
    return cfg, params, host


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_row_checksums_on_the_card_equal_the_cpu(cuda, dtype):
    from repro_torch.serving.expert_store import row_checksums
    rng = np.random.default_rng(0)
    x = torch.tensor(rng.standard_normal((6, 64, 96)), dtype=dtype)
    x[0, 0, :3] = torch.tensor([float("nan"), -0.0, float("inf")])
    for t in (x, x[1:], x.reshape(6, -1)[:, 1:]):      # odd offsets too
        assert torch.equal(row_checksums(t.to(cuda)).cpu(), row_checksums(t))


def test_little_twins_on_the_card_equal_the_cpu(cuda):
    """The quantizer divides by tensors: CUDA divides by a host scalar
    through its reciprocal, so the twins would part from the CPU's."""
    from repro_torch.serving.expert_store import ExpertStore
    from repro_torch.tree import tree_map
    cfg, _, host = _small_bf16_model()
    on_card = ExpertStore(host, cfg, n_slots=3).little_view()
    on_cpu = ExpertStore(tree_map(lambda t: t.cpu(), host), cfg,
                         n_slots=3).little_view()
    for k in on_cpu:
        assert torch.equal(on_card[k].cpu(), on_cpu[k]), k


def test_faulted_decode_on_the_card_equals_full_resident(cuda):
    """Transient, read-error and corrupt-row faults in every mode on the
    card: retried and restaged, decode equal to full-resident's."""
    from repro_torch.serving import expert_store as es
    from repro_torch.serving import steps
    cfg, params, host = _small_bf16_model()
    pol = steps.resolve_policy("dali", cfg)
    slim = es.strip_expert_params(host, cfg)
    for mode in ("blocking", "overlap", "pipelined"):
        for faults in ("transient_stall@1-4", "read_error@1-4",
                       "corrupt_rows@1-6"):
            store = es.ExpertStore(host, cfg, n_slots=3, mode=mode,
                                   faults=faults, retry_backoff_s=1e-4)
            dec_ref = steps.make_decode_step(cfg, policy=pol)
            dec = steps.ResilientDecode(cfg, policy=pol, offload=store)
            s_ref = steps.init_serve_state(cfg, 2, 32, policy=pol, device=cuda)
            s_slot = steps.init_serve_state(cfg, 2, 32, policy=pol,
                                            device=cuda, offload=store)
            rng, target = np.random.default_rng(2), None
            for t in range(8):
                tok = torch.tensor(rng.integers(1, cfg.vocab, (2, 1)),
                                   dtype=torch.int32, device=cuda)
                s_ref["tokens"], s_slot["tokens"] = tok, tok.clone()
                if t == 2:                     # every plan stages rows
                    store._cur[:] = -1
                    store._set_dev_cur(s_slot["offload"], store._cur)
                s_slot["offload"] = store.pre_step(s_slot["offload"], mode,
                                                   target)
                dec.react()
                s_ref, lg_ref, _ = dec_ref(params, s_ref)
                s_slot, lg_slot, tel = dec(slim, s_slot)
                store.post_dispatch(mode, target)
                target = store.next_target(s_slot, tel)
                assert torch.equal(lg_ref, lg_slot), (mode, faults, t)
            st = store.stats()
            assert st["stage_aborts"] == 0
            assert st["retries"] + st["corrupt_caught"] > 0, (mode, faults)
            if faults.startswith("corrupt"):
                assert st["restaged_rows"] >= st["corrupt_caught"] > 0


def test_little_rung_on_the_card_launches_k4_and_stays_close(cuda):
    from repro_torch.serving import expert_store as es
    from repro_torch.serving import steps
    cfg, params, host = _small_bf16_model()
    pol = steps.resolve_policy("dali", cfg)
    store = es.ExpertStore(host, cfg, n_slots=3, mode="pipelined",
                           fallback="little")
    dec_ref = steps.make_decode_step(cfg, policy=pol)
    dec = steps.make_decode_step(cfg, policy=pol, offload=store)
    s_ref = steps.init_serve_state(cfg, 2, 32, policy=pol, device=cuda)
    s = steps.init_serve_state(cfg, 2, 32, policy=pol, device=cuda,
                                offload=store)
    store._cur[:] = -1
    store._set_dev_cur(s["offload"], store._cur)
    tok = torch.tensor([[3], [7]], dtype=torch.int32, device=cuda)
    s_ref["tokens"], s["tokens"] = tok, tok.clone()
    before = kernels.LAUNCHES["expert_ffn_grouped"]
    _, lg_ref, _ = dec_ref(params, s_ref)
    _, lg, _ = dec(es.strip_expert_params(host, cfg), s)
    torch.cuda.synchronize()
    # per MoE layer: the pool launch and the launch over the twins' rows
    assert kernels.LAUNCHES["expert_ffn_grouped"] - before >= 2 * 2
    assert store.stats()["fallback_rows"] == 2 * 2 * cfg.moe.top_k
    assert store.stats()["fallback_fetches"] == 0
    err = float((lg.float() - lg_ref.float()).norm() / lg_ref.float().norm())
    assert 0.0 < err < 0.2


# --------------------------------------------------------------------------
# long prompts: K3 past the blockwise threshold, the chunked MoE layer
# --------------------------------------------------------------------------

def test_flash_attention_long_prompt_matches_blockwise_plain(cuda):
    """K3 at S = 8192 against the plain version, which attends blockwise
    from 4096 keys on (the dense one would hold 8.6 GB of scores).  Row by
    row: a late row averages thousands of values and is far smaller than
    row 0, so one scale for the whole output would not see it."""
    g = torch.Generator(device=cuda)
    g.manual_seed(0)
    S, Hq, Hkv, D = 8192, 32, 8, 128
    q = torch.randn((1, S, Hq, D), generator=g, device=cuda).bfloat16()
    k = torch.randn((1, S, Hkv, D), generator=g, device=cuda).bfloat16()
    v = torch.randn((1, S, Hkv, D), generator=g, device=cuda).bfloat16()
    before = kernels.LAUNCHES["flash_attention"]
    o = flash_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["flash_attention"] == before + 1
    assert _row_rel_err(o, flash_attention_plain(q, k, v, causal=True)) \
        < BF16_TOL


def test_chunked_apply_moe_on_the_card_matches_plain(cuda, monkeypatch):
    """A 96-token MoE forward in chunks of 40 (the last one padded and
    masked): K1 and K2 ragged launch once per chunk, and the output and
    every observable agree with the same forward through the plain
    versions on the card (indices and workloads exactly)."""
    import repro_torch.models.moe as moe
    from repro_torch.kernels.expert_ffn import ops as ffn_ops
    from repro_torch.kernels.gating import ops as gating_ops
    cfg, params, _ = _small_bf16_model()
    mlp = {k: v[0] for k, v in params["scan"][0]["mlp"].items()}
    monkeypatch.setattr(moe, "MOE_CHUNK_TOKENS", 40)
    x = torch.tensor(np.random.default_rng(2).standard_normal(
        (2, 48, cfg.d_model)), dtype=torch.bfloat16, device=cuda)
    kernels.reset_launch_counts()
    y, info = moe.apply_moe(mlp, x, cfg)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["gating"] == 3
    assert kernels.LAUNCHES["expert_ffn_ragged"] == 3
    monkeypatch.setattr(gating_ops, "_launch", gating_ops.gating_plain)
    monkeypatch.setattr(ffn_ops, "_launch", lambda *a: ffn_ops
                        .expert_ffn_plain(*a))
    yp, ip = moe.apply_moe(mlp, x, cfg)
    assert _rel_err(y, yp) < BF16_TOL
    for key in ("topk_idx", "workload", "dropped"):
        assert torch.equal(info[key], ip[key]), key
    assert info["topk_idx"].shape == (96, cfg.moe.top_k)


# --------------------------------------------------------------------------
# the remaining architectures on the card
# --------------------------------------------------------------------------

@pytest.mark.parametrize("B,Sq,Sk,Hq,Hkv,D,causal,window,cap", [
    (1, 64, 1601, 32, 32, 128, False, 0, 0.0),    # vision cross, Sq != Sk
    (1, 1024, 1024, 16, 16, 64, False, 0, 0.0),   # Seamless's encoder
    (1, 5000, 5000, 16, 8, 256, True, 4096, 50.0),  # Gemma-2 local layer
    (1, 256, 256, 128, 8, 128, True, 0, 0.0),     # Llama-3-405B, G = 16
    (2, 128, 128, 64, 8, 128, True, 0, 0.0),      # Jamba's attention
    (1, 256, 256, 40, 8, 128, True, 0, 0.0),      # Llama-4: G = 5
])
def test_flash_attention_at_the_new_archs_shapes_matches_plain(
        cuda, B, Sq, Sk, Hq, Hkv, D, causal, window, cap):
    """K3 at the shapes the new architectures give it, row by row against
    the plain version (blockwise from 4096 keys); Llama-4's query groups
    of 5, which do not divide the kernel's 64-row tile, attend over K/V
    heads repeated to one per query head."""
    g = torch.Generator(device=cuda)
    g.manual_seed(Sq)
    q = torch.randn((B, Sq, Hq, D), generator=g, device=cuda).bfloat16()
    k = torch.randn((B, Sk, Hkv, D), generator=g, device=cuda).bfloat16()
    v = torch.randn((B, Sk, Hkv, D), generator=g, device=cuda).bfloat16()
    kw = dict(causal=causal, window=window, softcap=cap)
    before = kernels.LAUNCHES["flash_attention"]
    o = flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["flash_attention"] == before + 1
    assert _row_rel_err(o, flash_attention_plain(q, k, v, **kw)) < BF16_TOL


def test_expert_ffn_over_jambas_stack_past_two_to_the_31(cuda):
    """Jamba's expert widths (E = 16, d = 8192, f = 24576): each weight
    stack holds 3.2e9 elements, past 2^31, so the last experts sit at
    offsets that only 64-bit strides reach.  K2 ragged over the 256-token
    bucket and K4 grouped over a decode step whose ids reach expert 15."""
    g = torch.Generator(device=cuda)
    g.manual_seed(20)
    E, d, f, C = 16, 8192, 24576, 40
    w = lambda *s: (torch.randn(s, generator=g, device=cuda)
                    / s[1] ** 0.5).bfloat16()
    wg, wu, wd = w(E, d, f), w(E, d, f), w(E, f, d)
    assert wg.numel() > 2**31
    xe = torch.randn((E, C, d), generator=g, device=cuda).bfloat16()
    cnt = torch.randint(1, C + 1, (E,), generator=g, device=cuda,
                        dtype=torch.int32)
    y = expert_ffn(xe, wg, wu, wd, counts=cnt)
    torch.cuda.synchronize()
    assert _rel_err(y, expert_ffn_plain(xe, wg, wu, wd, counts=cnt)) \
        < BF16_TOL
    eids = torch.tensor([15, 3, 12, 15], dtype=torch.int32, device=cuda)
    ones = torch.ones((4,), dtype=torch.int32, device=cuda)
    xs = xe[:4, :1].contiguous()
    y = expert_ffn(xs, wg, wu, wd, counts=ones, expert_ids=eids)
    torch.cuda.synchronize()
    r = expert_ffn_plain(xs, wg, wu, wd, counts=ones, expert_ids=eids)
    assert _rel_err(y, r) < BF16_TOL
    # expert 15 alone: the rows that only the far end of the stack feeds
    assert _rel_err(y[0], r[0]) < BF16_TOL


@pytest.mark.parametrize("T", [2, 256])
def test_gating_sigmoid_top1_at_llama4s_router(cuda, T):
    """Llama-4's router (E = 128, top-1, sigmoid, no renormalisation): the
    warp variant against the plain version."""
    rng = np.random.default_rng(T)
    lg = torch.tensor(rng.standard_normal((T, 128)) * 2,
                      dtype=torch.float32, device=cuda)
    assert plan(128, 1)[0] == "warp"
    _check_gating(lg, 1, "sigmoid", False)


def test_apply_mamba_on_the_card_matches_the_cpu(cuda):
    """Mamba-2's block (bfloat16 smoke widths) through a prefill then two
    decode steps on the card against the same on the CPU: outputs and every
    cache leaf within 3e-2."""
    from repro_torch.configs import get_config, make_smoke
    from repro_torch.models.mamba import (apply_mamba, init_mamba,
                                          init_mamba_cache)
    cfg = make_smoke(get_config("mamba2-780m")).replace(
        dtype="bfloat16", param_dtype="bfloat16")
    cpu = init_mamba(torch.Generator().manual_seed(0), cfg, "cpu")
    gpu = {k: t.to(cuda) for k, t in cpu.items()}
    x = torch.tensor(np.random.default_rng(1).standard_normal(
        (2, 21, cfg.d_model)) * 0.5, dtype=torch.bfloat16)
    cc = init_mamba_cache(cfg, 2, "cpu")
    cg = init_mamba_cache(cfg, 2, cuda)
    for lo, hi in ((0, 19), (19, 20), (20, 21)):
        yc, cc = apply_mamba(cpu, x[:, lo:hi], cfg, cc)
        yg, cg = apply_mamba(gpu, x[:, lo:hi].to(cuda), cfg, cg)
        assert _rel_err(yg.cpu(), yc) < BF16_TOL, (lo, hi)
        for k in cc:
            assert _rel_err(cg[k].cpu(), cc[k]) < BF16_TOL, k


def test_rolling_cache_write_on_the_card_wraps_at_pos_mod_window(cuda):
    """The ring write on the card: a prefill of 37 positions into a
    16-slot rolling cache keeps each of the last 16 at slot pos % 16, as on
    the CPU; then Gemma-2's bfloat16 smoke model decodes after a 37-token
    prompt within 3e-2 of its recompute on the card."""
    from repro_torch.configs import get_config, make_smoke
    from repro_torch.models.attention import _update_cache
    from repro_torch.models.model import apply_model, init_caches, init_model
    caches = {dev: {"k": torch.zeros((1, 16, 1, 1), device=dev),
                    "pos": torch.full((1, 16), -1, dtype=torch.int32,
                                      device=dev)} for dev in ("cpu", cuda)}
    pos = torch.arange(37, dtype=torch.int32)
    for dev, c in caches.items():
        _update_cache(c, pos.to(dev),
                      k=pos.float().to(dev)[None, :, None, None])
    assert torch.equal(caches[cuda]["pos"].cpu(), caches["cpu"]["pos"])
    assert torch.equal(caches[cuda]["k"].cpu(), caches["cpu"]["k"])
    assert torch.equal(caches["cpu"]["pos"][0] % 16, torch.arange(16))
    cfg = make_smoke(get_config("gemma2-9b")).replace(
        dtype="bfloat16", param_dtype="bfloat16")
    params = init_model(cfg, seed=0, device=cuda)
    toks = torch.tensor(np.random.default_rng(3).integers(
        0, cfg.vocab, (1, 37)), dtype=torch.int32, device=cuda)
    c = init_caches(cfg, 1, 48, device=cuda)
    lg, c, _ = apply_model(params, toks, cfg, positions=torch.arange(
        37, dtype=torch.int32, device=cuda), caches=c, last_logit_only=True)
    nxt = lg[:, -1:].argmax(-1).to(torch.int32)
    dec, _, _ = apply_model(params, nxt, cfg, positions=torch.tensor(
        [37], dtype=torch.int32, device=cuda), caches=c)
    full, _, _ = apply_model(params, torch.cat([toks, nxt], 1), cfg,
                             last_logit_only=True)
    assert _rel_err(dec[:, -1], full[:, -1]) < BF16_TOL


def test_jamba_offloaded_wave_on_the_card_equals_full_resident(cuda):
    """Jamba's bfloat16 smoke model through the wave server on the card:
    the pipelined slot pool (four MoE layers between Mamba layers, experts
    drawn into the host store) gives the full-resident tokens."""
    from repro_torch.configs import get_config, make_smoke
    from repro_torch.models.model import init_model
    from repro_torch.serving.scheduler import Request
    from repro_torch.serving.spec import OffloadSpec, ServeSpec
    cfg = make_smoke(get_config("jamba-1.5-large-398b")).replace(
        dtype="bfloat16", param_dtype="bfloat16")
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, cfg.vocab, n).astype(np.int32)
               for n in (9, 20, 14, 5)]
    outs = {}
    for mode, experts in (("modeled", "device"), ("pipelined", "host")):
        params = init_model(cfg, seed=0, device=cuda, experts=experts)
        srv = ServeSpec(cfg=cfg, server="wave", policy="dali",
                        batch_size=2, max_len=48, eos_id=-1,
                        offload=OffloadSpec(mode=mode)).resolve(
                            params).server()
        for i, p in enumerate(prompts):
            srv.submit(Request(rid=i, prompt=p, max_new_tokens=6))
        kernels.reset_launch_counts()
        outs[mode] = {r.rid: r.output for r in srv.run()}
        assert kernels.LAUNCHES["gating"] > 0
        assert kernels.LAUNCHES["flash_attention"] > 0
    assert outs["pipelined"] == outs["modeled"]


@pytest.mark.parametrize("ragged", [True, False])
def test_expert_ffn_at_the_ep_group_layout_matches_plain(cuda, ragged):
    """K4 as the expert-parallel layer calls it (models/moe_ep.py::
    _ep_expert_ffn): E/tp weight sets, one group per (expert, source),
    group e * tp + src, the exchanged (tp, E/tp) counts (the dense
    exchange counts every row)."""
    from repro_torch.models.config import ModelConfig, MoEConfig
    from repro_torch.models.moe_ep import _ep_expert_ffn
    E_loc, tp, C, d, f = 2, 4, 80, 128, 256
    cfg = ModelConfig(d_model=d, d_ff=f, moe=MoEConfig(n_routed=E_loc * tp,
                                                       top_k=2, d_expert=f))
    xa, wg, wu, wd = _ffn_inputs(cuda, E_loc * tp, E_loc, C, d, f, seed=7)
    xa = xa.reshape(E_loc, tp, C, d)
    cnt = (torch.tensor([[0, 80], [13, 1], [64, 65], [79, 0]],
                        dtype=torch.int32, device=cuda) if ragged else None)
    before = kernels.LAUNCHES["expert_ffn_grouped"]
    y = _ep_expert_ffn(xa, wg, wu, wd, cnt, cfg)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["expert_ffn_grouped"] == before + 1
    gcnt = (cnt.t().reshape(-1) if ragged
            else torch.full((E_loc * tp,), C, dtype=torch.int32,
                            device=cuda))
    eids = torch.arange(E_loc, dtype=torch.int32,
                        device=cuda).repeat_interleave(tp)
    r = expert_ffn_plain(xa.reshape(E_loc * tp, C, d), wg, wu, wd,
                         counts=gcnt, expert_ids=eids).reshape(y.shape)
    assert _rel_err(y, r) < BF16_TOL
    rows = (torch.arange(C, device=cuda)[None, :]
            >= gcnt[:, None]).reshape(E_loc, tp, C)
    assert not y[rows].float().abs().sum()


def _layout_rank(rank, world):
    """A rank of ``test_layout_on_gloo_ranks_runs_the_kernels``: smoke
    Mixtral in bfloat16 laid out on a (2, 2) mesh whose every rank is on
    this card, against the single-process port on the same card."""
    from repro_torch.configs import get_config, make_smoke
    from repro_torch.launch import layout as lay
    from repro_torch.launch import sharding as shd
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.model import apply_model, init_model
    cfg = make_smoke(get_config("mixtral_8x7b")).replace(
        dtype="bfloat16", param_dtype="bfloat16")
    params = init_model(cfg, seed=0, device="cuda")
    toks = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab, (4, 64)), dtype=torch.int32, device="cuda")
    with torch.no_grad():
        ref = apply_model(params, toks, cfg)[0][..., :cfg.vocab].float()
    mesh = make_mesh(2, 2, device_type="cuda")
    kernels.reset_launch_counts()
    with shd.rules(mesh, shd.logical_map_for(cfg, "prefill_32k", mesh)), \
            torch.no_grad():
        logits = apply_model(lay.distribute_params(params, cfg, mesh),
                             lay.distribute_batch(toks, mesh), cfg)[0]
        torch.cuda.synchronize()
        launches = kernels.launch_counts()
        got = logits.full_tensor().float()
    return _row_rel_err(got, ref), launches


def test_layout_on_gloo_ranks_runs_the_kernels(cuda):
    """The laid-out forward on four gloo ranks sharing the card (their
    collectives staged through host memory by ``HostWire``): K1 on each
    rank's tokens, K2 ragged on its f slice, K3 on its heads; logits
    within 3e-2 of the single-process port."""
    from repro_torch.launch.mesh import run_ranks
    for err, launches in run_ranks(_layout_rank, 4, backend="gloo",
                                   device="cuda", timeout_s=300):
        assert err < BF16_TOL
        for k in ("gating", "expert_ffn_ragged", "flash_attention"):
            assert launches[k] > 0, k
