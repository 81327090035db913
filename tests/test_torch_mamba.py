"""The port's Mamba-2 / SSD (``repro_torch/models/mamba.py``) against the JAX
package's (``repro/models/mamba.py``): the chunked scan with padding and a
carried state, the single-token recurrence, the gated norm and the cache
leaves of a prefill then a decode, on the reference's parameters carried
over by ``repro_torch.bridge`` and seeded numpy inputs; then the port's
twins of tests/test_models.py's SSD, blockwise-attention and layer-pattern
tests.

Tolerance: 3e-5 relative to max |ref| (float32; tests/test_kernels.py:17);
the twins keep their reference tests' tolerances.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.mamba as jmamba
import repro_torch.models.mamba as tmamba
from _hypothesis_compat import given, settings, st
from repro_torch import bridge
from repro_torch.configs import get_config
from repro_torch.kernels.flash_attention.ops import mha, mha_blockwise
from repro_torch.models.config import (MambaConfig, ModelConfig,
                                       layer_pattern, scan_pattern)

F32_TOL = 3e-5


def _cfg(chunk=4, G=1, **kw):
    return ModelConfig(
        d_model=32, d_ff=0, family="ssm", attn=None, dtype="float32",
        param_dtype="float32",
        mamba=MambaConfig(d_state=8, d_conv=3, expand=2, head_dim=16,
                          n_groups=G, chunk_size=chunk), **kw)


def _jcfg(cfg):
    from repro.models.config import MambaConfig as JMamba
    from repro.models.config import ModelConfig as JModel
    return JModel(**{**cfg.__dict__, "mamba": JMamba(**cfg.mamba.__dict__)})


def _x(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _rel(t, j):
    t = t.detach().float().numpy() if torch.is_tensor(t) else np.asarray(t)
    j = np.asarray(j, np.float32)
    assert t.shape == j.shape, (t.shape, j.shape)
    return float(np.abs(t - j).max()) / (float(np.abs(j).max()) + 1e-30)


def _close(t, j, what=""):
    err = _rel(t, j)
    assert err < F32_TOL, f"{what}: {err:.3e}"


@pytest.fixture(scope="module")
def params():
    cfg = _cfg()
    jp = jax.tree.map(np.asarray, jmamba.init_mamba(jax.random.PRNGKey(0),
                                                    _jcfg(cfg)))
    return cfg, jax.tree.map(jnp.asarray, jp), bridge.to_torch(jp, "cpu")


def _ssd_inputs(S, seed, H=4, P=16, G=1, N=8, B=2):
    rng = np.random.default_rng(seed)
    xh = rng.standard_normal((B, S, H, P)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((B, S, H)))).astype(np.float32)
    A = -np.exp(rng.uniform(0.0, 2.0, H)).astype(np.float32)
    Bm = rng.standard_normal((B, S, G, N)).astype(np.float32)
    Cm = rng.standard_normal((B, S, G, N)).astype(np.float32)
    return xh, dt, A, Bm, Cm


@pytest.mark.parametrize("S", [5, 8, 13])
@pytest.mark.parametrize("with_state", [False, True])
def test_ssd_chunked_matches_reference(S, with_state):
    """Chunk 4: S = 5 and 13 pad their last chunk (dt = 0 there), S = 8
    does not; with a carried initial state as prefill after a cache."""
    cfg = _cfg()
    ins = _ssd_inputs(S, seed=S)
    st0 = _x((2, 4, 16, 8), 7, 0.3) if with_state else None
    yj, sj = jmamba.ssd_chunked(*map(jnp.asarray, ins), _jcfg(cfg),
                                None if st0 is None else jnp.asarray(st0))
    yt, stt = tmamba.ssd_chunked(*map(torch.from_numpy, ins), cfg,
                                 None if st0 is None else torch.from_numpy(
                                     st0))
    _close(yt, yj, "y")
    _close(stt, sj, "final state")


def test_ssd_decode_and_gated_norm_match_reference():
    xh, dt, A, Bm, Cm = _ssd_inputs(1, seed=3)
    one = lambda a: a[:, 0]
    args = (one(xh), one(dt), A, one(Bm), one(Cm))
    state = _x((2, 4, 16, 8), 9, 0.5)
    yj, sj = jmamba.ssd_decode(*map(jnp.asarray, args), jnp.asarray(state))
    yt, stt = tmamba.ssd_decode(*map(torch.from_numpy, args),
                                torch.from_numpy(state))
    _close(yt, yj, "y")
    _close(stt, sj, "state")
    w, y, z = _x((64,), 1, 0.1), _x((2, 3, 64), 2), _x((2, 3, 64), 3)
    _close(tmamba._gated_norm(*map(torch.from_numpy, (w, y, z))),
           jmamba._gated_norm(*map(jnp.asarray, (w, y, z))), "gated norm")


def test_segsum_and_convs_match_reference():
    x = _x((2, 3, 6), 4)
    a, b = np.asarray(jmamba._segsum(jnp.asarray(x))), \
        tmamba._segsum(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(np.isinf(a), np.isinf(b))
    _close(b[np.isfinite(b)], a[np.isfinite(a)], "segsum")
    xs, w, bias = _x((2, 7, 10), 5), _x((3, 10), 6), _x((10,), 7)
    _close(tmamba._causal_conv(*map(torch.from_numpy, (xs, w, bias))),
           jmamba._causal_conv(*map(jnp.asarray, (xs, w, bias))), "conv")
    _close(tmamba._conv_step(*map(torch.from_numpy, (xs[:, :3], w, bias))),
           jmamba._conv_step(*map(jnp.asarray, (xs[:, :3], w, bias))),
           "conv step")


def test_init_mamba_keeps_the_reference_tree_and_dtypes():
    cfg = _cfg().replace(dtype="bfloat16", param_dtype="bfloat16")
    jp = jmamba.init_mamba(jax.random.PRNGKey(0), _jcfg(cfg))
    tp = tmamba.init_mamba(torch.Generator().manual_seed(0), cfg, "cpu")
    assert tp.keys() == jp.keys()
    for k in tp:
        assert tuple(tp[k].shape) == jp[k].shape, k
        assert str(tp[k].dtype).replace("torch.", "") == jp[k].dtype.name, k
    for k in ("dt_bias", "A_log", "D"):
        assert tp[k].dtype == torch.float32
    # the reference's ranges: dt = softplus(dt_bias) in [1e-3, 1e-1], A in
    # [-16, -1]
    dt = torch.nn.functional.softplus(tp["dt_bias"])
    assert float(dt.min()) >= 1e-3 * 0.999 and float(dt.max()) <= 0.1001
    A = -torch.exp(tp["A_log"])
    assert float(A.min()) >= -16.0 and float(A.max()) <= -1.0
    jc = _jcfg(cfg)
    jcache = jmamba.init_mamba_cache(jc, 2, jnp.bfloat16)
    tcache = tmamba.init_mamba_cache(cfg, 2, "cpu")
    for k in jcache:
        assert tuple(tcache[k].shape) == jcache[k].shape, k
        assert str(tcache[k].dtype).replace("torch.", "") \
            == jcache[k].dtype.name, k


@pytest.mark.parametrize("S", [5, 8, 13])
def test_apply_mamba_full_sequence_matches_reference(params, S):
    cfg, jp, tp = params
    x = _x((2, S, 32), S, 0.5)
    yj, cj = jmamba.apply_mamba(jp, jnp.asarray(x), _jcfg(cfg))
    yt, ct = tmamba.apply_mamba(tp, torch.from_numpy(x), cfg)
    assert cj is None and ct is None
    _close(yt, yj, "y")


def test_apply_mamba_cache_after_prefill_then_decode_matches(params):
    """Prefill 9 tokens into a cache, then decode 2: every cache leaf and
    output equals the reference's, and the port's cache tensors are the
    ones it was given (updated in place)."""
    cfg, jp, tp = params
    jc = _jcfg(cfg)
    x = _x((2, 11, 32), 21, 0.5)
    jcache = jmamba.init_mamba_cache(jc, 2)
    tcache = tmamba.init_mamba_cache(cfg, 2, "cpu")
    ptrs = {k: t.data_ptr() for k, t in tcache.items()}
    for lo, hi in ((0, 9), (9, 10), (10, 11)):
        yj, jcache = jmamba.apply_mamba(jp, jnp.asarray(x[:, lo:hi]), jc,
                                        jcache)
        yt, tcache = tmamba.apply_mamba(tp, torch.from_numpy(x[:, lo:hi]),
                                        cfg, tcache)
        _close(yt, yj, f"y [{lo}:{hi}]")
        for k in jcache:
            _close(tcache[k], jcache[k], f"{k} after [{lo}:{hi}]")
    assert {k: t.data_ptr() for k, t in tcache.items()} == ptrs


# --------------------------------------------------------------------------
# twins of tests/test_models.py:86-160
# --------------------------------------------------------------------------

@settings(max_examples=6, deadline=None)
@given(st.integers(0, 50), st.sampled_from([5, 8, 13]))
def test_ssd_chunked_equals_recurrent(seed, S):
    cfg = _cfg()
    gen = torch.Generator().manual_seed(seed)
    p = tmamba.init_mamba(gen, cfg, "cpu")
    x = torch.randn((2, S, 32), generator=gen) * 0.5
    y_full, _ = tmamba.apply_mamba(p, x, cfg, cache=None)
    cache = tmamba.init_mamba_cache(cfg, 2, "cpu")
    ys = []
    for t in range(S):
        y_t, cache = tmamba.apply_mamba(p, x[:, t:t + 1], cfg, cache)
        ys.append(y_t)
    np.testing.assert_allclose(y_full.numpy(), torch.cat(ys, 1).numpy(),
                               rtol=2e-3, atol=2e-3)


def test_ssd_prefill_then_decode_state_consistent():
    cfg = _cfg()
    gen = torch.Generator().manual_seed(0)
    p = tmamba.init_mamba(gen, cfg, "cpu")
    x = torch.randn((1, 9, 32), generator=gen) * 0.5
    cache = tmamba.init_mamba_cache(cfg, 1, "cpu")
    _, cache = tmamba.apply_mamba(p, x[:, :8], cfg, cache)      # prefill
    y_dec, _ = tmamba.apply_mamba(p, x[:, 8:9], cfg, cache)     # decode
    y_full, _ = tmamba.apply_mamba(p, x, cfg, None)
    np.testing.assert_allclose(y_dec[:, 0].numpy(), y_full[:, 8].numpy(),
                               rtol=2e-3, atol=2e-3)


@settings(max_examples=20, deadline=None)
@given(st.integers(0, 1000), st.sampled_from([(8, 64), (64, 64), (1, 96)]),
       st.booleans(), st.sampled_from([0, 16]),
       st.sampled_from([0.0, 30.0]))
def test_blockwise_matches_dense(seed, sqk, causal, window, softcap):
    import repro_torch.kernels.flash_attention.ops as fa
    Sq, Sk = sqk
    rng = np.random.default_rng(seed)
    B, Hq, Hkv, D = 2, 4, 2, 16
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               for s in ((B, Sq, Hq, D), (B, Sk, Hkv, D), (B, Sk, Hkv, D)))
    qp, kp = torch.arange(Sk - Sq, Sk), torch.arange(Sk)
    kw = dict(causal=causal, window=window, softcap=softcap, scale=0.25)
    dense = mha(q, k, v, qp, kp, **kw)
    old = fa.BLOCKWISE_KV_BLOCK
    fa.BLOCKWISE_KV_BLOCK = 32
    try:
        blk = mha_blockwise(q, k, v, qp, kp, **kw)
    finally:
        fa.BLOCKWISE_KV_BLOCK = old
    np.testing.assert_allclose(dense.numpy(), blk.numpy(), rtol=2e-5,
                               atol=2e-5)


def test_scan_pattern_factorisation():
    for arch in ("jamba_1_5_large_398b", "gemma2_9b",
                 "llama_3_2_vision_11b", "deepseek_v2_lite_16b"):
        cfg = get_config(arch)
        prefix, period, n_super = scan_pattern(cfg)
        rebuilt = list(prefix) + list(period) * n_super
        assert tuple(rebuilt) == layer_pattern(cfg)


def test_jamba_pattern_ratios():
    cfg = get_config("jamba_1_5_large_398b")
    pat = layer_pattern(cfg)
    attn = sum(1 for m, _ in pat if m == "attn")
    mamba = sum(1 for m, _ in pat if m == "mamba")
    moe = sum(1 for _, ml in pat if ml == "moe")
    assert attn * 7 == mamba            # 1:7 interleave
    assert moe == cfg.n_layers // 2     # MoE every other layer
    _, period, n_super = scan_pattern(cfg)
    assert len(period) == 8 and n_super == 9
    assert [i for i, (_, ml) in enumerate(period) if ml == "moe"] \
        == [1, 3, 5, 7]
