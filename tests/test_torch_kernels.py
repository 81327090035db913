"""The plain PyTorch version of each kernel of the port against the JAX
package's Pallas kernel (interpret mode, as tests/test_kernels.py runs it
on the CPU) and its ``ref.py`` oracle, on the same numpy inputs.

On the CPU every wrapper takes its plain version, and launches nothing:
the launch counters stay at zero.  Tolerances are the repo's own
(tests/test_kernels.py:17): 3e-5 relative to max |ref| in float32, 3e-2 in
bfloat16; top-k indices exactly, gates within atol 1e-5.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.expert_ffn.kernel import expert_ffn as pallas_ffn
from repro.kernels.expert_ffn.ref import expert_ffn_ragged_ref, expert_ffn_ref
from repro.kernels.flash_attention.kernel import \
    flash_attention as pallas_flash
from repro.kernels.flash_attention.ref import flash_attention_ref
from repro.kernels.gating.kernel import gating as pallas_gating
from repro.kernels.gating.ref import gating_ref
from repro_torch import kernels
from repro_torch.kernels.expert_ffn.ops import expert_ffn
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.gating.ops import gating

TOL = {"float32": 3e-5, "bfloat16": 3e-2}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@pytest.fixture(autouse=True)
def _no_launches():
    """CPU tensors take the plain versions: no kernel launch is counted."""
    kernels.reset_launch_counts()
    yield
    assert kernels.launch_counts() == {k: 0 for k in kernels.LAUNCHES}


def _rel_err(y, r):
    y = np.asarray(y, np.float32)
    r = np.asarray(r, np.float32)
    return float(np.abs(y - r).max()) / (float(np.abs(r).max()) + 1e-6)


def _t(a, dt):
    return torch.tensor(np.asarray(a, np.float32), dtype=TDT[dt])


def _j(a, dt):
    return jnp.asarray(np.asarray(a, np.float32), JDT[dt])


@pytest.mark.parametrize("T,E,k,rt,renorm", [
    (128, 8, 2, "topk_softmax", True),       # Mixtral router
    (256, 64, 6, "softmax_topk", True),      # DeepSeek router
    (64, 128, 1, "sigmoid", False),          # Llama4 router
    (100, 16, 4, "softmax_topk", False),     # padded T
    (512, 128, 8, "softmax_topk", True),     # Qwen3-30B router
])
def test_gating_plain_matches_pallas_and_ref(T, E, k, rt, renorm):
    lg = (np.random.default_rng(0).standard_normal((T, E)) * 2) \
        .astype(np.float32)
    g, i, p = gating(torch.from_numpy(lg), k, rt, renorm)
    gp, ip = pallas_gating(jnp.asarray(lg), k, router_type=rt,
                           renormalize=renorm, block_t=64, interpret=True)
    gr, ir = gating_ref(jnp.asarray(lg), k, router_type=rt,
                        renormalize=renorm)
    for gg, ii in ((gp, ip), (gr, ir)):
        np.testing.assert_array_equal(i.numpy(), np.asarray(ii))
        np.testing.assert_allclose(g.numpy(), np.asarray(gg), atol=1e-5,
                                   rtol=0)
    want = (1 / (1 + np.exp(-lg.astype(np.float64))) if rt == "sigmoid"
            else np.exp(lg - lg.max(-1, keepdims=True))
            / np.exp(lg - lg.max(-1, keepdims=True)).sum(-1, keepdims=True))
    np.testing.assert_allclose(p.numpy(), want, atol=1e-6, rtol=3e-5)


def test_gating_ties_go_to_the_lowest_index():
    lg = np.zeros((3, 8), np.float32)
    lg[1, [2, 5]] = 1.0
    lg[2, [7, 3]] = [2.0, 2.0]
    _, i, _ = gating(torch.from_numpy(lg), 2, "topk_softmax")
    _, ir = gating_ref(jnp.asarray(lg), 2, router_type="topk_softmax")
    np.testing.assert_array_equal(i.numpy(), np.asarray(ir))
    assert i.tolist() == [[0, 1], [2, 5], [3, 7]]


def _ffn_inputs(G, E, C, d, f, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((G, C, d)),
            rng.standard_normal((E, d, f)) * 0.05,
            rng.standard_normal((E, d, f)) * 0.05,
            rng.standard_normal((E, f, d)) * 0.05)


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("act", ["silu", "gelu"])
@pytest.mark.parametrize("E,C,d,f", [(2, 128, 128, 256), (4, 64, 64, 128)])
def test_expert_ffn_dense_plain_matches_pallas_and_ref(E, C, d, f, act, dt):
    xe, wg, wu, wd = _ffn_inputs(E, E, C, d, f, seed=1)
    y = expert_ffn(*(_t(a, dt) for a in (xe, wg, wu, wd)), act=act)
    assert y.dtype == TDT[dt] and tuple(y.shape) == (E, C, d)
    jx = [_j(a, dt) for a in (xe, wg, wu, wd)]
    yp = pallas_ffn(*jx, act=act, block_c=64, block_f=128, interpret=True)
    yr = expert_ffn_ref(*jx, act=act)
    for other in (yp, yr):
        assert _rel_err(y.float(), other.astype(jnp.float32)) < TOL[dt]


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("counts", [
    [0, 128, 37, 5],            # skewed: empty, full, partial, tiny
    [0, 0, 0, 0],               # fully idle layer
    [128, 128, 128, 128],       # saturated == dense
])
def test_expert_ffn_ragged_plain_matches_pallas_and_ref(counts, dt):
    E, C, d, f = 4, 128, 64, 256
    xe, wg, wu, wd = _ffn_inputs(E, E, C, d, f, seed=2)
    xe = xe * 1.0
    cnt = np.asarray(counts, np.int32)
    # garbage in the bucket tails must never leak into the output
    xe[np.arange(C)[None, :] >= cnt[:, None]] = 1e3
    y = expert_ffn(*(_t(a, dt) for a in (xe, wg, wu, wd)),
                   counts=torch.from_numpy(cnt))
    jx = [_j(a, dt) for a in (xe, wg, wu, wd)]
    yp = pallas_ffn(*jx, counts=jnp.asarray(cnt), block_c=64, block_f=128,
                    interpret=True)
    yr = expert_ffn_ragged_ref(*jx, jnp.asarray(cnt))
    for other in (yp, yr):
        assert _rel_err(y.float(), other.astype(jnp.float32)) < TOL[dt]
    rows = np.arange(C)[None, :] >= cnt[:, None]
    assert not y.float().numpy()[rows].any()


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_expert_ffn_grouped_plain_matches_pallas_and_ref(dt):
    E, G, C, d, f = 3, 6, 32, 16, 48
    xe, wg, wu, wd = _ffn_inputs(G, E, C, d, f, seed=3)
    cnt = np.asarray([0, 32, 7, 0, 12, 1], np.int32)
    eids = np.asarray([0, 0, 1, 1, 2, 2], np.int32)
    xe[np.arange(C)[None, :] >= cnt[:, None]] = -1e3
    y = expert_ffn(*(_t(a, dt) for a in (xe, wg, wu, wd)),
                   counts=torch.from_numpy(cnt),
                   expert_ids=torch.from_numpy(eids))
    jx = [_j(a, dt) for a in (xe, wg, wu, wd)]
    yp = pallas_ffn(*jx, counts=jnp.asarray(cnt),
                    expert_ids=jnp.asarray(eids), block_c=16, block_f=16,
                    interpret=True)
    yr = expert_ffn_ragged_ref(*jx, jnp.asarray(cnt),
                               expert_ids=jnp.asarray(eids))
    for other in (yp, yr):
        assert _rel_err(y.float(), other.astype(jnp.float32)) < TOL[dt]
    rows = np.arange(C)[None, :] >= cnt[:, None]
    assert not y.float().numpy()[rows].any()
    with pytest.raises(ValueError):
        expert_ffn(*(_t(a, dt) for a in (xe, wg, wu, wd)),
                   expert_ids=torch.from_numpy(eids))


FLASH_CASES = [
    (1, 128, 128, 4, 2, 64, True, 0, 0.0),
    (2, 128, 256, 8, 8, 32, True, 0, 50.0),
    (1, 64, 192, 4, 1, 64, True, 64, 0.0),
    (2, 128, 128, 2, 2, 128, False, 0, 0.0),
    (1, 256, 256, 16, 2, 64, True, 0, 30.0),
]


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,Sq,Sk,Hq,Hkv,D,causal,window,cap", FLASH_CASES)
def test_flash_attention_plain_matches_pallas_and_ref(B, Sq, Sk, Hq, Hkv, D,
                                                      causal, window, cap,
                                                      dt):
    rng = np.random.default_rng(4)
    q, k, v = (rng.standard_normal(s) for s in
               ((B, Sq, Hq, D), (B, Sk, Hkv, D), (B, Sk, Hkv, D)))
    o = flash_attention(_t(q, dt), _t(k, dt), _t(v, dt), causal=causal,
                        window=window, softcap=cap)
    jq, jk, jv = _j(q, dt), _j(k, dt), _j(v, dt)
    op = pallas_flash(jq, jk, jv, causal=causal, window=window, softcap=cap,
                      block_q=64, block_k=64, interpret=True)
    orf = flash_attention_ref(jq, jk, jv, causal=causal, window=window,
                              softcap=cap)
    for other in (op, orf):
        err = float(np.abs(o.float().numpy()
                           - np.asarray(other, np.float32)).max())
        assert err < TOL[dt], err


@pytest.mark.parametrize("Sq,Sk,window", [(100, 100, 0), (37, 37, 0),
                                          (45, 130, 32)])
def test_flash_attention_plain_ragged_lengths_match_ref(Sq, Sk, window):
    """Admission buckets may be any length: the port masks ragged tails
    (the Pallas kernel asserts whole blocks, so only ref.py applies)."""
    rng = np.random.default_rng(5)
    q, k, v = (rng.standard_normal(s) for s in
               ((1, Sq, 8, 32), (1, Sk, 2, 32), (1, Sk, 2, 32)))
    o = flash_attention(_t(q, "float32"), _t(k, "float32"),
                        _t(v, "float32"), causal=True, window=window)
    r = flash_attention_ref(*(_j(a, "float32") for a in (q, k, v)),
                            causal=True, window=window)
    assert float(np.abs(o.numpy() - np.asarray(r)).max()) < TOL["float32"]
