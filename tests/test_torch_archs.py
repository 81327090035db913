"""Every architecture of the registry in the port against the JAX package
(the twin of tests/test_archs_smoke.py): the twelve smoke configs field by
field, forward logits, a prefill then a cached decode step (against the
reference's decode and the port's own full recompute) and one training
step's loss and gradients (tests/test_torch_archs_train.py), with the
reference's parameters carried over by ``repro_torch.bridge`` (float32,
CPU).

The cross-attention gates (``gate``, ``mlp_gate``) are zero at init in both
packages, which would hide the cross path; the carried parameters set them
to 0.5 on both sides.  Cross sources are seeded normal draws.

Tolerances: 3e-5 relative to max |ref| for float32 tensors (the repo's
kernel tolerance, tests/test_kernels.py:17; each gradient leaf relative to
its own max |g|).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
import repro.models.model as jmodel
import repro_torch.configs as tconfigs
import repro_torch.models.model as tmodel
from repro_torch import bridge, kernels

F32_TOL = 3e-5
B, S = 2, 16


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
    err = _rel(t, j)
    assert err < F32_TOL, f"{what}: {err:.3e}"


def open_gates(tree):
    """A numpy param tree with every cross-attention gate at 0.5 (the
    scalar ``gate`` of a cross mixer and the ``mlp_gate``; the MLP's
    ``gate`` matrices are left as they are)."""
    def fix(path, a):
        key = path[-1].key if hasattr(path[-1], "key") else None
        if key in ("gate", "mlp_gate") and np.ndim(a) <= 1:
            return np.full_like(a, 0.5)
        return np.asarray(a)
    return jax.tree_util.tree_map_with_path(fix, tree)


@functools.lru_cache(maxsize=None)
def carried(arch):
    """(JAX cfg, port cfg, JAX params, port params) of ``arch``'s smoke
    config, the gates opened on both sides."""
    jc = jconfigs.make_smoke(jconfigs.get_config(arch))
    tc = tconfigs.make_smoke(tconfigs.get_config(arch))
    jp = open_gates(jmodel.init_model(jax.random.PRNGKey(0), jc))
    tp = bridge.to_torch(jp, "cpu")
    return jc, tc, jax.tree.map(jnp.asarray, jp), tp


def cross_src(cfg, seed=3):
    """A seeded cross source for a VLM (its vision tokens) or audio arch
    (16 frames), else None."""
    if cfg.family == "vlm":
        T = cfg.n_vision_tokens
    elif cfg.family == "audio":
        T = 16
    else:
        return None
    return (np.random.default_rng(seed).standard_normal((B, T, cfg.d_model))
            * 0.1).astype(np.float32)


def n_cross(cfg):
    return 16 if cfg.family in ("vlm", "audio") else None


def _tokens(cfg, n, seed=1):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (B, n)) \
        .astype(np.int32)


def _t(a):
    return None if a is None else torch.from_numpy(a)


def _j(a):
    return None if a is None else jnp.asarray(a)


# --------------------------------------------------------------------------
# configs
# --------------------------------------------------------------------------

def test_registry_equals_the_reference():
    assert tconfigs.ARCHS == jconfigs.ARCHS
    assert tconfigs.ASSIGNED == jconfigs.ASSIGNED == tconfigs.ARCHS[:10]
    tall, jall = tconfigs.all_configs(), jconfigs.all_configs()
    assert list(tall) == list(jall) == tconfigs.ARCHS
    for arch in tconfigs.ARCHS:
        assert dataclasses.asdict(tall[arch]) == dataclasses.asdict(
            jall[arch]), arch
        assert tconfigs.get_config(arch.replace("_", "-")) is tall[arch]


@pytest.mark.parametrize("arch", jconfigs.ARCHS)
def test_smoke_config_equals_the_reference(arch):
    jc = jconfigs.make_smoke(jconfigs.get_config(arch))
    tc = tconfigs.make_smoke(tconfigs.get_config(arch))
    assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
    from repro.models.config import scan_pattern as jscan
    from repro_torch.models.config import scan_pattern as tscan
    assert tscan(tc) == jscan(jc)


# --------------------------------------------------------------------------
# parameters, forward, decode
# --------------------------------------------------------------------------

@pytest.mark.parametrize("arch", jconfigs.ARCHS)
def test_bridge_carries_every_leaf_with_its_dtype(arch):
    """The port's own ``init_model`` builds the reference's tree (same
    paths, shapes and dtypes, the float32 Mamba leaves included), and the
    bridge carries the reference's leaves unchanged."""
    jc, tc, jp, tp = carried(arch)
    fj = bridge.flatten(jax.tree.map(np.asarray, jp))
    ft = bridge.flatten(tp)
    own = bridge.flatten(tmodel.init_model(tc.replace(
        dtype="bfloat16", param_dtype="bfloat16"), seed=0, device="cpu"))
    jb = bridge.flatten(jax.tree.map(np.asarray, jmodel.init_model(
        jax.random.PRNGKey(0), jc.replace(dtype="bfloat16",
                                          param_dtype="bfloat16"))))
    assert ft.keys() == fj.keys() == own.keys() == jb.keys()
    for k in ft:
        if not torch.is_tensor(ft[k]):        # an empty ``prefix`` marker
            continue
        np.testing.assert_array_equal(ft[k].numpy(), fj[k], err_msg=k)
        assert tuple(own[k].shape) == jb[k].shape, k
        assert str(own[k].dtype).replace("torch.", "") == jb[k].dtype.name, k


@pytest.mark.parametrize("arch", jconfigs.ARCHS)
def test_forward_logits_match_reference(arch):
    jc, tc, jp, tp = carried(arch)
    toks, src = _tokens(jc, S), cross_src(jc)
    lj, _, _ = jmodel.apply_model(jp, jnp.asarray(toks), jc,
                                  cross_src=_j(src))
    kernels.reset_launch_counts()
    lt, _, _ = tmodel.apply_model(tp, torch.from_numpy(toks), tc,
                                  cross_src=_t(src))
    assert kernels.launch_counts() == {k: 0 for k in kernels.LAUNCHES}
    _close(lt, lj, "logits")


@pytest.mark.parametrize("arch", jconfigs.ARCHS)
def test_prefill_then_decode_matches_reference_and_recompute(arch):
    """A prefill into caches then one cached decode step: the prefill's and
    the decode's logits equal the reference's, and the decode equals the
    port's own recompute of the whole sequence."""
    jc, tc, jp, tp = carried(arch)
    toks, src = _tokens(jc, S), cross_src(jc)
    pos = np.arange(S, dtype=np.int32)
    jcache = jmodel.init_caches(jc, B, S + 4, dtype="float32",
                                n_cross=n_cross(jc))
    tcache = tmodel.init_caches(tc, B, S + 4, device="cpu",
                                n_cross=n_cross(tc))
    lj, jcache, _ = jmodel.apply_model(jp, jnp.asarray(toks), jc,
                                       positions=jnp.asarray(pos),
                                       caches=jcache, cross_src=_j(src))
    lt, tcache, _ = tmodel.apply_model(tp, torch.from_numpy(toks), tc,
                                       positions=torch.from_numpy(pos),
                                       caches=tcache, cross_src=_t(src))
    _close(lt, lj, "prefill logits")
    nxt = np.asarray(jnp.argmax(lj[:, -1:], -1)).astype(np.int32)
    np.testing.assert_array_equal(
        lt[:, -1:].argmax(-1).numpy(), nxt)
    step = np.array([S], np.int32)
    dj, _, _ = jmodel.apply_model(jp, jnp.asarray(nxt), jc,
                                  positions=jnp.asarray(step), caches=jcache)
    dt, _, _ = tmodel.apply_model(tp, torch.from_numpy(nxt), tc,
                                  positions=torch.from_numpy(step),
                                  caches=tcache)
    _close(dt, dj, "decode logits")
    full, _, _ = tmodel.apply_model(
        tp, torch.from_numpy(np.concatenate([toks, nxt], 1)), tc,
        cross_src=_t(src))
    _close(dt[:, 0], full[:, -1].numpy(), "decode against recompute")


@pytest.mark.parametrize("arch", ["jamba_1_5_large_398b",
                                  "llama4_maverick_400b_a17b"])
def test_moe_layer_maps_follow_the_scan_pattern(arch):
    """Jamba's MoE layers sit at positions 1, 3, 5, 7 of its period,
    between Mamba layers; Llama-4's router is sigmoid top-1 with a shared
    expert.  The expert leaves, the MoE layer indices, the store's layer
    map, the policy's observations and a decode trace over Mamba caches
    follow ``scan_pattern`` as the reference's do."""
    import repro.core.tracing as jtracing
    import repro_torch.core.tracing as ttracing
    from repro_torch.models.moe import is_expert_leaf
    from repro_torch.serving.expert_store import moe_layer_layout
    from repro_torch.tree import tree_map_with_path
    jc, tc, jp, tp = carried(arch)
    assert ttracing.moe_layer_indices(tc) == jtracing.moe_layer_indices(jc)
    _, period, n_super = tmodel.scan_pattern(tc)
    moe_pos = [p for p, (_, m) in enumerate(period) if m == "moe"]
    leaves = []
    tree_map_with_path(lambda path, t: leaves.append(path)
                       if is_expert_leaf(path, tc) else None, tp)
    assert sorted(leaves) == sorted(("scan", p, "mlp", k) for p in moe_pos
                                    for k in ("gate", "up", "down"))
    assert moe_layer_layout(tc) == ([], moe_pos, n_super)
    toks = _tokens(jc, 12, seed=5)
    lj, _, ij = jmodel.apply_model(jp, jnp.asarray(toks), jc, trace=True)
    lt, _, it = tmodel.apply_model(tp, torch.from_numpy(toks), tc,
                                   trace=True)
    wj, oj = jmodel.collect_policy_obs(jp, ij, jc)
    wt, ot = tmodel.collect_policy_obs(tp, it, tc)
    assert wt.shape[0] == len(moe_pos) * n_super
    np.testing.assert_array_equal(wt.numpy(), np.asarray(wj))
    _close(ot.gate_in, oj.gate_in, "gate_in")
    np.testing.assert_array_equal(ot.routers.numpy(), np.asarray(oj.routers))
    jtr = jtracing.capture_decode_trace(jp, jc, jnp.asarray(toks[:, :8]),
                                        n_decode=3)
    ttr = ttracing.capture_decode_trace(tp, tc, toks[:, :8], n_decode=3,
                                        device="cpu")
    assert ttr.n_moe_layers == jtr.n_moe_layers == len(moe_pos) * n_super
    for s in range(3):
        for layer in range(ttr.n_moe_layers):
            np.testing.assert_array_equal(ttr.workload[s][layer],
                                          jtr.workload[s][layer])
