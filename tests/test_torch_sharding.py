"""The port's logical-axis layout functions (repro_torch/launch/
{sharding,collectives,mesh}.py) against the JAX package's
(repro/launch/{sharding,hloparse}.py): ``fit_spec``, ``logical_map_for``,
``param_pspecs`` (every leaf of the twelve architectures, both weight
modes, five mesh shapes), ``cache_pspecs``, ``batch_pspec``,
``weights_need_fsdp`` at the reference's 16 GB and 'model' = 16, and the
ring ``traffic`` formulas, all exactly.  No ranks, nothing compiled: the
meshes are the reference's ``FakeMesh`` pattern (``.shape``, ``.axis_names``).
"""
import functools
import itertools

import jax
import pytest
from _hypothesis_compat import given, settings, st
from jax.sharding import PartitionSpec as P

import repro.launch.hloparse as jhlo
import repro.launch.sharding as jshd
from repro.configs import get_config as jget_config
from repro.models.model import init_caches as jinit_caches
from repro.models.model import init_model as jinit_model
from repro_torch.configs import ARCHS, get_config
from repro_torch.launch import collectives, mesh as tmesh
from repro_torch.launch import sharding as shd
from repro_torch.launch.shapes import SHAPES, n_cross_for
from repro_torch.models.model import meta_caches, meta_model
from repro_torch.tree import tree_map_with_path


class FakeMesh:
    def __init__(self, shape):
        self.shape = shape
        self.axis_names = tuple(shape)


def fake(dims):
    names = ("data", "model") if len(dims) == 2 else ("pod", "data", "model")
    return FakeMesh(dict(zip(names, dims)))


MESHES = [(16, 16), (2, 16, 16), (32, 8), (2, 32, 8), (2, 2)]


def _jpath(path):
    return tuple(getattr(k, "key", getattr(k, "idx", None)) for k in path)


def _jflat(specs):
    leaves = jax.tree_util.tree_flatten_with_path(
        specs, is_leaf=lambda x: isinstance(x, P))[0]
    return {_jpath(p): tuple(s) for p, s in leaves}


def _tflat(specs, tree):
    """{path: spec} over the leaves of ``tree`` (the specs are tuples)."""
    out = {}

    def put(path, _):
        s = specs
        for k in path:
            s = s[k]
        out[path] = s
    tree_map_with_path(put, tree)
    return out


@functools.lru_cache(maxsize=None)
def _jparams(arch):
    return jax.eval_shape(functools.partial(jinit_model,
                                            cfg=jget_config(arch)),
                          jax.random.PRNGKey(0))


@functools.lru_cache(maxsize=None)
def _tparams(arch):
    return meta_model(get_config(arch))


# --------------------------------------------------------------------------
# fit_spec
# --------------------------------------------------------------------------

FIT_CASES = [   # test_sharding.py's cases, then tuples, dedup, short specs
    (("model", None), (50280, 64), (16, 16)),
    (("model", None), (50304, 64), (16, 16)),
    ((("data", "model"), None), (256, 4), (16, 16)),
    ((("data", "model"), None), (128, 4), (16, 16)),
    (("model", "model"), (32, 32), (16, 16)),
    ((("pod", "data"), None, "model"), (64, 3, 16), (2, 16, 16)),
    (("data", ("data", "model")), (32, 512), (2, 16, 16)),
    (("model", None, "data"), (8, 4), (2, 2)),
]


@pytest.mark.parametrize("spec,shape,dims", FIT_CASES)
def test_fit_spec_cases(spec, shape, dims):
    m = fake(dims)
    assert shd.fit_spec(spec, shape, m) == tuple(jshd.fit_spec(P(*spec),
                                                               shape, m))


AXES = [None, "data", "model", "pod", ("data", "model"), ("pod", "data"),
        ("pod", "data", "model")]


@settings(max_examples=200, deadline=None)
@given(st.integers(0, 10 ** 6), st.sampled_from(MESHES))
def test_fit_spec_sweep(seed, dims):
    import random
    rng = random.Random(seed)
    m = fake(dims)
    axes = [a for a in AXES if all(x in m.axis_names for x in
                                   (a if isinstance(a, tuple) else (a,))
                                   if x)]
    nd = rng.randint(1, 4)
    spec = tuple(rng.choice(axes) for _ in range(rng.randint(1, nd + 1)))
    shape = tuple(rng.choice([1, 2, 3, 8, 12, 16, 64, 96, 256, 4096])
                  for _ in range(nd))
    assert shd.fit_spec(spec, shape, m) == tuple(jshd.fit_spec(P(*spec),
                                                               shape, m))


# --------------------------------------------------------------------------
# logical map, batch spec, weight mode
# --------------------------------------------------------------------------

@pytest.mark.parametrize("dims", MESHES)
def test_logical_map_and_batch_spec(dims):
    m = fake(dims)
    for arch, shape in itertools.product(ARCHS, SHAPES):
        assert shd.logical_map_for(get_config(arch), shape, m) == \
            jshd.logical_map_for(jget_config(arch), shape, m)
    for batch in (1, 2, 3, 4, 16, 32, 64, 128, 256, 512):
        assert shd.batch_pspec(m, batch) == tuple(jshd.batch_pspec(m, batch))


@pytest.mark.parametrize("arch", ARCHS)
def test_weights_need_fsdp_at_the_reference_constants(arch):
    """At a v5e's 16 GB and 'model' = 16 the decision is the reference's;
    at the H100's 80 GB it divides by the mesh's own 'model' size."""
    m = fake((16, 16))
    for train in (False, True):
        assert shd.weights_need_fsdp(get_config(arch), m, train=train,
                                     hbm_bytes=16e9) == \
            jshd.weights_need_fsdp(jget_config(arch), m, train=train)
    n = shd.estimate_params(get_config(arch))
    assert n == jshd.estimate_params(jget_config(arch))
    for dims in ((32, 8), (2, 2)):
        tp = dims[-1]
        want = n * (2 if "16" in get_config(arch).param_dtype else 4) / tp \
            > 0.6 * 80e9
        assert shd.weights_need_fsdp(get_config(arch), fake(dims)) == want


# --------------------------------------------------------------------------
# parameter and cache specs
# --------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_param_pspecs_every_leaf(arch):
    """Every leaf's spec, for tp and fsdp at five mesh shapes, equals the
    reference's on ``jax.eval_shape(init_model)``; the two trees hold the
    same leaves."""
    jp, tp_ = _jparams(arch), _tparams(arch)
    jc, tc = jget_config(arch), get_config(arch)
    for dims, mode in itertools.product(MESHES, ("tp", "fsdp")):
        m = fake(dims)
        want = _jflat(jshd.param_pspecs(jc, jp, mode=mode, mesh=m))
        got = _tflat(shd.param_pspecs(tc, tp_, mode=mode, mesh=m), tp_)
        assert got == want, (dims, mode)


@pytest.mark.parametrize("shape", list(SHAPES))
def test_cache_pspecs(shape):
    """Every cache leaf's spec equals the reference's, but ``pos``: the
    port lays (B, S_c) out as the keys' first two dims, where the
    reference's spec names only its dim 0, with the sequence axis.  The
    VLM's and the encoder-decoder's caches are built with the dry run's
    ``n_cross`` on both sides, so their cross keys and values (batch over
    its axes, heads whole) are compared too."""
    spec = SHAPES[shape]
    for arch in ("mixtral_8x7b", "deepseek_v2_lite_16b", "jamba_1_5_large_398b",
                 "llama_3_2_vision_11b", "seamless_m4t_large_v2",
                 "gemma2_9b", "mamba2_780m"):
        jc, tc = jget_config(arch), get_config(arch)
        B, S = min(spec.batch, 64), min(spec.seq, 4096)
        n_cross = n_cross_for(tc, spec)
        jcache = jax.eval_shape(functools.partial(
            jinit_caches, jc, B, S, dtype=jc.dtype, n_cross=n_cross))
        tcache = meta_caches(tc, B, S, dtype=tc.dtype, n_cross=n_cross)
        cross = [k for k in _tflat(shd.cache_pspecs(
            tc, tcache, shape, fake(MESHES[0])), tcache)
            if k[-1] in ("xk", "xv")]
        assert bool(cross) == (tc.family in ("vlm", "audio")), arch
        for dims in MESHES:
            m = fake(dims)
            want = _jflat(jshd.cache_pspecs(jc, jcache, shape, m))
            got = _tflat(shd.cache_pspecs(tc, tcache, shape, m), tcache)
            assert got.keys() == want.keys()
            for path, s in got.items():
                if path[-1] != "pos":
                    assert s == want[path], (arch, dims, path)
                    continue
                lm = shd.logical_map_for(tc, shape, m)
                lead = (None,) if "scan" in path else ()
                shp = meta_leaf(tcache, path).shape
                assert s == shd.fit_spec(lead + (lm["batch"], lm["kv_seq"]),
                                         tuple(shp), m)
                assert want[path] == shd.fit_spec(lead + (lm["kv_seq"],),
                                                  tuple(shp), m)


def meta_leaf(tree, path):
    for k in path:
        tree = tree[k]
    return tree


# --------------------------------------------------------------------------
# placements, hint, traffic, the production mesh
# --------------------------------------------------------------------------

class _NamedMesh:
    mesh_dim_names = ("pod", "data", "model")


@pytest.mark.parametrize("spec,want", [
    ((("pod", "data"), None, "model"), ("S0", "S0", "S2")),
    ((None, ("data", "model")), ("R", "S1", "S1")),
    (("model", None), ("R", "R", "S0")),
    ((("pod", "data", "model"),), ("S0", "S0", "S0")),
    ((None, None), ("R", "R", "R")),
])
def test_placements_on_tuple_axes(spec, want):
    from torch.distributed.tensor import Replicate, Shard
    got = shd.placements(spec, _NamedMesh())
    assert [("R" if isinstance(p, Replicate) else f"S{p.dim}")
            for p in got] == list(want)
    assert all(isinstance(p, (Replicate, Shard)) for p in got)


def test_placements_refuse_an_axis_order_the_mesh_lacks():
    with pytest.raises(ValueError, match="order"):
        shd.placements(((("model", "data")),), _NamedMesh())


def test_hint_outside_and_inside_rules():
    import torch
    x = torch.zeros(4, 4)
    assert shd.hint(x, "batch", "embed") is x
    lm = shd.logical_map_for(get_config("mixtral_8x7b"), "prefill_32k",
                             fake((2, 2)))
    with shd.rules(_NamedMesh(), lm):
        assert shd.layout_active()
        with pytest.raises(TypeError, match="plain"):
            shd.hint(x, "batch", "embed")
    assert not shd.layout_active()
    with pytest.raises(ValueError, match="wmode"):
        with shd.rules(None, lm, "zero"):
            pass


@pytest.mark.parametrize("kind", collectives.KINDS)
def test_traffic_is_the_reference_formula(kind):
    for b, g in itertools.product((1, 64, 4096, 10 ** 9), (2, 4, 8, 16,
                                                           256, 512)):
        assert collectives.traffic(kind, b, g) == jhlo._traffic(kind, b, g)


def test_production_mesh_table():
    assert tmesh.PRODUCTION_SHAPES[False] == ((32, 8), ("data", "model"))
    assert tmesh.PRODUCTION_SHAPES[True] == ((2, 32, 8),
                                             ("pod", "data", "model"))
    assert tmesh.AXIS_LINKS["model"][1] == 450e9
    assert tmesh.AXIS_LINKS["data"][1] == tmesh.AXIS_LINKS["pod"][1] == 50e9
    # 'model' groups stay in one node of 8; 'data' groups cross nodes
    assert tmesh.group_link(range(8))[0] == "NVLink 4"
    assert tmesh.group_link(range(0, 256, 8))[0] == "InfiniBand NDR"
    with pytest.raises(RuntimeError, match="initialised world"):
        tmesh.make_production_mesh()
