"""The port's cost model, shape dry run and cost validation
(repro_torch/launch/{costs,shapes,dryrun,validate_costs}.py) against the
JAX package's (repro/launch/{costs,shapes}.py): ``step_cost`` is the
reference's closed form exactly (pure Python, no tolerance) over the
reference's whole arch x shape matrix; the meta dry run builds and runs
steps at the published widths; each kernel wrapper's ``meta`` path gives
its CPU output's shape and dtype and counts its kernel's FLOPs; the
closed form agrees with ``FlopCounterMode`` on the paper's three models.
"""
import dataclasses

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

import repro.launch.costs as jcosts
import repro.launch.shapes as jshapes
from repro.configs import ARCHS as JARCHS
from repro.configs import get_config as jget_config
from repro_torch.configs import ARCHS, get_config
from repro_torch.kernels.expert_ffn.ops import expert_ffn, flops as ffn_flops
from repro_torch.kernels.flash_attention.ops import (flash_attention,
                                                     flops as fa_flops)
from repro_torch.kernels.gating.ops import flops as gate_flops, gating
from repro_torch.launch import costs, dryrun, shapes, validate_costs


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_shapes_and_skip_rule_match_reference():
    assert ARCHS == JARCHS
    assert {k: dataclasses.astuple(v) for k, v in shapes.SHAPES.items()} \
        == {k: dataclasses.astuple(v) for k, v in jshapes.SHAPES.items()}
    for arch in ARCHS:
        for shape in shapes.SHAPES:
            assert shapes.skip_reason(arch, shape) == \
                jshapes.skip_reason(arch, shape)


@pytest.mark.parametrize("arch", ARCHS)
def test_step_cost_equals_reference(arch):
    """Every field of ``step_cost`` equals the reference's exactly, at each
    shape of the matrix the reference runs and at the validation's."""
    tc, jc = get_config(arch), jget_config(arch)
    cases = [(s.kind, s.seq, s.batch) for name, s in shapes.SHAPES.items()
             if shapes.skip_reason(arch, name) is None]
    cases += [("prefill", 128, 2), ("decode", 128, 2)]
    for kind, seq, batch in cases:
        assert dataclasses.asdict(costs.step_cost(tc, kind, seq, batch)) \
            == dataclasses.asdict(jcosts.step_cost(jc, kind, seq, batch))
        for mixer, mlp in costs.layer_pattern(tc):
            assert costs.layer_param_bytes(tc, mixer, mlp) == \
                jcosts.layer_param_bytes(jc, mixer, mlp)


@pytest.mark.parametrize("arch,shape", [
    ("mixtral-8x7b", "decode_32k"),
    ("jamba-1.5-large-398b", "long_500k"),
    ("seamless-m4t-large-v2", "prefill_32k")])
def test_meta_dry_run_builds(arch, shape):
    rec = dryrun.run_one(arch, shape)
    assert rec["status"] == "ok"
    # the step holds at least its parameters, and the FLOPs the run counts
    # are the closed form's to within 20 %
    assert rec["peak_live_bytes"] >= rec["param_bytes"] > 0
    r = rec["roofline"]
    assert 0.8 < rec["counted_flops"] / r["flops_global"] < 1.25
    assert r["compute_s"] == r["flops_global"] / dryrun.PEAK_FLOPS
    assert r["memory_s"] == r["hbm_bytes_global"] / dryrun.HBM_BW
    assert r["dominant"] in ("compute_s", "memory_s")


def test_meta_dry_run_skips_like_reference():
    rec = dryrun.run_one("mixtral-8x7b", "long_500k")
    assert rec["status"] == "skipped"


def _pair(fn, cpu_args, **kw):
    """(CPU output, meta output, FLOPs counted on meta) of one wrapper."""
    meta = lambda a: a.to("meta") if torch.is_tensor(a) else a
    out_cpu = fn(*cpu_args, **kw)
    with FlopCounterMode(display=False) as fc:
        out_meta = fn(*map(meta, cpu_args),
                      **{k: meta(v) for k, v in kw.items()})
    return out_cpu, out_meta, fc.get_total_flops()


def _same_layout(a, b):
    a = a if isinstance(a, tuple) else (a,)
    b = b if isinstance(b, tuple) else (b,)
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert y.device.type == "meta"
        assert tuple(x.shape) == tuple(y.shape) and x.dtype == y.dtype


@pytest.mark.parametrize("E,k", [(8, 2), (128, 8)])
def test_gating_meta_matches_cpu_layout(E, k):
    g = torch.Generator().manual_seed(0)
    logits = torch.randn((6, E), generator=g)
    cpu, meta, fl = _pair(gating, (logits, k))
    _same_layout(cpu, meta)
    assert fl == gate_flops(6, E, k)


@pytest.mark.parametrize("form", ["dense", "ragged", "grouped"])
def test_expert_ffn_meta_matches_cpu_layout(form):
    g = torch.Generator().manual_seed(0)
    E, C, d, f = 4, 8, 64, 128
    w = lambda *s: (torch.randn(s, generator=g) * 0.1).bfloat16()
    G = 6 if form == "grouped" else E
    kw = {}
    if form != "dense":
        kw["counts"] = torch.tensor([3, 8, 0, 5, 1, 2][:G], dtype=torch.int32)
    if form == "grouped":
        kw["expert_ids"] = torch.tensor([0, 3, 1, 1, 2, 0], dtype=torch.int32)
    cpu, meta, fl = _pair(expert_ffn, (w(G, C, d), w(E, d, f), w(E, d, f),
                                       w(E, f, d)), **kw)
    _same_layout(cpu, meta)
    assert fl == ffn_flops(G, C, d, f)


@pytest.mark.parametrize("Hq,Hkv,D,causal,window", [
    (8, 2, 64, True, 0), (10, 2, 64, True, 0),     # G = 5: K/V repeated
    (4, 4, 192, True, 5), (4, 4, 64, False, 0)])
def test_flash_attention_meta_matches_cpu_layout(Hq, Hkv, D, causal, window):
    g = torch.Generator().manual_seed(0)
    q = torch.randn((2, 12, Hq, D), generator=g).bfloat16()
    k = torch.randn((2, 12, Hkv, D), generator=g).bfloat16()
    v = torch.randn((2, 12, Hkv, D), generator=g).bfloat16()
    cpu, meta, fl = _pair(flash_attention, (q, k, v), causal=causal,
                          window=window)
    _same_layout(cpu, meta)
    assert fl == fa_flops(2, 12, 12, Hq, D, causal, window)
    if causal and not window:
        assert fa_flops(1, 12, 12, 1, 1, True, 0) == 4 * 12 * 13 // 2


@pytest.mark.parametrize("arch", ["mixtral-8x7b", "qwen3-30b-a3b",
                                  "deepseek-v2-lite-16b"])
@pytest.mark.parametrize("kind", ["prefill", "decode"])
def test_validate_costs_ratio_on_paper_models(arch, kind):
    counted, analytic, ratio = validate_costs.validate(arch, kind)
    assert counted > 0
    assert 0.8 <= ratio <= 1.25, (counted, analytic)


def _ffn_case(g):
    E, C, d, f = 4, 8, 64, 128
    w = lambda *s: (torch.randn(s, generator=g) * 0.1).bfloat16()
    counts = torch.tensor([3, 8, 0, 5], dtype=torch.int32)
    return (expert_ffn, (w(E, C, d), w(E, d, f), w(E, d, f), w(E, f, d)),
            {"counts": counts}, "expert_ffn_bwd", ffn_flops(E, C, d, f))


def _attention_case(g):
    q, k, v = (torch.randn((2, 12, h, 64), generator=g).bfloat16()
               for h in (8, 2, 2))
    return (flash_attention, (q, k, v), {"causal": True},
            "flash_attention_bwd", fa_flops(2, 12, 12, 8, 64, True, 0))


def _gating_case(g):
    return (gating, (torch.randn((6, 8), generator=g), 2), {}, "gating_bwd",
            gate_flops(6, 8, 2))


@pytest.mark.parametrize("case", [_gating_case, _ffn_case, _attention_case])
def test_meta_backward_is_the_plain_recompute(case):
    """With gradients on ``meta`` a wrapper goes through its autograd
    Function, as on the card: the forward is the kernel's shape op, the
    backward recomputes through the plain version.  So the FLOPs counted on
    ``meta`` are the kernel's plus those of the plain forward and backward
    (counted on the CPU), each gradient has its input's layout, and no
    launch is counted."""
    from repro_torch import kernels
    fn, args, kw, key, kernel_flops = case(torch.Generator().manual_seed(0))
    diff = [a for a in args if torch.is_tensor(a) and a.is_floating_point()]

    def step(device):
        ins = [a.to(device).requires_grad_(True) if any(a is d for d in diff)
               else (a.to(device) if torch.is_tensor(a) else a) for a in args]
        out = fn(*ins, **{n: t.to(device) if torch.is_tensor(t) else t
                          for n, t in kw.items()})
        outs = [o for o in (out if isinstance(out, tuple) else (out,))
                if o.is_floating_point()]
        grads = torch.autograd.grad(outs, [t for t in ins if torch.is_tensor(t)
                                           and t.requires_grad],
                                    [torch.ones_like(o) for o in outs])
        return grads

    with FlopCounterMode(display=False) as fc_cpu:
        cpu_grads = step("cpu")         # the plain version, fwd + bwd
    before = kernels.LAUNCHES[key]
    with FlopCounterMode(display=False) as fc_meta:
        meta_grads = step("meta")
    assert kernels.LAUNCHES[key] == before
    for c, m in zip(cpu_grads, meta_grads, strict=True):
        assert m.device.type == "meta"
        assert tuple(c.shape) == tuple(m.shape) and c.dtype == m.dtype
    assert fc_meta.get_total_flops() == \
        kernel_flops + fc_cpu.get_total_flops()


@pytest.mark.parametrize("shape", ["train_4k", "prefill_32k", "decode_32k"])
def test_laid_out_peak_on_one_rank_is_the_card_peak(shape):
    """Laid out on a (1, 1) mesh of a fake group every shard is the whole
    tensor, so ``PeakBytes`` must read the one-card run's peak: it counts
    the local storages and skips what DTensor's sharding propagation
    allocates in its fake mode (global-size tensors that hold no memory).
    The laid-out layers' own temporaries (their collectives' outputs, the
    log-sum-exp decode's partials) differ by under 0.5 %."""
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.configs import make_smoke
    from repro_torch.launch import sharding as shd
    cfg = make_smoke(get_config("mixtral_8x7b")).replace(
        dtype="bfloat16", param_dtype="bfloat16")
    spec = dataclasses.replace(shapes.SHAPES[shape], batch=2, seq=256)
    build = {"train": shapes.build_train, "prefill": shapes.build_prefill,
             "decode": shapes.build_decode}[spec.kind]
    train = spec.kind == "train"
    card = dryrun.measure(*build(cfg, spec)[1:], train=train)
    with dryrun.fake_world(1):
        mesh = init_device_mesh("cpu", (1, 1),
                                mesh_dim_names=("data", "model"))
        for wmode in ("tp", "fsdp"):
            c, fn, args = build(cfg, spec, mesh, wmode)
            with shd.rules(mesh, shd.logical_map_for(c, shape, mesh),
                           wmode):
                laid = dryrun.measure(fn, args, train=train, mesh=mesh)
            assert laid["param_bytes"] == card["param_bytes"]
            assert laid["peak_live_bytes"] == pytest.approx(
                card["peak_live_bytes"], rel=5e-3)


def test_peak_skips_the_sharding_propagation_of_a_wide_mesh():
    """A DTensor op over 64 ranks: DTensor learns its output's shape by
    running it on global-size fake tensors (64 x the shard); ``PeakBytes``
    reads the shard and the op's local output only."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor, Shard
    with dryrun.fake_world(64):
        mesh = init_device_mesh("cpu", (64,), mesh_dim_names=("model",))
        local = torch.empty((1021, 1024), device="meta")
        x = DTensor.from_local(local, mesh, [Shard(0)], run_check=False)
        mem = dryrun.PeakBytes()
        mem.start([local])
        with mem:
            y = x * 3.0
        assert y.to_local().shape == local.shape
        assert mem.peak == 2 * local.nbytes
