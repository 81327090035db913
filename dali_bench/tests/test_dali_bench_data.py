"""The benchmark's traffic, weights, counts and imports, on the CPU."""
import ast
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from dali_bench import costs, traffic, weights
from dali_bench.reference import common, for_config
from dali_bench.tests import tiny

BENCH = Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("name", ["chat.closed", "longdocs.closed"])
def test_same_seed_same_requests(name):
    t = tiny.load_traffic(name)
    a = traffic.requests(t, 512, 2**31 + 5, 12)
    b = traffic.requests(t, 512, 2**31 + 5, 12)
    c = traffic.requests(t, 512, 2**31 + 6, 12)
    assert all(np.array_equal(p, q) and n == m
               for (p, n), (q, m) in zip(a, b))
    # another seed: the same sizes in the same order, other tokens
    assert [(len(p), n) for p, n in a] == [(len(p), n) for p, n in c]
    assert any(not np.array_equal(p, q) for (p, _), (q, _) in zip(a, c))
    lo, hi = t["prompt_tokens"]["min"], t["prompt_tokens"]["max"]
    assert all(lo <= len(p) <= hi and 0 <= p.min() and p.max() < 512
               for p, _ in a)


def test_sizes_are_quantiles_in_a_fixed_shuffled_order():
    """Prompt and answer sizes are each distribution's quantiles, each set
    in an order of its own that no seed changes: neither sorted nor paired
    by rank."""
    t = tiny.load_traffic("chat.closed")
    n = 12
    reqs = traffic.requests(t, 512, 7, n)
    prompts = [len(p) for p, _ in reqs]
    answers = [o for _, o in reqs]
    assert sorted(prompts) == list(traffic.quantiles(t["prompt_tokens"], n))
    assert sorted(answers) == list(traffic.quantiles(t["output_tokens"], n))
    for sizes in (prompts, answers):
        assert sizes not in (sorted(sizes), sorted(sizes)[::-1])
    rank = np.argsort(np.argsort(prompts, kind="stable"), kind="stable")
    assert np.argsort(np.argsort(answers, kind="stable"),
                      kind="stable").tolist() not in (rank.tolist(),
                                                      (n - 1 - rank).tolist())


def test_chain_is_markov_corpus_chain():
    from repro_torch.data.pipeline import MarkovCorpus
    mc = MarkovCorpus(vocab=300, seed=2**33 + 1)
    ch = traffic.MarkovChain(300, 2**33 + 1)
    assert np.array_equal(mc.successors, ch.successors)
    assert np.allclose(np.cumsum(mc.probs, 1)[:, :-1], ch.cum[:, :-1])
    # every transition a sample takes is one of the chain's
    seq = ch.sample(np.random.default_rng(0), [400])[0]
    assert all(b in ch.successors[a] for a, b in zip(seq, seq[1:]))


@pytest.mark.parametrize("config", [tiny.MIXTRAL, tiny.DEEPSEEK],
                         ids=["mixtral", "deepseek"])
def test_same_seed_same_weights(config):
    spec = for_config(config).dims(config)
    layer = spec["first_dense"]
    a = weights.draw_layer(2**32 + 3, spec, layer, "cpu", torch.bfloat16)
    b = weights.draw_layer(2**32 + 3, spec, layer, "cpu", torch.bfloat16)
    c = weights.draw_layer(2**32 + 4, spec, layer, "cpu", torch.bfloat16)
    assert a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)
    assert all(not torch.equal(a[k], c[k]) for k in a)
    assert a["router"].dtype == torch.float32
    assert a["experts.gate"].dtype == torch.bfloat16
    # one weight drawn alone is the same as drawn with its layer
    shape, std, _ = weights.layer_specs(spec, layer)["wo"]
    one = weights.draw(2**32 + 3, f"layers.{layer}.wo", shape, std,
                       torch.bfloat16, "cpu")
    assert torch.equal(one, a["wo"])


def _counted(spec, seed, fn):
    from torch.utils.flop_counter import FlopCounterMode
    with FlopCounterMode(display=False) as fc:
        fn()
    return fc.get_total_flops()


@pytest.mark.parametrize("config", [tiny.MIXTRAL, tiny.DEEPSEEK],
                         ids=["mixtral", "deepseek"])
@pytest.mark.parametrize("L", [2, 7, 40])
def test_prefill_flops_closed_form(config, L):
    """The closed form against the reference's own products, counted:
    the reference attends every key of its block (no causal saving), so
    its count has L*L pairs where the closed form counts L(L+1)/2."""
    spec = for_config(config).dims(config)
    seq = list(range(L))
    n = _counted(spec, 1, lambda: common.forward_logits(
        spec, 1, [seq], [[L - 1]], "cpu", torch.float32))
    pairs = L * (L + 1) / 2
    ctx = costs._attn_ctx(spec, decode=False)
    want = (costs.prefill_flops(spec, L)
            + spec["layers"] * (L * L - pairs) * ctx)
    assert n == pytest.approx(want, rel=1e-12)


@pytest.mark.parametrize("config", [tiny.MIXTRAL, tiny.DEEPSEEK],
                         ids=["mixtral", "deepseek"])
def test_k2_bound_counts_the_experts_products(config):
    spec = for_config(config).dims(config)
    L = 37
    x = torch.randn(L, spec["d"])
    w = weights.draw_layer(5, spec, spec["first_dense"], "cpu",
                           torch.float32)
    spec_routed = dict(spec, shared_ff=0)
    n = _counted(spec, 5, lambda: common.moe(w, x, spec_routed,
                                             common.f32_mm))
    router = 2 * spec["d"] * spec["experts"] * L
    b = costs.k2_prefill_bound(spec, L, 2)
    assert n - router == b["flops"] / spec["moe_layers"]
    esz = 2
    assert b["bytes"] / spec["moe_layers"] == (
        min(spec["experts"], L * spec["top_k"])
        * costs.expert_bytes(spec, esz)
        + 2 * L * spec["top_k"] * spec["d"] * esz)


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield (node.module or "").split(".")[0]


def test_no_module_imports_jax_or_the_jax_package():
    files = sorted(BENCH.rglob("*.py"))
    assert files
    for f in files:
        names = set(_imports(f))
        assert not names & {"jax", "jaxlib", "flax", "repro"}, f
        if "reference" in f.relative_to(BENCH).parts:
            assert "repro_torch" not in names, f


def test_reference_loads_nothing_of_the_program():
    code = ("import sys; import dali_bench.reference.mixtral, "
            "dali_bench.reference.deepseek_v2, dali_bench.check; "
            "bad = {m.split('.')[0] for m in sys.modules} & "
            "{'jax', 'jaxlib', 'flax', 'repro', 'repro_torch'}; "
            "print(sorted(bad)); sys.exit(1 if bad else 0)")
    r = subprocess.run([sys.executable, "-c", code], cwd=BENCH.parent,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


def test_forbidden_modules_compares_whole_names(monkeypatch):
    from dali_bench import harness
    for m in [m for m in sys.modules
              if m.split(".")[0] in harness.FORBIDDEN]:
        monkeypatch.delitem(sys.modules, m)
    monkeypatch.setitem(sys.modules, "repro_torch_like", object())
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "repro.models", object())
    assert harness.forbidden_modules() == ["repro"]
