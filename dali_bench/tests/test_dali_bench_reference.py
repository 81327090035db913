"""The plain reference against the port's plain path, on the CPU at a
small size: the same weights, drawn from the seed by the benchmark."""
import numpy as np
import pytest
import torch

from dali_bench import port, traffic
from dali_bench.reference import common, for_config
from dali_bench.tests import tiny



@pytest.mark.parametrize("config", [tiny.MIXTRAL, tiny.DEEPSEEK],
                         ids=["mixtral", "deepseek"])
@pytest.mark.parametrize("host", [False, True], ids=["device", "host"])
def test_reference_matches_the_port_forward(config, host):
    """Logits at every position of a full forward: GQA or MLA, the router
    and top-k, the routed experts (read from the host stacks too), the
    shared experts and the dense first layer, the LM head."""
    from repro_torch.models.model import apply_model
    ref = for_config(config)
    spec = ref.dims(config)
    seed, S = 2**31 + 11, 29
    params = port.port_params(spec, seed, "cpu", torch.float32,
                              experts_on_host=host)
    pcfg = port.port_config(spec, config["name"], "float32")
    toks = np.stack(traffic.MarkovChain(spec["vocab"], seed).sample(
        np.random.default_rng(0), [S, S]))
    with torch.no_grad():
        got, _, _ = apply_model(params, torch.as_tensor(toks), pcfg,
                                positions=torch.arange(S))
    want = ref.forward_logits(spec, seed, [list(t) for t in toks],
                              [list(range(S))] * 2, "cpu", torch.float32)
    for g, w in zip(got, want):
        assert (g[:, :spec["vocab"]] - w).abs().max() < 2e-4


@pytest.mark.parametrize("config", [tiny.MIXTRAL, tiny.DEEPSEEK],
                         ids=["mixtral", "deepseek"])
def test_port_tree_is_the_ports_own(config):
    """The benchmark lays its weights out as the port's init does: the
    same paths, shapes and dtypes (the port's ``meta_model``)."""
    from repro_torch.models.model import meta_model
    from repro_torch.tree import tree_map_with_path
    spec = for_config(config).dims(config)
    pcfg = port.port_config(spec, config["name"], "float32")
    ours = port.port_params(spec, 1, "cpu", torch.float32,
                            experts_on_host=False)

    def flat(tree):
        out = {}
        tree_map_with_path(lambda p, t: out.__setitem__(
            p, (tuple(t.shape), t.dtype)), tree)
        return out
    assert flat(ours) == flat(meta_model(pcfg))


def test_fp8_rounds_both_operands():
    x = torch.randn(5, 64, dtype=torch.float64).float()
    w = torch.randn(64, 3).float()
    exact, low = common.f32_mm(x, w), common.fp8_mm(x, w)
    rel = ((low - exact).norm() / exact.norm()).item()
    assert 1e-3 < rel < 0.2
    assert torch.equal(common.fp8_mm(x, w), low)


def test_no_tf32_restores_the_flags():
    before = torch.backends.cuda.matmul.allow_tf32
    with common.no_tf32():
        assert torch.backends.cuda.matmul.allow_tf32 is False
        assert torch.backends.cudnn.allow_tf32 is False
    assert torch.backends.cuda.matmul.allow_tf32 == before


@pytest.mark.parametrize("assumed", [False, True],
                         ids=["unstated", "stated"])
def test_rope_scaling_runs_only_as_a_stated_departure(assumed):
    """The reference has no YaRN: a configuration that gives
    ``rope_scaling`` runs plain RoPE only where ``assumed`` says so."""
    config = dict(tiny.DEEPSEEK, rope_scaling={"type": "yarn", "factor": 40})
    if assumed:
        config["assumed"] = {"rope_scaling": "plain RoPE, as the port"}
        assert for_config(config).dims(config)["rope_theta"] == 10000
    else:
        with pytest.raises(ValueError, match="YaRN"):
            for_config(config).dims(config)
