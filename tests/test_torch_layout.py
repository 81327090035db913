"""The port's layout on ranks (repro_torch/launch/{layout,sharding,
collectives}.py and the models' laid-out layers): smoke Mixtral laid out
on a (2, 2) mesh of four gloo ranks, under ``tp`` and ``fsdp``, against
the single-process port (1e-5) and the JAX package's ``apply_model`` and
loss (3e-5), greedy tokens exact; Qwen3-30B-A3B's smoke prefill through
the expert-parallel exchange under the layout; the ranks' collectives
against the fake group's ``meta`` run of the same steps, element for
element; smoke configs laid out on the production mesh, with the
all-reduce bytes of a one-layer dense TP prefill against the closed form.
One rank spawn (``tests/_torch_layout_ranks.py::layout_rank``) and one
subprocess (the same module as a script) serve every test.
"""
import functools
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_layout_ranks as R
from repro import configs as jconfigs
from repro.models import model as jmodel
from repro.training import train_step as jstep
from repro_torch import bridge
from repro_torch import configs as tconfigs
from repro_torch.launch.mesh import run_ranks
from repro_torch.models.model import (apply_model, init_caches, init_model,
                                      meta_model)
from repro_torch.serving.steps import (default_dali_config, init_serve_state,
                                       make_decode_step, make_prefill_step)
from repro_torch.training.optimizer import (OptConfig, adamw_update,
                                            init_adamw)
from repro_torch.training.train_step import make_loss_fn, value_and_grad
from repro_torch.tree import tree_leaves, tree_map

HERE = os.path.dirname(__file__)


@functools.lru_cache(maxsize=None)
def _jax_params():
    jc = jconfigs.make_smoke(jconfigs.get_config("mixtral_8x7b"))
    return jc, jmodel.init_model(jax.random.PRNGKey(0), jc)


@functools.lru_cache(maxsize=None)
def _params_np():
    """The JAX package's params in the port's key order (the order its
    gradient reductions are issued in, as on ``meta``)."""
    jc, jp = _jax_params()
    tp = bridge.to_torch(jax.tree.map(np.asarray, jp), "cpu")
    return tree_map(lambda _, t: t.numpy(), meta_model(R.mixtral()), tp)


@functools.lru_cache(maxsize=None)
def _qwen_np():
    return tree_map(lambda t: t.numpy(),
                    init_model(R.qwen3_ep(), seed=0, device="cpu"))


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def meta_proc():
    """The fake group's run (the module as a script), started before the
    ranks so that it runs beside them."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.join(HERE, "..", "src"), env.get("PYTHONPATH", "")])
    p = subprocess.Popen([sys.executable,
                          os.path.join(HERE, "_torch_layout_ranks.py")],
                         stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                         text=True, env=env)
    yield p
    p.kill()


@pytest.fixture(scope="module")
def ranks(meta_proc):
    return run_ranks(R.layout_rank, 4, timeout_s=600,
                     args=(_params_np(), _qwen_np()))


@pytest.fixture(scope="module")
def meta(ranks, meta_proc):
    out, err = meta_proc.communicate(timeout=600)
    assert meta_proc.returncode == 0, err[-3000:]
    return json.loads(out)


@functools.lru_cache(maxsize=None)
def _single(arch="mixtral_8x7b"):
    """The single-process port from the same params and tokens."""
    if arch == "mixtral_8x7b":
        cfg = R.mixtral()
        params = tree_map(torch.from_numpy, _params_np())
    else:
        cfg = tconfigs.make_smoke(tconfigs.get_config(arch))
        params = init_model(cfg, seed=0, device="cpu")
    toks, lbls = (torch.from_numpy(a) for a in R.tokens(cfg))
    out = {}
    with torch.no_grad():
        out["logits"] = apply_model(params, toks, cfg)[0][..., :cfg.vocab]
        dcfg = default_dali_config(cfg) if cfg.moe is not None else None
        first, caches = make_prefill_step(cfg)(
            params, toks, init_caches(cfg, R.B, R.S + R.N_DEC, device="cpu"))
        state = init_serve_state(cfg, R.B, R.S + R.N_DEC, dali_cfg=dcfg,
                                 device="cpu")
        state.update(caches=caches, tokens=first,
                     pos=torch.full((), R.S, dtype=torch.int32))
        decode = make_decode_step(cfg, dcfg)
        out["tokens"] = [first]
        for _ in range(R.N_DEC):
            state, lg, _ = decode(params, state)
            out["tokens"].append(state["tokens"])
        out["decode_logits"] = lg[..., :cfg.vocab]
    p = tree_map(lambda t: t.clone(), params)
    (_, m), g = value_and_grad(make_loss_fn(cfg), p,
                               {"tokens": toks, "labels": lbls})
    p, _, om = adamw_update(p, g, init_adamw(p), OptConfig())
    out.update(params=p, grads=g, loss=float(m["loss"]),
               grad_norm=float(om["grad_norm"]))
    return out


def _grads_close(got, want, tol):
    """Every gradient leaf within ``tol`` of ``want``'s, relative to its
    own max |g| (tests/test_torch_archs_train.py)."""
    got, want = bridge.flatten(got), bridge.flatten(want)
    assert got.keys() == want.keys()
    for k in want:
        a, b = np.asarray(got[k]), np.asarray(want[k])
        assert a.shape == b.shape, k
        err = float(np.abs(a - b).max(initial=0))
        assert err <= tol * float(np.abs(b).max(initial=0)), (k, err)


@pytest.mark.parametrize("wmode", R.WMODES)
def test_forward_and_serving_against_the_port_and_jax(ranks, wmode):
    got = ranks[0][wmode]["out"]
    ref = _single()
    cfg = R.mixtral()
    np.testing.assert_allclose(got["logits"], ref["logits"].numpy(),
                               atol=1e-5, rtol=1e-5)
    jc, jp = _jax_params()
    toks = R.tokens(cfg)[0]
    jl = np.asarray(jmodel.apply_model(jp, jnp.asarray(toks), jc)[0])
    np.testing.assert_allclose(got["logits"], jl[..., :cfg.vocab],
                               atol=3e-5, rtol=3e-5)
    # greedy tokens exact, the last decode step's logits against the
    # port's decode and the JAX forward over the whole sequence
    for a, b in zip(got["tokens"], ref["tokens"]):
        np.testing.assert_array_equal(a, b.numpy())
    np.testing.assert_allclose(got["decode_logits"],
                               ref["decode_logits"].numpy(), atol=1e-5,
                               rtol=1e-5)
    seq = np.concatenate([toks] + [t for t in got["tokens"][:-1]], axis=1)
    jd = np.asarray(jmodel.apply_model(jp, jnp.asarray(seq), jc)[0])[:, -1:]
    np.testing.assert_allclose(got["decode_logits"], jd[..., :cfg.vocab],
                               atol=3e-5, rtol=3e-5)


@pytest.mark.parametrize("wmode", R.WMODES)
def test_train_step_against_the_port_and_jax(ranks, wmode):
    """One training step: every settled gradient leaf (each relative to
    its own max |g|), the gradient norm, the loss and the parameters after
    the AdamW step within 1e-5 of the single process, and the gradients
    and the loss within 3e-5 of ``jax.value_and_grad`` of the JAX
    package's loss."""
    got = ranks[0][wmode]["out"]
    ref = _single()
    _grads_close(got["grads"], ref["grads"], 1e-5)
    assert abs(float(got["grad_norm"]) / ref["grad_norm"] - 1) < 1e-5
    for a, b in zip(tree_leaves(got["params"]), tree_leaves(ref["params"])):
        np.testing.assert_allclose(a, b.numpy(), atol=1e-5, rtol=1e-5)
    assert abs(float(got["loss"]) - ref["loss"]) < 1e-5
    jc, jp = _jax_params()
    toks, lbls = R.tokens(R.mixtral())
    (jl, _), jg = jax.jit(jax.value_and_grad(
        jstep.make_loss_fn(jc), has_aux=True))(
            jp, {"tokens": jnp.asarray(toks), "labels": jnp.asarray(lbls)})
    assert abs(float(got["loss"]) - float(jl)) < 3e-5
    jg = bridge.to_torch(jax.tree.map(np.asarray, jg), "cpu")
    _grads_close(got["grads"],
                 tree_map(lambda _, t: t.numpy(), meta_model(R.mixtral()),
                          jg), 3e-5)


@pytest.mark.parametrize("arch", R.OTHERS)
def test_mla_and_mamba_layers_on_the_layout(ranks, arch):
    """DeepSeek-V2-Lite's MLA (heads over 'model', the latent cache's
    sequence sharded, the absorbed decode combined by log-sum-exp) and
    Jamba's Mamba-2 (inner channels and heads over 'model', the gated
    norm's mean square summed over it), under tp: the forward, greedy
    decode and a training step (every gradient leaf, relative to its own
    max |g|) within 1e-5 of the single-process port."""
    got, ref = ranks[0][arch], _single(arch)
    vocab = ref["logits"].shape[-1]
    np.testing.assert_allclose(got["logits"], ref["logits"].numpy(),
                               atol=1e-5, rtol=1e-5)
    for a, b in zip(got["tokens"], ref["tokens"]):
        np.testing.assert_array_equal(a, b.numpy())
    np.testing.assert_allclose(got["decode_logits"][..., :vocab],
                               ref["decode_logits"].numpy(), atol=1e-5,
                               rtol=1e-5)
    _grads_close(got["grads"], ref["grads"], 1e-5)
    for a, b in zip(tree_leaves(got["params"]), tree_leaves(ref["params"])):
        np.testing.assert_allclose(a, b.numpy(), atol=1e-5, rtol=1e-5)


def test_qwen3_ep_prefill_under_the_layout(ranks):
    """16 experts lie over 'model': the layer takes the EP exchange (its
    shipped capacity recorded per super-block) on each rank's block."""
    cfg = R.qwen3_ep()
    got = ranks[0]["qwen3"]
    assert len(got["ep_cx"]) == cfg.n_layers and min(got["ep_cx"]) >= 4
    params = tree_map(torch.from_numpy, _qwen_np())
    with torch.no_grad():
        toks = R.tokens(cfg, seed=1, seq=R.QWEN_S)[0]
        ref = apply_model(params, torch.from_numpy(toks), cfg)[0]
    ref = ref[..., :cfg.vocab]
    np.testing.assert_allclose(got["logits"], ref.numpy(), atol=1e-5,
                               rtol=1e-5)


@pytest.mark.parametrize("wmode", R.WMODES)
def test_rank_collectives_equal_the_meta_count(ranks, meta, wmode):
    """Every rank issues the same collectives, and the fake group's
    ``meta`` run of the same steps counts them kind for kind, element for
    element (the ranks run float32, ``meta`` bfloat16)."""
    sigs = [r[wmode]["sig"] for r in ranks]
    want = {k: [tuple(e[:3]) + (tuple(e[3]),) for e in v]
            for k, v in meta["sig"][wmode].items()}
    for sig in sigs:
        got = {k: [tuple(e[:3]) + (tuple(e[3]),) for e in v]
               for k, v in sig.items()}
        assert got == want
    assert all(want[k] for k in ("forward", "prefill", "decode", "train"))


def test_production_mesh_dry_run_of_smoke_configs(meta):
    """The twelve architectures' smoke configs laid out on (data=32,
    model=8) run every step kind (the cross source laid out over the
    batch, Gemma-2's 32-token prompt past its 16-wide window); a
    one-layer dense TP prefill all-reduces B/32 x S x d once per
    row-parallel product (the embedding, the attention's and the FFN's
    output projections), each at 2 (g - 1) / g of its bytes."""
    pod = meta["pod"]
    assert len(pod) == 3 * len(R.ARCHS)
    for name, rec in pod.items():
        assert rec["collectives"]["total"] > 0, name
    rec = pod["llama3_405b prefill_32k"]
    b = (64 // 32) * 32 * rec["d_model"] * rec["itemsize"]
    n_rowpar = 1 + 2 * rec["n_layers"]
    assert rec["collectives"]["_n_all-reduce"] == n_rowpar
    assert rec["collectives"]["all-reduce"] == n_rowpar * 2 * 7 / 8 * b
