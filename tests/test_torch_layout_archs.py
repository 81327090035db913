"""The port's layout for the seven architectures whose layers the Mixtral,
MLA and Mamba layout tests do not reach (``tests/_torch_layout_archs_
ranks.py::CASES``), on a (2, 2) mesh of four gloo ranks: Llama-3.2-Vision's
cross layer, SeamlessM4T's encoder and ``self_cross`` decoder, Gemma-2's
rolling cache past its window, Llama-4 under fsdp with 16 experts (its
shared expert through the expert-parallel exchange), OLMo, Qwen3-32B and
Mamba-2.  Each case's forward, prefill, greedy decode and (where it runs
one) training step against the single-process port (1e-5) and the JAX
package's ``apply_model`` and loss (3e-5; Gemma-2's decode after a prompt
past its window against the port only: the reference clamps that cache
write to slot 0), greedy tokens exact; the ranks' collectives against the
fake group's ``meta`` run of the same steps, element for element; and
the fsdp decode's expert-weight gathers over 'data' against the JAX
package's compiled step.  The cross gates are opened to 0.5 on both
sides.  One rank spawn and two subprocesses (the fake group's run, and
the JAX package's compile on eight host devices) serve every test.
"""
import dataclasses
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

import _torch_layout_archs_ranks as A
from repro import configs as jconfigs
from repro.models import model as jmodel
from repro.training import train_step as jstep
from repro_torch import bridge
from repro_torch.launch.mesh import run_ranks
from repro_torch.models.model import (apply_model, collect_field,
                                      collect_moe_scalars, init_caches,
                                      meta_model)
from repro_torch.serving.steps import (default_dali_config, init_serve_state,
                                       make_decode_step, make_prefill_step)
from repro_torch.training.optimizer import (OptConfig, adamw_update,
                                            init_adamw)
from repro_torch.training.train_step import (cross_entropy, make_loss_fn,
                                             value_and_grad)
from repro_torch.tree import tree_leaves, tree_map

HERE = os.path.dirname(__file__)
TRAINED = [c for c, spec in A.CASES.items() if spec[4]]
# training steps that take the expert-parallel exchange
EP_TRAINED = ("llama4",)
# prompts past Gemma-2's window: the reference clamps their cache write
PAST_WINDOW = ("gemma2", "gemma2_edge")


def _open_gates(tree):
    def fix(path, a):
        key = path[-1].key if hasattr(path[-1], "key") else None
        if key in ("gate", "mlp_gate") and np.ndim(a) <= 1:
            return np.full_like(a, 0.5)
        return np.asarray(a)
    return jax.tree_util.tree_map_with_path(fix, tree)


@functools.lru_cache(maxsize=None)
def _jax(arch):
    """(JAX config, JAX params) of an arch's case config, gates open."""
    jc = jconfigs.make_smoke(jconfigs.get_config(arch))
    if jc.moe is not None:
        jc = jc.replace(moe=dataclasses.replace(jc.moe, n_routed=16))
    return jc, _open_gates(jmodel.init_model(jax.random.PRNGKey(0), jc))


def _port_tree(arch, tree):
    """A JAX package's tree of params (or of their gradients) as numpy
    arrays in the port's key order."""
    cfg = A.config(next(c for c, s in A.CASES.items() if s[0] == arch))
    return tree_map(lambda _, t: t.numpy(), meta_model(cfg),
                    bridge.to_torch(tree, "cpu"))


@functools.lru_cache(maxsize=None)
def _params_np(arch):
    """The JAX package's params in the port's key order."""
    return _port_tree(arch, _jax(arch)[1])


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _script(name, **env):
    e = dict(os.environ, **env)
    e["PYTHONPATH"] = os.pathsep.join(
        [os.path.join(HERE, "..", "src"), e.get("PYTHONPATH", "")])
    return subprocess.Popen([sys.executable, os.path.join(HERE, name)],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, env=e)


@pytest.fixture(scope="module")
def procs():
    """The two subprocesses, started before the ranks so they run beside
    them."""
    p = {"meta": _script("_torch_layout_archs_ranks.py"),
         "f5": _script("_torch_f5_reference.py", JAX_PLATFORMS="cpu")}
    yield p
    for q in p.values():
        q.kill()


def _read(proc):
    out, err = proc.communicate(timeout=600)
    assert proc.returncode == 0, err[-3000:]
    return json.loads(out)


@pytest.fixture(scope="module")
def ranks(procs):
    params = {spec[0]: _params_np(spec[0]) for spec in A.CASES.values()}
    return run_ranks(A.archs_rank, 4, timeout_s=600, args=(params,))


@pytest.fixture(scope="module")
def meta(ranks, procs):
    return _read(procs["meta"])


@pytest.fixture(scope="module")
def f5_reference(ranks, procs):
    return _read(procs["f5"])


@functools.lru_cache(maxsize=None)
def _single(case):
    """The single-process port on the case's params and inputs."""
    arch, _, s, _, train = A.CASES[case]
    cfg = A.config(case)
    params = tree_map(torch.from_numpy, _params_np(arch))
    toks, lbls, src = (None if a is None else torch.from_numpy(a)
                       for a in A.inputs(case, cfg))
    n_cross = None if src is None else src.shape[1]
    out = {}
    vocab = cfg.vocab
    with torch.no_grad():
        out["logits"] = apply_model(params, toks, cfg,
                                    cross_src=src)[0][..., :vocab]
        dcfg = default_dali_config(cfg) if cfg.moe is not None else None
        caches = init_caches(cfg, A.B, s + 4, device="cpu", n_cross=n_cross)
        first, caches = make_prefill_step(cfg)(params, toks, caches,
                                               cross_src=src)
        out["caches"] = tree_map(lambda t: t.clone(), caches)
        state = init_serve_state(cfg, A.B, s + 4, dali_cfg=dcfg,
                                 device="cpu")
        state.update(caches=caches, tokens=first,
                     pos=torch.full((), s, dtype=torch.int32))
        decode = make_decode_step(cfg, dcfg)
        out["tokens"] = [first]
        for _ in range(4):
            state, lg, _ = decode(params, state)
            out["tokens"].append(state["tokens"])
        out["decode_logits"] = lg[..., :vocab]
    if train:
        batch = {"tokens": toks, "labels": lbls}
        if src is not None:
            batch["cross_src"] = src
        p = tree_map(lambda t: t.clone(), params)
        loss_fn = (_ep_loss_fn(cfg) if case in EP_TRAINED
                   else make_loss_fn(cfg))
        (_, m), g = value_and_grad(loss_fn, p, batch)
        p, _, om = adamw_update(p, g, init_adamw(p), OptConfig())
        out.update(params=p, grads=g, loss=float(m["loss"]),
                   aux=float(m["aux"]), grad_norm=float(om["grad_norm"]))
    return out


def _rel_close(a, b, tol, what=""):
    """Within ``tol`` of max |b|: a gradient leaf against its own largest
    element (tests/test_torch_archs_train.py)."""
    b = b.numpy() if torch.is_tensor(b) else np.asarray(b)
    a = np.asarray(a)
    assert a.shape == b.shape, (what, a.shape, b.shape)
    err = float(np.abs(a - b).max(initial=0))
    assert err <= tol * float(np.abs(b).max(initial=0)), (what, err)


def _grads_close(got, want, tol):
    """Every gradient leaf of ``got`` within ``tol`` of ``want``'s, each
    relative to its own max |g|."""
    got, want = bridge.flatten(got), bridge.flatten(want)
    assert got.keys() == want.keys()
    for k in want:
        _rel_close(got[k], want[k], tol, k)


def _close(a, b, tol):
    """Within ``tol`` of max |b| (the repo's float32 rule, tests/
    test_torch_archs.py), and at least ``tol`` absolute (the layout
    tests' ``atol``)."""
    b = b.numpy() if torch.is_tensor(b) else np.asarray(b)
    a = np.asarray(a)
    assert a.shape == b.shape, (a.shape, b.shape)
    err = float(np.abs(a - b).max(initial=0))
    assert err <= tol * max(float(np.abs(b).max(initial=0)), 1.0), err


def _ep_loss_fn(cfg):
    """The single process's loss with the load-balancing term as the
    expert-parallel exchange computes it in the laid-out training step
    (Llama-4's, 64 tokens a rank at train_4k's map): each rank's (B/2,
    S/2) block's term, averaged over the ranks (the reference's ``pmean``,
    ``repro/models/moe_ep.py:409-410``); the cross-entropy and z-losses as
    ``make_loss_fn``'s."""
    m = cfg.moe

    def block_aux(probs, idx, b, s):
        probs = probs.reshape(2, b // 2, 2, s // 2, -1)
        idx = idx.reshape(2, b // 2, 2, s // 2, -1)
        aux = []
        for di in range(2):
            for mi in range(2):
                p = probs[di, :, mi].reshape(-1, m.n_routed)
                i = idx[di, :, mi].reshape(-1)
                frac = (torch.bincount(i, minlength=m.n_routed).float()
                        / i.numel())
                aux.append(m.n_routed * (frac * p.mean(0)).sum())
        return torch.stack(aux).mean()

    def loss_fn(params, batch):
        toks = batch["tokens"]
        b, s = toks.shape
        logits, _, infos = apply_model(params, toks, cfg, trace=True)
        loss, ce = cross_entropy(logits, batch["labels"])
        aux = sum(block_aux(p, i, b, s) for p, i in zip(
            collect_field(infos, "probs"), collect_field(infos, "topk_idx"))
        ) * m.aux_loss_weight
        total = loss + aux + collect_moe_scalars(infos)["z_loss"]
        return total, {"loss": total, "ce": ce, "aux": aux}

    return loss_fn


@pytest.mark.parametrize("case", list(A.CASES))
def test_forward_and_serving_against_the_port_and_jax(ranks, case):
    got, ref = ranks[0][case]["out"], _single(case)
    arch = A.CASES[case][0]
    cfg = A.config(case)
    vocab = cfg.vocab
    for a, b in zip(got["tokens"], ref["tokens"]):
        np.testing.assert_array_equal(a, b.numpy())
    _close(got["decode_logits"][..., :vocab], ref["decode_logits"], 1e-5)
    toks, _, src = A.inputs(case, cfg)
    jc, jp = _jax(arch)
    jsrc = None if src is None else jnp.asarray(src)
    if "logits" in got:
        _close(got["logits"][..., :vocab], ref["logits"], 1e-5)
        jl = np.asarray(jmodel.apply_model(jp, jnp.asarray(toks), jc,
                                           cross_src=jsrc)[0])
        _close(got["logits"][..., :vocab], jl[..., :vocab], 3e-5)
    if case in PAST_WINDOW:
        return
    # the last decode step against the JAX forward over the whole sequence
    seq = np.concatenate([toks] + [t for t in got["tokens"][:-1]], axis=1)
    jd = np.asarray(jmodel.apply_model(jp, jnp.asarray(seq), jc,
                                       cross_src=jsrc)[0])[:, -1:]
    _close(got["decode_logits"][..., :vocab], jd[..., :vocab], 3e-5)


@pytest.mark.parametrize("case", TRAINED)
def test_train_step_against_the_port_and_jax(ranks, case):
    """One training step: every settled gradient leaf (each relative to
    its own max |g|), the gradient norm, the loss and the parameters after
    the AdamW step within 1e-5 of the single process, and the gradients
    and the loss within 3e-5 of ``jax.value_and_grad`` of the JAX
    package's loss.  Where the step takes the expert-parallel exchange
    (Llama-4), its load-balancing term is the ranks' blocks' average, as in
    the reference: the single process takes the same term
    (``_ep_loss_fn``), and the JAX package's global term is swapped for it
    in the loss; its gradients, which take the global term everywhere
    upstream of the router, are not compared."""
    got, ref = ranks[0][case]["out"], _single(case)
    _grads_close(got["grads"], ref["grads"], 1e-5)
    assert abs(float(got["grad_norm"]) / ref["grad_norm"] - 1) < 1e-5
    for a, b in zip(tree_leaves(got["params"]), tree_leaves(ref["params"])):
        _close(a, b, 1e-5)
    assert abs(float(got["aux"]) - ref["aux"]) < 1e-6
    assert abs(float(got["loss"]) - ref["loss"]) < 1e-5
    cfg = A.config(case)
    toks, lbls, src = A.inputs(case, cfg)
    arch = A.CASES[case][0]
    jc, jp = _jax(arch)
    batch = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(lbls)}
    if src is not None:
        batch["cross_src"] = jnp.asarray(src)
    if case in EP_TRAINED:
        jl, jm = jax.jit(jstep.make_loss_fn(jc))(jp, batch)
        assert abs(float(got["loss"])
                   - (float(jl) - float(jm["aux"]) + ref["aux"])) < 3e-5
        return
    (jl, _), jg = jax.jit(jax.value_and_grad(jstep.make_loss_fn(jc),
                                             has_aux=True))(jp, batch)
    assert abs(float(got["loss"]) - float(jl)) < 3e-5
    _grads_close(got["grads"], _port_tree(arch, jg), 3e-5)


@pytest.mark.parametrize("case", PAST_WINDOW)
def test_rolling_cache_past_its_window_keeps_each_position_at_its_slot(
        ranks, case):
    """A prompt past the 16-wide window (37: the wrap inside the first
    'model' rank's block of the sequence-sharded cache; 40: on the
    boundary of the two blocks) leaves the local layer's cache as the
    single process's, its last 16 positions each at slot pos % 16."""
    got, ref = ranks[0][case]["out"]["caches"], _single(case)["caches"]
    s = A.CASES[case][2]
    local = got["scan"][0]                       # ("attn_local", "dense")
    want = np.arange(s - 16, s)
    slots = np.empty(16, np.int64)
    slots[want % 16] = want
    for row in local["pos"][0]:
        np.testing.assert_array_equal(row, slots)
    for a, b in zip(tree_leaves(got), tree_leaves(ref)):
        _close(a, b, 1e-5)


@pytest.mark.parametrize("case", list(A.CASES))
def test_rank_collectives_equal_the_meta_count(ranks, meta, case):
    """Every rank issues the same collectives, and the fake group's
    ``meta`` run of the same steps counts them kind for kind, element for
    element (the ranks run float32, ``meta`` bfloat16), but for the
    expert-parallel exchange's buckets: the ranks ship the smallest rung
    of the ladder that covers their demand, ``meta`` (which reads no
    value) its top rung."""
    norm = lambda sig: {k: [tuple(e[:3]) + (tuple(e[3]),) for e in v]
                        for k, v in sig.items()}
    want = norm(meta["sig"][case])
    got = norm(ranks[0][case]["sig"])
    for r in ranks[1:]:
        assert norm(r[case]["sig"]) == got
    assert got.keys() == want.keys() and want["prefill"] and want["decode"]
    for step in want:
        assert len(got[step]) == len(want[step]), step
        for g, w in zip(got[step], want[step]):
            if g[0] == "all-to-all":
                assert g[2:] == w[2:] and g[1] <= w[1], (step, g, w)
            else:
                assert g == w, (step, g, w)


def test_fsdp_decode_gathers_expert_weights_as_the_reference(meta,
                                                             f5_reference):
    """At decode_32k the reference's logical map lays the expert hidden
    dim over 'data' ("so FSDP expert weights stay stationary"); its
    compiled decode step still all-gathers the fsdp weights over 'data'
    (XLA on eight host devices), and the port's laid-out decode gathers
    the same: every MoE layer's three expert stacks, once each, and its
    elements over 'data' within 10 % of the reference's."""
    from repro_torch.configs import get_config, make_smoke
    cfg = A.with_experts(make_smoke(get_config("jamba_1_5_large_398b")))
    n_moe = default_dali_config(cfg).n_moe_layers
    assert meta["f5"]["stack_gathers"] == 3 * n_moe
    ref = f5_reference["all-gather|data|elements"]
    port = meta["f5"]["all-gather|data"] / 2          # bfloat16
    assert ref > 1e6
    assert 0.9 < port / ref < 1.1


def test_laid_out_slot_pool_still_raises():
    """The reference never lays a slot pool out: under laid-out rules the
    model raises for one rather than run it unlaid."""
    import types

    from repro_torch.launch import sharding as shd
    cfg = A.config("llama4")
    with shd.rules(types.SimpleNamespace(), {"batch": None}), \
            pytest.raises(NotImplementedError, match="slot pool"):
        apply_model(meta_model(cfg), torch.zeros((1, 4), dtype=torch.int32),
                    cfg, expert_slots={"prefix": (), "scan": ()})
