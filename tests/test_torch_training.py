"""The port's training path (``repro_torch/training``, ``launch/train.py``,
``checkpoint/store.py``) and the kernels' autograd Functions against the
JAX package, on the smoke Mixtral at two layers, float32, on the CPU
(parameters, optimizer states and batches carried over with
``repro_torch.bridge`` and numpy).

Tolerances: 3e-5 relative to max |ref| for float32 values (the repo's
kernel tolerance, tests/test_kernels.py:17), every gradient leaf relative
to its own max |g|; drops exactly; 1e-4 relative for a 5-step loss
history (Adam's g / (sqrt(v) + eps) magnifies float32 rounding of
near-zero gradients from the second step on).

The autograd Functions (K1, K2, K3) run on the card only; here their
forward is routed through the plain version by patching each module's
``_launch`` hook, and their gradients must equal the plain version's own
autograd gradients exactly.
"""
import os
import pathlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
import repro.launch.train as jtrain
import repro.models.model as jmodel
import repro.training.optimizer as jopt
import repro.training.train_step as jstep
import repro_torch.configs as tconfigs
import repro_torch.launch.train as ttrain
import repro_torch.models.model as tmodel
import repro_torch.training.optimizer as topt
import repro_torch.training.train_step as tstep
from repro.kernels.expert_ffn.ops import _oracle as jffn_oracle
from repro_torch import bridge, kernels
from repro_torch.checkpoint.store import CheckpointManager, restore, save
from repro_torch.data.pipeline import MarkovCorpus, batches
from repro_torch.kernels.expert_ffn import ops as ffn_ops
from repro_torch.kernels.flash_attention import ops as attn_ops
from repro_torch.kernels.gating import ops as gating_ops
from repro_torch.tree import tree_leaves, tree_map

F32_TOL = 3e-5
SRC = pathlib.Path(__file__).resolve().parents[1] / "src" / "repro_torch"


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """Torch's many small training ops on one thread: under a parallel test
    run the CPU is shared, and torch's own thread pool then slows them
    down far more than it speeds them up."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(n_layers=2):
    j = jconfigs.make_smoke(jconfigs.get_config("mixtral_8x7b")).replace(
        n_layers=n_layers)
    t = tconfigs.make_smoke(tconfigs.get_config("mixtral_8x7b")).replace(
        n_layers=n_layers)
    return j, t


@pytest.fixture(scope="module")
def model():
    jc, tc = _cfgs()
    jp = jmodel.init_model(jax.random.PRNGKey(0), jc)
    return jc, tc, jp


def _tparams(jp):
    """A fresh port copy of the reference's params (the port updates in
    place)."""
    return bridge.to_torch(jax.tree.map(np.asarray, jp), "cpu")


def _batch(cfg, batch=4, seq=32, seed=0):
    b = next(iter(batches(MarkovCorpus(vocab=cfg.vocab, seed=seed), batch,
                          seq, 1, seed=seed)))
    return ({k: jnp.asarray(v) for k, v in b.items()},
            {k: torch.as_tensor(v) for k, v in b.items()})


def _rel(t, j):
    t = t.detach().float().numpy() if torch.is_tensor(t) \
        else np.asarray(t, np.float32)
    j = np.asarray(j, np.float32)
    assert t.shape == j.shape, (t.shape, j.shape)
    return float(np.abs(t - j).max()) / (float(np.abs(j).max()) + 1e-30)


def _trees_close(t_tree, j_tree, tol=F32_TOL):
    ft = bridge.flatten(t_tree)
    fj = bridge.flatten(jax.tree.map(np.asarray, j_tree))
    assert ft.keys() == fj.keys()
    for k in ft:
        if torch.is_tensor(ft[k]):
            assert _rel(ft[k], fj[k]) < tol, k


# --------------------------------------------------------------------------
# optimizer
# --------------------------------------------------------------------------

def test_schedule_matches_reference():
    oc = dict(lr=1e-3, warmup_steps=10, total_steps=100, min_lr_frac=0.1)
    for s in (0, 5, 10, 100):
        got = topt.schedule(s, topt.OptConfig(**oc))
        want = jopt.schedule(jnp.asarray(s), jopt.OptConfig(**oc))
        assert got.dtype == torch.float32
        assert abs(float(got) - float(want)) <= F32_TOL * abs(float(want))
    s = [float(topt.schedule(i, topt.OptConfig(**oc))) for i in (0, 5, 10,
                                                                 100)]
    assert s[1] < s[2]
    np.testing.assert_allclose(s[3], 1e-4, rtol=1e-4)


def _opt_inputs(seed, grad_scale):
    rng = np.random.default_rng(seed)
    params = {"w": rng.standard_normal((6, 5)).astype(np.float32),
              "stack": (rng.standard_normal((2, 3, 4)).astype(np.float32),),
              "norm": rng.standard_normal((5,)).astype(np.float32)}
    grads = jax.tree.map(lambda a: (rng.standard_normal(a.shape)
                                    * grad_scale).astype(np.float32), params)
    # a state one step in, so both moments and the step are non-trivial
    state = {"mu": jax.tree.map(lambda a: rng.standard_normal(a.shape)
                                .astype(np.float32) * 0.1, params),
             "nu": jax.tree.map(lambda a: rng.random(a.shape)
                                .astype(np.float32) * 0.01, params),
             "step": np.asarray(3, np.int32)}
    return params, grads, state


@pytest.mark.parametrize("grad_scale", [1e-2, 10.0],
                         ids=["clip_not_engaged", "clip_engaged"])
def test_adamw_update_matches_reference(grad_scale):
    params, grads, state = _opt_inputs(1, grad_scale)
    kw = dict(lr=1e-2, warmup_steps=2, total_steps=20, weight_decay=0.1,
              clip_norm=1.0)
    jp, js, jm = jopt.adamw_update(
        jax.tree.map(jnp.asarray, params), jax.tree.map(jnp.asarray, grads),
        jax.tree.map(jnp.asarray, state), jopt.OptConfig(**kw))
    tp = bridge.to_torch(params, "cpu")
    ts = bridge.adamw_to_torch(state, "cpu")
    tp2, ts2, tm = topt.adamw_update(tp, bridge.to_torch(grads, "cpu"), ts,
                                     topt.OptConfig(**kw))
    engaged = float(jm["grad_norm"]) > 1.0
    assert engaged == (grad_scale > 1)
    assert _rel(tm["grad_norm"], jm["grad_norm"]) < F32_TOL
    assert _rel(tm["lr"], jm["lr"]) < F32_TOL
    _trees_close(tp2, jp)
    _trees_close(ts2["mu"], js["mu"])
    _trees_close(ts2["nu"], js["nu"])
    assert ts2["step"].dtype == torch.int32 and int(ts2["step"]) == 4
    # in place: the same tensors were updated
    assert tp2["w"] is tp["w"] and ts2["mu"]["w"] is ts["mu"]["w"]


def test_adamw_moves_toward_gradient():
    params = {"w": torch.ones((4, 4))}
    opt = topt.init_adamw(params)
    assert opt["mu"]["w"].dtype == torch.float32
    assert opt["step"].dtype == torch.int32
    oc = topt.OptConfig(lr=0.1, warmup_steps=0, total_steps=10,
                        weight_decay=0.0)
    p2, opt2, m = topt.adamw_update(params, {"w": torch.ones((4, 4))}, opt,
                                    oc)
    assert bool((p2["w"] < 1.0).all())
    assert int(opt2["step"]) == 1


def test_grad_clipping_reports_the_norm_before_clipping():
    params = {"w": torch.ones((2,))}
    opt = topt.init_adamw(params)
    oc = topt.OptConfig(lr=0.1, warmup_steps=0, total_steps=10,
                        clip_norm=1.0, weight_decay=0.0)
    _, _, m = topt.adamw_update(params, {"w": torch.full((2,), 1e6)}, opt,
                                oc)
    assert float(m["grad_norm"]) > 1e5


def test_adamw_chunks_equal_one_pass(monkeypatch):
    """The in-place chunking of a large leaf changes nothing."""
    params, grads, state = _opt_inputs(2, 1.0)
    oc = topt.OptConfig(lr=1e-2, warmup_steps=1, total_steps=10)
    one = topt.adamw_update(bridge.to_torch(params, "cpu"),
                            bridge.to_torch(grads, "cpu"),
                            bridge.adamw_to_torch(state, "cpu"), oc)
    monkeypatch.setattr(topt, "CHUNK", 7)
    many = topt.adamw_update(bridge.to_torch(params, "cpu"),
                             bridge.to_torch(grads, "cpu"),
                             bridge.adamw_to_torch(state, "cpu"), oc)
    for a, b in zip(tree_leaves(one[:2]), tree_leaves(many[:2])):
        assert torch.equal(a, b)


# --------------------------------------------------------------------------
# loss and train step
# --------------------------------------------------------------------------

def test_cross_entropy_with_masked_labels_matches_reference():
    rng = np.random.default_rng(3)
    logits = rng.standard_normal((2, 5, 16)).astype(np.float32) * 3
    labels = rng.integers(0, 16, (2, 5)).astype(np.int32)
    labels[0, 3:] = -1
    labels[1, 0] = -1
    for zw in (1e-4, 0.0):
        t = tstep.cross_entropy(torch.from_numpy(logits),
                                torch.from_numpy(labels), zw)
        j = jstep.cross_entropy(jnp.asarray(logits), jnp.asarray(labels), zw)
        for a, b in zip(t, j):
            assert _rel(a, b) < F32_TOL
    _, ce = tstep.cross_entropy(torch.zeros((1, 4, 8)),
                                torch.tensor([[1, 2, -1, -1]]), 0.0)
    np.testing.assert_allclose(float(ce), np.log(8), rtol=1e-5)


def test_collect_moe_scalars_matches_reference(model):
    jc, tc, jp = model
    jb, tb = _batch(tc)
    _, _, jinfos = jmodel.apply_model(jp, jb["tokens"], jc)
    _, _, tinfos = tmodel.apply_model(_tparams(jp), tb["tokens"], tc)
    t = tmodel.collect_moe_scalars(tinfos)
    j = jmodel.collect_moe_scalars(jinfos)
    for k in ("aux_loss", "z_loss"):
        assert _rel(t[k], j[k]) < F32_TOL
    assert int(t["dropped"]) == int(j["dropped"])
    none = tmodel.collect_moe_scalars([None, ()])
    assert t["dropped"].dtype == torch.int32
    assert float(none["aux_loss"]) == 0 and int(none["dropped"]) == 0


def test_loss_and_every_gradient_match_reference(model):
    jc, tc, jp = model
    jb, tb = _batch(tc)
    (jl, jm), jg = jax.value_and_grad(jstep.make_loss_fn(jc), has_aux=True)(
        jp, jb)
    tp = _tparams(jp)
    (tl, tm), tg = tstep.value_and_grad(tstep.make_loss_fn(tc), tp, tb)
    assert _rel(tl, jl) < F32_TOL
    for k in ("loss", "ce", "aux", "router_z"):
        assert _rel(tm[k], jm[k]) < F32_TOL, k
    assert int(tm["dropped"]) == int(jm["dropped"])
    _trees_close(tg, jg)
    # every leaf got a gradient, and the caller's leaves are as they were
    assert all(float(g.abs().max()) > 0 for g in tree_leaves(tg))
    assert not any(p.requires_grad for p in tree_leaves(tp))


def test_train_step_matches_reference(model):
    """One whole step against the reference's: metrics and the grad norm
    within 3e-5; the updated params equal the reference's AdamW applied to
    the port's gradients within 3e-5, and the reference's whole step within
    3e-5 plus the gradient's own 3e-5 carried through Adam's first step,
    whose g / (|g| + eps) turns a float32 rounding of a gradient near eps
    into a change of up to lr in its param."""
    jc, tc, jp = model
    jb, tb = _batch(tc, seed=1)
    kw = dict(lr=2e-3, warmup_steps=2, total_steps=10)
    jp2, jo2, jm = jstep.make_train_step(jc, jopt.OptConfig(**kw))(
        jp, jopt.init_adamw(jp), jb)
    tp = _tparams(jp)
    (_, _), tg = tstep.value_and_grad(tstep.make_loss_fn(tc), tp, tb)
    tp2, to2, tm = tstep.make_train_step(tc, topt.OptConfig(**kw))(
        tp, topt.init_adamw(tp), tb)
    assert set(tm) == set(jm)
    for k in ("grad_norm", "lr", "loss", "ce", "aux", "router_z"):
        assert _rel(tm[k], jm[k]) < F32_TOL, k
    assert int(tm["dropped"]) == int(jm["dropped"])
    assert int(to2["step"]) == int(jo2["step"]) == 1
    # the reference's optimizer on the port's gradients
    jg = jax.tree.map(jnp.asarray, tree_map(lambda t: t.numpy(), tg))
    jq, jqo, _ = jopt.adamw_update(jp, jg, jopt.init_adamw(jp),
                                   jopt.OptConfig(**kw))
    _trees_close(tp2, jq)
    _trees_close(to2["mu"], jqo["mu"])
    _trees_close(to2["nu"], jqo["nu"])
    # the reference's whole step, element by element
    lr, eps = float(jm["lr"]), jopt.OptConfig().eps
    ft, fj = bridge.flatten(tp2), bridge.flatten(jax.tree.map(np.asarray,
                                                               jp2))
    fg = bridge.flatten(jax.tree.map(np.asarray, jax.grad(
        lambda p: jstep.make_loss_fn(jc)(p, jb)[0])(jp)))
    for k in ft:
        if not torch.is_tensor(ft[k]):
            continue
        t, j, g = ft[k].numpy(), fj[k], np.abs(fg[k])
        dg = F32_TOL * g.max()
        tol = F32_TOL * np.abs(j).max() + lr * eps * dg / (g + eps) ** 2
        assert (np.abs(t - j) <= tol).all(), k


def test_train_loop_history_matches_reference(model):
    jc, tc, jp = model
    _, _, jh = jtrain.train_loop(jc, 5, 4, 32, lr=1e-3, seed=0, log_every=99)
    _, _, th = ttrain.train_loop(tc, 5, 4, 32, lr=1e-3, seed=0, log_every=99,
                                 device="cpu", params=_tparams(jp))
    np.testing.assert_allclose(th, jh, rtol=1e-4)


def test_loss_decreases_markov():
    """Port twin of ``tests/test_training.py::test_loss_decreases_markov``
    on the smoke Mixtral (the port has no olmo)."""
    _, tc = _cfgs()
    params = tmodel.init_model(tc, seed=0, device="cpu")
    opt = topt.init_adamw(params)
    step = tstep.make_train_step(tc, topt.OptConfig(lr=2e-3, warmup_steps=5,
                                                    total_steps=40))
    losses = []
    for b in batches(MarkovCorpus(vocab=tc.vocab, seed=0), 8, 32, 40):
        params, opt, m = step(params, opt,
                              {k: torch.as_tensor(v) for k, v in b.items()})
        losses.append(float(m["ce"]))
    assert losses[-1] < losses[0] - 0.5


def test_training_on_the_cpu_launches_no_kernel(model):
    _, tc, jp = model
    _, tb = _batch(tc)
    kernels.reset_launch_counts()
    tstep.value_and_grad(tstep.make_loss_fn(tc), _tparams(jp), tb)
    assert kernels.launch_counts() == {k: 0 for k in kernels.LAUNCHES}


def test_train_loop_refuses_cross_attention_sources(model):
    """``train_loop`` trains a VLM (cross-attention layers) against the
    reference's constant cross source, and still refuses a card it does
    not have."""
    _, tc, _ = model
    vlm = tconfigs.make_smoke(tconfigs.get_config("llama_3_2_vision_11b"))
    params, _, hist = ttrain.train_loop(vlm.replace(n_layers=5), 2, 2, 8,
                                        device="cpu")
    assert len(hist) == 2 and all(np.isfinite(hist))
    assert float(params["scan"][4]["mixer"]["gate"].abs().max()) > 0  # cross
    with pytest.raises(RuntimeError, match="cuda"):
        ttrain.train_loop(tc, 1, 1, 8)


def test_param_count_and_training_bytes(model):
    """``training_bytes`` of the params the launcher built is what a step
    allocates beside them: the gradients and AdamW's two moments."""
    _, tc, jp = model
    nbytes = lambda tree: sum(t.numel() * t.element_size()
                              for t in tree_leaves(tree))
    n = sum(t.numel() for t in tree_leaves(_tparams(jp)))
    assert ttrain.training_bytes(_tparams(jp)) == n * (4 + 8)
    bf = tc.replace(dtype="bfloat16", param_dtype="bfloat16")
    built = tmodel.init_model(bf, seed=0, device="cpu")
    assert sum(t.numel() for t in tree_leaves(built)) == n
    _, grads = tstep.value_and_grad(tstep.make_loss_fn(bf), built,
                                    _batch(bf, 1, 8)[1])
    opt = topt.init_adamw(built)
    assert ttrain.training_bytes(built) == (
        nbytes(grads) + nbytes(opt["mu"]) + nbytes(opt["nu"]))


# --------------------------------------------------------------------------
# checkpoints and the launchers
# --------------------------------------------------------------------------

def test_checkpoint_roundtrip(tmp_path):
    tree = {"a": torch.arange(6, dtype=torch.float32).reshape(2, 3),
            "b": {"c": torch.ones((3,), dtype=torch.bfloat16),
                  "d": torch.tensor(3, dtype=torch.int32)},
            "e": (torch.zeros(2), ())}
    p = os.path.join(tmp_path, "x.ckpt")
    save(p, tree)
    assert sorted(os.listdir(tmp_path)) == ["x.ckpt"]
    back = restore(p, tree)
    for l1, l2 in zip(tree_leaves(tree), tree_leaves(back)):
        assert l1.dtype == l2.dtype and torch.equal(l1, l2)
    with pytest.raises(ValueError, match="structure"):
        restore(p, {"a": tree["a"]})


def test_checkpoint_manager_keeps_latest(tmp_path):
    cm = CheckpointManager(str(tmp_path), keep=2)
    assert cm.latest_step() is None and cm.restore_latest() == (None, None)
    for s in (1, 2, 3):
        cm.save(s, {"x": torch.tensor(s)})
    assert cm.latest_step() == 3
    step, tree = cm.restore_latest({"x": torch.tensor(0)})
    assert step == 3 and int(tree["x"]) == 3
    assert len(os.listdir(tmp_path)) == 2


def test_train_launcher_trains_and_checkpoints(tmp_path):
    hist = ttrain.main(["--smoke", "--device", "cpu", "--dtype", "float32",
                        "--steps", "3", "--batch", "2", "--seq", "16",
                        "--ckpt", str(tmp_path)])
    assert len(hist) == 3 and all(np.isfinite(hist))
    step, tree = CheckpointManager(str(tmp_path)).restore_latest()
    assert step == 3 and int(tree["opt"]["step"]) == 3
    assert tree["params"]["embed"]["tok"].dtype == torch.float32


@pytest.mark.parametrize("mode", ["blocking", "pipelined"])
def test_offloaded_launcher_calibrates_through_the_slot_path(mode):
    """The residual vectors of an offloaded serve (calibrated through the
    store's slot pool, experts on the host) equal the full-resident
    launcher's bit for bit, after training."""
    from repro_torch.launch import serve
    args = ["--device", "cpu", "--dtype", "float32", "--layers", "2",
            "--train-steps", "2", "--cache-ratio", "0.25", "--requests", "2",
            "--batch", "2", "--prompt-len", "8", "--max-new", "3"]
    ref, _ = serve.main(args)
    got, done = serve.main(args + ["--offload", mode])
    assert got.store is not None and got.store.mode == mode
    assert got.store.host["gate"].device.type == "cpu"
    assert ref.res_vecs is not None and float(ref.res_vecs.abs().sum()) > 0
    assert torch.equal(got.res_vecs, ref.res_vecs)
    assert len(done) == 2


def test_messages_cite_no_queue_number_that_does_not_exist():
    bad = []
    for p in SRC.rglob("*.py"):
        for i, line in enumerate(p.read_text().splitlines(), 1):
            if re.search(r"module 1|modules 1|MOE_CHUNK_TOKENS item", line):
                bad.append(f"{p.name}:{i}: {line.strip()}")
    assert not bad, bad


# --------------------------------------------------------------------------
# the kernels' autograd Functions, forward routed through the plain version
# --------------------------------------------------------------------------

def _grads(out, inputs, cot):
    outs = out if isinstance(out, tuple) else (out,)
    pairs = [(o, c) for o, c in zip(outs, cot) if c is not None]
    return torch.autograd.grad([o for o, _ in pairs], inputs,
                               [c for _, c in pairs])


@pytest.mark.parametrize("rt", ["topk_softmax", "softmax_topk", "sigmoid"])
def test_gating_function_gradients_equal_plain_autograd(monkeypatch, rt):
    monkeypatch.setattr(gating_ops, "_launch",
                        lambda *a: gating_ops.gating_plain(*a))
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.standard_normal((9, 8)).astype(np.float32))
    x.requires_grad_(True)
    cot = (torch.from_numpy(rng.standard_normal((9, 2)).astype(np.float32)),
           None,
           torch.from_numpy(rng.standard_normal((9, 8)).astype(np.float32)))
    kernels.reset_launch_counts()
    got = gating_ops.GatingFn.apply(x, 2, rt, True)
    assert not got[1].requires_grad
    (g1,) = _grads(got, [x], cot)
    (g2,) = _grads(gating_ops.gating_plain(x, 2, rt, True), [x], cot)
    assert torch.equal(g1, g2)
    assert kernels.LAUNCHES["gating_bwd"] == 1


@pytest.mark.parametrize("form", ["dense", "ragged", "grouped"])
def test_expert_ffn_function_gradients_equal_plain_autograd(monkeypatch,
                                                            form):
    monkeypatch.setattr(ffn_ops, "_launch",
                        lambda *a: ffn_ops.expert_ffn_plain(*a))
    rng = np.random.default_rng(5)
    G, E, C, d, f = 5, 3, 6, 16, 24
    t = lambda *s: torch.from_numpy(
        rng.standard_normal(s).astype(np.float32) * 0.3).requires_grad_()
    xe, wg, wu, wd = t(G if form == "grouped" else E, C, d), t(E, d, f), \
        t(E, d, f), t(E, f, d)
    counts = eids = None
    if form != "dense":
        counts = torch.tensor([6, 0, 2, 4, 1][:xe.shape[0]],
                              dtype=torch.int32)
    if form == "grouped":
        eids = torch.tensor([2, 0, 2, 1, 0], dtype=torch.int32)
    gy = torch.from_numpy(rng.standard_normal(xe.shape).astype(np.float32))
    kernels.reset_launch_counts()
    y = ffn_ops.ExpertFFNFn.apply(xe, wg, wu, wd, counts, eids, "silu")
    g1 = torch.autograd.grad(y, [xe, wg, wu, wd], gy)
    y2 = ffn_ops.expert_ffn_plain(xe, wg, wu, wd, counts, eids, "silu")
    g2 = torch.autograd.grad(y2, [xe, wg, wu, wd], gy)
    for a, b in zip(g1, g2):
        assert torch.equal(a, b)
    assert kernels.LAUNCHES["expert_ffn_bwd"] == 1
    # the reference's backward (K5): jax.vjp of its einsum oracle
    jc = None if counts is None else jnp.asarray(counts.numpy())
    je = None if eids is None else jnp.asarray(eids.numpy())
    _, vjp = jax.vjp(lambda *a: jffn_oracle(*a, jc, je, "silu"),
                     *(jnp.asarray(a.detach().numpy())
                       for a in (xe, wg, wu, wd)))
    for a, b in zip(g1, vjp(jnp.asarray(gy.numpy()))):
        assert _rel(a, b) < F32_TOL
    # integer inputs take no gradient
    ctx = type("Ctx", (), {})()
    ctx.saved_tensors = (xe.detach(), wg.detach(), wu.detach(), wd.detach(),
                         counts, eids)
    ctx.needs_input_grad = (True, False, True, False, False, False, False)
    ctx.act = "silu"
    out = ffn_ops.ExpertFFNFn.backward(ctx, gy)
    assert out[1] is None and out[3] is None and out[4:] == (None,) * 3


@pytest.mark.parametrize("causal,window,softcap", [(True, 0, 0.0),
                                                   (True, 3, 20.0),
                                                   (False, 0, 0.0)])
def test_flash_attention_function_gradients_equal_plain_autograd(
        monkeypatch, causal, window, softcap):
    monkeypatch.setattr(attn_ops, "_launch", lambda q, k, v, c, w, s, sc:
                        attn_ops.flash_attention_plain(
                            q, k, v, causal=c, window=w, softcap=s, scale=sc))
    rng = np.random.default_rng(6)
    t = lambda *s: torch.from_numpy(
        rng.standard_normal(s).astype(np.float32)).requires_grad_()
    q, k, v = t(2, 5, 4, 16), t(2, 7, 2, 16), t(2, 7, 2, 16)
    go = torch.from_numpy(rng.standard_normal((2, 5, 4, 16))
                          .astype(np.float32))
    kw = dict(causal=causal, window=window, softcap=softcap, scale=0.25)
    kernels.reset_launch_counts()
    o = attn_ops.FlashAttentionFn.apply(q, k, v, causal, window, softcap,
                                        0.25)
    g1 = torch.autograd.grad(o, [q, k, v], go)
    g2 = torch.autograd.grad(attn_ops.flash_attention_plain(q, k, v, **kw),
                             [q, k, v], go)
    for a, b in zip(g1, g2):
        assert torch.equal(a, b)
    assert kernels.LAUNCHES["flash_attention_bwd"] == 1


def test_wrappers_take_the_function_only_when_a_gradient_is_needed(
        monkeypatch):
    """The dispatch rule on a stand-in device: with grad enabled and an
    input that requires grad the Function runs, otherwise the launch."""
    seen = []
    monkeypatch.setattr(gating_ops.GatingFn, "apply",
                        staticmethod(lambda *a: seen.append("fn")))
    monkeypatch.setattr(gating_ops, "_launch",
                        lambda *a: seen.append("launch"))

    class FakeCuda(torch.Tensor):
        @property
        def device(self):
            return torch.device("cuda", 0)

    x = torch.zeros((4, 8)).as_subclass(FakeCuda)
    gating_ops.gating(x, 2)
    x.requires_grad_(True)
    gating_ops.gating(x, 2)
    with torch.no_grad():
        gating_ops.gating(x, 2)
    assert seen == ["launch", "fn", "launch"]


def test_launch_hooks_call_their_kernel_once_and_count_it(monkeypatch):
    """Each ``_launch`` hook (the Functions' forward) passes its tensors to
    its C entry point with the argument count of ``build._SIGNATURES`` and
    counts one launch: run here on CPU tensors against a stand-in library
    (the kernels themselves run on the card only)."""
    from repro_torch.kernels import build
    calls = []

    class Lib:
        def __getattr__(self, fn):
            def launch(*args):
                assert len(args) == len(build._SIGNATURES[fn]), fn
                calls.append(fn)
                return 0
            return launch

    stream = type("S", (), {"cuda_stream": 0})()
    monkeypatch.setattr(torch.cuda, "current_stream", lambda *a: stream)
    for mod in (gating_ops, ffn_ops, attn_ops):
        monkeypatch.setattr(mod, "library", lambda: Lib())
    kernels.reset_launch_counts()
    g, i, p = gating_ops._launch(torch.zeros((5, 8)), 2, "topk_softmax", True)
    assert g.shape == (5, 2) and i.dtype == torch.int32 and p.shape == (5, 8)
    y = ffn_ops._launch(torch.zeros((4, 3, 64)), torch.zeros((4, 64, 128)),
                        torch.zeros((4, 64, 128)), torch.zeros((4, 128, 64)),
                        torch.ones(4, dtype=torch.int32), None, "silu")
    assert y.shape == (4, 3, 64)
    o = attn_ops._launch(torch.zeros((1, 4, 4, 16)), torch.zeros((1, 4, 2, 16)),
                         torch.zeros((1, 4, 2, 16)), True, 0, 0.0, 0.25)
    assert o.shape == (1, 4, 4, 16)
    assert calls == ["gating_launch", "expert_ffn_launch",
                     "flash_attention_launch"]
    counts = kernels.launch_counts()
    assert {k for k, v in counts.items() if v} == {
        "gating", "expert_ffn_ragged", "flash_attention"}
    assert all(v in (0, 1) for v in counts.values())
