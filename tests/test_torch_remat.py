"""``cfg.remat``: activation checkpointing of each super-block of the
scanned stack (``repro_torch/models/model.py``, the reference's
``jax.checkpoint`` of the scan body, ``repro/models/model.py:187-188``).

At float32 smoke size, for Mixtral, Jamba (Mamba-2 + MoE) and Seamless
(the encoder and cross attention): every gradient leaf of one training
step with ``remat=True`` equals the port's own without remat, and the JAX
package's with ``remat=True``; the loss and its parts too.  Tolerance:
3e-5 relative to max |ref| (tests/test_kernels.py:17).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.training.train_step as jstep
import repro_torch.models.model as tmodel
import repro_torch.training.train_step as tstep
from repro_torch import bridge
from test_torch_archs import (S, _close, _one_thread, _tokens,  # noqa: F401
                              carried, cross_src)

REMAT_ARCHS = ("mixtral_8x7b", "jamba_1_5_large_398b",
               "seamless_m4t_large_v2")


def _batch(jc):
    toks = _tokens(jc, S + 1, seed=2)
    b = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    src = cross_src(jc, seed=4)
    if src is not None:
        b["cross_src"] = src
    return b


def _port_step(tc, tp, b):
    return tstep.value_and_grad(tstep.make_loss_fn(tc), tp,
                                {k: torch.from_numpy(v) for k, v in b.items()})


def _compare(got, want):
    (gl, gm), gg = got
    (wl, wm), wg = want
    assert int(gm["dropped"]) == int(wm["dropped"])
    _close(gl, wl, "loss")
    for k in ("ce", "aux", "router_z"):
        _close(gm[k], wm[k], k)
    fg, fw = bridge.flatten(gg), bridge.flatten(wg)
    assert fg.keys() == fw.keys()
    for k in fg:
        _close(fg[k], fw[k], k)


@pytest.mark.parametrize("arch", REMAT_ARCHS)
def test_remat_gradients_equal_no_remat(arch, monkeypatch):
    """remat=True changes no leaf, and the backward really recomputes:
    every scanned block runs twice per step (once in the forward, once in
    the backward's recompute), the prefix blocks once."""
    jc, tc, jp, tp = carried(arch)
    b = _batch(jc)
    calls = []
    real = tmodel.apply_block

    def counted(p, x, cfg, kinds, **kw):
        calls.append(kinds)
        return real(p, x, cfg, kinds, **kw)

    monkeypatch.setattr(tmodel, "apply_block", counted)
    plain = _port_step(tc, tp, b)
    n_plain = len(calls)
    del calls[:]
    remat = _port_step(tc.replace(remat=True), tp, b)
    prefix, period, n_super = tmodel.scan_pattern(tc)
    n_enc = tc.encoder.n_layers if tc.encoder is not None else 0
    assert n_plain == len(prefix) + n_super * len(period) + n_enc
    assert len(calls) == n_plain + n_super * len(period)
    _compare(remat, plain)


@pytest.mark.parametrize("arch", REMAT_ARCHS)
def test_remat_gradients_match_reference_remat(arch):
    """The port's remat step against the JAX package's remat step."""
    jc, tc, jp, tp = carried(arch)
    jc, tc = jc.replace(remat=True), tc.replace(remat=True)
    b = _batch(jc)
    (jl, jm), jg = jax.value_and_grad(jstep.make_loss_fn(jc), has_aux=True)(
        jp, {k: jnp.asarray(v) for k, v in b.items()})
    (tl, tm), tg = _port_step(tc, tp, b)
    _close(tl, jl, "loss")
    for k in ("ce", "aux", "router_z"):
        _close(tm[k], jm[k], k)
    ft, fj = bridge.flatten(tg), bridge.flatten(jax.tree.map(np.asarray, jg))
    assert ft.keys() == fj.keys()
    for k in ft:
        _close(ft[k], fj[k], k)


def test_remat_is_off_without_gradients(monkeypatch):
    """A forward without autograd (serving) never checkpoints: each block
    runs once and the logits are the same bits; remat only changes what a
    training step keeps for its backward."""
    jc, tc, jp, tp = carried("mixtral_8x7b")
    toks = torch.from_numpy(_tokens(jc, S))
    calls = []
    monkeypatch.setattr(tmodel, "checkpoint", lambda *a, **k: calls.append(1))
    with torch.no_grad():
        a = tmodel.apply_model(tp, toks, tc)[0]
        b = tmodel.apply_model(tp, toks, tc.replace(remat=True))[0]
    assert torch.equal(a, b) and not calls
