"""One training step of the port against the JAX package (loss, its
parts and every gradient leaf) for the six archs that
tests/test_archs_smoke.py trains and the two cross-attention archs, which
train against a cross source; the parameters and helpers are those of
tests/test_torch_archs.py.

Tolerance: 3e-5 relative to max |ref| (each gradient leaf relative to its
own max |g|; tests/test_kernels.py:17).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.training.train_step as jstep
import repro_torch.training.train_step as tstep
from repro_torch import bridge
from repro_torch.tree import tree_leaves
from test_torch_archs import (S, _close, _one_thread, _tokens,  # noqa: F401
                              carried, cross_src)

# the six archs the reference trains in tests/test_archs_smoke.py, and the
# two cross-attention archs with their sources
TRAIN_ARCHS = ("olmo_1b", "mixtral_8x7b", "deepseek_v2_lite_16b",
               "mamba2_780m", "jamba_1_5_large_398b", "gemma2_9b",
               "llama_3_2_vision_11b", "seamless_m4t_large_v2")


@pytest.mark.parametrize("arch", TRAIN_ARCHS)
def test_one_training_step_matches_reference(arch):
    """Loss, its parts and every gradient leaf of one training step; the
    VLM and audio archs train against a cross source."""
    jc, tc, jp, tp = carried(arch)
    toks = _tokens(jc, S + 1, seed=2)
    b = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    src = cross_src(jc, seed=4)
    if src is not None:
        b["cross_src"] = src
    (jl, jm), jg = jax.value_and_grad(jstep.make_loss_fn(jc), has_aux=True)(
        jp, {k: jnp.asarray(v) for k, v in b.items()})
    (tl, tm), tg = tstep.value_and_grad(
        tstep.make_loss_fn(tc), tp, {k: torch.from_numpy(v)
                                     for k, v in b.items()})
    _close(tl, jl, "loss")
    for k in ("ce", "aux", "router_z"):
        if float(jm[k]):
            _close(tm[k], jm[k], k)
        else:
            assert float(tm[k]) == 0.0, k
    assert int(tm["dropped"]) == int(jm["dropped"])
    ft, fj = bridge.flatten(tg), bridge.flatten(jax.tree.map(np.asarray, jg))
    assert ft.keys() == fj.keys()
    for k in ft:
        _close(ft[k], fj[k], k)
    assert all(float(g.abs().max()) > 0 for g in tree_leaves(tg))
