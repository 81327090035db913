"""Why chip_smoke.py's phase 14 holds some bfloat16 gradient leaves to a
float32 floor rather than to 3e-2 of another bfloat16 step: on the CPU
the JAX package's bfloat16 training step and the port's part by more than
3e-2 on many leaves of Jamba, Seamless and the VLM (sums of cancelling
terms: a cross gate, a conv filter, ``A_log``), and the JAX package's own
bfloat16 step lies that far from the float32 step on them, while the two
packages' float32 steps agree within 3e-5 (tests/test_torch_archs_train.py).

Both bfloat16 steps take the JAX package's routing, and the float32 truth
is the port's float32 step on the same parameters and routing.  The test
prints, per arch, how many leaves part and how far.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
import repro.models.model as jmodel
import repro.training.train_step as jstep
import repro_torch.configs as tconfigs
import repro_torch.models.moe as tmoe
import repro_torch.training.train_step as tstep
from repro_torch import bridge
from repro_torch.kernels.gating.ops import _gates, _probs
from test_torch_archs import _one_thread, _rel, open_gates  # noqa: F401

BF16_TOL = 3e-2


def _cfgs(arch, dtype):
    kw = dict(dtype=dtype, param_dtype=dtype)
    return (dataclasses.replace(
                jconfigs.make_smoke(jconfigs.get_config(arch)), **kw),
            dataclasses.replace(
                tconfigs.make_smoke(tconfigs.get_config(arch)), **kw))


def _flat(tree):
    return {k: (v.float().numpy() if torch.is_tensor(v)
                else np.asarray(v, np.float32))
            for k, v in bridge.flatten(tree).items()}


def _jax_routing(jc, jp, b):
    """The JAX model's top-k ids per MoE layer, in the port's call order
    (prefix layers, then the period's positions super-block by
    super-block)."""
    _, _, infos = jmodel.apply_model(
        jp, jnp.asarray(b["tokens"]), jc, trace=True,
        cross_src=jnp.asarray(b["cross_src"]) if "cross_src" in b else None)
    ids = [np.asarray(i["topk_idx"]) for i in infos[:-1] if i is not None]
    per = [np.asarray(i["topk_idx"]) for i in infos[-1] if i is not None]
    for s in range(per[0].shape[0] if per else 0):
        ids += [p[s] for p in per]
    return ids


def _port_grads(tc, tp, b, ids):
    n = [0]

    def replay(logits, top_k, router_type, renormalize):
        idx = torch.from_numpy(ids[n[0] % len(ids)].astype(np.int64))
        n[0] += 1
        x = logits.float()
        probs = _probs(x, router_type)
        return (_gates(x, probs, idx, router_type, renormalize), idx,
                probs)

    real = tmoe.gating
    tmoe.gating = replay if ids else real
    try:
        (loss, _), g = tstep.value_and_grad(
            tstep.make_loss_fn(tc), tp,
            {k: torch.from_numpy(v) for k, v in b.items()})
    finally:
        tmoe.gating = real
    return float(loss), _flat(g)


@pytest.mark.parametrize("arch", ["jamba_1_5_large_398b",
                                  "seamless_m4t_large_v2",
                                  "llama_3_2_vision_11b"])
def test_two_bfloat16_steps_part_where_bfloat16_cannot_resolve(arch):
    jc, tc = _cfgs(arch, "bfloat16")
    jp = open_gates(jmodel.init_model(jax.random.PRNGKey(0), jc))
    rng = np.random.default_rng(5)
    toks = rng.integers(0, jc.vocab, (2, 65)).astype(np.int32)
    b = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if jc.family in ("vlm", "audio"):
        T = jc.n_vision_tokens if jc.family == "vlm" else 16
        b["cross_src"] = (rng.standard_normal((2, T, jc.d_model))
                          * 0.1).astype(np.float32)
    jpj = jax.tree.map(jnp.asarray, jp)
    ids = _jax_routing(jc, jpj, b) if jc.moe is not None else []
    (jl, _), jg = jax.value_and_grad(jstep.make_loss_fn(jc), has_aux=True)(
        jpj, {k: jnp.asarray(v) for k, v in b.items()})
    jg = _flat(jax.tree.map(lambda a: np.asarray(a.astype(jnp.float32)),
                            jg))
    tl, tg = _port_grads(tc, bridge.to_torch(jp, "cpu"), b, ids)
    up = jax.tree.map(lambda a: np.asarray(jnp.asarray(a, jnp.float32)), jp)
    _, f32 = _port_grads(_cfgs(arch, "float32")[1],
                         bridge.to_torch(up, "cpu"), b, ids)
    assert abs(tl - float(jl)) <= BF16_TOL * abs(float(jl))
    part = {k: _rel(tg[k], jg[k]) for k in jg}
    floor = {k: _rel(jg[k], f32[k]) for k in jg}
    own = {k: _rel(tg[k], f32[k]) for k in jg}
    apart = [k for k in jg if part[k] > BF16_TOL]
    print(f"{arch}: {len(apart)} of {len(jg)} leaves part by more than "
          f"{BF16_TOL} between the two packages' bfloat16 steps (max "
          f"{max(part.values()):.3e}); the JAX package's bfloat16 step lies "
          f"more than {BF16_TOL} from float32 on "
          f"{sum(v > BF16_TOL for v in floor.values())} (max "
          f"{max(floor.values()):.3e}), the port's on "
          f"{sum(v > BF16_TOL for v in own.values())} (max "
          f"{max(own.values()):.3e})")
    # the reference's own bfloat16 step cannot resolve some leaf to 3e-2,
    # and where the two packages part most, both lie far from float32
    assert max(floor.values()) > BF16_TOL
    worst = max(part, key=part.get)
    assert max(floor[worst], own[worst]) > BF16_TOL / 2, worst
