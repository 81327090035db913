"""Rank bodies and the fake-group run of the port's layout tests
(``test_torch_layout.py``).

``launch/mesh.py::run_ranks`` spawns processes that import the function
they run, so the bodies live here; this module imports torch and
``repro_torch`` only (no JAX).  ``layout_rank`` runs smoke Mixtral's
prefill, greedy decode and one training step laid out on a (2, 2) mesh
of gloo ranks, under ``tp`` and ``fsdp``, the same steps of
DeepSeek-V2-Lite's (MLA) and Jamba-1.5-Large's (Mamba-2) smoke models
under ``tp``, and Qwen3-30B-A3B's smoke prefill (16 experts, so the
experts lie over 'model' and the EP exchange runs); each step's
collectives are recorded.  Run as a script
(``python _torch_layout_ranks.py``) it runs the same Mixtral steps on
``meta`` as rank 0 of a fake group of 4, then smoke configs laid out on
the production mesh, and prints what it recorded as JSON.
"""
import dataclasses
import json
import sys

import numpy as np
import torch

from repro_torch.configs import ARCHS, get_config, make_smoke
from repro_torch.launch import layout as lay
from repro_torch.launch import sharding as shd
from repro_torch.launch.collectives import CollectiveCount
from repro_torch.tree import tree_map

B, S, N_DEC = 4, 16, 4
WMODES = ("tp", "fsdp")
# the laid-out MLA (DeepSeek-V2-Lite) and Mamba-2 (Jamba) layers, under tp
OTHERS = ("deepseek_v2_lite_16b", "jamba_1_5_large_398b")


def mixtral():
    return make_smoke(get_config("mixtral_8x7b"))


def qwen3_ep():
    """Qwen3-30B-A3B's smoke config with 16 experts: ``param_pspecs``
    lays the expert stacks over 'model' from 16 on."""
    cfg = make_smoke(get_config("qwen3_30b_a3b"))
    return cfg.replace(moe=dataclasses.replace(cfg.moe, n_routed=16))


def wide(cfg):
    """A smoke config with 8 query and KV heads and 512-wide FFNs, so that
    'model' = 8 of the production mesh divides its heads and leaves K2 an
    f slice of 64 (Mamba-2's smoke heads, 16, already divide)."""
    kw = dict(d_ff=512)
    if cfg.attn is not None:
        kw["attn"] = dataclasses.replace(cfg.attn, n_heads=8, n_kv_heads=8,
                                         head_dim=32)
    if cfg.moe is not None:
        kw["moe"] = dataclasses.replace(cfg.moe, d_expert=512)
    return cfg.replace(**kw)


QWEN_S = 64     # (B/2) x (S/2) = 64 tokens a rank: the EP exchange runs


def tokens(cfg, seed=0, seq=S):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (B, seq)).astype(np.int32)
    return toks, np.roll(toks, -1, axis=1)


def _full(t):
    if t is None or t.is_meta:
        return None
    return (t.full_tensor() if lay.is_dtensor(t) else t).detach().numpy()


def serve_state(cfg, caches, first, meta, b=B, s=S):
    from repro_torch.launch.shapes import meta_serve_state
    from repro_torch.serving.steps import (default_dali_config,
                                           init_serve_state, resolve_policy)
    dcfg = default_dali_config(cfg) if cfg.moe is not None else None
    if meta:
        state, _ = meta_serve_state(cfg, b, s + N_DEC,
                                    resolve_policy(None, cfg, dcfg))
    else:
        state = init_serve_state(cfg, b, s + N_DEC, dali_cfg=dcfg,
                                 device="cpu")
    state.update(caches=caches, tokens=first,
                 pos=torch.full((), s, dtype=torch.int32,
                                device="meta" if meta else "cpu"))
    return state


def bf16(cfg):
    """``cfg`` in bfloat16: on ``meta`` the kernels take what the card's
    take."""
    return cfg.replace(dtype="bfloat16", param_dtype="bfloat16")


def run_steps(cfg, params, toks, lbls, mesh, wmode, src=None, train=True,
              forward=True, keep_caches=False):
    """Laid out on ``mesh``: the forward (prefill_32k's map), the prefill
    and ``N_DEC`` greedy decode steps (decode_32k's), one AdamW step
    (train_4k's), whose settled gradients are returned too.  ``params`` /
    ``toks`` / ``lbls`` are full tensors (or ``meta``); ``src`` a cross source (B, T, d) for the forward, the
    prefill and the training step, whose caches then hold T cross
    positions; ``train`` / ``forward`` False leave those steps out;
    ``keep_caches`` adds the caches the prefill wrote, gathered.  Returns
    the gathered results (None on meta) and each step's collectives (kind,
    elements, group size, axes)."""
    from repro_torch.models.model import (apply_model, init_caches,
                                          meta_caches)
    from repro_torch.serving.steps import (default_dali_config,
                                           make_decode_step,
                                           make_prefill_step)
    from repro_torch.training.optimizer import (OptConfig, adamw_update,
                                                init_adamw)
    from repro_torch.training.train_step import make_loss_fn, value_and_grad
    meta = toks.is_meta
    b, s = toks.shape
    n_cross = None if src is None else src.shape[1]
    out, sig = {}, {}
    lm = lambda shape: shd.logical_map_for(cfg, shape, mesh)
    laid_src = lambda: None if src is None else lay.distribute_batch(src,
                                                                     mesh)
    with shd.rules(mesh, lm("prefill_32k"), wmode), torch.no_grad():
        p = lay.distribute_params(params, cfg, mesh, wmode)
        t = lay.distribute_batch(toks, mesh)
        if forward:
            with CollectiveCount(mesh) as cc:
                logits, _, _ = apply_model(p, t, cfg, cross_src=laid_src())
            out["logits"] = _full(logits)
            sig["forward"] = cc.signature("elements")
    dcfg = default_dali_config(cfg) if cfg.moe is not None else None
    prefill = make_prefill_step(cfg)
    decode = make_decode_step(cfg, dcfg)
    with shd.rules(mesh, lm("decode_32k"), wmode), torch.no_grad():
        caches = lay.distribute_caches(
            meta_caches(cfg, b, s + N_DEC, dtype=cfg.dtype, n_cross=n_cross)
            if meta else init_caches(cfg, b, s + N_DEC, device="cpu",
                                     dtype=cfg.dtype, n_cross=n_cross),
            cfg, "decode_32k", mesh)
        with CollectiveCount(mesh) as cc:
            first, caches = prefill(p, t, caches, cross_src=laid_src())
        sig["prefill"] = cc.signature("elements")
        if keep_caches and not meta:
            out["caches"] = tree_map(lambda a: a.numpy(), lay.gather(caches))
        state = serve_state(cfg, caches, first, meta, b, s)
        toks_out = [first]
        with CollectiveCount(mesh) as cc:
            for _ in range(N_DEC):
                state, lg, _ = decode(p, state)
                toks_out.append(state["tokens"])
        out["tokens"] = [_full(t) for t in toks_out]
        out["decode_logits"] = _full(lg)
        sig["decode"] = cc.signature("elements")
    if not train:
        return out, sig
    loss_fn = make_loss_fn(cfg)
    with shd.rules(mesh, lm("train_4k"), wmode):
        p = lay.distribute_params(params, cfg, mesh, wmode)
        opt = lay.distribute_opt_state(init_adamw(params), cfg, mesh, wmode)
        batch = {"tokens": toks, "labels": lbls}
        if src is not None:
            batch["cross_src"] = src
        batch = lay.distribute_batch(batch, mesh)
        with CollectiveCount(mesh) as cc:
            # make_train_step's two halves, so that the settled gradients
            # can be read
            (_, metrics), grads = value_and_grad(loss_fn, p, batch)
            p, opt, om = adamw_update(p, grads, opt, OptConfig())
        sig["train"] = cc.signature("elements")
        for k in ("loss", "aux"):
            out[k] = _full(metrics[k])
        out["grad_norm"] = _full(om["grad_norm"])
        for k, tree in (("params", p), ("grads", grads)):
            out[k] = None if meta else tree_map(lambda a: a.numpy(),
                                                lay.gather(tree))
    return out, sig


def layout_rank(rank, world, params_np, qwen_np):
    """Mixtral under both weight modes, then Qwen3's EP prefill, on a
    (2, 2) mesh; rank 0's results and every rank's collectives."""
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.model import apply_model, init_model
    mesh = make_mesh(2, 2)
    cfg = mixtral()
    params = tree_map(torch.from_numpy, params_np)
    toks, lbls = (torch.from_numpy(a) for a in tokens(cfg))
    res = {}
    for wmode in WMODES:
        out, sig = run_steps(cfg, params, toks, lbls, mesh, wmode)
        res[wmode] = {"out": out if rank == 0 else None, "sig": sig}
    for arch in OTHERS:
        c = make_smoke(get_config(arch))
        out, _ = run_steps(c, init_model(c, seed=0, device="cpu"),
                           *(torch.from_numpy(a) for a in tokens(c)), mesh,
                           "tp")
        res[arch] = out if rank == 0 else None
    qcfg = qwen3_ep()
    qp = tree_map(torch.from_numpy, qwen_np)
    qt = torch.from_numpy(tokens(qcfg, seed=1, seq=QWEN_S)[0])
    with shd.rules(mesh, shd.logical_map_for(qcfg, "prefill_32k", mesh)), \
            torch.no_grad():
        logits, _, infos = apply_model(
            lay.distribute_params(qp, qcfg, mesh),
            lay.distribute_batch(qt, mesh), qcfg, trace=True)
        res["qwen3"] = {"logits": _full(logits),
                        "ep_cx": infos[-1][0]["ep_cx"].full_tensor().tolist()}
    return res


def meta_run():
    """The Mixtral steps on ``meta`` as rank 0 of a fake group of 4, and
    smoke configs laid out on the production mesh."""
    from repro_torch.launch.dryrun import fake_world, measure
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.launch.shapes import (ShapeSpec, build_decode,
                                           build_prefill, build_train)
    from repro_torch.models.model import meta_model
    from torch.distributed.device_mesh import init_device_mesh
    out = {"sig": {}, "pod": {}}
    cfg = bf16(mixtral())
    with fake_world(4):
        mesh = init_device_mesh("cpu", (2, 2),
                                mesh_dim_names=("data", "model"))
        meta = lambda shape, dt: torch.empty(shape, dtype=dt, device="meta")
        for wmode in WMODES:
            _, sig = run_steps(cfg, meta_model(cfg),
                               meta((B, S), torch.int32),
                               meta((B, S), torch.int32), mesh, wmode)
            out["sig"][wmode] = sig
    builders = {"prefill_32k": build_prefill, "decode_32k": build_decode,
                "train_4k": build_train}
    kinds = {"prefill_32k": "prefill", "decode_32k": "decode",
             "train_4k": "train"}
    with fake_world(256):
        mesh = make_production_mesh()
        for arch in ARCHS:
            c = bf16(wide(make_smoke(get_config(arch))))
            for shape, build in builders.items():
                spec = ShapeSpec(shape, kinds[shape], 32, 64)
                _, fn, args = build(c, spec, mesh, "tp")
                with shd.rules(mesh, shd.logical_map_for(c, shape, mesh),
                               "tp"):
                    rec = measure(fn, args, train=shape == "train_4k",
                                  mesh=mesh)
                out["pod"][f"{arch} {shape}"] = {
                    "collectives": rec["collectives"],
                    "peak_live_bytes": rec["peak_live_bytes"],
                    "d_model": c.d_model, "n_layers": c.n_layers,
                    "itemsize": torch.empty((), dtype=getattr(
                        torch, c.dtype)).element_size()}
    return out


if __name__ == "__main__":
    json.dump(meta_run(), sys.stdout)
