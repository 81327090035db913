"""Rank bodies and the fake-group run of ``test_torch_layout_archs.py``:
the seven architectures whose layers ``test_torch_layout.py`` does not
run, laid out on a (2, 2) mesh of gloo ranks.

Each case (``CASES``) is a smoke config, a weight mode, a prompt length,
whether it takes a cross source and whether it runs a training step:

* Llama-3.2-Vision (a cross layer with its gated FFN, a 16-token vision
  source) and SeamlessM4T (the encoder and ``self_cross`` decoder layers
  over 16 frames), under tp;
* Gemma-2 at a 37-token prompt past its 16-wide window, whose wrap lands
  inside the first 'model' rank's block of the rolling cache, and at 40,
  whose wrap lands on the boundary of the two blocks (prefill and decode
  only);
* Llama-4 Maverick with 16 experts (the experts over 'model' and the
  expert-parallel exchange at 64 tokens a rank) under fsdp: its shared
  expert gathers its d_model dim over 'data';
* OLMo, Qwen3-32B and Mamba-2 under tp (forward, prefill, decode).

``archs_rank`` runs every case on its rank and returns rank 0's results
and every rank's collectives; run as a script, this module runs the same
steps on ``meta`` as rank 0 of a fake group of 4 and prints their
collectives as JSON, beside the port's count of the collectives of one
fsdp decode step of smoke Jamba with 16 experts on a (2, 4) mesh (the
reference's own count is ``_torch_f5_reference.py``'s).  It imports no
JAX: every rank imports the function it runs.
"""
import dataclasses
import json
import sys

import numpy as np
import torch

import _torch_layout_ranks as R
from repro_torch.configs import get_config, make_smoke

B = 4
# case -> (arch, weight mode, prompt length, cross source, training step)
CASES = {
    "vision": ("llama_3_2_vision_11b", "tp", 16, True, True),
    "seamless": ("seamless_m4t_large_v2", "tp", 16, True, True),
    "gemma2": ("gemma2_9b", "tp", 37, False, True),
    "gemma2_edge": ("gemma2_9b", "tp", 40, False, False),
    "llama4": ("llama4_maverick_400b_a17b", "fsdp", 64, False, True),
    "olmo": ("olmo_1b", "tp", 16, False, False),
    "qwen3_32b": ("qwen3_32b", "tp", 16, False, False),
    "mamba2": ("mamba2_780m", "tp", 16, False, False),
}
N_CROSS = 16


def with_experts(cfg, n: int = 16):
    """``cfg`` with ``n`` routed experts: ``param_pspecs`` lays the stacks
    over 'model' from 16 on (``make_smoke`` cuts them to 4)."""
    return cfg.replace(moe=dataclasses.replace(cfg.moe, n_routed=n))


def config(case):
    arch = CASES[case][0]
    cfg = make_smoke(get_config(arch))
    return with_experts(cfg) if cfg.moe is not None else cfg


def inputs(case, cfg):
    """Tokens, labels and the cross source (or None) of a case, from
    numpy seeds."""
    _, _, s, cross, _ = CASES[case]
    rng = np.random.default_rng(1)
    toks = rng.integers(0, cfg.vocab, (B, s)).astype(np.int32)
    src = None
    if cross:
        src = (np.random.default_rng(3).standard_normal(
            (B, N_CROSS, cfg.d_model)) * 0.1).astype(np.float32)
    return toks, np.roll(toks, -1, axis=1), src


def run_case(case, cfg, params, mesh, meta=False):
    _, wmode, s, _, train = CASES[case]
    toks, lbls, src = inputs(case, cfg)
    if meta:
        m = lambda a, dt: torch.empty(a.shape, dtype=dt, device="meta")
        args = (m(toks, torch.int32), m(lbls, torch.int32),
                None if src is None else m(src, getattr(torch, cfg.dtype)))
    else:
        args = tuple(None if a is None else torch.from_numpy(a)
                     for a in (toks, lbls, src))
    return R.run_steps(cfg, params, args[0], args[1], mesh, wmode,
                       src=args[2], train=train,
                       forward=case != "gemma2_edge",
                       keep_caches=case.startswith("gemma2"))


def archs_rank(rank, world, params_np):
    """Every case on a (2, 2) mesh from the given params (numpy trees):
    rank 0's results, every rank's collectives."""
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.tree import tree_map
    mesh = make_mesh(2, 2)
    res = {}
    for case in CASES:
        params = tree_map(torch.from_numpy, params_np[CASES[case][0]])
        out, sig = run_case(case, config(case), params, mesh)
        res[case] = {"out": out if rank == 0 else None, "sig": sig}
    return res


def jamba_fsdp_decode_collectives():
    """The port's collectives of one decode step of smoke Jamba with 16
    experts (bfloat16) under fsdp on a (2, 4) mesh, decode_32k's map, B =
    4 over a 64-slot cache, as rank 0 of a fake group of 8: per-device
    bytes by kind and mesh axis, and the number of all-gathers over 'data'
    whose result is one rank's expert stack (its 'model' slots, whole)."""
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.launch import layout as lay
    from repro_torch.launch import sharding as shd
    from repro_torch.launch.collectives import CollectiveCount
    from repro_torch.launch.dryrun import fake_world
    from repro_torch.launch.shapes import meta_serve_state
    from repro_torch.models.model import meta_model
    from repro_torch.models.moe import expert_capacity
    from repro_torch.serving.steps import (default_dali_config,
                                           make_decode_step, resolve_policy)
    cfg = R.bf16(with_experts(make_smoke(get_config("jamba_1_5_large_398b"))))
    with fake_world(8):
        mesh = init_device_mesh("cpu", (2, 4),
                                mesh_dim_names=("data", "model"))
        policy = resolve_policy(None, cfg, default_dali_config(cfg))
        state, res = meta_serve_state(cfg, 4, 64, policy)
        decode = make_decode_step(cfg, policy=policy,
                                  moe_capacity=expert_capacity(cfg.moe, 4))
        with shd.rules(mesh, shd.logical_map_for(cfg, "decode_32k", mesh),
                       "fsdp"), torch.no_grad():
            p = lay.distribute_params(meta_model(cfg), cfg, mesh, "fsdp")
            state = dict(state, tokens=lay.distribute_batch(state["tokens"],
                                                            mesh),
                         caches=lay.distribute_caches(
                             state["caches"], cfg, "decode_32k", mesh))
            with CollectiveCount(mesh) as cc:
                decode(p, state, res)
    m = cfg.moe
    stack = m.n_routed // 4 * cfg.d_model * (m.d_expert or cfg.d_ff)
    out = {"stack_gathers": 0}
    for e in cc.events:
        key = f"{e['kind']}|{','.join(e['axes'])}"
        out[key] = out.get(key, 0.0) + e["bytes"]
        if key == "all-gather|data" and e["elements"] == stack:
            out["stack_gathers"] += 1
    return out


def meta_run():
    """Every case on ``meta`` (bfloat16) as rank 0 of a fake group of 4."""
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.launch.dryrun import fake_world
    from repro_torch.models.model import meta_model
    sig = {}
    with fake_world(4):
        mesh = init_device_mesh("cpu", (2, 2),
                                mesh_dim_names=("data", "model"))
        for case in CASES:
            cfg = R.bf16(config(case))
            sig[case] = run_case(case, cfg, meta_model(cfg), mesh,
                                 meta=True)[1]
    return {"sig": sig, "f5": jamba_fsdp_decode_collectives()}


if __name__ == "__main__":
    json.dump(meta_run(), sys.stdout)
