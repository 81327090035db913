"""The assigned input shapes and their ``meta``-device builders for the
shape dry run (port of ``repro/launch/shapes.py``).

Four shapes (the reference's assignment):
  train_4k     seq=4096    batch=256   (training:  train_step, remat on)
  prefill_32k  seq=32768   batch=32    (inference: prefill_step)
  decode_32k   seq=32768   batch=128   (inference: decode_step,
                                        ONE token + 32k KV cache)
  long_500k    seq=524288  batch=1     (long-context decode_step)

``long_500k`` needs sub-quadratic attention: it runs for SSM (mamba2),
hybrid (jamba) and gemma2 (sliding-window local layers); pure
full-attention archs skip it, as in the reference.  Where the reference
builds sharding-annotated ``ShapeDtypeStruct``s, these builders build
parameters, caches and inputs on the ``meta`` device (shapes and dtypes,
no storage) with the model's own init functions.  Without a mesh they are
one card's global trees; with one (``launch/mesh.py::
make_production_mesh`` over the dry run's fake group) they are rank 0's
local shards, laid out as DTensors by ``launch/layout.py``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from repro_torch.configs import canonical, get_config
from repro_torch.device import torch_dtype
from repro_torch.launch import layout as lay
from repro_torch.launch import sharding as shd
from repro_torch.models.config import ModelConfig
from repro_torch.models.model import meta_caches, meta_model
from repro_torch.models.moe import expert_capacity
from repro_torch.tree import tree_map

META = torch.device("meta")


@dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str          # train | prefill | decode
    seq: int
    batch: int


SHAPES = {
    "train_4k": ShapeSpec("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeSpec("long_500k", "decode", 524288, 1),
}

# archs allowed to run long_500k (sub-quadratic or windowed decode)
LONG_OK = {"mamba2_780m", "jamba_1_5_large_398b", "gemma2_9b"}


def skip_reason(arch: str, shape: str) -> Optional[str]:
    if shape == "long_500k" and canonical(arch) not in LONG_OK:
        return ("pure full-attention arch: long_500k skipped per "
                "sub-quadratic rule (DESIGN.md §4)")
    return None


def n_cross_for(cfg: ModelConfig, spec: ShapeSpec) -> Optional[int]:
    if cfg.family == "vlm":
        return cfg.n_vision_tokens
    if cfg.family == "audio":
        # encoder frames: decode against an encoder memory of seq length
        return min(spec.seq, 4096) if spec.kind != "train" else None
    return None


def cross_src_meta(cfg: ModelConfig, spec: ShapeSpec):
    if cfg.family == "vlm":
        T = cfg.n_vision_tokens
    elif cfg.family == "audio":
        T = min(spec.seq, 4096)
    else:
        return None
    return torch.empty((spec.batch, T, cfg.d_model),
                       dtype=torch_dtype(cfg.dtype), device=META)


def _tokens(B: int, S: int):
    return torch.empty((B, S), dtype=torch.int32, device=META)


def _capacity(cfg: ModelConfig, tokens: int):
    return expert_capacity(cfg.moe, tokens) if cfg.moe else None


# --------------------------------------------------------------------------
# step + meta-args builders (one per shape kind)
# --------------------------------------------------------------------------

def build_train(cfg: ModelConfig, spec: ShapeSpec, mesh=None,
                wmode: str = "tp"):
    from repro_torch.training.optimizer import OptConfig, init_adamw
    from repro_torch.training.train_step import make_train_step
    cfg = cfg.replace(remat=True)
    B, S = spec.batch, spec.seq
    params = meta_model(cfg)
    batch = {"tokens": _tokens(B, S), "labels": _tokens(B, S)}
    cs = cross_src_meta(cfg, spec)
    if cs is not None:
        batch["cross_src"] = cs
    fn = make_train_step(cfg, OptConfig(),
                         moe_capacity=_capacity(cfg, B * S))
    opt = init_adamw(params)
    if mesh is not None:
        params = lay.distribute_params(params, cfg, mesh, wmode)
        opt = lay.distribute_opt_state(opt, cfg, mesh, wmode)
        batch = lay.distribute_batch(batch, mesh)
    return cfg, fn, (params, opt, batch)


def build_prefill(cfg: ModelConfig, spec: ShapeSpec, mesh=None,
                  wmode: str = "tp"):
    from repro_torch.serving.steps import make_prefill_step
    B, S = spec.batch, spec.seq
    caches = meta_caches(cfg, B, S, dtype=cfg.dtype,
                         n_cross=n_cross_for(cfg, spec))
    fn = make_prefill_step(cfg, moe_capacity=_capacity(cfg, B * S))
    params, tokens = meta_model(cfg), _tokens(B, S)
    src = cross_src_meta(cfg, spec)
    if mesh is not None:
        params = lay.distribute_params(params, cfg, mesh, wmode)
        tokens = lay.distribute_batch(tokens, mesh)
        caches = lay.distribute_caches(caches, cfg, spec.name, mesh)
        if src is not None:
            src = lay.distribute_batch(src, mesh)
    return cfg, fn, (params, tokens, caches, None, src)


def meta_serve_state(cfg: ModelConfig, batch: int, max_len: int,
                     policy=None, per_slot: bool = False,
                     n_cross: Optional[int] = None):
    """``init_serve_state``'s tree on the ``meta`` device (no generator:
    the dry run decodes greedily); the policy's state is drawn on the CPU
    and carried over as shapes.  Returns (state, the decode's residual
    vectors or None)."""
    state = {"tokens": _tokens(batch, 1),
             "pos": torch.empty((batch,) if per_slot else (),
                                dtype=torch.int32, device=META),
             "caches": meta_caches(cfg, batch, max_len, dtype=cfg.dtype,
                                   n_cross=n_cross),
             "rng": None}
    if per_slot:
        state["active"] = torch.empty((batch,), dtype=torch.bool,
                                      device=META)
    if policy is None or not (policy.schedules and cfg.moe is not None):
        return state, None
    state["dali"] = tree_map(lambda t: t.to(META),
                             policy.init(seed=0, device="cpu"))
    return state, torch.empty((policy.dcfg.n_moe_layers, cfg.d_model),
                              dtype=torch.float32, device=META)


def build_decode(cfg: ModelConfig, spec: ShapeSpec, mesh=None,
                 wmode: str = "tp"):
    from repro_torch.serving.steps import (default_dali_config,
                                           make_decode_step, resolve_policy)
    B, S = spec.batch, spec.seq
    dali_cfg = default_dali_config(cfg) if cfg.moe is not None else None
    policy = resolve_policy(None, cfg, dali_cfg)
    state, res = meta_serve_state(cfg, B, S, policy,
                                  n_cross=n_cross_for(cfg, spec))
    fn = make_decode_step(cfg, policy=policy,
                          moe_capacity=_capacity(cfg, B))
    params = meta_model(cfg)
    if mesh is not None:
        params = lay.distribute_params(params, cfg, mesh, wmode)
        state = dict(state, tokens=lay.distribute_batch(state["tokens"],
                                                        mesh),
                     caches=lay.distribute_caches(state["caches"], cfg,
                                                  spec.name, mesh))
    return cfg, fn, (params, state) + ((res,) if res is not None else ())


def build(arch: str, shape: str, mesh=None, wmode: Optional[str] = None):
    """Returns (cfg, fn, meta_args, wmode): ``fn(*meta_args)`` runs the
    step on the ``meta`` device.  With a ``mesh`` the arguments are rank
    0's local shards laid out by the specs, and ``wmode=None`` picks "tp"
    or "fsdp" by ``weights_need_fsdp`` (as ``repro/launch/shapes.py:
    191-199`` does); without one ``wmode`` is None."""
    cfg = get_config(arch)
    spec = SHAPES[shape]
    builder = {"train": build_train, "prefill": build_prefill,
               "decode": build_decode}[spec.kind]
    if mesh is None:
        return builder(cfg, spec) + (None,)
    if wmode is None:
        wmode = "fsdp" if shd.weights_need_fsdp(
            cfg, mesh, train=spec.kind == "train") else "tp"
    return builder(cfg, spec, mesh, wmode) + (wmode,)
