"""Seeded model weights, drawn by the benchmark and handed to both sides.

Every weight has a name (``"embed"``, ``"layers.3.wq"``, ...), a shape
taken from the configuration file, and a generator of its own seeded from
``(--seed, name)``.  So any one of them can be drawn again, alone and in
the same bits, on the same device: the adapter draws them for the program
(``models/``), and the plain reference (``reference/``) draws each layer's
again after the window, from the seed and not from the program's copy.

The draws are normal, scaled by ``1/sqrt(fan_in)`` for a projection or an
expert, 1 for the embedding and 0.05 for the norms' ``w`` (the norms
multiply by ``1 + w``), and rounded to the served dtype; the router's
weights stay in float32, as the port keeps them.  Each tensor is drawn in
one call on the device it is served from (experts layer by layer).
"""
from __future__ import annotations

import hashlib
import math

import torch

NORM_STD = 0.05


def leaf_seed(seed: int, name: str) -> int:
    """A 63-bit generator seed for one named weight of run ``seed``."""
    h = hashlib.sha256(f"{int(seed)}/{name}".encode()).digest()
    return int.from_bytes(h[:8], "little") >> 1


def draw(seed: int, name: str, shape, std: float, dtype, device,
         out=None):
    """``N(0, std^2)`` of ``shape`` from the generator of ``(seed, name)``,
    rounded to ``dtype``; written into ``out`` (any device) when given."""
    dev = torch.device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(leaf_seed(seed, name))
    t = torch.randn(tuple(shape), generator=gen, device=dev,
                    dtype=torch.float32)
    t = t.mul_(std).to(dtype)
    if out is None:
        return t
    out.copy_(t)
    return out


def fan_in_std(shape) -> float:
    """``1/sqrt(fan_in)``: the input width is the second-to-last axis."""
    return 1.0 / math.sqrt(shape[-2])


def layer_specs(spec: dict, layer: int) -> dict:
    """``{short name: (shape, std, dtype key)}`` of one decoder layer of a
    ``dims(cfg)`` spec; dtype key ``"served"`` or ``"float32"``."""
    d = spec["d"]
    out = {"norm1": ((d,), NORM_STD, "served"),
           "norm2": ((d,), NORM_STD, "served")}
    if spec["mla"]:
        H, nope, rope, vd, R = (spec["heads"], spec["nope"], spec["rope"],
                                spec["v_dim"], spec["kv_lora"])
        shapes = {"wq": (d, H * (nope + rope)), "wdkv": (d, R + rope),
                  "wuk": (R, H * nope), "wuv": (R, H * vd),
                  "wo": (H * vd, d)}
        out["ckv_norm"] = ((R,), NORM_STD, "served")
    else:
        H, KV, hd = spec["heads"], spec["kv_heads"], spec["head_dim"]
        shapes = {"wq": (d, H * hd), "wk": (d, KV * hd), "wv": (d, KV * hd),
                  "wo": (H * hd, d)}
    for k, s in shapes.items():
        out[k] = (s, fan_in_std(s), "served")
    if layer < spec["first_dense"]:
        F = spec["dense_ff"]
        for k, s in (("gate", (d, F)), ("up", (d, F)), ("down", (F, d))):
            out[k] = (s, fan_in_std(s), "served")
        return out
    E, f = spec["experts"], spec["expert_ff"]
    out["router"] = ((d, E), 1.0 / math.sqrt(d), "float32")
    for k, s in (("experts.gate", (E, d, f)), ("experts.up", (E, d, f)),
                 ("experts.down", (E, f, d))):
        out[k] = (s, fan_in_std(s), "served")
    if spec["shared_ff"]:
        Fs = spec["shared_ff"]
        for k, s in (("shared.gate", (d, Fs)), ("shared.up", (d, Fs)),
                     ("shared.down", (Fs, d))):
            out[k] = (s, fan_in_std(s), "served")
    return out


def global_specs(spec: dict) -> dict:
    d, V = spec["d"], spec["vocab"]
    return {"embed": ((V, d), 1.0, "served"),
            "head": ((d, V), 1.0 / math.sqrt(d), "served"),
            "final_norm": ((d,), NORM_STD, "served")}


def draw_layer(seed: int, spec: dict, layer: int, device,
               served_dtype) -> dict:
    """One decoder layer's weights ``{short name: tensor}`` on ``device``."""
    return {k: draw(seed, f"layers.{layer}.{k}", shape, std,
                    torch.float32 if dt == "float32" else served_dtype,
                    device)
            for k, (shape, std, dt) in layer_specs(spec, layer).items()}


def draw_global(seed: int, spec: dict, device, served_dtype) -> dict:
    return {k: draw(seed, k, shape, std, served_dtype, device)
            for k, (shape, std, _) in global_specs(spec).items()}


def served_dtype(cfg: dict):
    return {"bfloat16": torch.bfloat16, "float16": torch.float16,
            "float32": torch.float32}[cfg["torch_dtype"]]
