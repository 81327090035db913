"""The system under test: the PyTorch port (``repro_torch``), given the
benchmark's configuration and weights.

``port_config`` states the configuration file's model in the port's
``ModelConfig``; ``port_params`` lays the weights that ``weights.py``
draws from the seed out as the port's parameter tree (the routed experts
of an offloaded cell in page-locked host memory, one ``(L, E, ...)``
tensor per matrix, which the port's expert store adopts without a copy).
Nothing here decides what the port computes: a setting the configuration
file states is passed on, and one the port cannot run raises.
"""
from __future__ import annotations

import torch

from dali_bench.weights import draw, global_specs, layer_specs


def port_config(spec: dict, name: str, dtype: str):
    """The port's ``ModelConfig`` of a reference ``dims`` spec."""
    from repro_torch.models.config import (AttentionConfig, MLAConfig,
                                           ModelConfig, MoEConfig)
    if spec.get("scaling", 1.0) != 1.0:
        raise ValueError("the port has no routed scaling factor")
    if spec["mla"]:
        attn = AttentionConfig(
            n_heads=spec["heads"], n_kv_heads=spec["heads"],
            rope_theta=spec["rope_theta"],
            mla=MLAConfig(kv_lora_rank=spec["kv_lora"], q_lora_rank=0,
                          qk_nope_head_dim=spec["nope"],
                          qk_rope_head_dim=spec["rope"],
                          v_head_dim=spec["v_dim"]))
    else:
        attn = AttentionConfig(n_heads=spec["heads"],
                               n_kv_heads=spec["kv_heads"],
                               head_dim=spec["head_dim"],
                               rope_theta=spec["rope_theta"])
    moe = MoEConfig(n_routed=spec["experts"], top_k=spec["top_k"],
                    d_expert=spec["expert_ff"],
                    n_shared=spec.get("n_shared", 0),
                    d_shared=spec["shared_ff"], router_type=spec["router"],
                    renormalize=spec["renormalize"],
                    first_dense=spec["first_dense"],
                    # the published models route every token: no capacity,
                    # no drops
                    capacity_factor=0.0)
    return ModelConfig(name=name, family="moe", n_layers=spec["layers"],
                       d_model=spec["d"],
                       d_ff=spec["dense_ff"] or spec["expert_ff"],
                       vocab=spec["vocab"], attn=attn, moe=moe,
                       norm="rmsnorm", act="silu", glu=True, dtype=dtype,
                       param_dtype=dtype)


def _pinned_stacks(shapes: dict, dtype, pin: bool) -> dict:
    """Host tensors of ``shapes``, page-locked when ``pin``: one pinned
    block each, or all in one, whichever the pinned allocator (which rounds
    a block up to a power of two) rounds to fewer bytes."""
    if not pin:
        return {k: torch.empty(s, dtype=dtype) for k, s in shapes.items()}
    esz = torch.empty((), dtype=dtype).element_size()
    sizes = {k: esz * torch.Size(s).numel() for k, s in shapes.items()}
    up = lambda n: 1 << (n - 1).bit_length()
    if up(sum(sizes.values())) >= sum(up(n) for n in sizes.values()):
        return {k: torch.empty(s, dtype=dtype, pin_memory=True)
                for k, s in shapes.items()}
    block = torch.empty(sum(sizes.values()), dtype=torch.uint8,
                        pin_memory=True)
    out, at = {}, 0
    for k, s in shapes.items():
        out[k] = block[at:at + sizes[k]].view(dtype).view(s)
        at += sizes[k]
    return out


def port_params(spec: dict, seed: int, device, served_dtype,
                experts_on_host: bool):
    """The port's parameter tree of the weights drawn from ``seed``:
    ``embed``, ``final_norm``, ``prefix`` (the dense layers before the
    MoE stack, one dict each) and ``scan`` (one pattern position whose
    leaves are stacked over the MoE layers).  With ``experts_on_host`` the
    routed expert stacks lie in host memory (page-locked on a card), each
    layer drawn on ``device`` and copied there."""
    dev = torch.device(device)
    g = {k: draw(seed, k, s, std, served_dtype, dev)
         for k, (s, std, _) in global_specs(spec).items()}
    params = {"embed": {"tok": g["embed"], "head": g["head"]},
              "final_norm": {"w": g["final_norm"]}}

    def block(flat):
        mlp_keys = ("router", "gate", "up", "down")
        b = {"norm1": {"w": flat["norm1"]}, "norm2": {"w": flat["norm2"]},
             "mixer": {k: v for k, v in flat.items()
                       if k not in mlp_keys and not k.startswith(
                           ("norm", "experts.", "shared."))},
             "mlp": {k: v for k, v in flat.items() if k in mlp_keys}}
        for k, v in flat.items():
            if k.startswith("experts."):
                b["mlp"][k.split(".", 1)[1]] = v
            elif k.startswith("shared."):
                b["mlp"].setdefault("shared", {})[k.split(".", 1)[1]] = v
        return b

    n_dense = spec["first_dense"]
    prefix = []
    for layer in range(n_dense):
        prefix.append(block({
            k: draw(seed, f"layers.{layer}.{k}", s, std,
                    torch.float32 if dt == "float32" else served_dtype, dev)
            for k, (s, std, dt) in layer_specs(spec, layer).items()}))
    n_moe = spec["layers"] - n_dense
    specs = layer_specs(spec, n_dense)
    host_keys = [k for k in specs if k.startswith("experts.")] \
        if experts_on_host else []
    stacks = _pinned_stacks({k: (n_moe,) + tuple(specs[k][0])
                             for k in host_keys}, served_dtype,
                            pin=dev.type == "cuda")
    for k, (s, _, dt) in specs.items():
        if k not in stacks:
            stacks[k] = torch.empty((n_moe,) + tuple(s), device=dev,
                                    dtype=torch.float32 if dt == "float32"
                                    else served_dtype)
    for i in range(n_moe):
        layer = n_dense + i
        for k, (s, std, dt) in specs.items():
            draw(seed, f"layers.{layer}.{k}", s, std,
                 torch.float32 if dt == "float32" else served_dtype, dev,
                 out=stacks[k][i])
    params["prefix"] = tuple(prefix)
    params["scan"] = (block(stacks),)
    return params
