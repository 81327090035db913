"""The JAX package's collectives of one fsdp decode step of smoke Jamba
with 16 experts (bfloat16) on a (data=2, model=4) mesh of host devices,
decode_32k's logical map, B = 4 over a 64-slot cache: the compiled HLO's
per-device traffic (``repro/launch/hloparse.py``'s ring formulas, scan
trip counts expanded) by kind and mesh axis, in bytes and in elements
(the CPU compiler may widen bfloat16 to float32 before a collective).

Run as a script (it sets ``XLA_FLAGS`` before JAX starts, as
``repro/launch/dryrun.py`` does); prints one JSON object.
"""
import os

os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                           + " --xla_force_host_platform_device_count=8")

import dataclasses  # noqa: E402
import functools  # noqa: E402
import json  # noqa: E402
import re  # noqa: E402
import sys  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from jax.sharding import Mesh, NamedSharding  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from repro import configs  # noqa: E402
from repro.launch import sharding as shd  # noqa: E402
from repro.launch.hloparse import _traffic, _walk_scaled  # noqa: E402
from repro.launch.shapes import _with_sharding  # noqa: E402
from repro.models.model import init_model  # noqa: E402
from repro.models.moe import expert_capacity  # noqa: E402
from repro.serving.steps import (default_dali_config,  # noqa: E402
                                 init_serve_state, make_decode_step)

KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
         "collective-permute")
ITEM = {"f32": 4, "bf16": 2, "s32": 4, "f16": 2, "pred": 1, "s8": 1,
        "u32": 4, "s64": 8, "f64": 8}
# the (2, 4) mesh's groups as the HLO writes them
AXES = {"[4,2]<=[2,4]T(1,0)": "data", "[2,4]<=[8]": "model",
        "[1,8]<=[8]": "data,model"}


def _shapes(text):
    """(elements, bytes) of an HLO result shape or tuple of shapes."""
    n = b = 0
    for dt, dims in re.findall(r"(\w+)\[([0-9,]*)\]", text):
        k = int(np.prod([int(d) for d in dims.split(",") if d])) \
            if dims else 1
        n += k
        b += k * ITEM.get(dt, 4)
    return n, b


def _by_axis(text):
    for line in text.splitlines():
        for kind in KINDS:
            if f" {kind}(" not in line and f" {kind}-start(" not in line:
                continue
            m = re.search(r"=\s*(\([^)]*\)|[\w\[\],{}\s]*?)\s*"
                          + kind.replace("-", r"\-") + r"(?:-start)?\(",
                          line)
            n, b = _shapes(m.group(1) if m else line.split("=")[0])
            gm = re.search(r"replica_groups=(\S+?),\s", line)
            ax = AXES.get(gm.group(1) if gm else "", "other")
            g = {"data": 2, "model": 4, "data,model": 8}.get(ax, 2)
            yield f"{kind}|{ax}", _traffic(kind, b, g)
            yield f"{kind}|{ax}|elements", _traffic(kind, n, g)
            break


def main():
    cfg = configs.make_smoke(configs.get_config("jamba_1_5_large_398b"))
    cfg = cfg.replace(moe=dataclasses.replace(cfg.moe, n_routed=16),
                      dtype="bfloat16", param_dtype="bfloat16")
    mesh = Mesh(np.array(jax.devices()[:8]).reshape(2, 4),
                ("data", "model"))
    B, S = 4, 64
    p = jax.eval_shape(functools.partial(init_model, cfg=cfg),
                       jax.random.PRNGKey(0))
    p = _with_sharding(p, shd.param_pspecs(cfg, p, mode="fsdp", mesh=mesh),
                       mesh)
    dcfg = default_dali_config(cfg)
    st = jax.eval_shape(functools.partial(init_serve_state, cfg, B, S,
                                          dali_cfg=dcfg, dtype=cfg.dtype))
    bspec = shd.batch_pspec(mesh, B)
    specs = {"tokens": P(bspec[0], None), "pos": P(), "rng": P(None),
             "caches": shd.cache_pspecs(cfg, st["caches"], "decode_32k",
                                        mesh),
             "dali": jax.tree.map(lambda s: P(*([None] * len(s.shape))),
                                  st["dali"])}
    st = _with_sharding(st, specs, mesh)
    res = jax.ShapeDtypeStruct((dcfg.n_moe_layers, cfg.d_model), jnp.float32,
                               sharding=NamedSharding(mesh, P(None, None)))
    fn = make_decode_step(cfg, dcfg, moe_capacity=expert_capacity(cfg.moe,
                                                                  B))
    with mesh, shd.rules(mesh, shd.logical_map_for(cfg, "decode_32k", mesh),
                         "fsdp"):
        hlo = jax.jit(fn).lower(p, st, res).compile().as_text()
    json.dump(_walk_scaled(hlo, _by_axis), sys.stdout)


if __name__ == "__main__":
    main()
