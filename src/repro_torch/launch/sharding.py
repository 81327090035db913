"""Expert-parallel rules and the parameter count of a model configuration
(port of parts of ``repro/launch/sharding.py``).

``rules(mesh, wmode)`` activates a mesh (``launch/mesh.py::make_mesh``)
for the code inside it: there ``models/moe.py::apply_moe`` takes the
expert-parallel path (``models/moe_ep.py``) wherever ``ep_applicable``
holds.  ``wmode`` is "tp" (expert stacks over 'model', replicated over
'data') or "fsdp" (their f dim also over 'data', gathered in the layer).
Outside a rules context every call runs on one device.  The reference's
logical-axis map has no meaning without GSPMD, so ``rules`` takes none.

The rest of the reference module lays parameters and activations out on a
TPU mesh for GSPMD (``logical_map_for``, ``fit_spec``, ``hint``,
``param_pspecs``, ``weights_need_fsdp``, ``cache_pspecs``,
``batch_pspec``); it waits for ROADMAP.md item 25.
"""
from __future__ import annotations

import contextlib

from repro_torch.models.config import ModelConfig, layer_pattern

WMODES = ("tp", "fsdp")
_ACTIVE: dict = {"mesh": None, "wmode": "tp"}


@contextlib.contextmanager
def rules(mesh, wmode: str = "tp"):
    """Activate ``mesh`` and the expert weight mode inside the block."""
    if wmode not in WMODES:
        raise ValueError(f"wmode must be one of {WMODES}, got {wmode!r}")
    prev = dict(_ACTIVE)
    _ACTIVE["mesh"] = mesh
    _ACTIVE["wmode"] = wmode
    try:
        yield
    finally:
        _ACTIVE.update(prev)


def active():
    return _ACTIVE


def estimate_params(cfg: ModelConfig) -> float:
    """The parameter count of ``cfg``, computed from its widths: embedding
    (and unembedding unless tied), every layer's mixer and MLP (routed and
    shared experts, router), and the encoder of an encoder-decoder."""
    d = cfg.d_model
    total = cfg.vocab * d * (1 if cfg.tie_embeddings else 2)
    for mixer, mlp in layer_pattern(cfg):
        if mixer == "mamba":
            mb = cfg.mamba
            din = mb.d_inner(d)
            total += 2 * d * din + din * d + 2 * d * mb.n_groups * mb.d_state
        elif mixer in ("attn", "attn_local", "attn_global", "cross",
                       "self_cross"):
            a = cfg.attn
            hd = cfg.head_dim()
            if a.mla is not None:
                ml = a.mla
                total += d * a.n_heads * (ml.qk_nope_head_dim
                                          + ml.qk_rope_head_dim)
                total += d * (ml.kv_lora_rank + ml.qk_rope_head_dim)
                total += ml.kv_lora_rank * a.n_heads * (ml.qk_nope_head_dim
                                                        + ml.v_head_dim)
                total += a.n_heads * ml.v_head_dim * d
            else:
                total += d * hd * (2 * a.n_heads + 2 * a.n_kv_heads)
            if mixer == "self_cross":
                total += d * hd * 4 * a.n_heads
        if mlp == "dense":
            total += d * cfg.d_ff * (3 if cfg.glu else 2)
        elif mlp == "moe":
            m = cfg.moe
            de = m.d_expert or cfg.d_ff
            total += m.n_routed * 3 * d * de + d * m.n_routed
            if m.n_shared:
                total += 3 * d * (m.d_shared or m.n_shared * de)
    if cfg.encoder is not None:
        a = cfg.attn
        hd = cfg.head_dim()
        per = d * hd * 4 * a.n_heads + d * cfg.d_ff * (3 if cfg.glu else 2)
        total += cfg.encoder.n_layers * per
    return float(total)
