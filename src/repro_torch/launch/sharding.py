"""Logical-axis layout on DTensor (port of ``repro/launch/sharding.py``)
and the parameter count of a model configuration.

A spec is the content of the reference's ``PartitionSpec``: a tuple with
one entry per tensor dim, each ``None``, a mesh axis name or a tuple of
axis names.  ``placements(spec, mesh)`` turns it into DTensor placements,
one per mesh dim.  The spec functions (``fit_spec``, ``logical_map_for``,
``param_pspecs``, ``cache_pspecs``, ``batch_pspec``,
``weights_need_fsdp``) take any mesh with ``.shape`` (a dict of axis
sizes) and ``.axis_names``, as the reference's do, or a ``DeviceMesh``
(``mesh_view`` adapts it).

``rules(mesh, logical_map, wmode)`` activates a mesh for the code inside
it.  With a ``logical_map`` (``logical_map_for``) the model runs laid
out: its inputs are DTensors placed by the spec functions
(``launch/layout.py``), ``hint(x, *names)`` redistributes ``x`` to the
fitted spec of its logical dim names, and the hand-written kernels run on
local shards; on a CUDA mesh under gloo the DTensors' collectives go
through ``collectives.HostWire``.  Without one, ``rules(mesh, wmode=...)`` keeps the
expert-parallel path of ``models/moe_ep.py`` on plain tensors.  Outside a
rules context every hint is a no-op and every call runs on one device.

Weight modes: ``tp`` shards over 'model' only (replicated over
'data'/'pod'); ``fsdp`` also shards the non-'model' matrix dim over 'data'
(gathered where the weight is used), for weights whose TP shards alone do
not fit a card (``weights_need_fsdp``).
"""
from __future__ import annotations

import contextlib
import re
from typing import Dict

from repro_torch.models.config import ModelConfig, layer_pattern
from repro_torch.tree import tree_map_with_path

WMODES = ("tp", "fsdp")
_ACTIVE: dict = {"mesh": None, "map": None, "wmode": "tp"}


@contextlib.contextmanager
def rules(mesh, logical_map: Dict[str, object] = None, wmode: str = "tp"):
    """Activate ``mesh``, the logical-axis map (None: the expert-parallel
    path on plain tensors) and the weight mode inside the block."""
    if wmode not in WMODES:
        raise ValueError(f"wmode must be one of {WMODES}, got {wmode!r}")
    if logical_map is not None and not isinstance(logical_map, dict):
        raise TypeError("logical_map must be a dict of logical name -> mesh "
                        f"axes (logical_map_for), got {logical_map!r}")
    prev = dict(_ACTIVE)
    _ACTIVE.update(mesh=mesh, map=logical_map, wmode=wmode)
    try:
        with _wire(mesh, logical_map):
            yield
    finally:
        _ACTIVE.update(prev)


def _wire(mesh, logical_map):
    """The laid-out model on the card under gloo: its DTensors'
    collectives cross host memory (``collectives.HostWire``; gloo's
    all-gather of a CUDA tensor kills its process).  Elsewhere nothing."""
    import torch.distributed as dist
    if (logical_map is None or getattr(mesh, "device_type", None) != "cuda"
            or dist.get_backend() != "gloo"):
        return contextlib.nullcontext()
    from repro_torch.launch.collectives import HostWire
    return HostWire()


def active():
    return _ACTIVE


def layout_active() -> bool:
    """Whether the laid-out (DTensor) model path is active."""
    return _ACTIVE["mesh"] is not None and _ACTIVE["map"] is not None


class _MeshView:
    """``.shape`` (axis name -> size) and ``.axis_names`` of a mesh."""

    def __init__(self, names, sizes):
        self.axis_names = tuple(names)
        self.shape = dict(zip(names, sizes))


def mesh_view(mesh):
    """The reference's view of a mesh: a ``DeviceMesh`` adapted, any object
    with ``.shape`` and ``.axis_names`` as it is."""
    if hasattr(mesh, "mesh_dim_names") and not hasattr(mesh, "axis_names"):
        return _MeshView(mesh.mesh_dim_names, tuple(mesh.mesh.shape))
    return mesh


def _dp(mesh):
    dp = tuple(a for a in ("pod", "data") if a in mesh.axis_names)
    return dp if len(dp) > 1 else (dp[0] if dp else None)


def _axsize(mesh, ax) -> int:
    if ax is None:
        return 1
    if isinstance(ax, (tuple, list)):
        n = 1
        for a in ax:
            n *= mesh.shape[a]
        return n
    return mesh.shape[ax]


def fit_spec(spec, shape, mesh) -> tuple:
    """Drop spec axes that do not evenly divide the dimension size, and
    deduplicate mesh axes (first dimension keeps the axis)."""
    mesh = mesh_view(mesh)
    out = []
    used = set()
    for i, ax in enumerate(spec):
        keep = None
        if ax is not None and i < len(shape) \
                and shape[i] % _axsize(mesh, ax) == 0:
            axes = ax if isinstance(ax, (tuple, list)) else (ax,)
            if not any(a in used for a in axes):
                used.update(axes)
                keep = ax
        out.append(keep)
    return tuple(out)


def placements(spec, mesh):
    """DTensor placements of ``spec`` on ``mesh`` (a ``DeviceMesh``): mesh
    dim m is ``Shard(i)`` where tensor dim i names its axis, else
    ``Replicate()``.  A tuple entry shards one dim over several mesh dims,
    which must come in the mesh's own order (the first the outermost, as
    GSPMD lays a tuple out)."""
    from torch.distributed.tensor import Replicate, Shard
    names = tuple(mesh.mesh_dim_names)
    out = [Replicate() for _ in names]
    for i, ax in enumerate(spec):
        if ax is None:
            continue
        axes = tuple(ax) if isinstance(ax, (tuple, list)) else (ax,)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"spec entry {ax!r} does not follow the mesh's "
                             f"axis order {names}")
        for m in idx:
            out[m] = Shard(i)
    return out


def hint(x, *names):
    """Redistribute ``x`` (a DTensor) to the fitted spec of its logical dim
    names; outside rules with a logical map, ``x`` unchanged.  A plain
    tensor inside such rules raises: it never passes through silently.
    Non-dividing axes are dropped (shape-aware), as in the reference."""
    if not layout_active():
        return x
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        raise TypeError(f"hint{names}: a plain {type(x).__name__} under "
                        "laid-out rules; the model's inputs must be DTensors "
                        "(launch/layout.py)")
    mesh, lmap = _ACTIVE["mesh"], _ACTIVE["map"]
    spec = fit_spec(tuple(lmap.get(n) if n is not None else None
                          for n in names), x.shape, mesh)
    return x.redistribute(mesh, placements(spec, mesh))


def logical_map_for(cfg: ModelConfig, shape_name: str, mesh
                    ) -> Dict[str, object]:
    """Logical-name -> mesh-axis map per input shape regime."""
    mesh = mesh_view(mesh)
    dp = _dp(mesh)
    m = {
        "batch": dp, "seq": None, "res_seq": None, "embed": None,
        "tokens": dp,            # flattened (batch*seq) token dim (MoE)
        "expert_ffn": None,      # expert hidden dim (TP'd for small E)
        "vocab": "model",
        "heads": "model", "kv_heads": None, "head_dim": None,
        "ffn": "model", "experts": "model", "cap": "data",
        "mamba_heads": "model", "state": None,
        "kv_seq": None, "frames": None,
    }
    if shape_name == "train_4k":
        # sequence parallelism: the residual stream between blocks is
        # sequence-sharded over 'model' (Megatron-SP style)
        m["res_seq"] = "model"
        dpt = (dp if isinstance(dp, tuple) else (dp,)) if dp else ()
        m["tokens"] = tuple(dpt) + ("model",)
    if shape_name == "long_500k":
        # batch=1: shard the KV/sequence dim over 'data' instead
        m["batch"] = None
        m["kv_seq"] = "data"
        m["seq"] = None
    elif shape_name in ("decode_32k", "prefill_32k"):
        m["kv_seq"] = "model"
    if shape_name in ("decode_32k", "long_500k"):
        # decode: keep the expert hidden dim 'data'-sharded so FSDP expert
        # weights stay stationary
        m["expert_ffn"] = "data"
    return m


# --------------------------------------------------------------------------
# parameter specs
# --------------------------------------------------------------------------

_COL = re.compile(   # (in, out-sharded-over-model) matrices
    r"(wq|wk|wv|up|gate|wuk|wuv|wz|wx|head)$")
_ROW = re.compile(   # (in-sharded-over-model, out) matrices
    r"(wo|down|out_proj)$")
_REPL = re.compile(
    r"(router|w|q_norm|k_norm|ckv_norm|wdkv|wdq|wB|wC|wdt|conv_B|conv_C|"
    r"conv_bB|conv_bC|dt_bias|A_log|D|mlp_gate)$")


def _key_str(path) -> str:
    return "/".join(str(p) for p in path)


def is_matrix(name: str) -> bool:
    """Whether a 2-D weight named ``name`` is a column- or row-parallel
    projection (``matrix_spec``)."""
    return bool(_ROW.search(name) or _COL.search(name))


def matrix_spec(name: str, mode: str = "tp") -> tuple:
    """The spec ``param_pspecs`` gives a 2-D weight named ``name`` (its
    last key) before fitting: a row-parallel one ('model' on its input
    dim), else column-parallel ('model' on its output dim); under ``fsdp``
    'data' on the other dim."""
    fs = "data" if mode == "fsdp" else None
    return ("model", fs) if _ROW.search(name) else (fs, "model")


def expert_parallel(cfg: ModelConfig) -> bool:
    """Whether ``param_pspecs`` shards the expert stacks' E dim over
    'model' (E >= 16 and a multiple of 16) rather than their f dim."""
    E = cfg.moe.n_routed if cfg.moe is not None else 0
    return E >= 16 and E % 16 == 0


def param_pspecs(cfg: ModelConfig, params, mode: str = "tp", mesh=None):
    """Spec tree for the params (tensors or anything with ``.ndim`` and
    ``.shape``).  mode in {tp, fsdp}."""
    fs = "data" if mode == "fsdp" else None
    ep = expert_parallel(cfg)
    m_ = mesh if mesh is not None else _ACTIVE["mesh"]

    def spec_for(path, leaf):
        ks = _key_str(path)
        nd = leaf.ndim
        stacked = ("scan/" in ks or ks.startswith("scan")) and nd >= 1
        lead = (None,) if stacked else ()
        name = ks.split("/")[-1]
        is_expert = nd - len(lead) == 3 and re.search(r"(gate|up|down)$", name)

        if is_expert:                               # (E, a, b)
            if re.search(r"down$", name):
                sp = ("model", fs, None) if ep else (None, "model", fs)
            else:                                   # gate/up: (E, d, f)
                sp = ("model", None, fs) if ep else (None, fs, "model")
            spec = (*lead, *sp)
        elif name == "tok":                         # embedding (V, d)
            spec = (*lead, "model", fs)
        elif nd - len(lead) == 2 and is_matrix(name):
            spec = (*lead, *matrix_spec(name, mode))
        elif name == "conv_x":                      # (K, d_inner)
            spec = (*lead, None, "model")
        elif name in ("conv_bx", "norm_w") and nd - len(lead) == 1 \
                and cfg.mamba is not None:
            spec = (*lead, "model")
        else:
            spec = (*lead, *([None] * (nd - len(lead))))
        if m_ is not None:
            spec = fit_spec(spec, tuple(leaf.shape), m_)
        return tuple(spec)

    return tree_map_with_path(spec_for, params)


def weights_need_fsdp(cfg: ModelConfig, mesh, train: bool = False,
                      hbm_bytes: float = 80e9) -> bool:
    """Do the TP-only weights exceed ~60% of one card's memory
    (``hbm_bytes``: the H100's 80 GB)?  Training counts optimizer state:
    params + grads in the param dtype + float32 moments (12 bytes a bf16
    param, against 2 for inference).  The TP shard is the params over the
    mesh's own 'model' size."""
    n_params = estimate_params(cfg)
    bytes_per = (2 if "16" in cfg.param_dtype else 4)
    if train:
        bytes_per = bytes_per * 2 + 8              # +grads, +f32 moments
    tp = mesh_view(mesh).shape.get("model", 1)
    tp_bytes = n_params * bytes_per / tp
    return tp_bytes > 0.6 * hbm_bytes


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


# --------------------------------------------------------------------------
# cache / state specs
# --------------------------------------------------------------------------

def cache_pspecs(cfg: ModelConfig, caches, shape_name: str, mesh):
    """Specs for the serve-state cache tree.  ``pos`` (B, S_c) is laid out
    as the keys' first two dims; the reference's spec names only its dim 0
    with the sequence axis (ROADMAP.md, "Notes on the reference")."""
    lm = logical_map_for(cfg, shape_name, mesh)
    batch_ax = lm["batch"]
    seq_ax = lm["kv_seq"]

    def spec_for(path, leaf):
        ks = _key_str(path)
        nd = leaf.ndim
        stacked = "scan" in ks.split("/")
        lead = (None,) if stacked else ()
        name = ks.split("/")[-1]
        body = nd - len(lead)
        if name in ("k", "v", "xk", "xv"):          # (B, S, Hkv, hd)
            return (*lead, batch_ax, seq_ax if name in ("k", "v") else None,
                    None, None)
        if name in ("ckv", "kpe"):                  # (B, S, R)
            return (*lead, batch_ax, seq_ax, None)
        if name == "pos":                           # (B, S)
            return (*lead, batch_ax, seq_ax)
        if name == "ssm":                           # (B, H, P, N)
            return (*lead, batch_ax, "model", None, None)
        if name in ("conv_x",):                     # (B, K-1, d_inner)
            return (*lead, batch_ax, None, "model")
        if name in ("conv_B", "conv_C"):
            return (*lead, batch_ax, None, None)
        return (*lead, *([None] * body))

    return tree_map_with_path(
        lambda path, leaf: fit_spec(spec_for(path, leaf), tuple(leaf.shape),
                                    mesh), caches)


def batch_pspec(mesh, batch: int) -> tuple:
    mesh = mesh_view(mesh)
    dp = tuple(a for a in ("pod", "data") if a in mesh.axis_names)
    total = 1
    for a in dp:
        total *= mesh.shape[a]
    if dp and batch % total == 0:
        return (dp if len(dp) > 1 else dp[0], None)
    # try data-only
    if "data" in mesh.axis_names and batch % mesh.shape["data"] == 0:
        return ("data", None)
    return (None, None)
