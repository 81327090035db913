"""Shared primitive layers: norms, rotary embeddings, dense FFN, embeddings
(port of ``repro/models/layers.py``).

Same functional convention as the reference: ``init_xxx(gen, cfg, ...)``
returns a nested dict of tensors and ``xxx(params, x, ...)`` applies it.
Params are created in ``cfg.param_dtype``; norms, rotary phases and softmax
run in float32, everything else in ``cfg.dtype``.
"""
from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.device import torch_dtype

from .config import ModelConfig

ACTS = {"silu": F.silu, "gelu": lambda x: F.gelu(x, approximate="tanh"),
        "relu": F.relu}


def dense_init(gen: torch.Generator, shape, dtype, device,
               scale: float | None = None):
    """Truncated-normal (+-3 sigma) fan-in init, drawn in float32."""
    fan_in = shape[0] if len(shape) >= 2 else shape[-1]
    std = scale if scale is not None else 1.0 / np.sqrt(fan_in)
    t = torch.empty(shape, dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(t, 0.0, 1.0, -3.0, 3.0, generator=gen)
    return (t * std).to(torch_dtype(dtype))


# --------------------------------------------------------------------------
# Norms
# --------------------------------------------------------------------------

def init_norm(cfg: ModelConfig, device, d: int | None = None):
    if cfg.norm == "nonparam_ln":
        return {}
    return {"w": torch.zeros((d or cfg.d_model,),
                             dtype=torch_dtype(cfg.param_dtype), device=device)}


def apply_norm(params, x, cfg: ModelConfig, eps: float = 1e-6):
    xf = x.float()
    if cfg.norm == "nonparam_ln":
        mu = xf.mean(-1, keepdim=True)
        var = xf.var(-1, keepdim=True, unbiased=False)
        return ((xf - mu) * torch.rsqrt(var + eps)).to(x.dtype)
    y = xf * torch.rsqrt((xf * xf).mean(-1, keepdim=True) + eps)
    # (1 + w) parameterisation (llama/gemma style, zero-init friendly)
    return (y * (1.0 + params["w"].float())).to(x.dtype)


def rms_norm_vec(w, x, eps: float = 1e-6):
    """RMSNorm over the last axis with weight ``w`` (``(1 + w)``, float32):
    Qwen3's qk-norm on every head, MLA's latent and query norms."""
    xf = x.float()
    y = xf * torch.rsqrt((xf * xf).mean(-1, keepdim=True) + eps)
    return (y * (1.0 + w.float())).to(x.dtype)


# --------------------------------------------------------------------------
# Rotary position embeddings
# --------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _inv_freq(head_dim: int, theta: float, device: torch.device):
    """The rotary frequencies on ``device``, built once per (width, base,
    device): built at every call they were a host-to-device copy, which
    waits for the device, in every attention layer of every step."""
    inv_freq = 1.0 / (theta ** (np.arange(0, head_dim, 2) / head_dim))
    return torch.tensor(inv_freq.astype(np.float32), device=device)


def rope_table(positions, head_dim: int, theta: float):
    """cos/sin tables for integer positions -> (..., head_dim // 2).

    The frequencies are built in float64 and meet the positions in
    float32, as in the reference (numpy float64 cast to float32 there)."""
    inv = _inv_freq(head_dim, theta, positions.device)
    ang = positions[..., None].float() * inv
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x, cos, sin):
    """x (..., S, H, D); cos/sin (..., S, D/2) broadcast over heads."""
    x1, x2 = x.float().chunk(2, dim=-1)
    c = cos[..., None, :]
    s = sin[..., None, :]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1).to(x.dtype)


# --------------------------------------------------------------------------
# Dense FFN (SwiGLU / GeGLU / plain)
# --------------------------------------------------------------------------

def init_mlp(gen, cfg: ModelConfig, device, d_ff: int | None = None):
    d, f = cfg.d_model, d_ff or cfg.d_ff
    dt = cfg.param_dtype
    p = {"up": dense_init(gen, (d, f), dt, device),
         "down": dense_init(gen, (f, d), dt, device)}
    if cfg.glu:
        p["gate"] = dense_init(gen, (d, f), dt, device)
    return p


def apply_mlp(params, x, cfg: ModelConfig):
    act = ACTS[cfg.act]
    up = x @ params["up"]
    h = act(x @ params["gate"]) * up if cfg.glu else act(up)
    return h @ params["down"]


# --------------------------------------------------------------------------
# Embedding / unembedding
# --------------------------------------------------------------------------

def init_embedding(gen, cfg: ModelConfig, device):
    p = {"tok": dense_init(gen, (cfg.vocab, cfg.d_model), cfg.param_dtype,
                           device, 1.0)}
    if not cfg.tie_embeddings:
        p["head"] = dense_init(gen, (cfg.d_model, cfg.vocab), cfg.param_dtype,
                               device)
    return p


def embed(params, tokens, cfg: ModelConfig):
    # F.embedding, not indexing: its backward on the CPU is deterministic
    # (indexing's scatters with a nondeterministic accumulation order)
    x = F.embedding(tokens.long(), params["tok"]).to(torch_dtype(cfg.dtype))
    if cfg.scale_embeddings:
        x = x * torch.tensor(np.sqrt(cfg.d_model), dtype=x.dtype)
    return x


def head_logits(x, w, cfg: ModelConfig):
    """x @ w in x's dtype -> float32 logits, soft-capped where the config
    says (the head's columns: every vocab row, or a rank's)."""
    logits = (x @ w.to(x.dtype)).float()
    if cfg.logit_softcap:
        c = cfg.logit_softcap
        logits = c * torch.tanh(logits / c)
    return logits


def unembed(params, x, cfg: ModelConfig):
    w = params["tok"].T if cfg.tie_embeddings else params["head"]
    logits = head_logits(x, w, cfg)
    # vocab padded to a multiple of 256 as in the reference; the padded
    # columns hold -1e30 (never sampled, zero softmax mass)
    pad = (-w.shape[-1]) % 256
    if pad:
        logits = torch.cat([logits, logits.new_full(
            logits.shape[:-1] + (pad,), -1e30)], dim=-1)
    return logits


# --------------------------------------------------------------------------
# the laid-out layers (DTensor inputs under launch/sharding.py::rules)
# --------------------------------------------------------------------------

def norm_laid(params, x, cfg: ModelConfig):
    """``apply_norm`` on each rank's tokens (the weight replicated)."""
    from repro_torch.launch import layout as lay
    ws = [params["w"]] if "w" in params else []
    return lay.local_kernel(
        lambda x, *w: apply_norm(dict(zip(("w",), w)), x, cfg),
        [x.placements] + [lay.place((None,))] * len(ws),
        x.placements)(x, *ws)


def mlp_laid(params, x, cfg: ModelConfig):
    """The dense FFN with its hidden dim over 'model' (column-parallel up /
    gate, row-parallel down): x (B, S, d), the batch as it lies and the
    sequence whole (gathered over 'model' in training) -> ``Partial`` over
    'model'."""
    from repro_torch.launch import layout as lay
    keys = sorted(params)
    b = lay.spec_from(x.placements, 3)[0]
    rows = lay.place((b, None, None))
    return lay.local_kernel(
        lambda x, *ws: apply_mlp(dict(zip(keys, ws)), x, cfg),
        [rows] + [lay.gathered_weight(params[k]) for k in keys],
        lay.place((b, None, None), partial=("model",)))(
            x, *[params[k] for k in keys])


def embed_laid(params, tokens, cfg: ModelConfig):
    """The embedding with its vocab rows over 'model': each rank looks up
    the ids its rows hold (zero elsewhere) -> ``Partial`` over 'model'."""
    from repro_torch.launch import layout as lay
    tok = params["tok"]
    v0 = lay.offset(tok, 0)

    def look(ids, w):
        ids = ids.long() - v0
        own = (ids >= 0) & (ids < w.shape[0])
        x = embed({"tok": w}, ids.clamp(0, w.shape[0] - 1), cfg)
        return torch.where(own[..., None], x, 0)

    b = lay.spec_from(tokens.placements, 2)
    return lay.local_kernel(
        look, [tokens.placements, lay.gathered_weight(tok)],
        lay.place(tuple(b) + (None,), partial=("model",)))(tokens, tok)


def unembed_laid(params, x, cfg: ModelConfig):
    """Logits (B, S, V) float32 with the vocab over 'model' (the
    column-parallel head, or the tied table's rows).  The vocab's own
    columns only: the pad columns of ``unembed`` (-1e30) take no softmax
    mass and are never an argmax, and are left off."""
    from repro_torch.launch import layout as lay
    tied = cfg.tie_embeddings
    w = params["tok"] if tied else params["head"]
    b = lay.spec_from(x.placements, 3)[0]

    def head(x, w):
        return head_logits(x, w.T if tied else w, cfg)

    wspec = lay.spec_from(w.placements, 2)
    vocab = wspec[0] if tied else wspec[1]
    return lay.local_kernel(
        head, [lay.place((b, None, None)), lay.gathered_weight(w)],
        lay.place((b, None, vocab)))(x, w)
