"""Model configuration system.

Every assigned architecture is expressed as a ``ModelConfig``.  The config is
deliberately explicit (no "preset soup"): each architectural deviation the
assigned pool exercises (qk-norm, MLA, logit softcap, sliding/global
alternation, Mamba2 SSD, MoE shared experts, cross-attention layers,
encoder-decoder) is a first-class field.

Layer heterogeneity is captured by ``layer_pattern(cfg)`` which returns the
per-layer (mixer, mlp) kinds, and ``scan_pattern(cfg)`` which factors the
layer list into ``prefix_layers + n_super x period`` so parameters of the
homogeneous super-blocks stay stacked along a leading axis, the layout the
JAX package scans over and the port loops over.

A copy of ``repro/models/config.py``: the port imports nothing of ``repro``.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple

# --------------------------------------------------------------------------
# Sub-configs
# --------------------------------------------------------------------------


@dataclass(frozen=True)
class MLAConfig:
    """Multi-head Latent Attention (DeepSeek-V2, arXiv:2405.04434)."""

    kv_lora_rank: int = 512
    q_lora_rank: int = 0          # 0 => direct q projection (V2-Lite)
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128
    absorbed_decode: bool = True  # decode attends in latent space (weights
                                  # absorbed into q / output) instead of
                                  # decompressing the cache per step


@dataclass(frozen=True)
class AttentionConfig:
    n_heads: int = 8
    n_kv_heads: int = 8
    head_dim: int = 0             # 0 => d_model // n_heads
    rope_theta: float = 10_000.0
    qk_norm: bool = False         # Qwen3: RMSNorm on q/k heads
    attn_softcap: float = 0.0     # gemma2: tanh soft-capping of attn logits
    sliding_window: int = 0       # >0: window size for *local* layers
    local_global_period: int = 0  # gemma2: 2 -> alternate (local, global)
    mla: Optional[MLAConfig] = None

    def head_dim_of(self, d_model: int) -> int:
        if self.mla is not None:
            return self.mla.qk_nope_head_dim + self.mla.qk_rope_head_dim
        return self.head_dim or d_model // self.n_heads


@dataclass(frozen=True)
class MoEConfig:
    n_routed: int = 8
    top_k: int = 2
    d_expert: int = 0             # expert FFN hidden dim (0 => d_ff)
    n_shared: int = 0             # always-resident shared experts (DeepSeek)
    d_shared: int = 0             # shared-expert hidden (0 => n_shared*d_expert)
    router_type: str = "softmax_topk"   # softmax_topk | topk_softmax | sigmoid
    renormalize: bool = True      # renormalize selected gate weights
    every: int = 1                # MoE MLP on layers where i % every == every-1
    first_dense: int = 0          # first k layers use dense FFN (DeepSeek: 1)
    capacity_factor: float = 1.25
    aux_loss_weight: float = 0.01
    router_z_weight: float = 1e-3


@dataclass(frozen=True)
class MambaConfig:
    """Mamba2 / SSD (arXiv:2405.21060)."""

    d_state: int = 128
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64
    n_groups: int = 1
    chunk_size: int = 128

    def d_inner(self, d_model: int) -> int:
        return self.expand * d_model

    def n_heads(self, d_model: int) -> int:
        return self.d_inner(d_model) // self.head_dim


@dataclass(frozen=True)
class EncoderConfig:
    """Transformer encoder for enc-dec archs (audio frontend is stubbed:
    inputs are precomputed frame embeddings of shape (B, T, d_model))."""

    n_layers: int = 24
    frame_len: int = 0            # 0 => same as decoder seq len


@dataclass(frozen=True)
class ModelConfig:
    name: str = "model"
    family: str = "dense"         # dense | moe | ssm | hybrid | vlm | audio
    source: str = ""              # citation
    n_layers: int = 2
    d_model: int = 256
    d_ff: int = 1024
    vocab: int = 32000
    attn: Optional[AttentionConfig] = field(default_factory=AttentionConfig)
    moe: Optional[MoEConfig] = None
    mamba: Optional[MambaConfig] = None
    encoder: Optional[EncoderConfig] = None

    norm: str = "rmsnorm"         # rmsnorm | nonparam_ln (OLMo)
    post_block_norm: bool = False # gemma2 sandwich norms
    act: str = "silu"             # silu | gelu | relu
    glu: bool = True              # gated (SwiGLU/GeGLU) vs plain FFN
    logit_softcap: float = 0.0    # gemma2 final-logit soft-capping
    tie_embeddings: bool = False
    scale_embeddings: bool = False  # gemma2: x *= sqrt(d_model)

    attn_every: int = 1           # hybrid: layer i is attention iff
    attn_offset: int = 0          #   i % attn_every == attn_offset, else mamba
    cross_attn_period: int = 0    # vlm: layer i is cross-attn iff
                                  #   (i+1) % period == 0
    n_vision_tokens: int = 1601   # stubbed patch-embedding count (vlm)

    dtype: str = "bfloat16"
    param_dtype: str = "bfloat16"
    rope_max_len: int = 1 << 20
    remat: bool = False           # activation-checkpoint each super-block

    # -- derived helpers ---------------------------------------------------
    def head_dim(self) -> int:
        assert self.attn is not None
        return self.attn.head_dim_of(self.d_model)

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


# --------------------------------------------------------------------------
# Layer patterns
# --------------------------------------------------------------------------

# mixer kinds: "attn", "attn_local", "attn_global", "mamba", "cross"
# mlp kinds:   "dense", "moe", "none"


def layer_pattern(cfg: ModelConfig) -> Tuple[Tuple[str, str], ...]:
    """Per-layer (mixer_kind, mlp_kind) for the decoder stack."""
    out = []
    for i in range(cfg.n_layers):
        # mixer
        if cfg.family == "ssm":
            mixer = "mamba"
        elif cfg.family == "audio":
            mixer = "self_cross"          # enc-dec decoder layer
        elif cfg.family == "hybrid":
            mixer = "attn" if i % cfg.attn_every == cfg.attn_offset else "mamba"
        elif cfg.cross_attn_period and (i + 1) % cfg.cross_attn_period == 0:
            mixer = "cross"
        elif cfg.attn is not None and cfg.attn.local_global_period:
            p = cfg.attn.local_global_period
            mixer = "attn_local" if i % p == 0 else "attn_global"
        else:
            mixer = "attn"
        # mlp
        if cfg.family == "ssm":
            mlp = "none"                      # mamba2 blocks are standalone
        elif cfg.moe is not None and i >= cfg.moe.first_dense \
                and i % cfg.moe.every == (cfg.moe.every - 1):
            mlp = "moe"
        else:
            mlp = "dense"
        out.append((mixer, mlp))
    return tuple(out)


def scan_pattern(cfg: ModelConfig) -> Tuple[Tuple[Tuple[str, str], ...],
                                            Tuple[Tuple[str, str], ...], int]:
    """Factor layer_pattern into (prefix, period_pattern, n_super).

    prefix layers run unscanned; the remaining ``n_super`` repetitions of
    ``period_pattern`` run as one loop over stacked params.
    """
    pat = layer_pattern(cfg)
    n = len(pat)
    prefix_len = cfg.moe.first_dense if cfg.moe is not None else 0
    body = pat[prefix_len:]
    m = len(body)
    for period in range(1, m + 1):
        if m % period:
            continue
        cand = body[:period]
        if all(body[j] == cand[j % period] for j in range(m)):
            return pat[:prefix_len], cand, m // period
    return pat[:prefix_len], body, 1  # fully heterogeneous (shouldn't happen)
