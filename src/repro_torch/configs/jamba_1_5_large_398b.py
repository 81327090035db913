"""Jamba-1.5 Large 398B [arXiv:2403.19887].  72L hybrid: attention on 1 of
every 8 layers (offset 4), Mamba elsewhere; MoE MLP (16 experts top-2,
d_ff=24576) on every other layer.  d_model=8192, 64 heads GQA kv=8,
vocab=65536.

Adaptation (DESIGN.md): Jamba's Mamba-1 layers are realised with this
framework's Mamba-2/SSD primitive (state 128, head_dim 128) — the TPU-native
chunked-scan formulation."""
from repro_torch.models.config import (AttentionConfig, MambaConfig,
                                       ModelConfig, MoEConfig)

CONFIG = ModelConfig(
    name="jamba-1.5-large-398b",
    family="hybrid",
    source="arXiv:2403.19887",
    n_layers=72,
    d_model=8192,
    d_ff=24576,
    vocab=65536,
    attn=AttentionConfig(n_heads=64, n_kv_heads=8, head_dim=128,
                         rope_theta=10_000.0),
    moe=MoEConfig(n_routed=16, top_k=2, d_expert=24576,
                  router_type="softmax_topk", renormalize=True,
                  every=2),
    mamba=MambaConfig(d_state=128, d_conv=4, expand=2, head_dim=128,
                      n_groups=1, chunk_size=256),
    attn_every=8,
    attn_offset=4,
    norm="rmsnorm",
    act="silu",
    glu=True,
    dtype="bfloat16",
)
