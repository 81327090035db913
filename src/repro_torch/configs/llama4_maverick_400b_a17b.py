"""Llama-4 Maverick 400B-A17B [hf:meta-llama/Llama-4-Scout-17B-16E family].
48L, d_model=5120, 40 heads GQA kv=8 (head_dim 128), vocab=202048.
MoE: 128 routed experts, top-1 sigmoid router + 1 always-on shared expert,
expert d_ff=8192 (per assignment spec).  Every layer is MoE per the spec's
"MoE 128e top-1"; the model card's early-fusion multimodality is out of
scope (text backbone only)."""
from repro_torch.models.config import AttentionConfig, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="llama4-maverick-400b-a17b",
    family="moe",
    source="hf:meta-llama/Llama-4-Scout-17B-16E",
    n_layers=48,
    d_model=5120,
    d_ff=8192,
    vocab=202048,
    attn=AttentionConfig(n_heads=40, n_kv_heads=8, head_dim=128,
                         rope_theta=500_000.0),
    moe=MoEConfig(n_routed=128, top_k=1, d_expert=8192,
                  n_shared=1, d_shared=8192,
                  router_type="sigmoid", renormalize=False),
    norm="rmsnorm",
    act="silu",
    glu=True,
    dtype="bfloat16",
)
