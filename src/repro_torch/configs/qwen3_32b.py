"""Qwen3-32B [hf:Qwen/Qwen3-8B family].  64L, d_model=5120, 64 heads GQA
kv=8 (head_dim 128), d_ff=25600, vocab=151936, qk-norm on."""
from repro_torch.models.config import AttentionConfig, ModelConfig

CONFIG = ModelConfig(
    name="qwen3-32b",
    family="dense",
    source="hf:Qwen/Qwen3-8B",
    n_layers=64,
    d_model=5120,
    d_ff=25600,
    vocab=151936,
    attn=AttentionConfig(n_heads=64, n_kv_heads=8, head_dim=128,
                         rope_theta=1_000_000.0, qk_norm=True),
    norm="rmsnorm",
    act="silu",
    glu=True,
    dtype="bfloat16",
)
