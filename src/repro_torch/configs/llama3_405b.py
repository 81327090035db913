"""Llama-3.1 405B [arXiv:2407.21783].  126L, d_model=16384, 128 heads with
GQA kv=8 (head_dim 128), d_ff=53248, vocab=128256, rope theta 5e5."""
from repro_torch.models.config import AttentionConfig, ModelConfig

CONFIG = ModelConfig(
    name="llama3-405b",
    family="dense",
    source="arXiv:2407.21783",
    n_layers=126,
    d_model=16384,
    d_ff=53248,
    vocab=128256,
    attn=AttentionConfig(n_heads=128, n_kv_heads=8, head_dim=128,
                         rope_theta=500_000.0),
    norm="rmsnorm",
    act="silu",
    glu=True,
    dtype="bfloat16",
)
