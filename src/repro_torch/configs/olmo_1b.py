"""OLMo-1B [arXiv:2402.00838].  16L, d_model=2048, 16 heads (MHA kv=16),
d_ff=8192, vocab=50304, *non-parametric* LayerNorm, tied embeddings."""
from repro_torch.models.config import AttentionConfig, ModelConfig

CONFIG = ModelConfig(
    name="olmo-1b",
    family="dense",
    source="arXiv:2402.00838",
    n_layers=16,
    d_model=2048,
    d_ff=8192,
    vocab=50304,
    attn=AttentionConfig(n_heads=16, n_kv_heads=16, head_dim=128,
                         rope_theta=10_000.0),
    norm="nonparam_ln",
    act="silu",
    glu=True,
    tie_embeddings=True,
    dtype="bfloat16",
)
