"""Gemma-2 9B [arXiv:2408.00118].  42L alternating local(sliding 4096)/
global attention, d_model=3584, 16 heads GQA kv=8 (head_dim 256),
d_ff=14336 GeGLU, vocab=256000, attn-logit softcap 50, final-logit softcap
30, sandwich (pre+post) norms, tied + scaled embeddings."""
from repro_torch.models.config import AttentionConfig, ModelConfig

CONFIG = ModelConfig(
    name="gemma2-9b",
    family="dense",
    source="arXiv:2408.00118",
    n_layers=42,
    d_model=3584,
    d_ff=14336,
    vocab=256000,
    attn=AttentionConfig(n_heads=16, n_kv_heads=8, head_dim=256,
                         rope_theta=10_000.0,
                         attn_softcap=50.0,
                         sliding_window=4096,
                         local_global_period=2),
    norm="rmsnorm",
    post_block_norm=True,
    act="gelu",
    glu=True,
    logit_softcap=30.0,
    tie_embeddings=True,
    scale_embeddings=True,
    dtype="bfloat16",
)
