"""Llama-3.2 11B Vision [hf:meta-llama/Llama-3.2-11B-Vision].  40 decoder
layers (every 5th is a gated cross-attention layer over image patch
embeddings), d_model=4096, 32 heads GQA kv=8, d_ff=14336, vocab=128256.
The ViT vision encoder + projector is the permitted stub — ``input_specs``
supplies projected patch embeddings (B, n_vision_tokens, 4096)."""
from repro_torch.models.config import AttentionConfig, ModelConfig

CONFIG = ModelConfig(
    name="llama-3.2-vision-11b",
    family="vlm",
    source="hf:meta-llama/Llama-3.2-11B-Vision",
    n_layers=40,
    d_model=4096,
    d_ff=14336,
    vocab=128256,
    attn=AttentionConfig(n_heads=32, n_kv_heads=8, head_dim=128,
                         rope_theta=500_000.0),
    cross_attn_period=5,
    n_vision_tokens=1601,
    norm="rmsnorm",
    act="silu",
    glu=True,
    dtype="bfloat16",
)
