"""SeamlessM4T-Large v2 text decoder + speech-encoder backbone
[arXiv:2308.11596].  24L decoder, d_model=1024, 16 heads (MHA: kv=16),
d_ff=8192, vocab=256206; 24-layer bidirectional encoder over *precomputed*
audio frame embeddings (the mel/conv frontend is the permitted stub —
``input_specs`` supplies (B, T_frames, 1024) embeddings).

Adaptations noted in DESIGN.md: classic post-LN transformer is mapped to the
framework's pre-RMSNorm residual blocks; FFN is non-gated ReLU as in the
original NLLB-style decoder.
"""
from repro_torch.models.config import (AttentionConfig, EncoderConfig,
                                       ModelConfig)

CONFIG = ModelConfig(
    name="seamless-m4t-large-v2",
    family="audio",
    source="arXiv:2308.11596",
    n_layers=24,
    d_model=1024,
    d_ff=8192,
    vocab=256206,
    attn=AttentionConfig(n_heads=16, n_kv_heads=16, head_dim=64,
                         rope_theta=10_000.0),
    encoder=EncoderConfig(n_layers=24, frame_len=0),
    norm="rmsnorm",
    act="relu",
    glu=False,
    dtype="bfloat16",
)
