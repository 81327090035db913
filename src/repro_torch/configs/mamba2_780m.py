"""Mamba2-780M [arXiv:2405.21060].  48 SSD layers (attention-free, no
separate FFN — d_ff=0), d_model=1536, expand 2 (d_inner 3072, 48 heads of
64), ssm_state=128, vocab=50280, tied embeddings."""
from repro_torch.models.config import MambaConfig, ModelConfig

CONFIG = ModelConfig(
    name="mamba2-780m",
    family="ssm",
    source="arXiv:2405.21060",
    n_layers=48,
    d_model=1536,
    d_ff=0,
    vocab=50280,
    attn=None,
    mamba=MambaConfig(d_state=128, d_conv=4, expand=2, head_dim=64,
                      n_groups=1, chunk_size=256),
    norm="rmsnorm",
    tie_embeddings=True,
    dtype="bfloat16",
)
