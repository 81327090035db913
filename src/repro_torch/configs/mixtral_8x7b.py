"""Mixtral-8x7B-Instruct [arXiv:2401.04088] — the paper's primary
evaluation model (not in the assigned pool; included so EXPERIMENTS.md can
validate DALI against the paper's own numbers).  32L, d_model=4096,
32 heads GQA kv=8, expert d_ff=14336, vocab=32000, 8 experts top-2 with
Mixtral's topk-then-softmax router."""
from repro_torch.models.config import AttentionConfig, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="mixtral-8x7b",
    family="moe",
    source="arXiv:2401.04088",
    n_layers=32,
    d_model=4096,
    d_ff=14336,
    vocab=32000,
    attn=AttentionConfig(n_heads=32, n_kv_heads=8, head_dim=128,
                         rope_theta=1_000_000.0),
    moe=MoEConfig(n_routed=8, top_k=2, d_expert=14336,
                  router_type="topk_softmax"),
    norm="rmsnorm",
    act="silu",
    glu=True,
    dtype="bfloat16",
)
