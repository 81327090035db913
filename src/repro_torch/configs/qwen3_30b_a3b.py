"""Qwen3-30B-A3B [paper Table 3; hf:Qwen/Qwen3-30B-A3B] — the paper's
"Qwen" evaluation model.  48L, d_model=2048, 32 heads GQA kv=4
(head_dim 128), qk-norm, 128 routed experts top-8 (expert d_ff=768),
vocab=151936.  A copy of
``repro/configs/qwen3_30b_a3b.py``."""
from repro_torch.models.config import AttentionConfig, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="qwen3-30b-a3b",
    family="moe",
    source="hf:Qwen/Qwen3-30B-A3B",
    n_layers=48,
    d_model=2048,
    d_ff=6144,
    vocab=151936,
    attn=AttentionConfig(n_heads=32, n_kv_heads=4, head_dim=128,
                         rope_theta=1_000_000.0, qk_norm=True),
    moe=MoEConfig(n_routed=128, top_k=8, d_expert=768,
                  router_type="softmax_topk", renormalize=True),
    norm="rmsnorm",
    act="silu",
    glu=True,
    dtype="bfloat16",
)
