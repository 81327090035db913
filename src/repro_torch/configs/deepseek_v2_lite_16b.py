"""DeepSeek-V2-Lite 16B [arXiv:2405.04434] — one of the paper's own
evaluation models.  27L (first layer dense FFN d_ff=10944), d_model=2048,
16 heads, MLA (kv_lora=512, rope_head=64, nope/v head 128), vocab=102400.
MoE: 64 routed experts top-6 + 2 shared, expert d_ff=1408 (160 routed
experts is the full DeepSeek-V2, not V2-Lite).  A copy of
``repro/configs/deepseek_v2_lite_16b.py``."""
from repro_torch.models.config import (AttentionConfig, MLAConfig,
                                       ModelConfig, MoEConfig)

CONFIG = ModelConfig(
    name="deepseek-v2-lite-16b",
    family="moe",
    source="arXiv:2405.04434",
    n_layers=27,
    d_model=2048,
    d_ff=10944,
    vocab=102400,
    attn=AttentionConfig(n_heads=16, n_kv_heads=16,
                         rope_theta=10_000.0,
                         mla=MLAConfig(kv_lora_rank=512, q_lora_rank=0,
                                       qk_nope_head_dim=128,
                                       qk_rope_head_dim=64,
                                       v_head_dim=128)),
    moe=MoEConfig(n_routed=64, top_k=6, d_expert=1408,
                  n_shared=2, d_shared=2816,
                  router_type="softmax_topk", renormalize=True,
                  first_dense=1),
    norm="rmsnorm",
    act="silu",
    glu=True,
    dtype="bfloat16",
)
