"""Mixtral-8x7B (arXiv:2401.04088): grouped-query attention with RoPE, and
on every layer 8 SwiGLU experts of which the router takes the top 2 by
logit and weighs them by the softmax over those two.  No shared expert,
no dense layer."""
from dali_bench.reference.common import forward_logits  # noqa: F401


def dims(cfg: dict) -> dict:
    d = cfg["hidden_size"]
    H = cfg["num_attention_heads"]
    return {"d": d, "vocab": cfg["vocab_size"],
            "layers": cfg["num_hidden_layers"], "heads": H, "mla": False,
            "kv_heads": cfg["num_key_value_heads"],
            "head_dim": cfg.get("head_dim") or d // H,
            "eps": cfg["rms_norm_eps"], "rope_theta": float(cfg["rope_theta"]),
            "experts": cfg["num_local_experts"],
            "top_k": cfg["num_experts_per_tok"],
            "expert_ff": cfg["intermediate_size"], "shared_ff": 0,
            "first_dense": 0, "dense_ff": 0, "router": "topk_softmax",
            "renormalize": True, "scaling": 1.0,
            "moe_layers": cfg["num_hidden_layers"]}
