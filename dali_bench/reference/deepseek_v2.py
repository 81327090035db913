"""DeepSeek-V2 (arXiv:2405.04434), as V2-Lite configures it: latent
attention with a normed KV latent of ``kv_lora_rank`` and a rotary key
shared by the heads (no query LoRA); the first ``first_k_dense_replace``
layers a dense SwiGLU FFN, the rest ``n_routed_experts`` SwiGLU experts
under a softmax router's top ``num_experts_per_tok`` (renormalised only
with ``norm_topk_prob``, times ``routed_scaling_factor``) plus the shared
experts, run as one FFN of ``n_shared_experts`` x the expert width.

Departure: no YaRN; plain RoPE and the softmax scale 1/sqrt(qk head dim),
as the port runs them. A configuration that gives ``rope_scaling`` runs
only where its ``assumed`` names that departure."""
from dali_bench.reference.common import forward_logits  # noqa: F401


def dims(cfg: dict) -> dict:
    if cfg.get("rope_scaling") and "rope_scaling" not in cfg.get("assumed",
                                                                  {}):
        raise ValueError("the reference has no YaRN rope scaling")
    if cfg.get("q_lora_rank"):
        raise ValueError("the reference has no query LoRA")
    L = cfg["num_hidden_layers"]
    dense = cfg["first_k_dense_replace"]
    return {"d": cfg["hidden_size"], "vocab": cfg["vocab_size"],
            "layers": L, "heads": cfg["num_attention_heads"], "mla": True,
            "nope": cfg["qk_nope_head_dim"], "rope": cfg["qk_rope_head_dim"],
            "v_dim": cfg["v_head_dim"], "kv_lora": cfg["kv_lora_rank"],
            "eps": cfg["rms_norm_eps"], "rope_theta": float(cfg["rope_theta"]),
            "experts": cfg["n_routed_experts"],
            "top_k": cfg["num_experts_per_tok"],
            "expert_ff": cfg["moe_intermediate_size"],
            "n_shared": cfg["n_shared_experts"],
            "shared_ff": cfg["n_shared_experts"]
            * cfg["moe_intermediate_size"],
            "first_dense": dense, "dense_ff": cfg["intermediate_size"],
            "router": "softmax_topk",
            "renormalize": bool(cfg["norm_topk_prob"]),
            "scaling": float(cfg["routed_scaling_factor"]),
            "moe_layers": L - dense}
