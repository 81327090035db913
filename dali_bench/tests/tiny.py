"""Tiny configurations and cells for the CPU tests: the published
configurations' keys at widths a test run holds, float32."""
import json
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]

MIXTRAL = {
    "name": "mixtral.tiny", "model_type": "mixtral", "hidden_size": 64,
    "intermediate_size": 96, "num_attention_heads": 4,
    "num_key_value_heads": 2, "num_local_experts": 4,
    "num_experts_per_tok": 2, "num_hidden_layers": 2, "rms_norm_eps": 1e-6,
    "rope_theta": 1000000.0, "vocab_size": 256, "torch_dtype": "float32"}

DEEPSEEK = {
    "name": "deepseek.tiny", "model_type": "deepseek_v2", "hidden_size": 64,
    "intermediate_size": 128, "moe_intermediate_size": 32,
    "num_attention_heads": 4, "num_key_value_heads": 4,
    "qk_nope_head_dim": 16, "qk_rope_head_dim": 8, "v_head_dim": 16,
    "kv_lora_rank": 32, "q_lora_rank": None, "n_routed_experts": 8,
    "num_experts_per_tok": 3, "n_shared_experts": 2,
    "first_k_dense_replace": 1, "norm_topk_prob": False,
    "routed_scaling_factor": 1, "num_hidden_layers": 3,
    "rms_norm_eps": 1e-6, "rope_theta": 10000, "rope_scaling": None,
    "vocab_size": 256, "torch_dtype": "float32"}

# the same at the widths the card's kernels take (the port's smoke sizes:
# K3 needs head widths that are multiples of 16)
MIXTRAL_CARD = dict(MIXTRAL, name="mixtral.card", hidden_size=256,
                    intermediate_size=256, vocab_size=512,
                    torch_dtype="bfloat16")
DEEPSEEK_CARD = dict(DEEPSEEK, name="deepseek.card", hidden_size=256,
                     intermediate_size=512, moe_intermediate_size=256,
                     kv_lora_rank=64, qk_nope_head_dim=32,
                     qk_rope_head_dim=16, v_head_dim=32, vocab_size=512,
                     torch_dtype="bfloat16")

CHAT = {"arrival": "closed",
        "prompt_tokens": {"dist": "loguniform", "min": 8, "max": 40},
        "output_tokens": {"dist": "loguniform", "min": 3, "max": 8}}


def bench():
    with open(ROOT / "BENCHMARK.json") as f:
        return json.load(f)


DOCS = {"arrival": "closed",
        "prompt_tokens": {"dist": "loguniform", "min": 40, "max": 90},
        "output_tokens": {"dist": "loguniform", "min": 1, "max": 1}}


def found(config, workload, offload="pipelined", slots=2, rate=0.6,
          traffic=None, check=None):
    """A ``harness.find_cell`` result for a tiny configuration under the
    metrics of ``workload``."""
    return {"workload": {"name": workload, "config": config["name"],
                         "traffic": "tiny", "chips": 1},
            "config": config, "traffic": traffic or CHAT,
            "cell": {"offload": offload, "fallback": "fetch",
                     "cache_ratio": 0.5, "policy": "dali", "slots": slots,
                     "requests_per_s": rate,
                     "check": check or {"sample": 3, "logit_err.median": 1e-4,
                                        "not_argmax": 0}}}


def load_traffic(name):
    with open(ROOT / "dali_bench" / "traffic" / f"{name}.json") as f:
        return json.load(f)
