"""Architecture config registry (a copy of ``repro/configs/__init__.py``).

Each architecture lives in its own module exposing ``CONFIG`` at its
published widths; ``make_smoke`` builds the reduced same-family variant
(one layer-pattern period, d_model <= 256, <= 4 experts) the CPU tests run.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Dict, List

from repro_torch.models.config import (EncoderConfig, MLAConfig, ModelConfig,
                                       scan_pattern)

ARCHS: List[str] = [
    "seamless_m4t_large_v2",
    "llama3_405b",
    "llama4_maverick_400b_a17b",
    "qwen3_32b",
    "llama_3_2_vision_11b",
    "deepseek_v2_lite_16b",
    "gemma2_9b",
    "jamba_1_5_large_398b",
    "olmo_1b",
    "mamba2_780m",
    # the paper's own evaluation models (DeepSeek-V2-Lite is assigned above)
    "mixtral_8x7b",
    "qwen3_30b_a3b",
]

ASSIGNED: List[str] = ARCHS[:10]


def canonical(name: str) -> str:
    return name.replace("-", "_").replace(".", "_")


def get_config(name: str) -> ModelConfig:
    mod = importlib.import_module(f"repro_torch.configs.{canonical(name)}")
    return mod.CONFIG


def all_configs() -> Dict[str, ModelConfig]:
    return {a: get_config(a) for a in ARCHS}


def make_smoke(cfg: ModelConfig) -> ModelConfig:
    """Reduced same-family variant for CPU smoke tests (same rule as the
    JAX package's ``make_smoke``, so both build identical configs)."""
    _, period, _ = scan_pattern(cfg)
    prefix = cfg.moe.first_dense if cfg.moe is not None else 0
    n_layers = prefix + len(period)          # one full pattern period
    d_model = min(cfg.d_model, 256)
    kw = dict(
        n_layers=n_layers,
        d_model=d_model,
        d_ff=min(cfg.d_ff, 2 * d_model) if cfg.d_ff else 0,
        vocab=min(cfg.vocab, 512),
        dtype="float32",
        param_dtype="float32",
    )
    if cfg.attn is not None:
        a = cfg.attn
        n_heads = min(a.n_heads, 4)
        n_kv = max(1, min(a.n_kv_heads, n_heads))
        while n_heads % n_kv:
            n_kv -= 1
        mla = None
        if a.mla is not None:
            mla = MLAConfig(kv_lora_rank=64, q_lora_rank=a.mla.q_lora_rank and 32,
                            qk_nope_head_dim=32, qk_rope_head_dim=16,
                            v_head_dim=32)
        kw["attn"] = dataclasses.replace(
            a, n_heads=n_heads, n_kv_heads=n_kv,
            head_dim=min(a.head_dim or d_model // n_heads, 64) or 0,
            sliding_window=min(a.sliding_window, 16) if a.sliding_window else 0,
            mla=mla)
    if cfg.moe is not None:
        m = cfg.moe
        kw["moe"] = dataclasses.replace(
            m, n_routed=min(m.n_routed, 4), top_k=min(m.top_k, 2),
            d_expert=min(m.d_expert or cfg.d_ff, d_model),
            d_shared=min(m.d_shared, d_model) if m.d_shared else 0,
            capacity_factor=0.0)            # no drops in numeric tests
    if cfg.mamba is not None:
        kw["mamba"] = dataclasses.replace(
            cfg.mamba, d_state=16, head_dim=32, chunk_size=8)
    if cfg.encoder is not None:
        kw["encoder"] = EncoderConfig(n_layers=2, frame_len=16)
    kw["n_vision_tokens"] = min(cfg.n_vision_tokens, 16)
    return cfg.replace(name=cfg.name + "-smoke", **kw)
