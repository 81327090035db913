"""Analytic FLOP / HBM-byte accounting per (architecture x input shape): a
copy of ``repro/launch/costs.py`` over the port's ``models/config.py``.

Why analytic: the closed form comes from the model math, so it does not
depend on how a run is traced or counted; ``launch/validate_costs.py``
holds it against ``torch.utils.flop_counter.FlopCounterMode`` on a
one-super-block variant of each arch on the ``meta`` device, and
``launch/dryrun.py`` derives the roofline terms from it.

Conventions (global, whole-step quantities):
  * matmul flops = 2*m*n*k; attention counts qk+pv; train = fwd + 2x bwd.
  * HBM bytes = parameter reads (once per step) + KV/state cache traffic +
    activation stream between blocks (2 x d_model per layer boundary) +
    attention KV reads.  This is a roofline *lower bound* on traffic.
"""
from __future__ import annotations

from dataclasses import dataclass

from repro_torch.models.config import ModelConfig, layer_pattern


@dataclass
class StepCost:
    flops: float
    hbm_bytes: float
    kv_bytes: float
    param_bytes: float


def _dt_bytes(cfg: ModelConfig) -> int:
    return 2 if "16" in cfg.dtype else 4


def layer_flops_per_token(cfg: ModelConfig, mixer: str, mlp: str,
                          kv_len: int, decode: bool = False) -> float:
    """Forward FLOPs per (new) token for one layer.  MoE expert FLOPs are
    accounted at step level in ``step_cost`` (capacity-padded, matching the
    compiled dispatch); here only router + shared expert are counted."""
    d = cfg.d_model
    fl = 0.0
    a = cfg.attn
    if mixer in ("attn", "attn_local", "attn_global", "cross", "self_cross"):
        hd = cfg.head_dim()
        if a.mla is not None:
            m = a.mla
            qk = m.qk_nope_head_dim + m.qk_rope_head_dim
            fl += 2 * d * a.n_heads * qk                      # q proj
            fl += 2 * d * (m.kv_lora_rank + m.qk_rope_head_dim)
            if decode and m.absorbed_decode:
                # absorbed decode: q/output projected through W_uk/W_uv
                # once; attention runs in the (R + rope) latent space
                fl += 2 * m.kv_lora_rank * a.n_heads * (
                    m.qk_nope_head_dim + m.v_head_dim)
                fl += 2 * kv_len * a.n_heads * (
                    m.kv_lora_rank + m.qk_rope_head_dim) * 2   # qk + pv
            else:
                # naive: decompress the latent cache (kv_len entries per
                # new decode token; prefill decompresses each token once)
                dec_n = kv_len if decode else 1
                fl += 2 * m.kv_lora_rank * a.n_heads * (
                    m.qk_nope_head_dim + m.v_head_dim) * dec_n
                fl += 2 * kv_len * a.n_heads * (qk + m.v_head_dim)
            fl += 2 * a.n_heads * m.v_head_dim * d             # out proj
        else:
            eff_kv = kv_len
            if mixer == "attn_local" and a.sliding_window:
                eff_kv = min(kv_len, a.sliding_window)
            if mixer == "cross":
                eff_kv = cfg.n_vision_tokens
            n_kv = a.n_heads if mixer in ("cross",) else a.n_kv_heads
            fl += 2 * d * hd * (2 * a.n_heads + 2 * n_kv)      # q,k,v,o
            fl += 2 * 2 * a.n_heads * hd * eff_kv              # qk + pv
            if mixer == "self_cross":                          # + cross attn
                fl += 2 * d * hd * 4 * a.n_heads
                fl += 2 * 2 * a.n_heads * hd * min(kv_len, 4096)
    elif mixer == "mamba":
        mb = cfg.mamba
        din = mb.d_inner(d)
        H = mb.n_heads(d)
        N = mb.d_state
        fl += 2 * d * (2 * din + 2 * mb.n_groups * N + H)      # projections
        fl += 2 * din * mb.d_conv                              # conv
        fl += 2 * H * mb.head_dim * N * 3                      # ssd update+out
        fl += 2 * din * d                                      # out proj
    if mlp == "dense":
        fl += 2 * d * cfg.d_ff * (3 if cfg.glu else 2)
    elif mlp == "moe":
        m = cfg.moe
        de = m.d_expert or cfg.d_ff
        fl += 2 * d * m.n_routed                               # router
        if m.n_shared:
            fl += 6 * d * (m.d_shared or m.n_shared * de)
    return fl


def layer_param_bytes(cfg: ModelConfig, mixer: str, mlp: str,
                      active_only: bool = False) -> float:
    """Weight bytes touched per step for one layer.  For MoE decode with
    small batch, only activated experts' weights are read."""
    d = cfg.d_model
    b = _dt_bytes(cfg)
    a = cfg.attn
    total = 0.0
    if mixer in ("attn", "attn_local", "attn_global", "cross", "self_cross"):
        hd = cfg.head_dim()
        if a.mla is not None:
            m = a.mla
            qk = m.qk_nope_head_dim + m.qk_rope_head_dim
            total += d * a.n_heads * qk + d * (m.kv_lora_rank + m.qk_rope_head_dim)
            total += m.kv_lora_rank * a.n_heads * (m.qk_nope_head_dim + m.v_head_dim)
            total += a.n_heads * m.v_head_dim * d
        else:
            n_kv = a.n_heads if mixer == "cross" else a.n_kv_heads
            total += d * hd * (2 * a.n_heads + 2 * n_kv)
            if mixer == "self_cross":
                total += d * hd * 4 * a.n_heads
    elif mixer == "mamba":
        mb = cfg.mamba
        din = mb.d_inner(d)
        total += 2 * d * din + din * d + 2 * d * mb.n_groups * mb.d_state \
            + d * mb.n_heads(d)
    if mlp == "dense":
        total += d * cfg.d_ff * (3 if cfg.glu else 2)
    elif mlp == "moe":
        m = cfg.moe
        de = m.d_expert or cfg.d_ff
        n_read = m.n_routed
        total += 3 * d * de * n_read + d * m.n_routed
        if m.n_shared:
            total += 3 * d * (m.d_shared or m.n_shared * de)
    return total * b


def kv_bytes_per_step(cfg: ModelConfig, mixer: str, kv_len: int,
                      batch: int, new_tokens: int) -> float:
    """Cache traffic per step for one layer: read full KV + write new."""
    b = _dt_bytes(cfg)
    a = cfg.attn
    if mixer == "mamba":
        mb = cfg.mamba
        state = mb.n_heads(cfg.d_model) * mb.head_dim * mb.d_state
        return batch * state * 4 * 2.0          # f32 state read+write
    if mixer in ("attn", "attn_local", "attn_global", "self_cross"):
        if a.mla is not None:
            per_tok = a.mla.kv_lora_rank + a.mla.qk_rope_head_dim
        else:
            per_tok = 2 * a.n_kv_heads * cfg.head_dim()
        eff = kv_len
        if mixer == "attn_local" and a.sliding_window:
            eff = min(kv_len, a.sliding_window)
        return batch * (eff * per_tok + new_tokens * per_tok) * b
    if mixer == "cross":
        per = 2 * a.n_heads * cfg.head_dim()
        return batch * cfg.n_vision_tokens * per * b
    return 0.0


def step_cost(cfg: ModelConfig, kind: str, seq: int, batch: int) -> StepCost:
    """Global cost of one step: train fwd+bwd over (batch, seq); prefill
    fwd over (batch, seq); decode ONE token with kv_len=seq."""
    pat = layer_pattern(cfg)
    if kind == "decode":
        new_tokens, kv_len = 1, seq
        tokens = batch
    else:
        new_tokens, kv_len = seq, seq / 2  # mean causal context
        tokens = batch * seq

    fl = 0.0
    pbytes = 0.0
    kvb = 0.0
    d = cfg.d_model
    b = _dt_bytes(cfg)
    from repro_torch.models.moe import expert_capacity
    for mixer, mlp in pat:
        fl += tokens * layer_flops_per_token(cfg, mixer, mlp, kv_len,
                                             decode=(kind == "decode"))
        if mlp == "moe":
            m = cfg.moe
            de = m.d_expert or cfg.d_ff
            C = expert_capacity(m, int(tokens))
            fl += m.n_routed * C * 6 * d * de     # capacity-padded experts
        pbytes += layer_param_bytes(cfg, mixer, mlp)
        if kind != "train":
            kvb += kv_bytes_per_step(cfg, mixer, kv_len if kind == "decode"
                                     else seq, batch, new_tokens)
    # embedding + head
    fl += tokens * 2 * d * cfg.vocab
    pbytes += cfg.vocab * d * b * (1 if cfg.tie_embeddings else 2)
    if cfg.encoder is not None and kind != "decode":
        a = cfg.attn
        hd = cfg.head_dim()
        enc_tok = batch * min(seq, 4096)
        per = (2 * d * hd * 4 * a.n_heads + 2 * 2 * a.n_heads * hd
               * min(seq, 4096) + 2 * d * cfg.d_ff * (3 if cfg.glu else 2))
        fl += cfg.encoder.n_layers * enc_tok * per
        pbytes += cfg.encoder.n_layers * (
            d * hd * 4 * a.n_heads + d * cfg.d_ff * (3 if cfg.glu else 2)) * b

    act_bytes = tokens * d * b * 2 * len(pat)       # stream between blocks
    if kind == "train":
        fl *= 3.0                                   # fwd + 2x bwd
        pbytes *= 3.0                               # read w, read w, write g
        act_bytes *= 2.0                            # remat re-reads
    hbm = pbytes + kvb + act_bytes
    return StepCost(flops=fl, hbm_bytes=hbm, kv_bytes=kvb,
                    param_bytes=pbytes)
