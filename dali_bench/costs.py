"""Operations and bytes, counted by the benchmark from the configuration
and the traffic, never from the program.

The closed forms follow the program's ``launch/costs.py`` (matmul FLOPs
= 2*m*n*k; attention counts q.k and p.v; MLA as its decompressed prefill
and its absorbed decode), frozen here, with two changes that make them
the work these inputs need: the routed experts count the top-k rows each
token takes (no capacity padding), and attention counts each token's own
causal context.  The LM head counts the rows a server samples from: the
last prompt position of a prefill and each decode step's token.

Peaks: NVIDIA's H100 SXM data sheet, dense bf16 989 TFLOP/s, HBM3 3.35 TB/s
(both at the 700 W power limit).
"""
from __future__ import annotations

PEAK_FLOPS = 989e12
PEAK_BYTES = 3.35e12


def elem_bytes(cfg: dict) -> int:
    return 2 if cfg["torch_dtype"] in ("bfloat16", "float16") else 4


def expert_bytes(spec: dict, esz: int) -> int:
    """One routed expert's three matrices."""
    return 3 * spec["d"] * spec["expert_ff"] * esz


def _attn_proj(spec: dict) -> float:
    """Attention FLOPs per token outside the scores (projections)."""
    d, H = spec["d"], spec["heads"]
    if spec["mla"]:
        nope, rp, vd, R = (spec["nope"], spec["rope"], spec["v_dim"],
                           spec["kv_lora"])
        fl = 2 * d * H * (nope + rp) + 2 * d * (R + rp) + 2 * H * vd * d
        # prefill decompresses each token's latent once; the absorbed decode
        # folds wuk / wuv into the query and the output instead, at the
        # same count
        return fl + 2 * R * H * (nope + vd)
    hd, KV = spec["head_dim"], spec["kv_heads"]
    return 2 * d * hd * (2 * H + 2 * KV)


def _attn_ctx(spec: dict, decode: bool) -> float:
    """Attention FLOPs per (query, key) pair (q.k + p.v)."""
    H = spec["heads"]
    if spec["mla"]:
        if decode:       # absorbed: attends in the latent space
            return 2 * H * (2 * spec["kv_lora"] + spec["rope"])
        return 2 * H * (spec["nope"] + spec["rope"] + spec["v_dim"])
    return 2 * 2 * H * spec["head_dim"]


def _mlp_per_token(spec: dict, layer: int) -> float:
    d = spec["d"]
    if layer < spec["first_dense"]:
        return 6 * d * spec["dense_ff"]
    fl = 2 * d * spec["experts"] + spec["top_k"] * 6 * d * spec["expert_ff"]
    if spec["shared_ff"]:
        fl += 6 * d * spec["shared_ff"]
    return fl


def prefill_flops(spec: dict, L: int) -> float:
    """Model FLOPs of one prompt of ``L`` tokens and its first token."""
    pairs = L * (L + 1) / 2
    fl = 0.0
    for layer in range(spec["layers"]):
        fl += L * (_attn_proj(spec) + _mlp_per_token(spec, layer))
        fl += pairs * _attn_ctx(spec, False)
    return fl + 2 * spec["d"] * spec["vocab"]


def decode_flops(spec: dict, context: int) -> float:
    """Model FLOPs of one decode token that attends ``context`` keys."""
    fl = 0.0
    for layer in range(spec["layers"]):
        fl += _attn_proj(spec) + _mlp_per_token(spec, layer)
        fl += context * _attn_ctx(spec, True)
    return fl + 2 * spec["d"] * spec["vocab"]


def request_flops(spec: dict, prompt_len: int, n_out: int) -> float:
    """A request's model FLOPs: its prefill (which gives the first output
    token) and its ``n_out - 1`` decode steps."""
    fl = prefill_flops(spec, prompt_len)
    for i in range(1, n_out):
        fl += decode_flops(spec, prompt_len + i)
    return fl


def k2_prefill_bound(spec: dict, L: int, esz: int) -> dict:
    """K2's roofline over one prompt of ``L`` tokens, summed over the MoE
    layers: FLOPs = L * top_k * 6*d*f a layer; bytes = each needed expert's
    three matrices once a layer (min(E, L * top_k) experts) plus the rows
    in and out.  -> {flops, bytes, seconds, by}."""
    d, f, k, E = spec["d"], spec["expert_ff"], spec["top_k"], spec["experts"]
    n = spec["moe_layers"]
    flops = n * L * k * 6 * d * f
    nbytes = n * (min(E, L * k) * expert_bytes(spec, esz)
                  + 2 * L * k * d * esz)
    t_ops, t_bytes = flops / PEAK_FLOPS, nbytes / PEAK_BYTES
    return {"flops": flops, "bytes": nbytes, "seconds": max(t_ops, t_bytes),
            "by": "operations" if t_ops >= t_bytes else "bytes"}


def step_mfu(spec: dict, requests, window_s: float) -> float:
    """The model FLOPs of ``requests`` (``request_flops``) over
    ``window_s`` at the bf16 peak, in %."""
    fl = sum(request_flops(spec, len(r.prompt), len(r.output))
             for r in requests)
    return 100.0 * fl / (window_s * PEAK_FLOPS)
