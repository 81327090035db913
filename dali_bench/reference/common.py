"""The plain float32 decoder both configurations share: RMSNorm, half-split
RoPE, causal attention (grouped-query, or DeepSeek-V2's latent attention
decompressed), a SwiGLU FFN, the top-k router and routed plus shared
experts, the LM head.

It imports nothing of the program, and nothing of ``jax``.  It draws every
layer's weights again from the seed (``weights.py``), one layer at a time,
on the device it runs on, so what it holds at once is one layer in float32
and the hidden states of the sequences it is given.  TF32 is switched off
while it runs.

``mm`` is the matrix product of every projection, expert and the head:
``f32_mm`` for the reference, ``fp8_mm`` for the control (both operands
rounded to float8 e4m3 with a scale per row of the input and per column
of the weight, the lower precision a later change could be tempted by).
"""
from __future__ import annotations

import contextlib

import torch

from dali_bench.weights import draw_global, draw_layer

ATTN_BLOCK = 1024        # queries per block of the attention's scores
FP8_MAX = 448.0          # largest finite float8 e4m3


def f32_mm(x, w):
    return x @ w


def _fp8(t, dim):
    amax = t.abs().amax(dim=dim, keepdim=True).clamp(min=1e-30)
    scale = amax / FP8_MAX
    return (t / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


def fp8_mm(x, w):
    """``x @ w`` with both operands rounded to float8 e4m3 (per-row scales
    of ``x``, per-column scales of ``w``), accumulated in float32."""
    return _fp8(x, -1) @ _fp8(w, -2)


@contextlib.contextmanager
def no_tf32():
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev


def rms_norm(x, w, eps):
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * (1.0 + w)


def rope(x, positions, theta):
    """Rotate ``x`` (S, h, D) by ``positions`` (S,): the two halves of the
    last axis are the pair's two coordinates."""
    D = x.shape[-1]
    inv = 1.0 / (theta ** (torch.arange(0, D, 2, dtype=torch.float64,
                                        device=x.device) / D))
    ang = positions.to(torch.float64)[:, None] * inv
    c = torch.cos(ang).to(x.dtype)[:, None, :]
    s = torch.sin(ang).to(x.dtype)[:, None, :]
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)


def causal_attention(q, k, v, scale):
    """q (S, H, D), k (S, Hk, D), v (S, Hk, Dv), H a multiple of Hk ->
    (S, H, Dv); query blocks of ``ATTN_BLOCK`` rows."""
    S, H, _ = q.shape
    g = H // k.shape[1]
    k = k.repeat_interleave(g, dim=1).transpose(0, 1)        # (H, S, D)
    v = v.repeat_interleave(g, dim=1).transpose(0, 1)        # (H, S, Dv)
    out = []
    for a in range(0, S, ATTN_BLOCK):
        b = min(S, a + ATTN_BLOCK)
        s = torch.einsum("qhd,hkd->hqk", q[a:b], k[:, :b]) * scale
        mask = (torch.arange(b, device=q.device)[None, :]
                > torch.arange(a, b, device=q.device)[:, None])
        s = s.masked_fill(mask, float("-inf"))
        out.append(torch.einsum("hqk,hkd->qhd", torch.softmax(s, -1),
                                v[:, :b]))
    return torch.cat(out)


def gqa(w, x, positions, spec, mm):
    S = x.shape[0]
    H, KV, hd = spec["heads"], spec["kv_heads"], spec["head_dim"]
    q = rope(mm(x, w["wq"]).view(S, H, hd), positions, spec["rope_theta"])
    k = rope(mm(x, w["wk"]).view(S, KV, hd), positions, spec["rope_theta"])
    v = mm(x, w["wv"]).view(S, KV, hd)
    o = causal_attention(q, k, v, hd ** -0.5)
    return mm(o.reshape(S, H * hd), w["wo"])


def mla(w, x, positions, spec, mm):
    """Latent attention, decompressed: the latent ``ckv`` (normed) and the
    shared rotary key ``kpe`` make each head's key [ckv @ wuk, kpe] and
    value ckv @ wuv."""
    S = x.shape[0]
    H, nope, rp, vd, R = (spec["heads"], spec["nope"], spec["rope"],
                          spec["v_dim"], spec["kv_lora"])
    q = mm(x, w["wq"]).view(S, H, nope + rp)
    q = torch.cat([q[..., :nope],
                   rope(q[..., nope:], positions, spec["rope_theta"])], -1)
    dkv = mm(x, w["wdkv"])
    ckv = rms_norm(dkv[:, :R], w["ckv_norm"], spec["eps"])
    kpe = rope(dkv[:, None, R:], positions, spec["rope_theta"])  # (S,1,rp)
    k = torch.cat([mm(ckv, w["wuk"]).view(S, H, nope),
                   kpe.expand(S, H, rp)], -1)
    v = mm(ckv, w["wuv"]).view(S, H, vd)
    o = causal_attention(q, k, v, (nope + rp) ** -0.5)
    return mm(o.reshape(S, H * vd), w["wo"])


def swiglu(x, gate, up, down, mm):
    return mm(torch.nn.functional.silu(mm(x, gate)) * mm(x, up), down)


def route(x, router, spec):
    """(gates (T, k), experts (T, k)) of the top-k router."""
    logits = x @ router
    k = spec["top_k"]
    if spec["router"] == "topk_softmax":
        top, idx = logits.topk(k, dim=-1)
        return torch.softmax(top, -1), idx
    probs = torch.softmax(logits, -1)
    top, idx = probs.topk(k, dim=-1)
    if spec["renormalize"]:
        top = top / top.sum(-1, keepdim=True)
    return top * spec.get("scaling", 1.0), idx


def moe(w, x, spec, mm):
    gates, idx = route(x, w["router"], spec)
    y = torch.zeros_like(x)
    for e in range(spec["experts"]):
        tok, slot = (idx == e).nonzero(as_tuple=True)
        if tok.numel() == 0:
            continue
        ye = swiglu(x[tok], w["experts.gate"][e], w["experts.up"][e],
                    w["experts.down"][e], mm)
        y.index_add_(0, tok, ye * gates[tok, slot][:, None])
    if spec["shared_ff"]:
        y = y + swiglu(x, w["shared.gate"], w["shared.up"], w["shared.down"],
                       mm)
    return y


def forward_logits(spec, seed: int, seqs, rows, device, served_dtype,
                   mm=f32_mm):
    """Float32 logits of each sequence in ``seqs`` (lists of token ids) at
    its positions ``rows[i]`` -> list of (len(rows[i]), vocab) tensors.
    Every weight is drawn from ``seed`` in ``served_dtype`` (the values the
    program was given) and computed with in float32."""
    with no_tf32():
        g = {k: t.float() for k, t in
             draw_global(seed, spec, device, served_dtype).items()}
        ids = [torch.as_tensor(s, dtype=torch.long, device=device)
               for s in seqs]
        hs = [g["embed"][i] for i in ids]
        pos = [torch.arange(len(s), device=device) for s in seqs]
        attn = mla if spec["mla"] else gqa
        for layer in range(spec["layers"]):
            w = {k: t.float() for k, t in
                 draw_layer(seed, spec, layer, device, served_dtype).items()}
            for i, h in enumerate(hs):
                h = h + attn(w, rms_norm(h, w["norm1"], spec["eps"]), pos[i],
                             spec, mm)
                x = rms_norm(h, w["norm2"], spec["eps"])
                if layer < spec["first_dense"]:
                    h = h + swiglu(x, w["gate"], w["up"], w["down"], mm)
                else:
                    h = h + moe(w, x, spec, mm)
                hs[i] = h
            del w
        out = []
        for h, r in zip(hs, rows):
            x = rms_norm(h[torch.as_tensor(r, device=device)],
                         g["final_norm"], spec["eps"])
            out.append(mm(x, g["head"]))
        return out
