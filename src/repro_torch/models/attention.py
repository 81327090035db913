"""Attention variants (port of ``repro/models/attention.py``): GQA (rope,
qk-norm, sliding window, softcap), MLA, DeepSeek-V2's multi-head latent
attention, and cross-attention (VLM cross layers, the encoder-decoder's
decoder).

Cache convention (as in the reference): one dict per layer,
``{"k": (B, S_c, Hkv, D), "v": (B, S_c, Hkv, D), "pos": (B, S_c)}`` for
GQA and ``{"ckv": (B, S_c, R), "kpe": (B, S_c, Dr), "pos": (B, S_c)}`` for
MLA, where ``pos`` holds each row's absolute position per slot (-1 =
empty) and every mask is derived from it; cross-attention reads static
``{"k", "v"}`` (B, T_src, H, D) built from the source by ``build_cross_kv``.
``positions`` is ``(S,)``
shared by the batch (prefill) or ``(B, S)`` per row (decode: the
continuous server's per-slot positions, or the wave's shared position
broadcast to ``(B, 1)``, which writes and masks as the shared position
does and is never read on the host).

Unlike the reference, ``_update_cache`` writes into the cache tensors in
place (the caller's cache dict is updated and returned): a serving step
then never copies a layer's whole cache to change one row.  A rolling
(sliding-window) cache keeps every position at slot ``pos % S_c``, also
for a prefill longer than the window whose length the window does not
divide: the write wraps around the buffer in two pieces.  The reference's
``dynamic_update_slice`` clamps that write to slot 0 (ROADMAP.md, "Notes
on the reference").

Prefill (S > 1) runs the flash-attention kernel K3 over the fresh keys and
values: GQA's at its head width, MLA's over the decompressed per-head
keys of width ``qk_nope + qk_rope`` (192 for DeepSeek-V2-Lite) with the
values zero-padded to that width and the output sliced back, since K3
has one head width D as the Pallas kernel has; cross-attention's
non-causal over the source (Sq != Sk: the kernel's suffix-aligned query
positions matter only under a causal mask or a window).  ``_mha`` (the
float32 attention of decode and of K3's plain version) attends blockwise
from ``BLOCKWISE_KV_THRESHOLD`` keys on, as the reference's does.  Decode
attends over the cache in plain PyTorch, as the JAX package does it
outside any Pallas kernel (K3 has no per-row position mask); MLA's
absorbed decode attends in the latent space in float32.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.device import torch_dtype
from repro_torch.kernels.flash_attention.ops import attn_mask as _attn_mask
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.flash_attention.ops import \
    masked_scores as _masked_scores
from repro_torch.kernels.flash_attention.ops import mha as _mha
from repro_torch.kernels.flash_attention.ops import pos_rows as _pos_rows

from .config import ModelConfig
from .layers import apply_rope, dense_init, rms_norm_vec, rope_table

NEG_INF = -1e30


def init_attention(gen, cfg: ModelConfig, device, kind: str = "attn"):
    a = cfg.attn
    d, dt = cfg.d_model, cfg.param_dtype
    if a.mla is not None and kind != "cross":
        m = a.mla
        qk = m.qk_nope_head_dim + m.qk_rope_head_dim
        # with a query LoRA, wq maps the normalised rank-q_lora_rank query
        p = {
            "wq": dense_init(gen, (m.q_lora_rank or d, a.n_heads * qk), dt,
                             device),
            "wdkv": dense_init(gen, (d, m.kv_lora_rank + m.qk_rope_head_dim),
                               dt, device),
            "ckv_norm": torch.zeros((m.kv_lora_rank,),
                                    dtype=torch_dtype(dt), device=device),
            "wuk": dense_init(gen, (m.kv_lora_rank,
                                    a.n_heads * m.qk_nope_head_dim), dt,
                              device),
            "wuv": dense_init(gen, (m.kv_lora_rank, a.n_heads * m.v_head_dim),
                              dt, device),
            "wo": dense_init(gen, (a.n_heads * m.v_head_dim, d), dt, device),
        }
        if m.q_lora_rank:
            p["wdq"] = dense_init(gen, (d, m.q_lora_rank), dt, device)
            p["q_norm"] = torch.zeros((m.q_lora_rank,),
                                      dtype=torch_dtype(dt), device=device)
        return p
    hd = cfg.head_dim()
    # cross-attention: K and V with every query head, q/k norms and a
    # tanh gate (Llama-3.2-Vision's cross layers)
    n_kv = a.n_heads if kind == "cross" else a.n_kv_heads
    p = {
        "wq": dense_init(gen, (d, a.n_heads * hd), dt, device),
        "wk": dense_init(gen, (d, n_kv * hd), dt, device),
        "wv": dense_init(gen, (d, n_kv * hd), dt, device),
        "wo": dense_init(gen, (a.n_heads * hd, d), dt, device),
    }
    if a.qk_norm or kind == "cross":
        p["q_norm"] = torch.zeros((hd,), dtype=torch_dtype(dt), device=device)
        p["k_norm"] = torch.zeros((hd,), dtype=torch_dtype(dt), device=device)
    if kind == "cross":
        p["gate"] = torch.zeros((), dtype=torch_dtype(dt), device=device)
    return p


def _update_cache(cache, positions, **new):
    """Write new tokens (each ``new`` entry (B, S, ...) into the cache
    entry of its name) IN PLACE and return the cache.

    Shared positions (S,): every position lands at slot ``pos % S_c``; a
    chunk longer than the buffer keeps its last S_c tokens, and a chunk
    that runs past the buffer's end wraps to its start.  The slots are
    indexed on the positions' device, so the write reads nothing back to
    the host.  Per-slot positions (B, S): each row scatters to its own
    slots."""
    S_c = cache["pos"].shape[1]
    if positions.dim() == 2:
        slot = (positions % S_c).long()                       # (B, S)
        b_idx = torch.arange(positions.shape[0],
                             device=positions.device)[:, None]
        for key, t in new.items():
            cache[key][b_idx, slot] = t.to(cache[key].dtype)
        cache["pos"][b_idx, slot] = positions.to(cache["pos"].dtype)
        return cache
    if positions.shape[0] > S_c:
        new = {key: t[:, -S_c:] for key, t in new.items()}
        positions = positions[-S_c:]
    slot = (positions % S_c).long()
    new["pos"] = positions[None].expand(cache["pos"].shape[0],
                                        positions.shape[0])
    for key, t in new.items():
        cache[key][:, slot] = t.to(cache[key].dtype)
    return cache


def _check_prefill_positions(positions):
    if positions.dim() != 1:
        raise NotImplementedError("multi-token steps with per-slot positions "
                                  "are not on the serving path")


def gqa_attention(params, x, cfg: ModelConfig, *, kind: str, positions,
                  cache=None, causal: bool = True):
    """kind in {"attn", "attn_local", "attn_global"}.  Returns (y, cache').
    Under laid-out rules (``launch/sharding.py``) ``x`` is a DTensor and
    the layer runs ``_gqa_laid``."""
    from repro_torch.launch.sharding import layout_active
    if layout_active():
        return _gqa_laid(params, x, cfg, kind=kind, positions=positions,
                         cache=cache, causal=causal)
    a = cfg.attn
    hd = cfg.head_dim()
    B, S, _ = x.shape
    qn, kn = _qk_norms(params, cfg)
    rope = rope_table(_pos_rows(positions), hd, a.rope_theta)
    q = _heads(x @ params["wq"], hd, qn, rope)
    k = _heads(x @ params["wk"], hd, kn, rope)
    v = _heads(x @ params["wv"], hd)

    window = a.sliding_window if kind == "attn_local" else 0
    scale = 1.0 / math.sqrt(hd)
    if cache is not None and S == 1:
        cache = _update_cache(cache, positions, k=k, v=v)
        y = _mha(q, cache["k"], cache["v"], positions, cache["pos"],
                 causal=causal, window=window, softcap=a.attn_softcap,
                 scale=scale)
        return y @ params["wo"], cache
    _check_prefill_positions(positions)
    # prefill / full-sequence forward: the cache (if any) was empty, so the
    # fresh K/V are its whole content; positions are an arange, so the
    # kernel's suffix-aligned causal mask is the position mask
    if cache is not None:
        cache = _update_cache(cache, positions, k=k, v=v)
    y = _k3(q, k, v, cfg, causal=causal, window=window,
            softcap=a.attn_softcap, scale=scale)
    return y.reshape(B, S, a.n_heads * hd) @ params["wo"], cache


def _qk_norms(params, cfg: ModelConfig):
    """The query and key norms' weights, or (None, None) without qk-norm."""
    if cfg.attn.qk_norm:
        return params["q_norm"], params["k_norm"]
    return None, None


def _heads(t, hd: int, norm=None, rope=None):
    """A projection (B, S, n * hd) -> heads (B, S, n, hd), RMS-normed by
    ``norm`` and rotated by ``rope`` ((cos, sin) of ``rope_table``) where
    given.  The plain layer calls it on every head, the laid-out one on a
    rank's."""
    t = t.reshape(t.shape[0], t.shape[1], -1, hd)
    if norm is not None:
        t = rms_norm_vec(norm, t)
    if rope is not None:
        t = apply_rope(t, *rope)
    return t


def _k3(q, k, v, cfg: ModelConfig, **kw):
    """K3 over q / k / v -> (B, Sq, Hq, D) in q's dtype.  A float32 cross
    source promotes the cross keys and values, and the encoder, to float32
    (as the reference's source does); the kernel takes ``cfg.dtype``, so on
    the card such operands are rounded at its boundary.  On the CPU the
    plain version attends in float32 whatever their dtype."""
    dt = torch_dtype(cfg.dtype)
    if q.is_cuda and any(t.dtype != dt for t in (q, k, v)):
        return flash_attention(*(t.to(dt).contiguous() for t in (q, k, v)),
                               **kw).to(q.dtype)
    return flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                           **kw)


# --------------------------------------------------------------------------
# the laid-out layer (DTensor inputs under launch/sharding.py::rules)
# --------------------------------------------------------------------------

def _rows(positions, x):
    """Per-row positions (B, S) of ``x``'s local batch rows; shared (S,)
    positions as they are."""
    if positions.dim() == 1:
        return positions
    from repro_torch.launch import layout as lay
    b0 = lay.offset(x, 0)
    return positions[b0:b0 + x.to_local().shape[0]]


def _kv_block(j: int, hq_loc: int, n_heads: int, n_kv: int):
    """The KV heads [k0, k1) that query heads [j * hq_loc, (j+1) * hq_loc)
    read: a block of n_kv / tp heads, or one head that several ranks share
    where tp > n_kv."""
    g = n_heads // n_kv
    h0 = j * hq_loc
    return h0 // g, (h0 + hq_loc - 1) // g + 1


def _gqa_laid(params, x, cfg: ModelConfig, *, kind: str, positions, cache,
              causal: bool):
    """GQA on the layout: the query heads over 'model', the keys and values
    replicated over it (the reference's hints, ``attention.py:276-281``),
    the batch over the data axes.  K3 runs on each rank's query heads and
    the KV heads they read (``_k3_laid``).  A cache whose sequence is
    sharded (``cache_pspecs``' kv_seq) is written only by the rank that
    owns each position (``_write_laid``), and decode attends over the local
    sequence shard and combines the ranks' partial results by their
    log-sum-exp (``_decode_laid``).  Returns (y, cache'), y ``Partial``
    over 'model' (the row-parallel output projection)."""
    from repro_torch.launch import layout as lay
    from repro_torch.launch.mesh import axis_size
    from repro_torch.launch.sharding import hint
    a = cfg.attn
    hd = cfg.head_dim()
    Hq = a.n_heads
    tp = axis_size(lay.mesh(), "model")
    if Hq % tp:
        raise NotImplementedError(f"laid-out GQA needs the {Hq} query heads "
                                  f"to divide over 'model' = {tp}")
    hq_loc = Hq // tp
    S = x.shape[1]
    h = hint(x, "batch", "seq", "embed")
    hp = h.placements
    bs = tuple(lay.spec_from(hp, 3)[:2])
    heads = lay.place(bs + ("model", None))
    repl3 = lay.place(bs + (None,))
    # the keys' and values' columns lie as wk's do (whole where 'model'
    # does not divide them)
    kvcols = lay.place(bs + (lay.spec_from(params["wk"].placements, 2)[1],))
    qn, kn = _qk_norms(params, cfg)
    norms = [qn] if qn is not None else []
    pos = _rows(positions, h)

    def proj(h, wq, wk, wv, *qn):
        rope = rope_table(_pos_rows(pos), hd, a.rope_theta)
        return (_heads(h @ wq, hd, qn[0] if qn else None, rope), h @ wk,
                h @ wv)

    ws = [params["wq"], params["wk"], params["wv"]]
    q, k, v = lay.local_kernel(
        proj, [hp] + [lay.gathered_weight(w) for w in ws]
        + [lay.place((None,))] * len(norms), (heads, kvcols, kvcols))(
            h, *ws, *norms)
    k = hint(k, "batch", "seq", "kv_heads")
    v = hint(v, "batch", "seq", "kv_heads")
    window = a.sliding_window if kind == "attn_local" else 0
    scale = 1.0 / math.sqrt(hd)
    kn = [kn] if kn is not None else []

    def rope_kv(k, v, *kn):
        rope = rope_table(_pos_rows(pos), hd, a.rope_theta)
        return _heads(k, hd, kn[0] if kn else None, rope), _heads(v, hd)

    kv4 = lay.place(bs + (None, None))
    k, v = lay.local_kernel(rope_kv, [repl3, repl3]
                            + [lay.place((None,))] * len(kn),
                            (kv4, kv4))(k, v, *kn)
    if cache is not None:
        cache = _write_laid(cache, positions, k=k, v=v)
    if cache is not None and S == 1:
        y = _decode_laid(q, cache, positions, cfg, window=window,
                         causal=causal, scale=scale)
        return _out_proj_laid(y, params["wo"], Hq * hd, hq_loc * hd), cache
    _check_prefill_positions(positions)
    y = _k3_laid(q, k, v, cfg, causal=causal, window=window,
                 softcap=a.attn_softcap, scale=scale)
    return _out_proj_laid(y, params["wo"], None, None), cache


def _k3_laid(q, k, v, cfg: ModelConfig, **kw):
    """K3 on this rank's query heads (B, S, Hq/tp, D) and the KV heads they
    read (``_kv_block``), inside ``local_kernel`` -> (B, S, Hq/tp * D),
    the heads over 'model'."""
    from repro_torch.launch import layout as lay
    from repro_torch.launch.mesh import axis_index
    a = cfg.attn
    j = axis_index(lay.mesh(), "model")

    def core(q, k, v):
        B, S, hq_loc, hd = q.shape
        k0, k1 = _kv_block(j, hq_loc, a.n_heads, a.n_kv_heads)
        y = _k3(q, k[:, :, k0:k1], v[:, :, k0:k1], cfg, **kw)
        return y.reshape(B, S, hq_loc * hd)

    qp = q.placements
    return lay.local_kernel(core, [qp, k.placements, v.placements],
                            lay.place(tuple(lay.spec_from(qp, 4)[:2])
                                      + ("model",)))(q, k, v)


def _out_proj_laid(y, wo, width, loc_width):
    """y @ wo with wo's rows over 'model' -> ``Partial`` over 'model'.
    ``width`` set: y (B, S, width) holds every head on each rank, and each
    rank multiplies its own ``loc_width`` columns."""
    from repro_torch.launch import layout as lay
    from repro_torch.launch.mesh import axis_index
    yp = y.placements
    j = axis_index(lay.mesh(), "model")

    def proj(y, wo):
        if width is not None:
            y = y[..., j * loc_width:(j + 1) * loc_width]
        return y @ wo.to(y.dtype)

    spec = tuple(lay.spec_from(yp, 3)[:2]) + (None,)
    return lay.local_kernel(proj, [yp, lay.gathered_weight(wo)],
                            lay.place(spec, partial=("model",)))(y, wo)


def _write_laid(cache, positions, **new):
    """Write the fresh keys / values (each (B, S, ...), the batch as the
    cache's, the sequence whole) into the laid-out cache in place: each
    rank writes the positions its sequence shard holds.  Decode's per-row
    positions (B, 1) write one slot a row; a prefill's shared positions
    are 0..S-1 (every prefill of the port), written as the slice of them
    the shard holds.  A prefill longer than the cache (a rolling one)
    keeps its last S_c positions at slots ``pos % S_c``, as
    ``_update_cache`` does: slot j holds the latest position congruent to
    j, so a shard whose slots span the wrap takes positions from both
    sides of it."""
    from repro_torch.launch import layout as lay
    keys = list(new)
    ref = cache[keys[0]]
    S_c = ref.shape[1]
    s0 = lay.offset(ref, 1)
    pos_rows = _rows(positions, ref) if positions.dim() == 2 else positions

    def write(*ts):
        cs, ns, pos_c = ts[:len(keys)], ts[len(keys):-1], ts[-1]
        n = pos_c.shape[1]
        if pos_rows.dim() == 2:                   # decode: a slot a row
            li = (pos_rows % S_c).long() - s0            # (B, 1)
            own = (li >= 0) & (li < n)
            li = li.clamp(0, n - 1)
            b = torch.arange(li.shape[0], device=li.device)[:, None]
            for c, t in zip(cs, ns):
                keep = own.reshape(own.shape + (1,) * (t.dim() - 2))
                c[b, li] = torch.where(keep, t.to(c.dtype), c[b, li])
            pos_c[b, li] = torch.where(own, pos_rows.to(pos_c.dtype),
                                       pos_c[b, li])
        elif ns[0].shape[1] > S_c:
            # a prompt past a rolling cache: its last S_c positions, each
            # at slot pos % S_c, which every slot of every shard takes
            S = ns[0].shape[1]
            j = torch.arange(s0, s0 + n, device=pos_c.device)
            p = j + S_c * torch.div(S - 1 - j, S_c, rounding_mode="floor")
            for c, t in zip(cs, ns):
                c.copy_(t[:, p].to(c.dtype))
            pos_c.copy_(p.to(pos_c.dtype)[None].expand_as(pos_c))
        else:
            S = ns[0].shape[1]
            lo, hi = max(s0, 0), min(s0 + n, S)
            if lo < hi:
                for c, t in zip(cs, ns):
                    c[:, lo - s0:hi - s0] = t[:, lo:hi].to(c.dtype)
                pos_c[:, lo - s0:hi - s0] = torch.arange(
                    lo, hi, dtype=pos_c.dtype, device=pos_c.device)
        return (*cs, pos_c)

    cpl = [cache[k].placements for k in keys]
    npl = [new[k].placements for k in keys]
    ppl = cache["pos"].placements
    out = lay.local_kernel(write, cpl + npl + [ppl],
                           tuple(cpl) + (ppl,))(
        *[cache[k] for k in keys], *[new[k] for k in keys], cache["pos"])
    for k, t in zip(keys + ["pos"], out):
        cache[k] = t
    return cache


def _decode_laid(q, cache, positions, cfg: ModelConfig, *, window: int,
                 causal: bool, scale: float):
    """One decode token's attention over a laid-out cache: every query
    head on each rank (gathered over 'model'), the keys of the rank's
    sequence shard; the partial outputs with their max and sum are
    combined by their log-sum-exp (``_lse_combine``).  -> (B, 1, Hq * D),
    every head on every rank."""
    from repro_torch.launch import layout as lay
    a = cfg.attn
    kc, vc, pc = cache["k"], cache["v"], cache["pos"]
    base = lay.spec_from(kc.placements, 4)[:1]
    qrow = lay.place(tuple(base) + (None, None, None))
    pos = _rows(positions, kc)

    def partial(q, k, v, k_pos):
        B, Sq, Hq, D = q.shape
        Hkv = k.shape[2]
        s = _masked_scores(q.reshape(B, Sq, Hkv, Hq // Hkv, D), k, pos,
                           k_pos, causal=causal, window=window,
                           softcap=a.attn_softcap, scale=scale)
        m = s.amax(-1, keepdim=True)
        p = torch.exp(s - m)
        o = torch.einsum("bkgqs,bskd->bkgqd", p, v.float())
        part = torch.cat([o, m, p.sum(-1, keepdim=True)], dim=-1)
        return part.flatten(1, 2)[None]          # (1, B, Hq, Sq, D + 2)

    part = lay.local_kernel(
        partial, [qrow, kc.placements, vc.placements, pc.placements],
        lay.place((_seq_axes(kc),) + tuple(base) + (None,) * 3))(
            q, kc, vc, pc)
    D = q.shape[-1]
    o = _lse_combine(part, D, q.dtype, base)           # (B, Hq, Sq, D)

    def heads_last(o):
        B, H, Sq, _ = o.shape
        return o.permute(0, 2, 1, 3).reshape(B, Sq, H * D)

    return lay.local_kernel(heads_last, [o.placements],
                            lay.place(tuple(base) + (None, None)))(o)


def mla_attention(params, x, cfg: ModelConfig, *, positions, cache=None):
    """DeepSeek-V2's multi-head latent attention.  Returns (y, cache').

    The cache holds the normalised latent ``ckv`` (R wide) and the rotary
    key ``kpe`` (Dr wide, shared by the heads).  Prefill decompresses the
    fresh latents to per-head keys and values and runs K3 over them;
    decode attends over the cache, absorbed (``wuk`` folded into the
    query, ``wuv`` applied to the latent output, float32) or, with
    ``absorbed_decode=False``, decompressed as prefill does."""
    from repro_torch.launch.sharding import layout_active
    if layout_active():
        return _mla_laid(params, x, cfg, positions=positions, cache=cache)
    a, m = cfg.attn, cfg.attn.mla
    S = x.shape[1]
    H = a.n_heads
    nope, rp, vd, R = (m.qk_nope_head_dim, m.qk_rope_head_dim,
                       m.v_head_dim, m.kv_lora_rank)
    q_nope, q_pe, ckv, kpe = _mla_project(params, x, cfg, positions)
    scale = 1.0 / math.sqrt(nope + rp)

    if cache is not None and S == 1:
        cache = _update_cache(cache, positions, ckv=ckv, kpe=kpe[:, :, 0])
        ckv_all, kpe_all, k_pos = cache["ckv"], cache["kpe"], cache["pos"]
        if m.absorbed_decode:
            q_lat = _mla_fold(q_nope, params["wuk"], R)
            s = _mla_scores(q_lat, q_pe, ckv_all, kpe_all, positions, k_pos,
                            nope + rp)
            p = torch.softmax(s, dim=-1)                        # (B,H,1,S_c)
            o_lat = torch.einsum("bhqs,bsr->bqhr", p, ckv_all.float())
            y = _mla_unfold(o_lat, params["wuv"], R).to(x.dtype)
            return y @ params["wo"], cache
        k, v = _mla_decompress(params, ckv_all, kpe_all[:, :, None], H, nope,
                               rp, vd)
        y = _mha(torch.cat([q_nope, q_pe], dim=-1), k, v, positions, k_pos,
                 causal=True, window=0, softcap=0.0, scale=scale)
        return y @ params["wo"], cache

    # prefill / full-sequence forward over the fresh latents (the cache, if
    # any, was empty); positions are an arange, so K3's suffix-aligned
    # causal mask is the position mask
    _check_prefill_positions(positions)
    if cache is not None:
        cache = _update_cache(cache, positions, ckv=ckv, kpe=kpe[:, :, 0])
    y = _mla_prefill(q_nope, q_pe, ckv, kpe, params, cfg, scale)
    return y @ params["wo"], cache


def _mla_project(params, x, cfg: ModelConfig, positions):
    """MLA's projections: the queries of the heads ``wq`` holds (every
    head, or a rank's) split into their (B, S, h, nope) and rotated (B, S,
    h, rp) parts, the normalised latent ``ckv`` (B, S, R) and the rotated
    shared key ``kpe`` (B, S, 1, rp)."""
    rope = rope_table(_pos_rows(positions), cfg.attn.mla.qk_rope_head_dim,
                      cfg.attn.rope_theta)
    return (_mla_queries(params, x, cfg, rope)
            + _mla_latent(params, x, cfg, rope))


def _mla_queries(params, x, cfg: ModelConfig, rope):
    """(q_nope, q_pe) of ``_mla_project``; ``rope`` its (cos, sin)."""
    m = cfg.attn.mla
    nope, rp = m.qk_nope_head_dim, m.qk_rope_head_dim
    B, S, _ = x.shape
    if m.q_lora_rank:
        x = rms_norm_vec(params["q_norm"], x @ params["wdq"])
    q = (x @ params["wq"]).reshape(B, S, -1, nope + rp)
    return q[..., :nope], apply_rope(q[..., nope:], *rope)


def _mla_latent(params, x, cfg: ModelConfig, rope):
    """(ckv, kpe) of ``_mla_project``; ``rope`` its (cos, sin)."""
    R = cfg.attn.mla.kv_lora_rank
    dkv = x @ params["wdkv"]
    ckv = rms_norm_vec(params["ckv_norm"], dkv[..., :R])        # (B, S, R)
    kpe = dkv[..., R:][:, :, None, :]                           # (B,S,1,rp)
    return ckv, apply_rope(kpe, *rope)


def _mla_prefill(q_nope, q_pe, ckv, kpe, params, cfg: ModelConfig, scale):
    """K3 over the fresh latents: ``ckv`` (B, S, R) and ``kpe`` (B, S, 1,
    rp) decompressed by ``params``' ``wuk`` / ``wuv`` to the keys and values
    of the queries' h heads -> (B, S, h * vd)."""
    m = cfg.attn.mla
    nope, rp, vd = m.qk_nope_head_dim, m.qk_rope_head_dim, m.v_head_dim
    B, S, H = q_nope.shape[:3]
    k, v = _mla_decompress(params, ckv, kpe, H, nope, rp, vd)
    q_full = torch.cat([q_nope, q_pe], dim=-1)
    # K3 has one head width: the values are zero-padded to the keys' and
    # the padded output columns (zero) are dropped
    v = F.pad(v, (0, nope + rp - vd))
    y = flash_attention(q_full, k, v, causal=True, scale=scale)[..., :vd]
    return y.reshape(B, S, H * vd)


def _mla_fold(q_nope, wuk, R: int):
    """The absorbed decode's latent queries: ``wuk`` (R, h * nope) folded
    into q_nope (B, Sq, h, nope) -> (B, Sq, h, R) float32."""
    h, nope = q_nope.shape[2:]
    return torch.einsum("bqhn,rhn->bqhr", q_nope.float(),
                        wuk.reshape(R, h, nope).float())


def _mla_scores(q_lat, q_pe, ckv, kpe, q_pos, k_pos, width: int):
    """The absorbed decode's float32 scores (B, h, Sq, S_c) of the latent
    and rotary queries over cached latents (B, S_c, R) and rotary keys (B,
    S_c, rp), causal by position, NEG_INF where masked."""
    s = torch.einsum("bqhr,bsr->bhqs", q_lat, ckv.float())
    s = s + torch.einsum("bqhp,bsp->bhqs", q_pe.float(), kpe.float())
    s = s / math.sqrt(width)
    valid = _attn_mask(q_pos, k_pos, causal=True, window=0)
    return torch.where(valid[:, None], s, NEG_INF)


def _mla_unfold(o_lat, wuv, R: int):
    """The absorbed decode's latent output (B, Sq, h, R) float32 through
    ``wuv`` (R, h * vd) -> (B, Sq, h * vd) float32."""
    B, Sq, h, _ = o_lat.shape
    y = torch.einsum("bqhr,rhv->bqhv", o_lat,
                     wuv.reshape(R, h, -1).float())
    return y.reshape(B, Sq, -1)


def _mla_decompress(params, ckv, kpe, H, nope, rp, vd):
    """Latents (B, Sk, R) and rotary keys (B, Sk, 1, rp) -> per-head keys
    (B, Sk, H, nope + rp) and values (B, Sk, H, vd)."""
    B, Sk = ckv.shape[:2]
    k_nope = (ckv @ params["wuk"]).reshape(B, Sk, H, nope)
    v = (ckv @ params["wuv"]).reshape(B, Sk, H, vd)
    k = torch.cat([k_nope, kpe.expand(B, Sk, H, rp).to(k_nope.dtype)],
                  dim=-1)
    return k, v


def _mla_laid(params, x, cfg: ModelConfig, *, positions, cache):
    """MLA on the layout: the query heads (``wq``, ``wuk``, ``wuv``) over
    'model', the latent and rotary key (``wdkv``) computed whole on each
    rank.  Prefill decompresses each rank's heads and runs K3 on them;
    the cache's latents lie with the sequence sharded (written by
    ``_write_laid``); the absorbed decode gathers every head's latent
    query, attends over the rank's sequence shard and combines the
    partials by their log-sum-exp (``_lse_combine``).  -> (y ``Partial``
    over 'model', cache')."""
    from repro_torch.launch import layout as lay
    from repro_torch.launch.mesh import axis_size
    from repro_torch.launch.sharding import hint
    m = cfg.attn.mla
    H = cfg.attn.n_heads
    tp = axis_size(lay.mesh(), "model")
    if H % tp or not m.absorbed_decode:
        raise NotImplementedError(f"laid-out MLA needs the {H} heads to "
                                  f"divide over 'model' = {tp} and the "
                                  "absorbed decode")
    S = x.shape[1]
    h = hint(x, "batch", "seq", "embed")
    bs = tuple(lay.spec_from(h.placements, 3)[:2])
    pos = _rows(positions, h)
    rope = lambda: rope_table(_pos_rows(pos), m.qk_rope_head_dim,
                              cfg.attn.rope_theta)
    qn = (["wdq", "q_norm"] if m.q_lora_rank else []) + ["wq"]
    kvn = ["wdkv", "ckv_norm"]

    def queries(h, *ws):
        q_nope, q_pe = _mla_queries(dict(zip(qn, ws)), h, cfg, rope())
        return q_nope.contiguous(), q_pe

    def latent(h, *ws):
        ckv, kpe = _mla_latent(dict(zip(kvn, ws)), h, cfg, rope())
        return ckv, kpe[:, :, 0]

    # two regions: the heads' queries differ across 'model', the latent
    # is each rank's whole (one region with both would declare the
    # latent's weights' gradients Partial, each rank's share, where every
    # rank holds the whole)
    heads = lay.place(bs + ("model", None))
    whole = lay.place(bs + (None,))
    gathered = lambda names: [lay.gathered_weight(params[k]) for k in names]
    q_nope, q_pe = lay.local_kernel(
        queries, [h.placements] + gathered(qn), (heads, heads))(
            h, *[params[k] for k in qn])
    ckv, kpe = lay.local_kernel(
        latent, [h.placements] + gathered(kvn), (whole, whole))(
            h, *[params[k] for k in kvn])
    if cache is not None:
        cache = _write_laid(cache, positions, ckv=ckv, kpe=kpe)
    scale = 1.0 / math.sqrt(m.qk_nope_head_dim + m.qk_rope_head_dim)
    wuk, wuv = params["wuk"], params["wuv"]
    if cache is not None and S == 1:
        y = _mla_decode_laid(q_nope, q_pe, cache, positions, wuk, wuv, cfg)
        return _out_proj_laid(y, params["wo"], None, None), cache
    _check_prefill_positions(positions)

    def core(q_nope, q_pe, ckv, kpe, wuk, wuv):
        return _mla_prefill(q_nope, q_pe, ckv, kpe[:, :, None],
                            {"wuk": wuk, "wuv": wuv}, cfg, scale)

    y = lay.local_kernel(
        core, [heads, heads, whole, whole, lay.gathered_weight(wuk),
               lay.gathered_weight(wuv)],
        lay.place(bs + ("model",)))(q_nope, q_pe, ckv, kpe, wuk, wuv)
    return _out_proj_laid(y, params["wo"], None, None), cache


def _lse_combine(part, D: int, out_dtype, base):
    """Partial attention results (n, B, H, Sq, D + 2): each shard's
    unnormalised output, max and sum, all-gathered over the axes that shard
    the sequence (dim 0) -> their log-sum-exp combination (B, H, Sq, D)."""
    from repro_torch.launch import layout as lay

    def combine(part):
        o, m, l = part[..., :D], part[..., D:D + 1], part[..., D + 1:]
        mx = m.amax(0, keepdim=True)
        w = torch.exp(m - mx)
        return ((o * w).sum(0) / (l * w).sum(0).clamp(min=1e-30)).to(
            out_dtype)

    nd = part.dim()
    return lay.local_kernel(
        combine, [lay.place((None,) + tuple(base) + (None,) * (nd - 2))],
        lay.place(tuple(base) + (None,) * (nd - 2)))(part)


def _seq_axes(t):
    """The mesh axes that shard a cache tensor's sequence (dim 1)."""
    from repro_torch.launch import layout as lay
    from torch.distributed.tensor import Shard
    names = lay.mesh().mesh_dim_names
    axes = [names[m] for m, p in enumerate(t.placements)
            if isinstance(p, Shard) and p.dim == 1]
    return tuple(axes) if len(axes) > 1 else axes[0] if axes else None


def _mla_decode_laid(q_nope, q_pe, cache, positions, wuk, wuv,
                     cfg: ModelConfig):
    """The absorbed decode over a laid-out latent cache: each rank folds
    ``wuk`` into its heads' queries, every head's latent query is gathered
    over 'model', each rank attends over its sequence shard, the partials
    are combined (``_lse_combine``), and each rank applies ``wuv`` to its
    heads' latent output -> (B, 1, H/tp * vd), the heads over 'model'."""
    from repro_torch.launch import layout as lay
    from repro_torch.launch.mesh import axis_index
    m = cfg.attn.mla
    R, vd = m.kv_lora_rank, m.v_head_dim
    width = m.qk_nope_head_dim + m.qk_rope_head_dim
    ckv_c, kpe_c, pc = cache["ckv"], cache["kpe"], cache["pos"]
    base = lay.spec_from(ckv_c.placements, 3)[:1]
    heads = q_nope.placements

    q_lat = lay.local_kernel(lambda q, w: _mla_fold(q, w, R),
                             [heads, lay.gathered_weight(wuk)],
                             heads)(q_nope, wuk)
    pos = _rows(positions, ckv_c)
    allh = lay.place(tuple(base) + (None, None, None))

    def partial(q_lat, q_pe, ckv, kpe, k_pos):
        s = _mla_scores(q_lat, q_pe, ckv, kpe, pos, k_pos, width)
        mx = s.amax(-1, keepdim=True)
        p = torch.exp(s - mx)
        o = torch.einsum("bhqs,bsr->bhqr", p, ckv.float())
        return torch.cat([o, mx, p.sum(-1, keepdim=True)], dim=-1)[None]

    part = lay.local_kernel(
        partial, [allh, allh, ckv_c.placements, kpe_c.placements,
                  pc.placements],
        lay.place((_seq_axes(ckv_c),) + tuple(base) + (None,) * 3))(
            q_lat, q_pe, ckv_c, kpe_c, pc)
    o_lat = _lse_combine(part, R, torch.float32, base)   # (B, H, 1, R)
    j = axis_index(lay.mesh(), "model")

    def expand(o_lat, wuv):
        hl = wuv.shape[1] // vd
        o = o_lat[:, j * hl:(j + 1) * hl].permute(0, 2, 1, 3)
        return _mla_unfold(o, wuv, R).to(q_nope.dtype)

    return lay.local_kernel(
        expand, [o_lat.placements, lay.gathered_weight(wuv)],
        lay.place(tuple(base) + (None, "model")))(o_lat, wuv)


# --------------------------------------------------------------------------
# Cross-attention (VLM cross layers / enc-dec decoder)
# --------------------------------------------------------------------------

def build_cross_kv(params, src, cfg: ModelConfig):
    """Keys and values (B, T, H, D) of the encoder / vision embeddings
    ``src`` (B, T, d), every query head its own, in the dtype that ``src``
    and the weights promote to (float32 for the reference's float32
    source over bfloat16 weights).  Under laid-out rules ``src`` is a
    DTensor and ``build_cross_kv_laid`` runs."""
    from repro_torch.launch.sharding import layout_active
    if layout_active():
        return build_cross_kv_laid(params, src, cfg)
    return _cross_kv_of(params, src, cfg.head_dim())


def _cross_kv_of(params, src, hd: int):
    """The cross keys and values of the heads ``wk`` / ``wv`` hold (every
    head, or a rank's): (B, T, h, hd) each."""
    B, T, _ = src.shape
    dt = torch.promote_types(src.dtype, params["wk"].dtype)
    src = src.to(dt)
    k = (src @ params["wk"].to(dt)).reshape(B, T, -1, hd)
    v = (src @ params["wv"].to(dt)).reshape(B, T, -1, hd)
    if "k_norm" in params:
        k = rms_norm_vec(params["k_norm"], k)
    return {"k": k, "v": v}


def cross_attention(params, x, cfg: ModelConfig, cross_kv):
    """x (B, S, d) attends to every source position, unmasked.  A prompt
    (S > 1) runs K3 non-causal over the T source keys; decode (S = 1)
    attends in plain PyTorch, as the self-attention's decode does.  Under
    laid-out rules ``cross_attention_laid`` runs."""
    from repro_torch.launch.sharding import layout_active
    if layout_active():
        return cross_attention_laid(params, x, cfg, cross_kv)
    y = _cross_core(x, params["wq"], cross_kv["k"], cross_kv["v"], cfg,
                    params.get("q_norm"))
    y = y @ params["wo"]
    return apply_gate(y, params["gate"]) if "gate" in params else y


def _cross_core(x, wq, k, v, cfg: ModelConfig, q_norm=None):
    """The query heads of ``x`` (B, S, d) through ``wq`` (every head, or a
    rank's) attending, unmasked, to their own keys and values (B, T, h,
    D): K3 non-causal for a prompt (S > 1), the plain attention for decode
    -> (B, S, h * D)."""
    hd = cfg.head_dim()
    B, S, _ = x.shape
    q = _heads(x @ wq, hd, q_norm)
    scale = 1.0 / math.sqrt(hd)
    if S > 1:
        y = _k3(q, k, v, cfg, causal=False, scale=scale)
    else:
        zeros = lambda n: torch.zeros((n,), dtype=torch.int32,
                                      device=x.device)
        y = _mha(q, k, v, zeros(S), zeros(k.shape[1]), causal=False,
                 window=0, softcap=0.0, scale=scale)
    return y.reshape(B, S, -1)


def apply_gate(y, gate):
    """``tanh(gate) * y`` for a scalar ``gate``; under laid-out rules (a
    replicated ``gate``) on the local tensors of ``y``, a ``Partial`` sum
    too (the scaling is linear)."""
    from repro_torch.launch import layout as lay
    fn = lambda y, g: torch.tanh(g.float()).to(y.dtype) * y
    if not lay.is_dtensor(y):
        return fn(y, gate)
    return lay.local_kernel(fn, [y.placements, lay.place(())],
                            y.placements)(y, gate)


def build_cross_kv_laid(params, src, cfg: ModelConfig):
    """``build_cross_kv`` on the layout: the source (B, T, d) with its
    batch over the data axes and its positions as the logical map lays
    'frames'; ``wk`` / ``wv`` column-parallel, so the keys and values (B,
    T, H, D) come with their heads over 'model' (whole where 'model' does
    not divide them)."""
    from repro_torch.launch import layout as lay
    from repro_torch.launch.sharding import hint
    hd = cfg.head_dim()
    src = hint(src, "batch", "frames", "embed")
    bs = tuple(lay.spec_from(src.placements, 3)[:2])
    heads = lay.place(bs + (lay.spec_from(params["wk"].placements, 2)[1],
                            None))
    norms = [params["k_norm"]] if "k_norm" in params else []

    def proj(src, wk, wv, *kn):
        ckv = _cross_kv_of(dict(wk=wk, wv=wv, **dict(zip(("k_norm",), kn))),
                           src, hd)
        return ckv["k"], ckv["v"]

    ws = [params["wk"], params["wv"]]
    k, v = lay.local_kernel(
        proj, [src.placements] + [lay.gathered_weight(w) for w in ws]
        + [lay.place((None,))] * len(norms), (heads, heads))(src, *ws, *norms)
    return {"k": k, "v": v}


def cross_attention_laid(params, x, cfg: ModelConfig, cross_kv):
    """``cross_attention`` on the layout: the query heads over 'model'
    (column-parallel ``wq``), each rank attending with its heads to their
    own keys and values (Hkv = Hq): fresh ones lie with their heads over
    'model' as ``build_cross_kv_laid`` makes them; a cache's lie whole
    (``cache_pspecs``), and each rank slices its heads out.  A prompt runs
    K3 non-causal on the local heads, decode the plain attention.  The
    row-parallel ``wo`` leaves the output ``Partial`` over 'model', and
    the tanh gate scales that partial sum (it is linear)."""
    from repro_torch.launch import layout as lay
    from repro_torch.launch.mesh import axis_index, axis_size
    from repro_torch.launch.sharding import hint
    H = cfg.attn.n_heads
    tp = axis_size(lay.mesh(), "model")
    if H % tp:
        raise NotImplementedError(f"laid-out cross-attention needs the {H} "
                                  f"heads to divide over 'model' = {tp}")
    hl = H // tp
    j = axis_index(lay.mesh(), "model")
    h = hint(x, "batch", "seq", "embed")
    bs = tuple(lay.spec_from(h.placements, 3)[:2])
    norms = [params["q_norm"]] if "q_norm" in params else []
    k, v = cross_kv["k"], cross_kv["v"]

    def core(h, wq, k, v, *qn):
        if k.shape[2] != hl:                # a cache's heads, every one
            k, v = k[:, :, j * hl:(j + 1) * hl], v[:, :, j * hl:(j + 1) * hl]
        return _cross_core(h, wq, k, v, cfg, qn[0] if qn else None)

    y = lay.local_kernel(
        core, [h.placements, lay.gathered_weight(params["wq"]),
               k.placements, v.placements]
        + [lay.place((None,))] * len(norms),
        lay.place(bs + ("model",)))(h, params["wq"], k, v, *norms)
    y = _out_proj_laid(y, params["wo"], None, None)
    return apply_gate(y, params["gate"]) if "gate" in params else y
