"""Mamba2 block via State-Space Duality (SSD), arXiv:2405.21060 (port of
``repro/models/mamba.py``).

Two execution modes sharing one parameter set:
  * ``ssd_chunked``  — training / prefill: chunked block-decomposition of the
    semiseparable matrix (intra-chunk quadratic blocks + inter-chunk
    recurrence).  Where the reference carries the state through
    ``lax.scan``, the port loops in Python over views of the chunks; every
    O(L^2) intermediate lives inside one iteration (O(B·H·L^2) memory per
    chunk, not O(B·H·S·L)).
  * ``ssd_decode``   — single-token recurrent update on the (B,H,P,N) state.

The reference computes SSD in ``jnp`` outside any Pallas kernel, so plain
PyTorch (``einsum`` / ``matmul``) is its port; no CUDA kernel stands here.

State cache convention (as in the reference), updated IN PLACE like the
port's attention caches:
  {"ssm": (B, H, P, N) f32,
   "conv_x": (B, d_conv-1, d_inner), "conv_B"/"conv_C": (B, d_conv-1, G*N)}
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.device import torch_dtype

from .config import ModelConfig
from .layers import dense_init


def _dims(cfg: ModelConfig):
    mb = cfg.mamba
    d_in = mb.d_inner(cfg.d_model)
    H = mb.n_heads(cfg.d_model)
    return mb, d_in, H, mb.head_dim, mb.n_groups, mb.d_state


def init_mamba(gen, cfg: ModelConfig, device):
    """Projections per stream (z, x, B, C, dt), depthwise conv filters and
    biases, and the float32 ``dt_bias``, ``A_log`` and ``D`` (the reference
    initialises those three in float32 whatever ``param_dtype`` is)."""
    mb, d_in, H, P, G, N = _dims(cfg)
    dt = cfg.param_dtype
    d = cfg.d_model
    f32 = dict(dtype=torch.float32, device=device)
    u = torch.empty((H,), **f32).uniform_(math.log(1e-3), math.log(1e-1),
                                          generator=gen)
    dt0 = torch.exp(u)
    conv_scale = 1.0 / np.sqrt(mb.d_conv)
    zeros = lambda n: torch.zeros((n,), dtype=torch_dtype(dt), device=device)
    return {
        "wz": dense_init(gen, (d, d_in), dt, device),
        "wx": dense_init(gen, (d, d_in), dt, device),
        "wB": dense_init(gen, (d, G * N), dt, device),
        "wC": dense_init(gen, (d, G * N), dt, device),
        "wdt": dense_init(gen, (d, H), dt, device),
        "conv_x": dense_init(gen, (mb.d_conv, d_in), dt, device,
                             scale=conv_scale),
        "conv_B": dense_init(gen, (mb.d_conv, G * N), dt, device,
                             scale=conv_scale),
        "conv_C": dense_init(gen, (mb.d_conv, G * N), dt, device,
                             scale=conv_scale),
        "conv_bx": zeros(d_in),
        "conv_bB": zeros(G * N),
        "conv_bC": zeros(G * N),
        "dt_bias": dt0 + torch.log(-torch.expm1(-dt0)),
        "A_log": torch.log(torch.empty((H,), **f32).uniform_(
            1.0, 16.0, generator=gen)),
        "D": torch.ones((H,), **f32),
        "norm_w": zeros(d_in),
        "out_proj": dense_init(gen, (d_in, d), dt, device),
    }


def _causal_conv(x, w, b):
    """Depthwise causal conv over full sequence: x (B,S,C), w (K,C)."""
    K = w.shape[0]
    S = x.shape[1]
    pad = F.pad(x, (0, 0, K - 1, 0))
    y = sum(pad[:, i:i + S, :] * w[i][None, None, :] for i in range(K))
    return F.silu(y + b[None, None, :])


def _conv_step(window, w, b):
    """Single-token conv: window (B,K,C), w (K,C) -> (B,C)."""
    return F.silu(torch.einsum("bkc,kc->bc", window, w) + b[None, :])


def _segsum(x):
    """x (..., L) -> (..., L, L): ss[i,j] = sum_{k=j+1..i} x_k, -inf above."""
    L = x.shape[-1]
    cs = torch.cumsum(x, dim=-1)
    ss = cs[..., :, None] - cs[..., None, :]
    mask = torch.ones((L, L), dtype=torch.bool, device=x.device).tril()
    return torch.where(mask, ss, -math.inf)


def ssd_chunked(xh, dt, A, Bm, Cm, cfg: ModelConfig, init_state=None):
    """xh (B,S,H,P), dt (B,S,H) post-softplus, A (H,) negative,
    Bm/Cm (B,S,G,N).  Returns (y (B,S,H,P) f32, final_state (B,H,P,N))."""
    mb = cfg.mamba
    Bsz, S_in, H, P = xh.shape
    G, N = Bm.shape[2], Bm.shape[3]
    L = min(mb.chunk_size, S_in)
    pad = (-S_in) % L
    xh, dt, Bm, Cm = (t.float() for t in (xh, dt, Bm, Cm))
    if pad:   # padded positions get dt=0: no decay, no input
        zp = lambda t: F.pad(t, (0, 0) * (t.dim() - 2) + (0, pad))
        xh, dt, Bm, Cm = zp(xh), zp(dt), zp(Bm), zp(Cm)
    rep = H // G
    st = (xh.new_zeros((Bsz, H, P, N)) if init_state is None
          else init_state.float())
    ys = []
    for c0 in range(0, S_in + pad, L):
        xk, dtk, Bk, Ck = (t[:, c0:c0 + L] for t in (xh, dt, Bm, Cm))
        dA = dtk * A[None, None, :]                         # (B,L,H)
        dAcs = torch.cumsum(dA, dim=1)
        Lmat = torch.exp(_segsum(dA.transpose(1, 2)))       # (B,H,L,L)
        scores = torch.einsum("blgn,bsgn->bgls", Ck, Bk)    # (B,G,L,L)
        scores = scores.repeat_interleave(rep, dim=1)       # (B,H,L,L)
        # y_diag[b,l,h,p] = sum_s scores*Lmat[b,h,l,s] dt[b,s,h] x[b,s,h,p]
        w = scores * Lmat * dtk.transpose(1, 2)[:, :, None, :]
        y_diag = torch.matmul(w, xk.transpose(1, 2)).transpose(1, 2)
        # contribution of the carried state
        Ck_h = Ck.repeat_interleave(rep, dim=2) if G != H else Ck
        y_off = torch.einsum("blhn,bhpn->blhp", Ck_h, st) \
            * torch.exp(dAcs)[..., None]
        # chunk state update
        decay_states = torch.exp(dAcs[:, -1:, :] - dAcs)    # (B,L,H)
        # summed over the groups, as the reference's einsum does (every
        # config has one group)
        s_new = torch.einsum("blgn,blhp->bhpn", Bk,
                             (dtk * decay_states)[..., None] * xk)
        st = st * torch.exp(dAcs[:, -1, :])[:, :, None, None] + s_new
        ys.append(y_diag + y_off)
    y = torch.cat(ys, dim=1)[:, :S_in]
    return y, st


def ssd_decode(xh, dt, A, Bm, Cm, state):
    """Single-token recurrence.  xh (B,H,P), dt (B,H), Bm/Cm (B,G,N),
    state (B,H,P,N) -> (y (B,H,P) f32, state')."""
    H = xh.shape[1]
    rep = H // Bm.shape[1]
    xh, dt, Bm, Cm, state = (t.float() for t in (xh, dt, Bm, Cm, state))
    Bh = Bm.repeat_interleave(rep, dim=1)                   # (B,H,N)
    Ch = Cm.repeat_interleave(rep, dim=1)
    dA = torch.exp(dt * A[None, :])                         # (B,H)
    state = state * dA[:, :, None, None] + \
        (dt[:, :, None] * xh)[..., None] * Bh[:, :, None, :]
    y = torch.einsum("bhpn,bhn->bhp", state, Ch)
    return y, state


def _gated_norm(w, y, z, eps=1e-6):
    """RMSNorm(y * silu(z)) — mamba2's norm-after-gate."""
    u = _gate(y, z)
    return _norm(w, u, (u * u).mean(-1, keepdim=True), eps)


def _gate(y, z):
    """The gated norm's input y * silu(z), float32."""
    return y.float() * F.silu(z.float())


def _norm(w, u, ms, eps=1e-6):
    """The gated norm's output from the gate ``u`` and its mean square
    ``ms`` over every channel (a sum over ranks where the channels are
    laid out)."""
    return u * torch.rsqrt(ms + eps) * (1.0 + w.float())


def apply_mamba(params, x, cfg: ModelConfig, cache=None):
    """x (B,S,d).  cache None -> full-sequence SSD; cache + S>1 -> prefill
    from the cached conv window and state; cache + S==1 -> recurrent
    decode.  Returns (y (B,S,d), cache), the cache written in place.
    Under laid-out rules ``x`` is a DTensor and ``_mamba_laid`` runs."""
    from repro_torch.launch.sharding import layout_active
    if layout_active():
        return _mamba_laid(params, x, cfg, cache)
    y, z = _ssm(params, x, cfg, cache, _dims(cfg))
    y = _gated_norm(params["norm_w"], y, z)
    return y.to(x.dtype) @ params["out_proj"], cache


def _ssm(params, x, cfg: ModelConfig, cache, dims):
    """The layer up to its gated norm, over ``dims`` (``_dims``' tuple, or
    a rank's share of the heads and channels): -> (y (B,S,d_in) float32,
    z), the cache written in place."""
    mb, d_in, H, P, G, N = dims
    B, S, _ = x.shape
    z = x @ params["wz"]
    xs_r = x @ params["wx"]
    Bm_r = x @ params["wB"]
    Cm_r = x @ params["wC"]
    dt_r = x @ params["wdt"]
    A = -torch.exp(params["A_log"])

    if cache is None or S > 1:
        if cache is not None:
            cat = lambda c, t: torch.cat([c.to(t.dtype), t], dim=1)
            xs_r = cat(cache["conv_x"], xs_r)
            Bm_r = cat(cache["conv_B"], Bm_r)
            Cm_r = cat(cache["conv_C"], Cm_r)
        hx = _causal_conv(xs_r, params["conv_x"], params["conv_bx"])[:, -S:]
        hB = _causal_conv(Bm_r, params["conv_B"], params["conv_bB"])[:, -S:]
        hC = _causal_conv(Cm_r, params["conv_C"], params["conv_bC"])[:, -S:]
        xh = hx.reshape(B, S, H, P)
        Bm = hB.reshape(B, S, G, N)
        Cm = hC.reshape(B, S, G, N)
        dts = F.softplus(dt_r.float() + params["dt_bias"][None, None, :])
        init_state = None if cache is None else cache["ssm"]
        y, st = ssd_chunked(xh, dts, A, Bm, Cm, cfg, init_state)
        y = y + params["D"][None, None, :, None] * xh.float()
        y = y.reshape(B, S, d_in)
        if cache is not None:
            K = mb.d_conv
            cache["ssm"].copy_(st)
            for key, t in (("conv_x", xs_r), ("conv_B", Bm_r),
                           ("conv_C", Cm_r)):
                cache[key].copy_(t[:, -(K - 1):])
    else:
        cat = lambda c, t: torch.cat([c.to(t.dtype), t], dim=1)
        wx_ = cat(cache["conv_x"], xs_r)
        wB_ = cat(cache["conv_B"], Bm_r)
        wC_ = cat(cache["conv_C"], Cm_r)
        hx = _conv_step(wx_, params["conv_x"], params["conv_bx"])
        hB = _conv_step(wB_, params["conv_B"], params["conv_bB"])
        hC = _conv_step(wC_, params["conv_C"], params["conv_bC"])
        xh = hx.reshape(B, H, P)
        Bm = hB.reshape(B, G, N)
        Cm = hC.reshape(B, G, N)
        dts = F.softplus(dt_r[:, 0].float() + params["dt_bias"][None, :])
        y, st = ssd_decode(xh, dts, A, Bm, Cm, cache["ssm"])
        y = y + params["D"][None, :, None] * xh.float()
        y = y.reshape(B, 1, d_in)
        cache["ssm"].copy_(st)
        for key, t in (("conv_x", wx_), ("conv_B", wB_), ("conv_C", wC_)):
            cache[key].copy_(t[:, 1:])

    return y, z


def _mamba_laid(params, x, cfg: ModelConfig, cache):
    """The Mamba-2 layer on the layout (the reference's hints,
    ``mamba.py:168-169``): the inner channels and the heads over 'model'
    (``param_pspecs`` / ``cache_pspecs``), B and C replicated (one group).
    Each rank runs the SSD over its heads inside ``local_kernel``; the
    gated norm's mean square over every channel is summed over 'model';
    the row-parallel output projection is ``Partial`` over 'model'."""
    from repro_torch.launch import layout as lay
    from repro_torch.launch.mesh import axis_index, axis_size
    from repro_torch.launch.sharding import hint
    mb, d_in, H, P, G, N = _dims(cfg)
    tp = axis_size(lay.mesh(), "model")
    if G != 1 or H % tp:
        raise NotImplementedError(f"laid-out Mamba needs one group and the "
                                  f"{H} heads to divide over 'model' = {tp}")
    hl = H // tp
    h0 = axis_index(lay.mesh(), "model") * hl
    dims = (mb, d_in // tp, hl, P, G, N)
    h = hint(x, "batch", "seq", "embed")
    bspec = lay.spec_from(h.placements, 3)[:2]
    names = ("wz", "wx", "wB", "wC", "wdt", "conv_x", "conv_B", "conv_C",
             "conv_bx", "conv_bB", "conv_bC", "dt_bias", "A_log", "D")
    ckeys = sorted(cache) if cache is not None else []

    def core(h, *ts):
        p = dict(zip(names, ts[:len(names)]))
        c = dict(zip(ckeys, ts[len(names):])) or None
        p["wdt"] = p["wdt"][:, h0:h0 + hl]
        for k in ("dt_bias", "A_log", "D"):
            p[k] = p[k][h0:h0 + hl]
        u = _gate(*_ssm(p, h, cfg, c, dims))
        return (u, (u * u).sum(-1, keepdim=True)) + tuple(
            c[k] for k in ckeys)

    ws = [params[k] for k in names]
    cs = [cache[k] for k in ckeys]
    out = lay.local_kernel(
        core, [h.placements] + [lay.gathered_weight(w) for w in ws]
        + [c.placements for c in cs],
        (lay.place(tuple(bspec) + ("model",)),
         lay.place(tuple(bspec) + (None,), partial=("model",)))
        + tuple(c.placements for c in cs))(h, *ws, *cs)
    u, ss = out[0], out[1]
    if cache is not None:
        cache = dict(cache, **dict(zip(ckeys, out[2:])))
    ss = ss.redistribute(ss.device_mesh, lay.place(tuple(bspec) + (None,)))

    def norm_out(u, ss, w, wo):
        return _norm(w, u, ss / d_in).to(x.dtype) @ wo

    wo = params["out_proj"]
    y = lay.local_kernel(
        norm_out, [u.placements, ss.placements,
                   lay.gathered_weight(params["norm_w"]),
                   lay.gathered_weight(wo)],
        lay.place(tuple(bspec) + (None,), partial=("model",)))(
            u, ss, params["norm_w"], wo)
    return y, cache


def init_mamba_cache(cfg: ModelConfig, batch: int, device, dtype=None):
    mb, d_in, H, P, G, N = _dims(cfg)
    K = mb.d_conv
    dt = torch_dtype(dtype or cfg.dtype)
    z = lambda *shape, d=dt: torch.zeros(shape, dtype=d, device=device)
    return {"ssm": z(batch, H, P, N, d=torch.float32),
            "conv_x": z(batch, K - 1, d_in),
            "conv_B": z(batch, K - 1, G * N),
            "conv_C": z(batch, K - 1, G * N)}
