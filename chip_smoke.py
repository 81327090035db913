#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

  python3 chip_smoke.py

Run from the root of a checkout on a machine with a CUDA card and the
CUDA toolkit.  It exits non-zero, printing no result, without a card or
outside a checkout.  Phases (any failure exits non-zero):

1. device  — the card's name, the device count and ``nvidia-smi``'s name
   and power limit;
2. build   — the hand-written kernels (``src/repro_torch/csrc``), compiled
   with ``nvcc`` for ``sm_90a`` into ``build/kernels/``;
3. kernels — each kernel at the main path's shapes against its plain
   PyTorch version on the card (exact indices for the router; 3e-2
   relative to max |ref| for the bfloat16 kernels), with its time, the
   plain version's, one PyTorch library call's (CUDA events, and for the
   kernel and the library call also device time from a torch.profiler
   window) and the card's bound; then each wrapper's host cost per call;
4. reference — the port on the card (kernels) against the port on the CPU
   (plain versions) on the same small bfloat16 model;
5. serve   — Mixtral-8x7B at its published widths, depth cut to 8
   layers, random bfloat16 weights from a seed: residual calibration,
   then ``MarkovCorpus`` requests through ``ContinuousBatchServer`` with
   the ``dali`` policy at batch 8 and at batch 2.  The kernel launch
   counters are zeroed just before this phase and read just after it;
   every kernel of the path must have launched.

The second-to-last line is the ``kernels`` JSON object, the last line
``{"ok": true, "device": {...}}``.
"""
import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

HBM_BYTES_S = 3.35e12        # H100 SXM memory rate
BF16_FLOP_S = 989e12         # H100 SXM dense bf16 tensor-core peak
F32_FLOP_S = 67e12           # H100 SXM float32 outside the tensor cores
BF16_TOL = 3e-2              # tests/test_kernels.py's bfloat16 tolerance
TPU = "src/repro/kernels/"
REPLACES = {
    "gating": TPU + "gating/kernel.py:72",
    "expert_ffn_dense": TPU + "expert_ffn/kernel.py:153",
    "expert_ffn_grouped": TPU + "expert_ffn/kernel.py:188",
    "expert_ffn_ragged": TPU + "expert_ffn/kernel.py:210",
    "flash_attention": TPU + "flash_attention/kernel.py:115",
}
SOURCE = {
    "gating": "src/repro_torch/csrc/gating.cu",
    "expert_ffn_dense": "src/repro_torch/csrc/expert_ffn.cu",
    "expert_ffn_grouped": "src/repro_torch/csrc/expert_ffn.cu",
    "expert_ffn_ragged": "src/repro_torch/csrc/expert_ffn.cu",
    "flash_attention": "src/repro_torch/csrc/flash_attention.cu",
}


def fail(msg):
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def cuda_ms(torch, fn, budget_s=0.25, max_iters=200):
    """Mean milliseconds of ``fn`` on the card: warmed, then timed with CUDA
    events over as many launches as fit ``budget_s``."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    once = time.perf_counter() - t0
    iters = max(3, min(max_iters, int(budget_s / max(once, 1e-6))))
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(torch, fn, iters=20):
    """Device time of ``fn`` per call: the summed durations of the card's
    own activity (kernels, copies, fills) that ``torch.profiler`` records
    over ``iters`` calls.  Unlike ``cuda_ms`` it does not include the gaps
    in which the card waits for the host to issue the next launch."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    us = sum(e.time_range.elapsed_us() for e in prof.events()
             if e.device_type == DeviceType.CUDA)
    return us / iters / 1e3


def host_us(torch, fn, calls=1000):
    """Host microseconds per call of ``fn`` over ``calls`` calls issued
    back to back without synchronising (what the caller's thread pays)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    us = (time.perf_counter() - t0) / calls * 1e6
    torch.cuda.synchronize()
    return us


def bound(nbytes, flops, peak):
    t_bytes = nbytes / HBM_BYTES_S * 1e3
    t_ops = flops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def rel_err(y, r):
    y, r = y.float(), r.float()
    return float((y - r).abs().max()) / (float(r.abs().max()) + 1e-6)


# --------------------------------------------------------------------------
# phase 3: each kernel against its plain version at the main path's shapes
# --------------------------------------------------------------------------

def kernel_phase(torch, cfg):
    from repro_torch.kernels.expert_ffn.ops import expert_ffn, expert_ffn_plain
    from repro_torch.kernels.flash_attention.ops import (
        flash_attention, flash_attention_plain)
    from repro_torch.kernels.gating.ops import gating, gating_plain
    from repro_torch.models.moe import expert_capacity

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    m = cfg.moe
    E, K, d, f = m.n_routed, m.top_k, cfg.d_model, m.d_expert
    rows = []

    def record(name, shape, err, ok, fn, plain_fn, lib_fn, b, plain_kw=None):
        """Time the kernel (``fn``), its plain version and the library call
        by CUDA events and the kernel and library call by device time."""
        ms, dms = cuda_ms(torch, fn), device_ms(torch, fn)
        plain_ms = cuda_ms(torch, plain_fn, **(plain_kw or {}))
        lib_ms, lib_dms = cuda_ms(torch, lib_fn), device_ms(torch, lib_fn)
        rows.append({"name": name, "shape": shape, "max_abs_err": err,
                     "ok": ok, "ms": ms, "device_ms": dms,
                     "plain_ms": plain_ms, "library_ms": lib_ms,
                     "library_device_ms": lib_dms, "bound_ms": b[0],
                     "bound_by": b[1]})
        print(f"kernel {name} [{shape}]: max_abs_err={err:.3e} "
              f"{'pass' if ok else 'FAIL'} kernel_ms={ms:.4f} "
              f"device_ms={dms:.4f} plain_ms={plain_ms:.4f} "
              f"library_ms={lib_ms:.4f} library_device_ms={lib_dms:.4f} "
              f"bound_ms={b[0]:.4f} ({b[1]})", flush=True)

    # -- K1: router over T rows of E logits -------------------------------
    for T in (256, 8):
        lg = torch.randn((T, E), generator=gen, device=dev) * 2
        g1, i1, p1 = gating(lg, K, m.router_type, m.renormalize)
        g2, i2, p2 = gating_plain(lg, K, m.router_type, m.renormalize)
        torch.cuda.synchronize()
        ok = bool(torch.equal(i1, i2)) and float((g1 - g2).abs().max()) < 1e-5
        err = max(float((g1 - g2).abs().max()), float((p1 - p2).abs().max()))
        nbytes = T * E * 4 * 2 + T * K * 8
        record("gating", f"T={T} E={E} k={K}", err, ok,
               lambda: gating(lg, K, m.router_type, m.renormalize),
               lambda: gating_plain(lg, K, m.router_type, m.renormalize),
               lambda: torch.softmax(torch.topk(lg, K).values, -1),
               bound(nbytes, T * E * (K + 4), F32_FLOP_S))

    # -- K2: one Mixtral layer's experts ----------------------------------
    s = 1.0 / math.sqrt(d)
    wg = (torch.randn((E, d, f), generator=gen, device=dev) * s).bfloat16()
    wu = (torch.randn((E, d, f), generator=gen, device=dev) * s).bfloat16()
    wd = (torch.randn((E, f, d), generator=gen, device=dev)
          / math.sqrt(f)).bfloat16()

    def routed_counts(T):
        idx = torch.randint(0, E, (T, K), generator=gen, device=dev)
        return torch.bincount(idx.reshape(-1), minlength=E).to(torch.int32)

    def lib_ffn(xe, wg_, wu_, wd_):
        h = torch.nn.functional.silu(torch.bmm(xe, wg_)) * torch.bmm(xe, wu_)
        return torch.bmm(h, wd_)

    def ffn_case(name, shape, xe, counts, eids):
        y = expert_ffn(xe, wg, wu, wd, counts=counts, expert_ids=eids)
        r = expert_ffn_plain(xe, wg, wu, wd, counts=counts, expert_ids=eids)
        torch.cuda.synchronize()
        err = float((y.float() - r.float()).abs().max())
        ok = rel_err(y, r) < BF16_TOL
        if counts is not None:
            tail = torch.arange(xe.shape[1], device=dev)[None] \
                >= counts[:, None]
            ok = ok and not bool(y[tail].float().abs().sum())
        if eids is None:
            lib = lambda: lib_ffn(xe, wg, wu, wd)
        else:
            el = eids.long()
            lib = lambda: lib_ffn(xe, wg[el], wu[el], wd[el])
        G, C = xe.shape[0], xe.shape[1]
        valid = (torch.full((G,), C, device=dev) if counts is None
                 else counts.clamp(0, C))
        used = valid > 0
        ids = torch.arange(G, device=dev) if eids is None else eids
        n_experts = len(set(ids[used].tolist()))
        n_rows = int(valid.sum())
        nbytes = n_experts * 3 * d * f * 2 + n_rows * d * 2 + G * C * d * 2
        record(name, shape, err, ok,
               lambda: expert_ffn(xe, wg, wu, wd, counts=counts,
                                  expert_ids=eids),
               lambda: expert_ffn_plain(xe, wg, wu, wd, counts=counts,
                                        expert_ids=eids), lib,
               bound(nbytes, 6.0 * d * f * n_rows, BF16_FLOP_S),
               plain_kw=dict(budget_s=0.5, max_iters=20))

    for T in (256, 64, 8):              # admission buckets, decode batch
        C = expert_capacity(m, T)
        xe = torch.randn((E, C, d), generator=gen, device=dev).bfloat16()
        ffn_case("expert_ffn_ragged", f"T={T} E={E} C={C} d={d} f={f}", xe,
                 routed_counts(T), None)
    G = 2 * K                           # batch 2 on the sparse decode path
    xe = torch.randn((G, 1, d), generator=gen, device=dev).bfloat16()
    ffn_case("expert_ffn_grouped", f"G={G} C=1 d={d} f={f}", xe,
             torch.ones((G,), dtype=torch.int32, device=dev),
             torch.randint(0, E, (G,), generator=gen, device=dev,
                           dtype=torch.int32))
    xe = torch.randn((E, 16, d), generator=gen, device=dev).bfloat16()
    ffn_case("expert_ffn_dense", f"E={E} C=16 d={d} f={f}", xe, None, None)
    del wg, wu, wd, xe

    # -- K3: causal GQA prefill attention ---------------------------------
    a = cfg.attn
    Hq, Hkv, D = a.n_heads, a.n_kv_heads, a.head_dim
    for S in (128, 256, 512):
        q = torch.randn((1, S, Hq, D), generator=gen, device=dev).bfloat16()
        k = torch.randn((1, S, Hkv, D), generator=gen, device=dev).bfloat16()
        v = torch.randn((1, S, Hkv, D), generator=gen, device=dev).bfloat16()
        o = flash_attention(q, k, v, causal=True)
        r = flash_attention_plain(q, k, v, causal=True)
        torch.cuda.synchronize()
        err = float((o.float() - r.float()).abs().max())
        ok = rel_err(o, r) < BF16_TOL
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        pairs = S * (S + 1) // 2
        record("flash_attention",
               f"B=1 S={S} Hq={Hq} Hkv={Hkv} D={D} causal", err, ok,
               lambda: flash_attention(q, k, v, causal=True),
               lambda: flash_attention_plain(q, k, v, causal=True),
               lambda: torch.nn.functional.scaled_dot_product_attention(
                   qt, kt, vt, is_causal=True, enable_gqa=True),
               bound((2 * S * Hq + 2 * S * Hkv) * D * 2,
                     4.0 * Hq * D * pairs, BF16_FLOP_S))
    torch.cuda.empty_cache()

    # -- host cost per wrapper call at decode forms; narrow widths so that
    # the card keeps pace and the host's own time per call is what is read
    lg = torch.randn((8, E), generator=gen, device=dev)
    w_ = lambda *shape: torch.randn(shape, generator=gen,
                                    device=dev).bfloat16()
    ws = (w_(E, 256, 256), w_(E, 256, 256), w_(E, 256, 256))
    xe, ones = w_(4, 1, 256), torch.ones((4,), dtype=torch.int32, device=dev)
    eids = torch.arange(4, dtype=torch.int32, device=dev)
    q, kv = w_(1, 32, Hq, D), w_(1, 32, Hkv, D)
    for name, fn in (
            ("gating T=8", lambda: gating(lg, K, m.router_type,
                                          m.renormalize)),
            ("expert_ffn grouped G=4 C=1 d=f=256",
             lambda: expert_ffn(xe, *ws, counts=ones, expert_ids=eids)),
            ("flash_attention S=32", lambda: flash_attention(q, kv, kv))):
        print(f"host {name}: {host_us(torch, fn):.1f} us per call "
              "(1000 calls, no synchronise)", flush=True)
    return rows


# --------------------------------------------------------------------------
# phase 4: the port on the card against the port on the CPU, small input
# --------------------------------------------------------------------------

def reference_phase(torch):
    from repro_torch.configs import get_config, make_smoke
    from repro_torch.models.attention import gqa_attention
    from repro_torch.models.model import (apply_model, collect_field,
                                          init_caches, init_model)
    from repro_torch.models.moe import apply_moe
    from repro_torch.tree import tree_map

    cfg = make_smoke(get_config("mixtral-8x7b")).replace(
        n_layers=2, dtype="bfloat16", param_dtype="bfloat16")
    cpu = init_model(cfg, seed=1, device="cpu")
    gpu = tree_map(lambda t: t.to("cuda"), cpu)
    layer = lambda p: tree_map(lambda t: t[0], p["scan"][0])
    rng = torch.Generator().manual_seed(2)
    checks = []

    def check(what, y_gpu, y_cpu, exact=False):
        y_gpu = y_gpu.cpu()
        ok = (torch.equal(y_gpu, y_cpu) if exact
              else rel_err(y_gpu, y_cpu) < BF16_TOL)
        checks.append(ok)
        print(f"reference {what}: "
              + ("exact" if exact else f"rel_err={rel_err(y_gpu, y_cpu):.3e}")
              + (" pass" if ok else " FAIL"), flush=True)

    for T in (24, 1):                   # dense sweep, sparse decode path
        x = torch.randn((1, T, cfg.d_model), generator=rng).bfloat16()
        y_c, i_c = apply_moe(layer(cpu)["mlp"], x, cfg)
        y_g, i_g = apply_moe(layer(gpu)["mlp"], x.cuda(), cfg)
        check(f"apply_moe T={T} y", y_g, y_c)
        check(f"apply_moe T={T} topk_idx", i_g["topk_idx"], i_c["topk_idx"],
              exact=True)
        check(f"apply_moe T={T} workload", i_g["workload"], i_c["workload"],
              exact=True)
    x = torch.randn((1, 20, cfg.d_model), generator=rng).bfloat16()
    pos = torch.arange(20, dtype=torch.int32)
    y_c, _ = gqa_attention(layer(cpu)["mixer"], x, cfg, kind="attn",
                           positions=pos)
    y_g, _ = gqa_attention(layer(gpu)["mixer"], x.cuda(), cfg, kind="attn",
                           positions=pos.cuda())
    check("gqa_attention prefill S=20", y_g, y_c)

    # whole model: right-padded admission prefill then two decode steps,
    # both devices fed the CPU's greedy tokens
    toks = torch.zeros((1, 32), dtype=torch.int32)
    toks[0, :21] = torch.randint(0, cfg.vocab, (21,), generator=rng)
    caches = {"cpu": init_caches(cfg, 1, 40, device="cpu"),
              "cuda": init_caches(cfg, 1, 40, device="cuda")}
    diverged = 0
    for step in range(3):
        if step == 0:
            kw = dict(positions=torch.arange(32, dtype=torch.int32),
                      logit_index=20)
            inp = toks
        else:
            kw = dict(positions=torch.tensor([[20 + step]],
                                             dtype=torch.int32))
            inp = nxt
        outs = {}
        for name, p in (("cpu", cpu), ("cuda", gpu)):
            kw_d = {k: (v.to(name) if torch.is_tensor(v) else v)
                    for k, v in kw.items()}
            logits, caches[name], infos = apply_model(
                p, inp.to(name), cfg, caches=caches[name], trace=True, **kw_d)
            outs[name] = (logits, collect_field(infos, "topk_idx"))
        nxt = outs["cpu"][0][:, -1:].argmax(-1).to(torch.int32)
        checks.append(bool(torch.isfinite(outs["cuda"][0][..., :cfg.vocab])
                           .all()))
        if torch.equal(outs["cuda"][1].cpu(), outs["cpu"][1]):
            check(f"model logits step {step}", outs["cuda"][0],
                  outs["cpu"][0])
        else:
            # a bf16 near-tie routed one token to another expert
            diverged += 1
            print(f"reference model step {step}: routing diverged between "
                  "devices (bf16 near-tie); logits not compared", flush=True)
    if diverged == 3:
        checks.append(False)
    return all(checks)


# --------------------------------------------------------------------------
# phase 5: serve Mixtral-8x7B through the port's main path
# --------------------------------------------------------------------------

def serve_phase(torch, kernels, name):
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.core.residual import calibrate_residuals
    from repro_torch.core.tracing import capture_decode_trace
    from repro_torch.data.pipeline import MarkovCorpus
    from repro_torch.models.model import apply_model, init_caches, init_model
    from repro_torch.serving.scheduler import Request
    from repro_torch.serving.spec import OffloadSpec, ServeSpec
    from repro_torch.serving.steps import default_dali_config
    from repro_torch.tree import tree_leaves

    full = get_config("mixtral-8x7b")
    cfg = full.replace(n_layers=8)
    print(f"serve: {cfg.name} at published widths (d_model {cfg.d_model}, "
          f"expert d_ff {cfg.moe.d_expert}, {cfg.attn.n_heads}q/"
          f"{cfg.attn.n_kv_heads}kv heads of {cfg.attn.head_dim}, vocab "
          f"{cfg.vocab}, {cfg.moe.n_routed} experts top-{cfg.moe.top_k}, "
          f"{cfg.dtype}); depth cut from {full.n_layers} to {cfg.n_layers} "
          "layers so every expert stays resident", flush=True)
    t0 = time.perf_counter()
    params = init_model(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    n_bytes = sum(t.numel() * t.element_size() for t in tree_leaves(params))
    print(f"serve: random weights from seed 0, {n_bytes / 1e9:.2f} GB, "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    corpus = MarkovCorpus(vocab=cfg.vocab, seed=0)
    rng = np.random.default_rng(1)
    kernels.reset_launch_counts()          # the main path starts here
    torch.cuda.reset_peak_memory_stats()
    calib = np.stack([corpus.sample(rng, 32) for _ in range(8)])
    res_vecs = np.stack(calibrate_residuals([capture_decode_trace(
        params, cfg, calib, n_decode=8)]))
    dali_cfg = default_dali_config(cfg, cache_ratio=0.5)
    results = []
    for batch, n_req in ((8, 16), (2, 4)):
        spec = ServeSpec(cfg=cfg, policy="dali", dali_cfg=dali_cfg,
                         batch_size=batch, max_len=256, eos_id=-1,
                         offload=OffloadSpec(mode="modeled"))
        server = spec.resolve(params).server(res_vecs=res_vecs)
        reqs = [Request(rid=i, prompt=corpus.sample(
            rng, int(rng.integers(24, 201))), max_new_tokens=32)
            for i in range(n_req)]
        for r in reqs:
            server.submit(r)
        t0 = time.perf_counter()
        done = server.run()
        wall = time.perf_counter() - t0
        results.append((batch, server, done, wall))
    torch.cuda.synchronize()
    counts = kernels.launch_counts()       # ... and ends here
    peak = torch.cuda.max_memory_allocated()

    ok = True
    for batch, server, done, wall in results:
        mt = server.metrics
        ttft = [r.ttft for r in done]
        budget_ok = len(done) == (16 if batch == 8 else 4) and all(
            len(r.output) == 32 for r in done)
        lookups_ok = mt.dali.lookups > 0
        ok = ok and budget_ok and lookups_ok
        print(f"serve batch={batch}: {len(done)} requests, "
              f"{mt.prefill_tokens} prompt tokens, {mt.decode_tokens} "
              f"decode tokens, {mt.steps} steps in {wall:.2f} s | "
              f"prefill {mt.prefill_tokens / mt.prefill_s:.1f} tok/s, "
              f"decode {mt.decode_tokens / mt.decode_s:.1f} tok/s, "
              f"TTFT p50 {np.percentile(ttft, 50) * 1e3:.1f} ms | "
              f"{mt.dali.summary()} lookups={mt.dali.lookups} | "
              f"budgets {'ok' if budget_ok else 'FAIL'} | on {name}",
              flush=True)
    print(f"serve: peak device memory {peak / 2**30:.2f} GiB on {name}",
          flush=True)

    # the served model's logits are finite and of the expected shape
    prompt = torch.as_tensor(corpus.sample(rng, 40)[None], device="cuda")
    logits, _, _ = apply_model(params, prompt, cfg,
                               caches=init_caches(cfg, 1, 64),
                               last_logit_only=True)
    pad_vocab = cfg.vocab + (-cfg.vocab) % 256
    finite = bool(torch.isfinite(logits[..., :cfg.vocab]).all())
    shape_ok = tuple(logits.shape) == (1, 1, pad_vocab)
    print(f"serve: logits {tuple(logits.shape)} finite={finite}", flush=True)

    # where the time goes: one more batch-8 serve under torch.profiler
    spec = ServeSpec(cfg=cfg, policy="dali", dali_cfg=dali_cfg, batch_size=8,
                     max_len=256, eos_id=-1)
    server = spec.resolve(params).server(res_vecs=res_vecs)
    for i in range(8):
        server.submit(Request(rid=i, prompt=corpus.sample(
            rng, int(rng.integers(24, 201))), max_new_tokens=16))
    profile_window(torch, server, name)
    return ok and finite and shape_ok, counts


KERNEL_GROUPS = (("K2 expert_ffn", ("ffn_gate_up_kernel", "ffn_down_kernel")),
                 ("K3 flash_attention", ("flash_kernel",)),
                 ("K1 gating", ("gating_kernel",)),
                 ("matmul (projections, router, lm head)",
                  ("gemm", "gemv", "cutlass", "xmma", "splitK")),
                 ("sort / scatter / index", ("sort", "Sort", "scatter",
                                             "index", "gather", "Scan")))


def profile_window(torch, server, name):
    """Device busy share and device time by kernel group over one serve."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        server.run()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    groups = {g: 0.0 for g, _ in KERNEL_GROUPS}
    groups["other (elementwise, reductions, copies)"] = 0.0
    busy = 0.0
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        us = e.time_range.elapsed_us()
        busy += us
        for g, keys in KERNEL_GROUPS:
            if any(k in e.name for k in keys):
                groups[g] += us
                break
        else:
            groups["other (elementwise, reductions, copies)"] += us
    mt = server.metrics
    print(f"profile batch=8 serve: wall {wall_us / 1e3:.1f} ms "
          f"(prefill {mt.prefill_s * 1e3:.1f} ms, decode "
          f"{mt.decode_s * 1e3:.1f} ms over {mt.steps} steps), device busy "
          f"{busy / 1e3:.1f} ms = {100 * busy / wall_us:.1f}% of wall, idle "
          f"{100 - 100 * busy / wall_us:.1f}% | on {name}", flush=True)
    for g, us in sorted(groups.items(), key=lambda kv: -kv[1]):
        print(f"profile   {g}: {us / 1e3:.2f} ms "
              f"({100 * us / max(busy, 1e-9):.1f}% of device time)",
              flush=True)


def main():
    if not (SRC / "repro_torch" / "csrc").is_dir():
        fail(f"{ROOT} is not a checkout of the repository "
             "(src/repro_torch is missing)")
    sys.path.insert(0, str(SRC))
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke run needs a "
             "CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # -- phase 1: device ----------------------------------------------------
    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 \
        else f"nvidia-smi failed: {smi.stderr.strip()}"
    print(f"device: {name} x{count} | torch {torch.__version__} cuda "
          f"{torch.version.cuda}", flush=True)

    # -- phase 2: build -----------------------------------------------------
    from repro_torch import kernels
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    build.library()
    print(f"build: {time.perf_counter() - t0:.1f} s "
          f"({build.BUILD_INFO.get('path')})", flush=True)

    # -- phase 3: kernels against their plain versions ----------------------
    from repro_torch.configs import get_config
    rows = kernel_phase(torch, get_config("mixtral-8x7b"))
    kernels_ok = all(r["ok"] for r in rows)

    # -- phase 4: the port on the card against the port on the CPU ----------
    reference_ok = reference_phase(torch)

    # -- phase 5: serve -----------------------------------------------------
    serve_ok, counts = serve_phase(torch, kernels, name)
    print(f"serve: kernel launches {json.dumps(counts)}", flush=True)
    launched_ok = all(counts[k] > 0 for k in (
        "gating", "expert_ffn_ragged", "expert_ffn_grouped",
        "flash_attention"))

    out = []
    for r in rows:
        out.append({"name": f"{r['name']} [{r['shape']}]", "route": "cuda",
                    "source": SOURCE[r["name"]],
                    "replaces": REPLACES[r["name"]],
                    "launches": counts[r["name"]],
                    "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                    "device_ms": r["device_ms"],
                    "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                    "bound_by": r["bound_by"],
                    "library_ms": r["library_ms"],
                    "library_device_ms": r["library_device_ms"]})
    print(card, flush=True)
    print(json.dumps({"kernels": out}), flush=True)
    failed = [p for p, ok in (("kernels", kernels_ok),
                              ("reference", reference_ok),
                              ("serve", serve_ok),
                              ("launches", launched_ok)) if not ok]
    if failed:
        fail("phases failed: " + ", ".join(failed))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": count}}), flush=True)


if __name__ == "__main__":
    main()
