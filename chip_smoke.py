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
   every kernel of the path must have launched;
6. offload — physical expert offload (pinned host store, device slot
   pool): at 8 layers the batch-2 requests of phase 5 in the blocking,
   overlap and pipelined modes with the fetch tier must give phase 5's
   tokens, and the host tier's first-step logits must be within 3e-2; then
   Mixtral-8x7B as deep as the host can pin, up to ``OFFLOAD_MAX_LAYERS``
   (12 of its 32: the depth cut that keeps the script inside its time
   limit), served pipelined at two cache ratios, must give identical
   tokens with
   peak device memory below the model's weight bytes.  Its launch counts
   are read on their own, like phase 5's;
7. wave    — ``BatchServer`` (the wave server) with ``dali`` at 8 layers:
   8 requests × 32 new tokens drawn as in phase 5, one wave left-padded to
   S = 223 (max_len 256 - 32 - 1), full-resident and then ``pipelined``
   with the fetch tier, whose tokens must equal full-resident's; K1, K2
   ragged and K3 must have launched (its counts read on their own).  Both
   runs pin the MoE capacity at the wave prefill's own C = 560: the
   prefill is then the published configuration's, and the full-resident
   decode (T = 8, the capacity sweep) keeps every row as the offloaded
   decode (the grouped slot path) does.  Unpinned, the full-resident
   decode's C = 4 drops rows and the tokens part, in the JAX package too;
8. policies — the first ``POLICY_REQUESTS`` (2) of phase 5's batch-2
   requests at 8 layers (cut from 4 for the time limit), offloaded
   (``pipelined``, fetch tier, cache ratio 0.25) through the continuous
   server under each of ``static``, ``all_gpu``, ``lru``, ``score``,
   ``statistical`` and ``random``: every policy must give phase 5's
   tokens; one line per policy with its rates and counters;
9. train   — (a) Mixtral-8x7B at its published widths, depth cut to 2
   layers, bfloat16, random weights from a seed: 3 AdamW steps at batch
   8 x 128 tokens through ``value_and_grad`` + ``adamw_update`` (the body
   of ``make_train_step``) with the kernels' autograd Functions; every
   param leaf must get a finite, non-zero gradient and K1, K2 ragged, K3
   and their three backward recomputes must have run (counts read on
   their own); per step the loss, grad norm, step time and peak device
   memory; then one more step through ``make_train_step`` under
   ``torch.profiler``, and each backward recompute timed beside one
   PyTorch autograd call of the same function.  (b) one step's
   gradients of a small bfloat16 model on the card against the same step
   on the CPU (plain versions): every leaf within 3e-2 relative to max
   |ref|, ce / aux / router_z within 3e-2, drops exact.  (c) the
   launcher's path: the smoke Mixtral at 4 layers trained 120 steps as
   ``repro/launch/serve.py`` trains it (ce must fall), residual vectors
   calibrated full-resident and through the ``pipelined`` slot pool
   (bit-equal), then batch-2 requests served full-resident and offloaded
   with them (identical tokens);
10. models — the paper's other two evaluation models, Qwen3-30B-A3B
   (qk-norm, 128 experts top-8) and DeepSeek-V2-Lite (MLA, one dense
   first layer, 2 shared experts beside 64 routed top-6), at published
   widths with random bfloat16 weights from seed 0: (a) the smoke model
   of each on the card against the CPU as phases 4 and 9 (b) do;
   (b) 8 layers full-resident (DeepSeek: 1 dense + 7 MoE), residual
   calibration, then ``dali`` through ``ContinuousBatchServer`` at batch
   8 (8 x 16 tokens) and batch 2 (4 x 16); K1's warp variant, K2 ragged
   and grouped and K3 must each have launched (counts zeroed just before
   and read just after), then one profiled batch-8 window; (c) the
   batch-2 requests offloaded (pipelined, fetch tier, cache ratio 0.25,
   calibrated through the slot pool) must give (b)'s tokens, with the
   routed stacks on the host and the dense prefix FFN and shared experts
   on the card; (d) every layer of each model (27 and 48), full-resident
   when it fits beside what the process holds (else pipelined at cache
   ratio 0.25, printed), 2 requests x 8 tokens at batch 2, with peak
   device memory and decode rate;
11. faults — fault-tolerant offload streaming on Mixtral-8x7B at 8
   layers (seed 0): (a) ``CostModel.calibrate_link`` on the card (the
   fitted GB/s, latency and whether the fit was rejected) and one
   expert's copy from the pinned store against its time at that rate, an
   expert's int8 twin and row checksums card against CPU; (b) phase 5's
   first two batch-2 requests (16 tokens) in the blocking, overlap and
   pipelined modes (fetch tier, cache ratio 0.25) under
   ``transient_stall@2-5``, ``read_error@1-4`` and ``corrupt_rows@1-8``
   must give phase 5's tokens with no plan dropped (every corrupt row
   caught and copied again), one line of counters per run; (c) in
   pipelined and overlap, phase 5's batch-2 requests under
   ``link_degrade:x12@5-25``: the ladder must go healthy -> degraded ->
   little -> healthy, every step before the first little step must give
   the fault-free run's logits bit for bit and the first little step's
   must be within 0.2 (relative norm) of them, K4 must launch in the
   little window (counts zeroed just before it, read just after it),
   and fresh requests after recovery must give the fault-free tokens;
   median ms per step per rung, time to recover, little_bytes and peak
   device memory are printed; (d) the launcher with ``--offload
   pipelined --faults transient_stall --check-exact`` must return;
12. long   — prompts past ``MOE_CHUNK_TOKENS``: Mixtral-8x7B at published
   widths, 8 layers, seed 0, two ``MarkovCorpus`` prompts of 20000 tokens
   (16 new tokens each, max_len 20018) through ``ContinuousBatchServer``
   with ``dali`` at batch 2; each admission is one B = 1 prefill of 20018
   positions, two MoE chunks of 16384 (the second padded and masked).
   (a) full-resident: K1, K2 ragged at C = 5120 and K3 must launch (counts
   zeroed just before and read just after); prefill rate, TTFT, decode
   rate at 20k context and peak device memory are printed; (b) the first
   admission's prefill with the kernels against the same prefill through
   the plain versions on the card (the blockwise attention included):
   first-token logits within 3e-2 relative to max |ref| and the same
   token; (c) the two requests offloaded (pipelined, fetch tier, cache
   ratio 0.25, residual vectors calibrated through the slot pool, equal to
   phase 5's) must give (a)'s tokens;
13. examples — each of ``repro_torch.examples``' ``train_tiny --tiny`` (its
   own check that the ce falls), ``quickstart`` (greedy makespan >= the
   optimal one, the DALI step's hits + misses > 0), ``offload_ablation``
   (every row, the four ``--offload`` modes' 20 timed steps) and
   ``serve_moe`` (16 requests) at the reference's defaults;
14. archs  — the nine architectures the port added last, bfloat16, random
   weights from seed 0: (a) each smoke model (its whole period, cross
   gates opened to 0.5) on the card against the CPU: a 20-token prefill
   (with a float32 cross source for the VLM and audio archs) and two
   decode steps, the first token's logits within 3e-2 with the same
   token; one training step at two seeds for OLMo, Mamba-2, Jamba,
   Gemma-2, Llama-3.2-Vision and Seamless (float32 cross sources for the
   last two), every gradient leaf within 3e-2 of the CPU's or, where
   bfloat16 cannot resolve the leaf, no farther from the float32 step
   than the farthest of three bfloat16 steps without the kernels or on
   the CPU plus 3e-2 (``train_parity``); (b) Jamba-1.5-Large at published widths, the shortest prefix of
   its pattern period with the attention layer and 2 MoE layers (5
   layers, 38.7 GB of experts; cut from the whole 8-layer period, 77.3
   GB, for the time limit), the routed stacks drawn into the pinned
   host store, residual vectors calibrated through the slot pool, then 4
   ``MarkovCorpus`` requests x 8 tokens at batch 2 through ``BatchServer``
   with ``dali``, pipelined, fetch tier, at cache ratio 0.25 and a second
   ratio (0.5 where its pool and staging fit on the card, else 0.125):
   identical tokens, K1, K4 and K3 launched (counts zeroed just before the
   serves, read just after); (c) Seamless, Llama-3-405B, Llama-4 Maverick,
   Qwen3-32B, Llama-3.2-Vision, Gemma-2, OLMo and Mamba-2 at published
   widths, at full depth where the weights fit beside what the process
   holds, else the depth that fits (printed), full-resident: 2 requests x
   8 tokens at batch 2 (the wave server for Mamba-2), the kernels each
   arch runs launched; Gemma-2 decodes after a 5000-token prompt (past
   its 4096 window, admitted at exact length) with every kept position at
   slot pos % 4096, within 3e-2 of the recompute at 8 layers and, at all
   42, within 1.5x of a 4000-token prompt's decode-vs-recompute gap
   (bfloat16 alone puts the two ~4.5e-2 apart there); Llama-3.2-Vision (1601 vision tokens) and Seamless (1024
   frames through its encoder) decode after a cross source within 3e-2
   of the recompute, K3 non-causal launched;
15. audit  — the serving-path audit on the card (run right after phase 5,
   on its 8-layer Mixtral-8x7B; (e) after phase 9): (a) ten full-resident
   batch-8 decode steps under ``torch.cuda.set_sync_debug_mode("error")``
   must not raise (the CPU census's zero host reads); (b) ten pipelined
   steps at cache ratio 0.25 under "warn": each step's synchronising calls
   against the host seams it entered (one ``read_misses`` per MoE layer
   must be among them); (c) one full-resident decode step captured in a
   ``torch.cuda.CUDAGraph`` on a side stream (printed, not gated); (d) the
   meta dry run's peak bytes of (a)'s decode against
   ``max_memory_allocated`` (within 2x); (e) phase 9's training step with
   ``remat=True`` and without, 3 steps each: ms, peak memory and the
   largest gradient difference (within 3e-2); K1, K2 ragged and grouped
   and K3 launched in (a)-(d) and K1, K2 ragged and K3 in (e) (counts
   zeroed just before, read just after);
16. ep     — expert parallelism (``models/moe_ep.py``), last, once this
   process has released the card: ranks spawned by
   ``launch/mesh.py::run_ranks`` (gloo, every rank on this one card, the
   exchanged buckets staged through host memory).  (a) Mixtral-8x7B at
   published widths, 2 layers, bfloat16, capacity factor 0, weights drawn
   on the card from seed 0 on each of 4 ranks of a (1, 4) mesh, each
   keeping its 2 experts: a B = 4 x S = 512 ``MarkovCorpus`` prefill
   through ``apply_model`` under ``rules(make_mesh(1, 4))`` (K1 on each
   rank's token shard, K4 over the received buckets, K3 replicated)
   against the single-process port on the same card (K2 ragged): logits
   within 3e-2, the first MoE layer's workload exact, no drops, ``ep_cx``
   at most C, the same logits on every rank; at the published capacity
   factor 1.25 the ragged and the dense exchange drop the same rows and
   agree within 3e-2; (b) the first MoE layer under a placement solved
   against a fabric whose busiest rank's link is 8x slower, weights
   re-sliced from a host copy, bit-equal to the unplaced layer; (c)
   ``launch/ep_serve.py::run_resilience_trials`` on 8 ranks at the
   reference's geometry and faults: all five verdicts.  The ranks' K1
   and K4 launches (counts zeroed just before (a)'s prefill, read just
   after) go into the ``kernels`` line; each rank's peak memory and
   ``ep_cx`` and the phase's seconds are printed;
17. layout — the GSPMD layout on DTensor (``launch/{sharding,layout,
   collectives}.py``), after phase 16: (a) Mixtral-8x7B at published
   widths, 2 layers, bfloat16, weights from seed 0 on 4 gloo ranks of a
   (2, 2) mesh sharing the card (their DTensor collectives staged through
   host memory by ``HostWire``); under ``tp`` and ``fsdp`` the B = 4 x S
   = 512 prefill (``prefill_32k``'s map; under ``tp`` the forward's logits
   too), greedy decode steps over a cache whose sequence lies over 'model'
   (``decode_32k``'s; 8 under ``tp``, 1 under ``fsdp``, whose every step
   gathers every weight through host memory: cut for the time limit), the
   gradients of a training step at B = 4 x 128 (``train_4k``'s), each
   against the single-process
   port on the same card: logits rows within 3e-2 where the token's
   experts are the single process's (at most 1 % of tokens differ: bf16
   near-ties), greedy tokens equal up to a tie, the gradients within 3e-2
   of the single process's step on the laid-out step's routing; K1, K2
   ragged and K3 launched in every rank (counts zeroed just before, read
   just after; the reference's launches excluded); (b) the fake process
   group's ``meta`` run of the same steps counts the same collectives,
   kind for kind and byte for byte; (c) the dry run of Mixtral-8x7B
   decode_32k on the production mesh (``pod``, ``multi-pod``): per-card
   peak, weight mode, collective bytes by axis, the three roofline terms
   (data-sheet predictions).

Phase 3 also times K3 and K2 ragged at phase 7's wave shapes, K1, K3
and K2 ragged at phase 9's training shapes (T = 1024 rows; B = 8 x
S = 128; C = 320), and K2 ragged at the continuous server's 512-token
admission bucket (C = 160), and phase 10's shapes: K1's warp variant at
E = 128 k = 8 and E = 64 k = 6 (T = 8, 256), K2 ragged over the 256-token
bucket and grouped over a batch-8 decode at d = 2048, f = 768 / 1408, and
K3 at Qwen3's GQA (D = 128, G = 8) and DeepSeek-V2-Lite's MLA (D = 192,
the 128-wide values zero-padded), S = 128..512, and phase 12's: K2
ragged over one 16384-token chunk (C = 5120) and K3 at B = 1, S = 20018
against its blockwise plain version, and phase 14's: K1 at Jamba's router
(E = 16 top-2) and Llama-4's (E = 128 top-1 sigmoid), K2 ragged over
Jamba's and Llama-4's expert stacks (3.2e9 and 5.4e9 elements a stack,
past 2^31), K4 over Jamba's pool sweep and a decode reading the stack's
far end, and K3 at a VLM cross layer (Sq = 64, Sk = 1601, non-causal),
Seamless's encoder (S = 1024, D = 64), Gemma-2's local layer at S = 5000
(window 4096, softcap 50, D = 256; its library call is a compiled
``flex_attention``), Llama-3-405B
(G = 16), Llama-4 (G = 5, K/V heads repeated) and Jamba's attention
layer, and phase 16's: K4 at the expert-parallel group layout (8 groups
over 2 weight sets, C = 256, counts from a routed draw; its library call
three ``bmm`` over (2, 4 x 256, d)).  Phase 6's full-depth
serve calibrates its residual vectors through the slot pool.  Each phase
prints its seconds.  The second-to-last line is the
``kernels`` JSON object, the last line ``{"ok": true, "device": {...}}``.
"""
import contextlib
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
    "gating_warp": TPU + "gating/kernel.py:72",
    "expert_ffn_dense": TPU + "expert_ffn/kernel.py:153",
    "expert_ffn_grouped": TPU + "expert_ffn/kernel.py:188",
    "expert_ffn_ragged": TPU + "expert_ffn/kernel.py:210",
    "flash_attention": TPU + "flash_attention/kernel.py:115",
}
SOURCE = {
    "gating": "src/repro_torch/csrc/gating.cu",
    "gating_warp": "src/repro_torch/csrc/gating.cu",
    "expert_ffn_dense": "src/repro_torch/csrc/expert_ffn.cu",
    "expert_ffn_grouped": "src/repro_torch/csrc/expert_ffn.cu",
    "expert_ffn_ragged": "src/repro_torch/csrc/expert_ffn.cu",
    "flash_attention": "src/repro_torch/csrc/flash_attention.cu",
}


# phase 7's wave: 8 prompts drawn as in phase 5 (24-200 tokens, from this
# seed), 32 new tokens each, max_len 256; the wave pads to S = 223
WAVE_BATCH, WAVE_NEW, WAVE_SEED, MAX_LEN = 8, 32, 9, 256
# phase 9: full-width steps at batch 8 x 128 tokens (the ragged K2 bucket
# is then C = 320), and the JAX launcher's smoke training (120 steps of
# batch 8 x 64, repro/launch/serve.py:114)
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS, TRAIN_LAYERS = 8, 128, 3, 2
SMOKE_STEPS = 120
POLICIES = ("static", "all_gpu", "lru", "score", "statistical", "random")
POLICY_REQUESTS = 2
# phase 10: the paper's other two evaluation models (tag, arch)
NEW_MODELS = (("qwen3", "qwen3-30b-a3b"), ("deepseek", "deepseek-v2-lite-16b"))
# phase 12: two prompts of 20000 tokens, each admitted as one B = 1 prefill
# of max_len = 20018 tokens: two MoE chunks of 16384 (the second with 3634
# real rows, the rest pad) and K3 over 20018 positions
LONG_LEN, LONG_MAX, LONG_NEW, LONG_SEED = 20000, 20018, 16, 12


def wave_prompts(cfg):
    """Phase 7's prompts and the wave's padded length S, as
    ``BatchServer`` computes it."""
    import numpy as np

    from repro_torch.data.pipeline import MarkovCorpus
    from repro_torch.serving.scheduler import _bucket_len
    corpus = MarkovCorpus(vocab=cfg.vocab, seed=0)
    rng = np.random.default_rng(WAVE_SEED)
    prompts = [corpus.sample(rng, int(rng.integers(24, 201)))
               for _ in range(WAVE_BATCH)]
    raw = max(len(p) for p in prompts)
    return prompts, _bucket_len(raw, 16, max(raw, MAX_LEN - WAVE_NEW - 1))


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
    # a window now and then records no device activity at all (one read
    # 0.0 ms on the H100 for a kernel that takes 1.6 us): take it again
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        us = sum(e.time_range.elapsed_us() for e in prof.events()
                 if e.device_type == DeviceType.CUDA)
        if us > 0:
            break
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


def row_rel_err(y, r):
    """The largest, over rows (every index but the last), of a row's max
    |y - r| over that row's max |r|.  Attention outputs shrink along a
    causal prompt (row i averages i + 1 values), so one scale for the whole
    output would let the late rows drift by many times their own size; each
    query row and head is held to its own."""
    y, r = y.float().flatten(0, -2), r.float().flatten(0, -2)
    return float(((y - r).abs().amax(-1)
                  / (r.abs().amax(-1) + 1e-6)).max())


# --------------------------------------------------------------------------
# phase 3: each kernel against its plain version at the main path's shapes
# --------------------------------------------------------------------------

def kernel_phase(torch, cfg, wave_S):
    from repro_torch.kernels.expert_ffn.ops import expert_ffn, expert_ffn_plain
    from repro_torch.kernels.flash_attention.ops import (
        flash_attention, flash_attention_plain)
    from repro_torch.kernels.gating.ops import gating, gating_plain
    from repro_torch.configs import get_config
    from repro_torch.models.moe import MOE_CHUNK_TOKENS, expert_capacity

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    m = cfg.moe
    E, K, d, f = m.n_routed, m.top_k, cfg.d_model, m.d_expert
    rows = []

    def record(name, shape, err, ok, fn, plain_fn, lib_fn, b, plain_kw=None,
               row_err=None):
        """Time the kernel (``fn``), its plain version and the library call
        by CUDA events and the kernel and library call by device time."""
        ms, dms = cuda_ms(torch, fn), device_ms(torch, fn)
        plain_ms = cuda_ms(torch, plain_fn, **(plain_kw or {}))
        lib_ms = lib_dms = None          # no single PyTorch call computes it
        if lib_fn is not None:
            lib_ms, lib_dms = cuda_ms(torch, lib_fn), device_ms(torch, lib_fn)
        rows.append({"name": name, "shape": shape, "max_abs_err": err,
                     "ok": ok, "ms": ms, "device_ms": dms,
                     "plain_ms": plain_ms, "library_ms": lib_ms,
                     "library_device_ms": lib_dms, "bound_ms": b[0],
                     "bound_by": b[1]})
        if row_err is not None:
            rows[-1]["row_rel_err"] = row_err
        print(f"kernel {name} [{shape}]: max_abs_err={err:.3e} "
              + ("" if row_err is None else f"row_rel_err={row_err:.3e} ")
              + f"{'pass' if ok else 'FAIL'} kernel_ms={ms:.4f} "
              f"device_ms={dms:.4f} plain_ms={plain_ms:.4f} "
              + (f"library_ms={lib_ms:.4f} library_device_ms={lib_dms:.4f} "
                 if lib_fn is not None else "library_ms=None (no single "
                 "PyTorch call) ")
              + f"bound_ms={b[0]:.4f} ({b[1]})", flush=True)

    # -- K1: router over T rows of E logits, beside the floor of a kernel
    # that does nothing with the same launch shape (csrc/noop.cu): the
    # path's decode batches 2 and 8 and its 256-token admission bucket,
    # off the path the row variant at width 16 (Jamba's router), and the
    # warp variant at phase 10's routers (DeepSeek-V2-Lite's and
    # Qwen3-30B-A3B's)
    from repro_torch.kernels.gating.ops import LAUNCH_KEY, launch_floor, plan
    k1_cases = [("", T, E, K, m.router_type, m.renormalize, "", gen)
                for T in (2, 8, 256)]
    # phase 9's training batch (8 x 128 tokens)
    k1_cases.append(("train ", TRAIN_BATCH * TRAIN_SEQ, E, K, m.router_type,
                     m.renormalize, "", gen))
    k1_cases.append(("", 256, 16, 2, "softmax_topk", True, " off the path",
                     gen))
    # phase 10's routers: the 256-token admission bucket (drawn from the
    # stream these rows took before they were on a path, DeepSeek's first,
    # so every row of earlier phases keeps its inputs), then decode batch 8
    # (and every later phase-10 row) from a stream of their own
    gen10 = torch.Generator(device=dev)
    gen10.manual_seed(10)
    routers = {tag: get_config(mc).moe for tag, mc in NEW_MODELS}
    for T, g in ((256, gen), (8, gen10)):
        k1_cases += [(tag + " ", T, routers[tag].n_routed,
                      routers[tag].top_k, routers[tag].router_type,
                      routers[tag].renormalize, "", g)
                     for tag in ("deepseek", "qwen3")]
    # phase 14's routers, from a stream of their own: Jamba's (E = 16 top-2,
    # the row variant) at its wave decode (batch 2) and a 256-token prefill,
    # Llama-4's (E = 128 top-1 sigmoid, the warp variant) likewise
    gen14 = torch.Generator(device=dev)
    gen14.manual_seed(14)
    for tag, arch in (("jamba", "jamba-1.5-large-398b"),
                      ("llama4", "llama4-maverick-400b-a17b")):
        am = get_config(arch).moe
        k1_cases += [(tag + " ", T, am.n_routed, am.top_k, am.router_type,
                      am.renormalize, "", gen14) for T in (2, 256)]
    for tag, T, e, k, rt, rn, note, g in k1_cases:
        variant, width = plan(e, k)
        floor = (device_ms(torch, lambda: launch_floor(T, e, k)),
                 cuda_ms(torch, lambda: launch_floor(T, e, k)))
        lg = torch.randn((T, e), generator=g, device=dev) * 2
        g1, i1, p1 = gating(lg, k, rt, rn)
        g2, i2, p2 = gating_plain(lg, k, rt, rn)
        torch.cuda.synchronize()
        ok = (bool(torch.equal(i1, i2))
              and float((g1 - g2).abs().max()) < 1e-5
              and bool(torch.allclose(p1, p2, atol=1e-6, rtol=1e-5)))
        err = max(float((g1 - g2).abs().max()), float((p1 - p2).abs().max()))
        nbytes = T * e * 4 * 2 + T * k * 8
        if rt == "topk_softmax":
            lib = lambda: torch.softmax(torch.topk(lg, k).values, -1)
        else:
            lib = lambda: torch.topk(torch.softmax(lg, -1), k)
        cut = f"row W={width}" if variant == "row" else f"warp {width}/lane"
        record(LAUNCH_KEY[variant],
               f"{tag}T={T} E={e} k={k} {rt} {cut}{note}",
               err, ok, lambda: gating(lg, k, rt, rn),
               lambda: gating_plain(lg, k, rt, rn), lib,
               bound(nbytes, T * e * (k + 4), F32_FLOP_S))
        r = rows[-1]
        r["floor_device_ms"], r["floor_ms"] = floor
        # K1's least time is the launch floor where it exceeds the bytes
        r["floor_bound_ms"] = max(r["bound_ms"], floor[0])
        ratio = r["device_ms"] / max(floor[0], 1e-9)
        print(f"floor no-op kernel, K1's launch shape T={T} ({variant}): "
              f"device_ms={floor[0]:.4f} kernel_ms={floor[1]:.4f}; K1 "
              f"device_ms / floor = {ratio:.2f}", flush=True)

    # -- K2: one Mixtral layer's experts ----------------------------------
    s = 1.0 / math.sqrt(d)
    wg = (torch.randn((E, d, f), generator=gen, device=dev) * s).bfloat16()
    wu = (torch.randn((E, d, f), generator=gen, device=dev) * s).bfloat16()
    wd = (torch.randn((E, f, d), generator=gen, device=dev)
          / math.sqrt(f)).bfloat16()
    ws = (wg, wu, wd)

    def routed_counts(T):
        idx = torch.randint(0, E, (T, K), generator=gen, device=dev)
        return torch.bincount(idx.reshape(-1), minlength=E).to(torch.int32)

    def lib_ffn(xe, wg_, wu_, wd_):
        h = torch.nn.functional.silu(torch.bmm(xe, wg_)) * torch.bmm(xe, wu_)
        return torch.bmm(h, wd_)

    def ffn_case(name, shape, xe, counts, eids, weights=None, lib=None):
        wg, wu, wd = weights or ws
        d, f = wg.shape[1], wg.shape[2]
        y = expert_ffn(xe, wg, wu, wd, counts=counts, expert_ids=eids)
        r = expert_ffn_plain(xe, wg, wu, wd, counts=counts, expert_ids=eids)
        torch.cuda.synchronize()
        err = float((y.float() - r.float()).abs().max())
        ok = rel_err(y, r) < BF16_TOL
        if counts is not None:
            tail = torch.arange(xe.shape[1], device=dev)[None] \
                >= counts[:, None]
            ok = ok and not bool(y[tail].float().abs().sum())
        if lib is None and eids is None:
            lib = lambda: lib_ffn(xe, wg, wu, wd)
        elif lib is None:
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
    T = WAVE_BATCH * wave_S             # phase 7's wave prefill
    C = expert_capacity(m, T)
    xe = torch.randn((E, C, d), generator=gen, device=dev).bfloat16()
    ffn_case("expert_ffn_ragged", f"wave T={T} E={E} C={C} d={d} f={f}",
             xe, routed_counts(T), None)
    # phase 9's training bucket and the continuous server's 512-token
    # admission bucket
    for T, tag in ((TRAIN_BATCH * TRAIN_SEQ, "train "), (512, "")):
        C = expert_capacity(m, T)
        xe = torch.randn((E, C, d), generator=gen, device=dev).bfloat16()
        ffn_case("expert_ffn_ragged", f"{tag}T={T} E={E} C={C} d={d} f={f}",
                 xe, routed_counts(T), None)
    # phase 12's long prompts: one 16384-token MoE chunk's bucket (C =
    # 5120), routed top-k (distinct experts per token), from a stream of
    # its own so that every earlier row keeps its inputs
    gen12 = torch.Generator(device=dev)
    gen12.manual_seed(12)
    T = MOE_CHUNK_TOKENS
    C = expert_capacity(m, T)
    idx = torch.rand((T, E), generator=gen12, device=dev).topk(K).indices
    xe = torch.randn((E, C, d), generator=gen12, device=dev).bfloat16()
    ffn_case("expert_ffn_ragged", f"long T={T} E={E} C={C} d={d} f={f}", xe,
             torch.bincount(idx.reshape(-1), minlength=E).to(torch.int32),
             None)
    del xe
    G = 2 * K                           # batch 2 on the sparse decode path
    xe = torch.randn((G, 1, d), generator=gen, device=dev).bfloat16()
    ffn_case("expert_ffn_grouped", f"G={G} C=1 d={d} f={f}", xe,
             torch.ones((G,), dtype=torch.int32, device=dev),
             torch.randint(0, E, (G,), generator=gen, device=dev,
                           dtype=torch.int32))
    xe = torch.randn((E, 16, d), generator=gen, device=dev).bfloat16()
    ffn_case("expert_ffn_dense", f"E={E} C=16 d={d} f={f}", xe, None, None)
    # the offload path's shapes: the prefill sweep's pool launch (8 groups
    # of the T=256 bucket, the 5 pooled experts' with expert_ids = slots)
    # and the decode miss launch (batch 2: 4 groups, 2 of them misses, over
    # the miss-staging rows); a pool / staging stack is the K2 weight set
    C = expert_capacity(m, 256)
    counts = routed_counts(256)
    counts[5:] = 0                      # experts 5..7 are not pooled
    xe = torch.randn((E, C, d), generator=gen, device=dev).bfloat16()
    ffn_case("expert_ffn_grouped", f"pool sweep G={E} C={C} S=5 d={d} f={f}",
             xe, counts, torch.tensor([0, 1, 2, 3, 4, 0, 0, 0],
                                      dtype=torch.int32, device=dev),
             weights=tuple(w[:5].contiguous() for w in (wg, wu, wd)))
    xe = torch.randn((2 * K, 1, d), generator=gen, device=dev).bfloat16()
    ffn_case("expert_ffn_grouped", f"decode miss G={2 * K} C=1 staging=2 "
             f"d={d} f={f}", xe,
             torch.tensor([0, 1, 0, 1], dtype=torch.int32, device=dev),
             torch.tensor([0, 0, 0, 1], dtype=torch.int32, device=dev),
             weights=tuple(w[6:8].contiguous() for w in (wg, wu, wd)))
    # phase 16's expert-parallel layout, from a stream of its own: a rank
    # of the (1, 4) mesh holds 2 experts and receives a C-row bucket from
    # each of the 4 sources, group e * 4 + src (G = 8 over 2 weight sets),
    # counts from a routed draw of 4 sources x 512 tokens top-2; its
    # library call is the reference's non-TPU form, three bmm over
    # (2, 4 C, d) (repro/models/moe_ep.py:184-188)
    gen16 = torch.Generator(device=dev)
    gen16.manual_seed(EP_SEED)
    e_loc, C = E // EP_TP, 256
    idx = torch.rand((EP_TP, 512, E), generator=gen16, device=dev) \
        .topk(K).indices
    cnt = torch.stack([torch.bincount(i.reshape(-1), minlength=E)
                       for i in idx])[:, :e_loc].clamp(max=C)
    xe = torch.randn((e_loc * EP_TP, C, d), generator=gen16,
                     device=dev).bfloat16()
    w_loc = tuple(w[:e_loc] for w in (wg, wu, wd))
    ffn_case("expert_ffn_grouped", f"ep G={e_loc * EP_TP} C={C} over "
             f"{e_loc} weight sets d={d} f={f}", xe,
             cnt.t().reshape(-1).to(torch.int32).contiguous(),
             torch.arange(e_loc, dtype=torch.int32,
                          device=dev).repeat_interleave(EP_TP),
             weights=w_loc,
             lib=lambda: lib_ffn(xe.reshape(e_loc, EP_TP * C, d), *w_loc))
    del wg, wu, wd, ws, xe, w_loc

    # -- K2 at phase 10's expert widths (d = 2048): the 256-token admission
    # bucket (ragged) and a batch-8 decode (grouped, one group per (token,
    # k), ids drawn as top-k routing draws them: distinct within a token,
    # repeated across tokens; each group reads its expert's weights)
    for tag, mc in NEW_MODELS:
        ncfg = get_config(mc)
        nm = ncfg.moe
        nE, nK, nd, nf = nm.n_routed, nm.top_k, ncfg.d_model, nm.d_expert
        nws = tuple((torch.randn(shape, generator=gen10, device=dev)
                     / math.sqrt(shape[1])).bfloat16()
                    for shape in ((nE, nd, nf), (nE, nd, nf), (nE, nf, nd)))
        C = expert_capacity(nm, 256)
        perm = lambda: torch.randperm(nE, generator=gen10, device=dev)[:nK]
        idx = torch.stack([perm() for _ in range(256)])
        counts = torch.bincount(idx.reshape(-1), minlength=nE).to(torch.int32)
        xe = torch.randn((nE, C, nd), generator=gen10,
                         device=dev).bfloat16()
        ffn_case("expert_ffn_ragged", f"{tag} T=256 E={nE} C={C} d={nd} "
                 f"f={nf}", xe, counts, None, weights=nws)
        eids = torch.stack([perm() for _ in range(8)]).reshape(-1) \
            .to(torch.int32)
        G = eids.numel()
        distinct = len(set(eids.tolist()))
        xe = torch.randn((G, 1, nd), generator=gen10, device=dev).bfloat16()
        ffn_case("expert_ffn_grouped", f"{tag} decode G={G} C=1 d={nd} "
                 f"f={nf}", xe, torch.ones((G,), dtype=torch.int32,
                                           device=dev), eids, weights=nws)
        print(f"kernel expert_ffn_grouped [{tag} decode G={G}]: {distinct} "
              f"distinct experts of {nE}; the groups read {G} weight sets, "
              f"{100 * (G / distinct - 1):.1f}% more weight bytes than the "
              "distinct set (the bound counts the distinct set)", flush=True)
        del nws, xe

    # -- K2 at phase 14's expert widths, one model's stack at a time:
    # Jamba's (E = 16, d = 8192, f = 24576: 3.2e9 elements a stack, past
    # 2^31) ragged over a 256-token bucket, grouped over its pipelined
    # pool's prefill sweep (the first 7 experts pooled, C = the bucket's)
    # and over a batch-2 decode reading the whole stack; Llama-4's (E = 128,
    # d = 5120, f = 8192) ragged over a 256-token bucket and grouped over a
    # batch-2 decode
    for tag, arch in (("jamba", "jamba-1.5-large-398b"),
                      ("llama4", "llama4-maverick-400b-a17b")):
        acfg = get_config(arch)
        am = acfg.moe
        aE, aK, ad, af = am.n_routed, am.top_k, acfg.d_model, am.d_expert
        aws = tuple((torch.randn(shape, generator=gen14, device=dev)
                     / math.sqrt(shape[1])).bfloat16()
                    for shape in ((aE, ad, af), (aE, ad, af), (aE, af, ad)))
        C = expert_capacity(am, 256)
        perm = lambda: torch.randperm(aE, generator=gen14, device=dev)[:aK]
        idx = torch.stack([perm() for _ in range(256)])
        counts = torch.bincount(idx.reshape(-1), minlength=aE) \
            .to(torch.int32)
        xe = torch.randn((aE, C, ad), generator=gen14, device=dev).bfloat16()
        ffn_case("expert_ffn_ragged", f"{tag} T=256 E={aE} C={C} d={ad} "
                 f"f={af} ({aws[0].numel():.2e} elements a stack)", xe,
                 counts, None, weights=aws)
        if tag == "jamba":
            pooled = 7
            pc = counts.clone()
            pc[pooled:] = 0
            ffn_case("expert_ffn_grouped", f"{tag} pool sweep G={aE} C={C} "
                     f"S={pooled} d={ad} f={af}", xe, pc,
                     torch.tensor(list(range(pooled)) + [0] * (aE - pooled),
                                  dtype=torch.int32, device=dev),
                     weights=tuple(w[:pooled] for w in aws))
        del xe
        eids = torch.stack([perm() for _ in range(2)]).reshape(-1) \
            .to(torch.int32)
        eids[0] = aE - 1                 # the stack's far end
        G = eids.numel()
        xe = torch.randn((G, 1, ad), generator=gen14, device=dev).bfloat16()
        ffn_case("expert_ffn_grouped", f"{tag} decode G={G} C=1 d={ad} "
                 f"f={af} ids={eids.tolist()}", xe,
                 torch.ones((G,), dtype=torch.int32, device=dev), eids,
                 weights=aws)
        del aws, xe
        torch.cuda.empty_cache()

    # -- K3: causal GQA prefill attention ---------------------------------
    a = cfg.attn
    Hq, Hkv, D = a.n_heads, a.n_kv_heads, a.head_dim
    # prefill buckets, phase 7's wave and phase 9's training batch
    for tag, B, S in (("", 1, 128), ("", 1, 256), ("", 1, 512),
                      ("wave ", WAVE_BATCH, wave_S),
                      ("train ", TRAIN_BATCH, TRAIN_SEQ)):
        q = torch.randn((B, S, Hq, D), generator=gen, device=dev).bfloat16()
        k = torch.randn((B, S, Hkv, D), generator=gen, device=dev).bfloat16()
        v = torch.randn((B, S, Hkv, D), generator=gen, device=dev).bfloat16()
        o = flash_attention(q, k, v, causal=True)
        r = flash_attention_plain(q, k, v, causal=True)
        torch.cuda.synchronize()
        err = float((o.float() - r.float()).abs().max())
        rerr = row_rel_err(o, r)
        ok = rerr < BF16_TOL
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        pairs = S * (S + 1) // 2
        record("flash_attention",
               f"{tag}B={B} S={S} Hq={Hq} Hkv={Hkv} D={D} causal", err, ok,
               lambda: flash_attention(q, k, v, causal=True),
               lambda: flash_attention_plain(q, k, v, causal=True),
               lambda: torch.nn.functional.scaled_dot_product_attention(
                   qt, kt, vt, is_causal=True, enable_gqa=True),
               bound(B * (2 * S * Hq + 2 * S * Hkv) * D * 2,
                     4.0 * B * Hq * D * pairs, BF16_FLOP_S), row_err=rerr)
    # -- K3 at phase 12's admission: one 20018-token prompt, against the
    # blockwise plain version (the dense one would hold 51 GB of scores)
    # and SDPA restricted to its flash and memory-efficient backends
    from torch.nn.attention import SDPBackend, sdpa_kernel
    S = LONG_MAX
    q = torch.randn((1, S, Hq, D), generator=gen12, device=dev).bfloat16()
    k = torch.randn((1, S, Hkv, D), generator=gen12, device=dev).bfloat16()
    v = torch.randn((1, S, Hkv, D), generator=gen12, device=dev).bfloat16()
    o = flash_attention(q, k, v, causal=True)
    r = flash_attention_plain(q, k, v, causal=True)
    torch.cuda.synchronize()
    err = float((o.float() - r.float()).abs().max())
    rerr = row_rel_err(o, r)
    ok = rerr < BF16_TOL
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    del o, r

    def sdpa_long():
        with sdpa_kernel([SDPBackend.FLASH_ATTENTION,
                          SDPBackend.EFFICIENT_ATTENTION]):
            return torch.nn.functional.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True, enable_gqa=True)

    pairs = S * (S + 1) // 2
    record("flash_attention", f"long B=1 S={S} Hq={Hq} Hkv={Hkv} D={D} "
           "causal (plain blockwise)", err, ok,
           lambda: flash_attention(q, k, v, causal=True),
           lambda: flash_attention_plain(q, k, v, causal=True), sdpa_long,
           bound((2 * S * Hq + 2 * S * Hkv) * D * 2,
                 4.0 * Hq * D * pairs, BF16_FLOP_S),
           plain_kw=dict(budget_s=0.5, max_iters=3), row_err=rerr)
    del q, k, v, qt, kt, vt
    torch.cuda.empty_cache()
    # -- K3 at phase 10's prefill shapes: Qwen3's GQA (G = 8, D = 128) and
    # DeepSeek-V2-Lite's MLA (Hq = Hkv = 16, q/k 192 wide, the 128-wide
    # values zero-padded to 192 as ``mla_attention`` pads them); the bound
    # counts the padded inputs, and beside it the bound with 128-wide
    # values (what the padding costs)
    for tag, mc in NEW_MODELS:
        na = get_config(mc).attn
        if na.mla is not None:
            nHq = nHkv = na.n_heads
            nD = na.mla.qk_nope_head_dim + na.mla.qk_rope_head_dim
            vd = na.mla.v_head_dim
        else:
            nHq, nHkv, nD = na.n_heads, na.n_kv_heads, na.head_dim
            vd = nD
        for S in (128, 256, 512):
            q = torch.randn((1, S, nHq, nD), generator=gen10,
                            device=dev).bfloat16()
            k = torch.randn((1, S, nHkv, nD), generator=gen10,
                            device=dev).bfloat16()
            v = torch.randn((1, S, nHkv, nD), generator=gen10,
                            device=dev).bfloat16()
            v[..., vd:] = 0
            o = flash_attention(q, k, v, causal=True)
            r = flash_attention_plain(q, k, v, causal=True)
            torch.cuda.synchronize()
            err = float((o.float() - r.float()).abs().max())
            rerr = row_rel_err(o, r)
            ok = rerr < BF16_TOL and not bool(
                o[..., vd:].float().abs().sum())
            qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
            pairs = S * (S + 1) // 2
            b = bound(S * (2 * nHq + 2 * nHkv) * nD * 2,
                      4.0 * nHq * nD * pairs, BF16_FLOP_S)
            record("flash_attention",
                   f"{tag} B=1 S={S} Hq={nHq} Hkv={nHkv} D={nD}"
                   + (f" v {vd} padded" if vd < nD else "") + " causal",
                   err, ok, lambda: flash_attention(q, k, v, causal=True),
                   lambda: flash_attention_plain(q, k, v, causal=True),
                   lambda: torch.nn.functional.scaled_dot_product_attention(
                       qt, kt, vt, is_causal=True, enable_gqa=True), b,
                   row_err=rerr)
            if vd < nD:
                unpadded = bound(S * (nHq + nHkv) * (nD + vd) * 2,
                                 2.0 * nHq * (nD + vd) * pairs, BF16_FLOP_S)
                rows[-1]["unpadded_bound_ms"] = unpadded[0]
                print(f"kernel flash_attention [{tag} S={S}]: bound with "
                      f"the values {vd} wide {unpadded[0]:.4f} ms "
                      f"({unpadded[1]}) against {b[0]:.4f} ms padded",
                      flush=True)
    torch.cuda.empty_cache()
    # -- K3 at phase 14's shapes: a VLM cross layer (non-causal, 64 queries
    # over the 1601 vision tokens), Seamless's encoder (non-causal, 1024
    # frames, D = 64), Gemma-2's local layer at a 5000-token prompt (window
    # 4096, softcap 50, D = 256: SDPA has no softcap; its library call is
    # ``flex_attention``), Llama-3-405B's G = 16, Llama-4's G = 5 (K/V heads repeated
    # to one per query head: 5 does not divide the kernel's 64-row tile)
    # and Jamba's attention layer (a batch-2 wave)
    for tag, arch, B, Sq, Sk, causal, window, cap in (
            ("vision", "llama-3.2-vision-11b", 1, 64, 1601, False, 0, 0.0),
            ("seamless", "seamless-m4t-large-v2", 1, 1024, 1024, False, 0,
             0.0),
            ("gemma2", "gemma2-9b", 1, 5000, 5000, True, 4096, 50.0),
            ("llama3", "llama3-405b", 1, 256, 256, True, 0, 0.0),
            ("llama4", "llama4-maverick-400b-a17b", 1, 256, 256, True, 0,
             0.0),
            ("jamba", "jamba-1.5-large-398b", 2, 128, 128, True, 0, 0.0)):
        na = get_config(arch).attn
        nHq, nD = na.n_heads, na.head_dim
        # a cross layer's keys and values have every query head
        nHkv = nHq if tag == "vision" else na.n_kv_heads
        q = torch.randn((B, Sq, nHq, nD), generator=gen14,
                        device=dev).bfloat16()
        k = torch.randn((B, Sk, nHkv, nD), generator=gen14,
                        device=dev).bfloat16()
        v = torch.randn((B, Sk, nHkv, nD), generator=gen14,
                        device=dev).bfloat16()
        kw = dict(causal=causal, window=window, softcap=cap)
        o = flash_attention(q, k, v, **kw)
        r = flash_attention_plain(q, k, v, **kw)
        torch.cuda.synchronize()
        err = float((o.float() - r.float()).abs().max())
        rerr = row_rel_err(o, r)
        ok = rerr < BF16_TOL
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        if causal:
            # query i (at key position Sk - Sq + i) sees min(i + 1, window)
            pairs = sum(min(i + 1, window or Sk) for i in range(Sq))
        else:
            pairs = Sq * Sk
        if cap:
            lib = flex_softcap(torch, qt, kt, vt, causal, window, cap,
                               o.transpose(1, 2))
        else:
            lib = (lambda: torch.nn.functional.scaled_dot_product_attention(
                qt, kt, vt, is_causal=causal, enable_gqa=True))
        record("flash_attention",
               f"{tag} B={B} Sq={Sq} Sk={Sk} Hq={nHq} Hkv={nHkv} D={nD}"
               + (" causal" if causal else " non-causal")
               + (f" window={window}" if window else "")
               + (f" softcap={cap:g}" if cap else ""), err, ok,
               lambda: flash_attention(q, k, v, **kw),
               lambda: flash_attention_plain(q, k, v, **kw), lib,
               bound(B * (2 * Sq * nHq + 2 * Sk * nHkv) * nD * 2,
                     4.0 * B * nHq * nD * pairs, BF16_FLOP_S),
               plain_kw=dict(budget_s=0.5, max_iters=5), row_err=rerr)
        del q, k, v, qt, kt, vt, o, r
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


def flex_softcap(torch, qt, kt, vt, causal, window, cap, ref):
    """The library call for a softcapped K3 row: ``flex_attention``
    (compiled here, once, outside the timed region) with a tanh softcap
    ``score_mod`` and a causal, sliding-window ``block_mask``, on (B, H, S,
    D) tensors with GQA.  Returns the call, or None (with the reason
    printed) where it does not compile or disagrees with K3's output
    ``ref`` (B, H, Sq, D)."""
    try:
        from torch.nn.attention.flex_attention import (create_block_mask,
                                                       flex_attention)
        Sq, Sk = qt.shape[2], kt.shape[2]
        off = Sk - Sq                    # K3's suffix-aligned query rows

        def mask(b, h, qi, ki):
            keep = (ki <= qi + off) if causal else (ki >= 0)
            return keep & (ki > qi + off - window) if window else keep

        def softcap(score, b, h, qi, ki):
            return cap * torch.tanh(score / cap)

        bm = create_block_mask(mask, None, None, Sq, Sk, device=qt.device)
        fn = torch.compile(flex_attention, dynamic=False)
        call = lambda: fn(qt, kt, vt, score_mod=softcap, block_mask=bm,
                          enable_gqa=True)
        t0 = time.perf_counter()
        out = call()
        torch.cuda.synchronize()
        err = row_rel_err(out, ref)
        print(f"kernel flash_attention softcap={cap:g}: library call "
              f"flex_attention compiled in {time.perf_counter() - t0:.1f} "
              f"s, row rel_err against K3 {err:.3e}", flush=True)
        return call if err < BF16_TOL else None
    except Exception as e:                # noqa: BLE001 (reported, no row)
        print(f"kernel flash_attention softcap={cap:g}: flex_attention "
              f"gives no library time: {type(e).__name__}: {e}"[:600],
              flush=True)
        return None


# --------------------------------------------------------------------------
# phase 4: the port on the card against the port on the CPU, small input
# --------------------------------------------------------------------------

def reference_phase(torch, arch="mixtral-8x7b"):
    """The smoke model of ``arch`` at two layers, bfloat16: its MoE layer,
    its attention (GQA, or MLA) and a whole right-padded admission prefill
    with two decode steps, on the card against the CPU."""
    from repro_torch.configs import get_config, make_smoke
    from repro_torch.models.attention import gqa_attention, mla_attention
    from repro_torch.models.model import (apply_model, collect_field,
                                          init_caches, init_model)
    from repro_torch.models.moe import apply_moe
    from repro_torch.tree import tree_map

    cfg = make_smoke(get_config(arch)).replace(
        n_layers=2, dtype="bfloat16", param_dtype="bfloat16")
    tag = "" if arch == "mixtral-8x7b" else f"{cfg.name} "
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
        print(f"reference {tag}{what}: "
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
    if cfg.attn.mla is not None:
        attn, what = mla_attention, "mla_attention"
    else:
        attn = lambda p, h, c, **kw: gqa_attention(p, h, c, kind="attn",
                                                   **kw)
        what = "gqa_attention" + (" qk-norm" if cfg.attn.qk_norm else "")
    y_c, _ = attn(layer(cpu)["mixer"], x, cfg, positions=pos)
    y_g, _ = attn(layer(gpu)["mixer"], x.cuda(), cfg, positions=pos.cuda())
    check(f"{what} prefill S=20", y_g, y_c)

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
            print(f"reference {tag}model step {step}: routing diverged "
                  "between "
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
    batch2 = []                            # phase 6 re-serves these
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
        if batch == 2:
            batch2 = [(r.prompt, r.output) for r in reqs]
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
    ctx = {"params": params, "cfg": cfg, "batch2": batch2,
           "res_vecs": res_vecs}
    return ok and finite and shape_ok, counts, ctx


KERNEL_GROUPS = (("K2 expert_ffn", ("ffn_gate_up_kernel", "ffn_down_kernel")),
                 ("K3 flash_attention", ("flash_kernel",)),
                 ("K1 gating", ("gating_row_kernel", "gating_warp_kernel")),
                 ("K1 floor (no-op kernel, not on the path)",
                  ("noop_kernel",)),
                 ("matmul (projections, router, lm head)",
                  ("gemm", "gemv", "cutlass", "xmma", "splitK")),
                 ("sort / scatter / index", ("sort", "Sort", "scatter",
                                             "index", "gather", "Scan")),
                 ("copies host to device (expert fetches, streaming)",
                  ("Memcpy HtoD",)))


def profile_window(torch, server, name, label="batch=8 serve"):
    """Device busy share and device time by kernel group over one serve."""
    busy, wall_us, groups, _ = device_breakdown(torch, server.run)
    mt = server.metrics
    print(f"profile {label}: wall {wall_us / 1e3:.1f} ms "
          f"(prefill {mt.prefill_s * 1e3:.1f} ms, decode "
          f"{mt.decode_s * 1e3:.1f} ms over {mt.steps} steps), device busy "
          f"{busy / 1e3:.1f} ms = {100 * busy / wall_us:.1f}% of wall, idle "
          f"{100 - 100 * busy / wall_us:.1f}% | on {name}", flush=True)
    print_groups(groups, busy)


def device_breakdown(torch, fn):
    """Run ``fn`` under torch.profiler: (device busy us, wall us, device us
    by ``KERNEL_GROUPS`` group, device us by kernel name)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    groups = {g: 0.0 for g, _ in KERNEL_GROUPS}
    groups["other (elementwise, reductions, copies)"] = 0.0
    by_name = {}
    busy = 0.0
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        us = e.time_range.elapsed_us()
        busy += us
        by_name[e.name] = by_name.get(e.name, 0.0) + us
        for g, keys in KERNEL_GROUPS:
            if any(k in e.name for k in keys):
                groups[g] += us
                break
        else:
            groups["other (elementwise, reductions, copies)"] += us
    return busy, wall_us, groups, by_name


def print_groups(groups, busy):
    for g, us in sorted(groups.items(), key=lambda kv: -kv[1]):
        print(f"profile   {g}: {us / 1e3:.2f} ms "
              f"({100 * us / max(busy, 1e-9):.1f}% of device time)",
              flush=True)


# --------------------------------------------------------------------------
# phase 6: physical offload (pinned host store + device slot pool)
# --------------------------------------------------------------------------

MODES = ("blocking", "overlap", "pipelined")
HOST_RESERVE = 8 * 2**30     # host bytes left unpinned at full depth
# phase 6 (b)'s depth: 12 of Mixtral's 32 layers (33.7 GB of experts
# pinned), cut so that the whole script stays inside its time limit
OFFLOAD_MAX_LAYERS = 12


def mem_available():
    """The host's MemAvailable in bytes (/proc/meminfo)."""
    for line in Path("/proc/meminfo").read_text().splitlines():
        if line.startswith("MemAvailable:"):
            return int(line.split()[1]) * 1024
    return 0


def settled_mem_available(torch, min_s=6.0, limit_s=120.0):
    """MemAvailable once freed pinned pages are back: after a large pinned
    store is freed, the host gets its pages back over some seconds (a
    reading taken at once was 40 GiB short on the H100 machine).  Polls
    for at least ``min_s`` and until it rises by under 0.5 GiB in 2 s."""
    t0 = time.perf_counter()
    last = mem_available()
    while time.perf_counter() - t0 < limit_s:
        torch.cuda.synchronize()
        time.sleep(2.0)
        now = mem_available()
        if now - last < 2**29 and time.perf_counter() - t0 >= min_s:
            return now, time.perf_counter() - t0
        last = now
    return last, time.perf_counter() - t0


def offload_line(tag, server, done, wall, name):
    """One reading of an offloaded serve: rates, counters, miss reads."""
    import numpy as np
    mt, st = server.metrics, server.store.stats()
    ttft = [r.ttft for r in done]
    print(f"offload {tag}: {len(done)} requests, {mt.steps} steps in "
          f"{wall:.2f} s | decode {mt.decode_tokens / mt.decode_s:.1f} "
          f"tok/s, prefill {mt.prefill_tokens / mt.prefill_s:.1f} tok/s, "
          f"TTFT p50 {np.percentile(ttft, 50) * 1e3:.1f} ms | h2d_rows="
          f"{st['h2d_rows']} fallback_rows={st['fallback_rows']} "
          f"fallback_fetches={st['fallback_fetches']} prefill_fetch_rows="
          f"{st['prefill_fetch_rows']} prefill_waves={st['prefill_waves']} "
          f"| miss reads {st['miss_reads']} over {mt.steps} decode steps = "
          f"{st['miss_reads'] / max(mt.steps, 1):.1f} per step "
          f"({server.store.n_layers} MoE layers), prefill "
          f"{st['prefill_miss_reads']} | on {name}", flush=True)


def serve_offloaded(torch, cfg, params, prompts, mode, dali_cfg, batch,
                    max_new, res_vecs=None):
    """Serve ``prompts`` through ContinuousBatchServer with the dali policy
    and a physical offload mode (fetch tier); returns (server, finished
    requests, wall seconds)."""
    from repro_torch.serving.spec import OffloadSpec, ServeSpec
    spec = ServeSpec(cfg=cfg, policy="dali", dali_cfg=dali_cfg,
                     batch_size=batch, max_len=256, eos_id=-1,
                     offload=OffloadSpec(mode=mode))
    return run_requests(torch, spec.resolve(params).server(
        res_vecs=res_vecs), prompts, max_new)


def run_requests(torch, server, prompts, max_new):
    """Submit ``prompts`` to ``server`` and run it; returns (server,
    finished requests, wall seconds)."""
    from repro_torch.serving.scheduler import Request
    for i, p in enumerate(prompts):
        server.submit(Request(rid=i, prompt=p, max_new_tokens=max_new))
    t0 = time.perf_counter()
    done = server.run()
    torch.cuda.synchronize()
    return server, done, time.perf_counter() - t0


def slot_res_vecs(rs, cfg, calib, n_decode=8):
    """Residual vectors (paper Eq. 11) calibrated through a resolved
    physical spec's slot pool, as the launcher calibrates an offloaded
    serve: bit-equal to a full-resident calibration.  The store's counters
    are zeroed afterwards, so its server counts its own serve only."""
    import numpy as np

    from repro_torch.core.residual import calibrate_residuals
    from repro_torch.core.tracing import capture_decode_trace
    off = rs.init_state()["offload"]
    tr = capture_decode_trace(rs.params, cfg, calib, n_decode=n_decode,
                              store=rs.store, off=off)
    del off
    rs.store.reset_stats()
    return np.stack(calibrate_residuals([tr]))


def free(torch):
    import gc
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


def offload_phase(torch, kernels, name, ctx):
    """(a) 8 layers, the serve phase's weights and batch-2 requests: every
    mode with the fetch tier gives the full-resident tokens; (b) the
    deepest depth the host can pin: pipelined + fetch at
    two cache ratios gives the same tokens, with peak device memory below
    the model's weight bytes; (c) 8 layers again: the host tier's
    first-step logits are close to full-resident's."""
    import weakref

    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import MarkovCorpus
    from repro_torch.models.model import (apply_model, experts_to_host,
                                          init_caches, init_model)
    from repro_torch.serving.scheduler import Request
    from repro_torch.serving.spec import OffloadSpec, ServeSpec
    from repro_torch.serving.steps import default_dali_config
    from repro_torch.tree import tree_leaves

    t_phase = time.perf_counter()
    ok = True
    params, cfg = ctx.pop("params"), ctx["cfg"]
    print(f"offload: MemAvailable {mem_available() / 2**30:.1f} GiB at the "
          "start of the phase", flush=True)
    prompts = [p for p, _ in ctx["batch2"]]
    kernels.reset_launch_counts()          # the offload path starts here
    # (a) -- the experts into pinned host memory once; every store adopts
    t0 = time.perf_counter()
    host = experts_to_host(params, cfg, "cuda")
    print(f"offload: {cfg.n_layers}-layer experts pinned on the host in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    dcfg = default_dali_config(cfg, cache_ratio=0.25)
    want = [out for _, out in ctx["batch2"]]
    for mode in MODES:
        server, done, wall = serve_offloaded(
            torch, cfg, host, prompts, mode, dcfg, 2, 32, ctx["res_vecs"])
        got = {r.rid: r.output for r in done}
        same = [got.get(i) for i in range(len(want))] == want
        ok = ok and same
        offload_line(f"8 layers {mode} fetch batch=2 (tokens "
                     f"{'identical to' if same else 'DIFFER from'} the "
                     "full-resident serve)", server, done, wall, name)
        if mode == "pipelined":
            lay = server.store.memory_layout()
            print(f"offload 8 layers: pool {lay['pool_bytes'] / 1e9:.2f} GB "
                  f"of {lay['full_resident_bytes'] / 1e9:.2f} GB experts "
                  f"({server.store.n_slots} of {cfg.moe.n_routed} slots)",
                  flush=True)
        del server
        free(torch)
    # where the time goes in an offloaded serve: batch 2, pipelined
    spec = ServeSpec(cfg=cfg, policy="dali", dali_cfg=dcfg, batch_size=2,
                     max_len=256, eos_id=-1,
                     offload=OffloadSpec(mode="pipelined"))
    server = spec.resolve(host).server(res_vecs=ctx["res_vecs"])
    for i, p in enumerate(prompts):
        server.submit(Request(rid=i, prompt=p, max_new_tokens=8))
    profile_window(torch, server, name,
                   label="8 layers pipelined fetch batch=2 serve")
    del server
    free(torch)
    rng = np.random.default_rng(5)
    corpus = MarkovCorpus(vocab=cfg.vocab, seed=0)
    b8 = [corpus.sample(rng, int(rng.integers(24, 201))) for _ in range(8)]
    server, done, wall = serve_offloaded(torch, cfg, host, b8, "pipelined",
                                         dcfg, 8, 16, ctx["res_vecs"])
    offload_line("8 layers pipelined fetch batch=8 (reading only)", server,
                 done, wall, name)
    del server
    free(torch)

    pinned = weakref.ref(host["scan"][0]["mlp"]["gate"])
    del host, params
    free(torch)
    avail, waited = settled_mem_available(torch)
    print(f"offload: 8-layer host store released: {pinned() is None}; "
          f"MemAvailable {avail / 2**30:.1f} GiB after {waited:.1f} s",
          flush=True)

    # (b) -- full depth, as deep as the host can pin
    full = get_config("mixtral-8x7b")
    m = full.moe
    layer_bytes = m.n_routed * 3 * full.d_model * m.d_expert * 2
    depth = min(full.n_layers, OFFLOAD_MAX_LAYERS,
                int((avail - HOST_RESERVE) // layer_bytes))
    print(f"offload: MemAvailable {avail / 2**30:.1f} GiB, "
          f"{layer_bytes / 1e9:.2f} GB of experts per layer -> depth "
          f"{depth} of {full.n_layers}", flush=True)
    t0 = time.perf_counter()
    cfgL = full.replace(n_layers=depth)
    hp = init_model(cfgL, seed=0, device="cuda", experts="host")
    torch.cuda.synchronize()
    weight_bytes = sum(t.numel() * t.element_size() for t in tree_leaves(hp))
    print(f"offload: {depth}-layer Mixtral-8x7B, random weights from seed 0, "
          f"{weight_bytes / 1e9:.2f} GB (experts on the host, pinned), "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    # the pinned store's copy rate to the card: one layer's experts
    src = hp["scan"][0]["mlp"]
    dst = {k: torch.empty(src[k].shape[1:], dtype=src[k].dtype,
                          device="cuda") for k in ("gate", "up", "down")}
    rates = []
    for _ in range(3):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for k in dst:
            dst[k].copy_(src[k][0], non_blocking=True)
        b.record()
        b.synchronize()
        rates.append(layer_bytes / (a.elapsed_time(b) / 1e3) / 1e9)
    del dst
    print(f"offload: H2D from the pinned store {max(rates):.2f} GB/s "
          f"(best of 3 copies of {layer_bytes / 1e9:.2f} GB: "
          f"{', '.join(f'{r:.2f}' for r in rates)})", flush=True)
    free(torch)
    torch.cuda.reset_peak_memory_stats()
    rng = np.random.default_rng(7)
    corpus = MarkovCorpus(vocab=cfgL.vocab, seed=0)
    reqs = [corpus.sample(rng, int(rng.integers(24, 201))) for _ in range(4)]
    calib = np.stack([corpus.sample(rng, 32) for _ in range(8)])
    outs = []
    res = None
    for ratio in (0.25, 0.125):
        rs = ServeSpec(cfg=cfgL, policy="dali",
                       dali_cfg=default_dali_config(cfgL, cache_ratio=ratio),
                       batch_size=2, max_len=256, eos_id=-1,
                       offload=OffloadSpec(mode="pipelined")).resolve(hp)
        if res is None:
            # the weights decide the vectors, not the pool: once is enough
            t0 = time.perf_counter()
            res = slot_res_vecs(rs, cfgL, calib)
            finite = bool(np.isfinite(res).all()) and bool(np.abs(res).sum())
            ok = ok and finite
            print(f"offload {depth} layers: residual vectors calibrated "
                  f"through the slot pool (8 prompts x 32 tokens, 8 decode "
                  f"steps) in {time.perf_counter() - t0:.1f} s, |res| sum "
                  f"{float(np.abs(res).sum()):.4f}, finite and non-zero: "
                  f"{finite}", flush=True)
        server, done, wall = run_requests(torch, rs.server(res_vecs=res),
                                          reqs, 8)
        del rs
        adopted = (server.store.host["gate"].data_ptr()
                   == hp["scan"][0]["mlp"]["gate"].data_ptr())
        ok = ok and adopted and len(done) == 4
        lay = server.store.memory_layout()
        print(f"offload {depth} layers cache_ratio={ratio}: pool "
              f"{lay['pool_bytes'] / 1e9:.2f} GB ({server.store.n_slots} of "
              f"{m.n_routed} slots per layer), host store adopted="
              f"{adopted}", flush=True)
        offload_line(f"{depth} layers pipelined fetch cache_ratio={ratio} "
                     "batch=2", server, done, wall, name)
        outs.append({r.rid: r.output for r in done})
        del server
        free(torch)
    peak = torch.cuda.max_memory_allocated()
    same = outs[0] == outs[1]
    fits = peak < weight_bytes
    ok = ok and same and fits
    print(f"offload {depth} layers: tokens identical across cache ratios: "
          f"{same}; peak device memory {peak / 1e9:.2f} GB < model weights "
          f"{weight_bytes / 1e9:.2f} GB: {fits} | on {name}", flush=True)
    del hp, src
    free(torch)
    avail, waited = settled_mem_available(torch)
    print(f"offload: {depth}-layer store released; MemAvailable "
          f"{avail / 2**30:.1f} GiB after {waited:.1f} s", flush=True)

    # host tier: an admission's first-step logits against full-resident's,
    # on the serve phase's 8-layer weights (drawn again from seed 0)
    params = init_model(cfg, seed=0, device="cuda")
    host = experts_to_host(params, cfg, "cuda")
    rs = ServeSpec(cfg=cfg, policy="dali", dali_cfg=dcfg, batch_size=1,
                   max_len=64, offload=OffloadSpec(mode="blocking",
                                                   fallback="host")
                   ).resolve(host)
    state = rs.init_state()
    L = 40
    toks = torch.zeros((1, 64), dtype=torch.int32, device="cuda")
    toks[0, :L] = torch.as_tensor(prompts[0][:L], device="cuda")
    pos = torch.arange(64, dtype=torch.int32, device="cuda")
    ref, _, _ = apply_model(params, toks, cfg, positions=pos,
                            caches=init_caches(cfg, 1, 64), logit_index=L - 1)
    t0 = time.perf_counter()
    got, _, _ = apply_model(rs.params, toks, cfg, positions=pos,
                            caches=init_caches(cfg, 1, 64), logit_index=L - 1,
                            expert_slots=rs.store.build_view(state["offload"]),
                            slot_fetch=rs.store, slot_phase="prefill")
    torch.cuda.synchronize()
    err = rel_err(got[..., :cfg.vocab], ref[..., :cfg.vocab])
    rows = rs.store.stats()["fallback_rows"]
    host_ok = err < BF16_TOL and rows > 0
    ok = ok and host_ok
    print(f"offload 8 layers host tier: first-step logits rel_err={err:.3e} "
          f"against full-resident, fallback_rows={rows}, "
          f"{time.perf_counter() - t0:.1f} s | "
          f"{'pass' if host_ok else 'FAIL'}", flush=True)
    del rs, state, host, params, ref, got
    ctx.clear()
    free(torch)
    print(f"offload: host tier done; MemAvailable "
          f"{mem_available() / 2**30:.1f} GiB", flush=True)
    counts = kernels.launch_counts()       # ... and ends here
    print(f"offload: phase {time.perf_counter() - t_phase:.1f} s", flush=True)
    return ok, counts


# --------------------------------------------------------------------------
# phase 7: the wave server, full-resident and offloaded
# --------------------------------------------------------------------------

def wave_phase(torch, kernels, name, cfg, res_vecs, wave):
    """One wave of 8 requests through ``BatchServer`` with ``dali`` at 8
    layers (the serve phase's weights, drawn again from seed 0): first
    full-resident, then ``pipelined`` with the fetch tier, which must give
    the same tokens.  Returns (ok, launch counts, the 8-layer weights with
    their experts pinned on the host, for phase 8)."""
    import numpy as np

    from repro_torch.models.model import experts_to_host, init_model
    from repro_torch.models.moe import expert_capacity
    from repro_torch.serving.scheduler import Request
    from repro_torch.serving.spec import OffloadSpec, ServeSpec
    from repro_torch.serving.steps import default_dali_config

    t_phase = time.perf_counter()
    prompts, S = wave
    params = init_model(cfg, seed=0, device="cuda")
    host = experts_to_host(params, cfg, "cuda")
    dcfg = default_dali_config(cfg, cache_ratio=0.25)
    torch.cuda.synchronize()
    T = WAVE_BATCH * S
    print(f"wave: {cfg.n_layers}-layer weights drawn again from seed 0, "
          f"experts pinned on the host, {time.perf_counter() - t_phase:.1f} "
          f"s; prompts of {sorted(len(p) for p in prompts)} tokens, "
          f"{WAVE_NEW} new each -> one wave at S={S} (T={T}, K2 capacity "
          f"C={expert_capacity(cfg.moe, T)}, pinned for prefill and "
          "decode)", flush=True)
    ok = True
    outs = {}
    kernels.reset_launch_counts()          # the wave path starts here
    for mode, p in (("modeled", params), ("pipelined", host)):
        spec = ServeSpec(cfg=cfg, server="wave", policy="dali",
                         dali_cfg=dcfg, batch_size=WAVE_BATCH,
                         max_len=MAX_LEN, eos_id=-1,
                         moe_capacity=expert_capacity(cfg.moe, T),
                         offload=OffloadSpec(mode=mode))
        server = spec.resolve(p).server(res_vecs=res_vecs)
        for i, pr in enumerate(prompts):
            server.submit(Request(rid=i, prompt=pr, max_new_tokens=WAVE_NEW))
        t0 = time.perf_counter()
        done = server.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        mt = server.metrics
        outs[mode] = {r.rid: r.output for r in done}
        shape_ok = (mt.waves == 1 and mt.prefill_tokens == T
                    and all(len(r.output) == WAVE_NEW for r in done))
        ok = ok and shape_ok and mt.dali.lookups > 0
        ttft = [r.ttft for r in done]
        line = (f"wave {mode} batch={WAVE_BATCH}: {len(done)} requests, "
                f"{mt.waves} wave of {mt.prefill_tokens} prompt tokens "
                f"(S={mt.prefill_tokens // WAVE_BATCH}), {mt.steps} steps "
                f"in {wall:.2f} s | prefill "
                f"{mt.prefill_tokens / mt.prefill_s:.1f} tok/s, decode "
                f"{mt.decode_tokens / mt.decode_s:.1f} tok/s, TTFT p50 "
                f"{np.percentile(ttft, 50) * 1e3:.1f} ms | "
                f"{mt.dali.summary()} hits={mt.dali.hits} "
                f"lookups={mt.dali.lookups}")
        if server.store is not None:
            st = server.store.stats()
            same = outs["pipelined"] == outs["modeled"]
            ok = ok and same
            line += (f" | h2d_rows={st['h2d_rows']} fallback_fetches="
                     f"{st['fallback_fetches']} prefill_fetch_rows="
                     f"{st['prefill_fetch_rows']} prefill_waves="
                     f"{st['prefill_waves']} | tokens "
                     f"{'identical to' if same else 'DIFFER from'} the "
                     "full-resident wave")
        print(f"{line} | shape {'ok' if shape_ok else 'FAIL'} | on {name}",
              flush=True)
        del server
        free(torch)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()       # ... and ends here
    # where the time goes in the full-resident wave
    server = ServeSpec(cfg=cfg, server="wave", policy="dali", dali_cfg=dcfg,
                       batch_size=WAVE_BATCH, max_len=MAX_LEN, eos_id=-1,
                       moe_capacity=expert_capacity(cfg.moe, T)
                       ).resolve(params).server(res_vecs=res_vecs)
    for i, pr in enumerate(prompts):
        server.submit(Request(rid=i, prompt=pr, max_new_tokens=WAVE_NEW))
    profile_window(torch, server, name,
                   label=f"wave batch={WAVE_BATCH} full-resident")
    del server
    del params
    free(torch)
    print(f"wave: phase {time.perf_counter() - t_phase:.1f} s", flush=True)
    return ok, counts, (cfg, host, dcfg)


# --------------------------------------------------------------------------
# phase 8: the baseline policies, offloaded
# --------------------------------------------------------------------------

def policy_phase(torch, kernels, name, hold, batch2, res_vecs):
    """Phase 5's batch-2 requests through the continuous server, offloaded
    (pipelined, fetch tier, cache ratio 0.25), under every baseline
    policy: each must give phase 5's tokens (placement never changes a
    token)."""
    import numpy as np

    from repro_torch.serving.scheduler import Request
    from repro_torch.serving.spec import OffloadSpec, ServeSpec

    t_phase = time.perf_counter()
    cfg, host, dcfg = hold
    ok = True
    # one batch of phase 5's batch-2 requests a policy (cut from both for
    # the script's time limit)
    batch2 = batch2[:POLICY_REQUESTS]
    kernels.reset_launch_counts()          # the policies' path starts here
    for pol in POLICIES:
        spec = ServeSpec(cfg=cfg, policy=pol, dali_cfg=dcfg, batch_size=2,
                         max_len=MAX_LEN, eos_id=-1,
                         offload=OffloadSpec(mode="pipelined"))
        server = spec.resolve(host).server(res_vecs=res_vecs)
        for i, (pr, out) in enumerate(batch2):
            server.submit(Request(rid=i, prompt=pr, max_new_tokens=len(out)))
        t0 = time.perf_counter()
        done = server.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = {r.rid: r.output for r in done}
        same = [got.get(i) for i in range(len(batch2))] \
            == [out for _, out in batch2]
        ok = ok and same
        mt, st = server.metrics, server.store.stats()
        ttft = [r.ttft for r in done]
        print(f"policy {pol}: decode {mt.decode_tokens / mt.decode_s:.1f} "
              f"tok/s, TTFT p50 {np.percentile(ttft, 50) * 1e3:.1f} ms | "
              f"h2d_rows={st['h2d_rows']} fallback_fetches="
              f"{st['fallback_fetches']} | DALI hits/lookups "
              f"{mt.dali.hits}/{mt.dali.lookups} | {mt.steps} steps in "
              f"{wall:.2f} s | tokens "
              f"{'identical to' if same else 'DIFFER from'} phase 5's "
              f"batch-2 serve | on {name}", flush=True)
        del server
        free(torch)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()       # ... and ends here
    print(f"policies: phase {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    return ok, counts


# --------------------------------------------------------------------------
# phase 9: training on the card
# --------------------------------------------------------------------------

def train_phase(torch, kernels, name):
    """(a) full width at 2 layers: 3 AdamW steps, every leaf's gradient
    finite and non-zero, the backward recomputes timed; (b) one step's
    gradients on the card against the CPU's on a small bfloat16 model;
    (c) the launcher's path: smoke training, residual vectors full-resident
    and through the slot pool (bit-equal), an offloaded serve of the
    trained model (tokens identical to full-resident)."""
    t_phase = time.perf_counter()
    free(torch)
    print(f"train: {torch.cuda.memory_allocated() / 1e9:.2f} GB allocated "
          "on the card at the start of the phase", flush=True)
    ok_a, counts = train_full_width(torch, kernels, name)
    ok_b = train_parity(torch, kernels)
    ok_c = train_launcher_path(torch, name)
    print(f"train: phase {time.perf_counter() - t_phase:.1f} s", flush=True)
    return ok_a and ok_b and ok_c, counts


def train_full_width(torch, kernels, name):
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import MarkovCorpus, batches
    from repro_torch.launch.train import training_bytes
    from repro_torch.models.model import init_model
    from repro_torch.training.optimizer import (OptConfig, adamw_update,
                                                init_adamw)
    from repro_torch.training.train_step import (make_loss_fn,
                                                 make_train_step,
                                                 value_and_grad)
    from repro_torch.tree import tree_leaves

    full = get_config("mixtral-8x7b")
    cfg = full.replace(n_layers=TRAIN_LAYERS)
    t0 = time.perf_counter()
    params = init_model(cfg, seed=0, device="cuda")
    opt = init_adamw(params)
    torch.cuda.synchronize()
    n = sum(t.numel() for t in tree_leaves(params))
    pbytes = sum(t.numel() * t.element_size() for t in tree_leaves(params))
    print(f"train (a): {cfg.name} at published widths, depth cut from "
          f"{full.n_layers} to {cfg.n_layers} layers, {n / 1e9:.3f} G "
          f"params in {cfg.param_dtype}, random from seed 0; params "
          f"{pbytes / 1e9:.1f} GB + gradients and AdamW moments "
          f"{training_bytes(params) / 1e9:.1f} GB; built in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    # warmup as train_loop sets it: min(50, steps // 10 + 1)
    oc = OptConfig(lr=1e-4, warmup_steps=min(50, TRAIN_STEPS // 10 + 1),
                   total_steps=TRAIN_STEPS)
    loss_fn = make_loss_fn(cfg)
    corpus = MarkovCorpus(vocab=cfg.vocab, seed=0)
    ok = True
    kernels.reset_launch_counts()          # the training path starts here
    torch.cuda.reset_peak_memory_stats()
    for i, b in enumerate(batches(corpus, TRAIN_BATCH, TRAIN_SEQ,
                                  TRAIN_STEPS, seed=0)):
        batch = {k: torch.as_tensor(v, device="cuda") for k, v in b.items()}
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        ev[0].record()
        (_, m), grads = value_and_grad(loss_fn, params, batch)
        ev[1].record()
        params, opt, om = adamw_update(params, grads, opt, oc)
        ev[2].record()
        ev[2].synchronize()
        # every leaf: a finite, non-zero gradient (AdamW reads the
        # gradients and leaves them as they were)
        bad = [j for j, g in enumerate(tree_leaves(grads))
               if not (bool(torch.isfinite(g).all())
                       and float(g.abs().max()) > 0)]
        del grads
        fb, upd = ev[0].elapsed_time(ev[1]), ev[1].elapsed_time(ev[2])
        fin = all(bool(torch.isfinite(v)) for v in m.values()) and bool(
            torch.isfinite(om["grad_norm"]))
        ok = ok and not bad and fin
        print(f"train (a) step {i + 1}: loss {float(m['loss']):.4f} ce "
              f"{float(m['ce']):.4f} aux {float(m['aux']):.4f} router_z "
              f"{float(m['router_z']):.5f} dropped {int(m['dropped'])} "
              f"grad_norm {float(om['grad_norm']):.4f} lr "
              f"{float(om['lr']):.2e} | step {fb + upd:.1f} ms (forward + "
              f"backward {fb:.1f} ms, AdamW {upd:.1f} ms, CUDA events; the "
              f"leaf check runs after them) | peak device memory "
              f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB | leaves "
              f"without a finite non-zero gradient: {bad or 'none'} | on "
              f"{name}", flush=True)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()       # ... and ends here
    # where the time goes in a step: one more, under torch.profiler
    batch = {k: torch.as_tensor(v, device="cuda") for k, v in next(iter(
        batches(corpus, TRAIN_BATCH, TRAIN_SEQ, 1, seed=1))).items()}

    train_step = make_train_step(cfg, oc)

    def one_step():
        train_step(params, opt, batch)

    busy, wall_us, groups, by_name = device_breakdown(torch, one_step)
    print(f"profile train step (full width, {cfg.n_layers} layers, batch "
          f"{TRAIN_BATCH} x {TRAIN_SEQ}): wall {wall_us / 1e3:.1f} ms, "
          f"device busy {busy / 1e3:.1f} ms = {100 * busy / wall_us:.1f}% of "
          f"wall, idle {100 - 100 * busy / wall_us:.1f}% | on {name}",
          flush=True)
    print_groups(groups, busy)
    for k, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:8]:
        print(f"profile   kernel {k[:90]}: {us / 1e3:.2f} ms "
              f"({100 * us / max(busy, 1e-9):.1f}%)", flush=True)
    need = ("gating", "expert_ffn_ragged", "flash_attention", "gating_bwd",
            "expert_ffn_bwd", "flash_attention_bwd")
    ran = all(counts[k] > 0 for k in need)
    ok = ok and ran
    print(f"train (a): launches {json.dumps(counts)}; K1, K2 ragged, K3 and "
          f"their backward recomputes all ran: {ran}", flush=True)
    backward_lines(torch, params, cfg, name)
    del params, opt
    free(torch)
    return ok, counts


def backward_lines(torch, params, cfg, name):
    """Each backward recompute at phase 9's shapes beside one PyTorch
    autograd call of the same function (not kernels: plain PyTorch)."""
    from repro_torch.kernels.expert_ffn.ops import expert_ffn_plain
    from repro_torch.kernels.flash_attention.ops import flash_attention_plain
    from repro_torch.kernels.gating.ops import _gates, _probs
    from repro_torch.models.moe import expert_capacity

    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    m, a = cfg.moe, cfg.attn
    T = TRAIN_BATCH * TRAIN_SEQ
    E, K, d, C = m.n_routed, m.top_k, cfg.d_model, expert_capacity(m, T)
    grad = lambda out, ins, g: torch.autograd.grad(out, ins, g)
    leaf = lambda t: t.detach().requires_grad_()
    mlp = params["scan"][0]["mlp"]
    ws = [leaf(mlp[k][0]) for k in ("gate", "up", "down")]
    idx = torch.randint(0, E, (T, K), generator=gen, device="cuda")
    counts = torch.bincount(idx.reshape(-1), minlength=E).clamp(max=C) \
        .to(torch.int32)
    xe = leaf(torch.randn((E, C, d), generator=gen, device="cuda")
              .bfloat16())
    gy = torch.randn((E, C, d), generator=gen, device="cuda").bfloat16()

    def lib_ffn():
        h = torch.nn.functional.silu(torch.bmm(xe, ws[0])) \
            * torch.bmm(xe, ws[1])
        return torch.bmm(h, ws[2])

    Hq, Hkv, D = a.n_heads, a.n_kv_heads, a.head_dim
    q = leaf(torch.randn((TRAIN_BATCH, TRAIN_SEQ, Hq, D), generator=gen,
                         device="cuda").bfloat16())
    kv = [leaf(torch.randn((TRAIN_BATCH, TRAIN_SEQ, Hkv, D), generator=gen,
                           device="cuda").bfloat16()) for _ in range(2)]
    go = torch.randn(q.shape, generator=gen, device="cuda").bfloat16()
    qt, kt, vt = (leaf(t.detach().transpose(1, 2).contiguous())
                  for t in (q, *kv))
    lg = leaf(torch.randn((T, E), generator=gen, device="cuda"))
    gg = torch.randn((T, K), generator=gen, device="cuda")
    gp = torch.randn((T, E), generator=gen, device="cuda")
    sel = torch.topk(lg.detach(), K).indices

    def k1_recompute():
        probs = _probs(lg, m.router_type)
        return grad((_gates(lg, probs, sel, m.router_type, m.renormalize),
                     probs), [lg], (gg, gp))

    def k1_library():
        return grad((torch.softmax(torch.topk(lg, K).values, -1),
                     torch.softmax(lg, -1)), [lg], (gg, gp))

    for what, rec, lib in (
            (f"expert_ffn [train E={E} C={C} d={d} f={m.d_expert}]",
             lambda: grad(expert_ffn_plain(xe, *ws, counts), [xe, *ws], gy),
             lambda: grad(lib_ffn(), [xe, *ws], gy)),
            (f"flash_attention [train B={TRAIN_BATCH} S={TRAIN_SEQ} Hq={Hq} "
             f"Hkv={Hkv} D={D} causal]",
             lambda: grad(flash_attention_plain(q, *kv, causal=True),
                          [q, *kv], go),
             lambda: grad(torch.nn.functional.scaled_dot_product_attention(
                 qt, kt, vt, is_causal=True, enable_gqa=True),
                 [qt, kt, vt], go.transpose(1, 2))),
            (f"gating [train T={T} E={E} k={K} {m.router_type}]",
             k1_recompute, k1_library)):
        rec_ms = cuda_ms(torch, rec, budget_s=0.5, max_iters=10)
        lib_ms = cuda_ms(torch, lib, budget_s=0.5, max_iters=10)
        print(f"backward {what}: plain recompute + autograd "
              f"{rec_ms:.4f} ms, one PyTorch autograd call of the same "
              f"function {lib_ms:.4f} ms (CUDA events; not kernels) | on "
              f"{name}", flush=True)
    del ws, xe, q, kv, qt, kt, vt
    free(torch)


def train_parity(torch, kernels, arch="mixtral-8x7b", n_layers=2,
                 bf16_floor=False, seed=1):
    """One step's gradients on the card (kernels, autograd Functions)
    against the same step on the CPU (plain versions), the smoke model of
    ``arch`` at ``n_layers`` layers (None: its whole period) from ``seed``,
    bfloat16; a VLM or audio arch trains against a float32 cross source
    (the launcher's dtype), its cross gates opened (``open_gates``).  Every
    leaf within 3e-2 relative to max |ref| of the CPU's.

    With ``bf16_floor`` a leaf outside that may pass on a bound that
    bfloat16 itself sets: such a leaf's gradient sums many cancelling terms
    (a gate's, a conv filter's, ``A_log``'s), and two bfloat16 steps of one
    function part there by more than 3e-2 (on the CPU the JAX package's
    bfloat16 step and the port's do on 102 of Jamba's 164 leaves,
    tests/test_torch_archs_bf16.py).  The leaf then passes only if the card
    lies no farther from the float32 step (CPU, same routing) than the
    farthest of three other bfloat16 steps of the same function does, plus
    3e-2: the CPU's; the CPU's with the kernels' own rounding
    (``kernel_rounding``: K2's SwiGLU product, K3's operands, probabilities
    and output rounded to bfloat16 where the CUDA kernels round them); and
    the card's own with the plain versions in place of the kernels (the
    card's op order; what differs from the card's step is the kernels
    alone).

    A bfloat16 near-tie can route a token to another expert on one device
    (phase 4), and that token's expert then differs: every other step takes
    the card's routing (its ``idx``, with gates and probs computed from its
    own logits), so all differentiate the same function.  How many tokens
    the CPU's own routing would have sent elsewhere is printed."""
    import repro_torch.kernels.expert_ffn.ops as ffn_ops
    import repro_torch.kernels.flash_attention.ops as fa_ops
    import repro_torch.models.moe as moe
    from repro_torch.configs import get_config, make_smoke
    from repro_torch.data.pipeline import MarkovCorpus, batches
    from repro_torch.kernels.gating.ops import _gates, _probs, gating_plain
    from repro_torch.models.config import layer_pattern
    from repro_torch.models.model import init_model
    from repro_torch.training.train_step import make_loss_fn, value_and_grad
    from repro_torch.tree import tree_leaves, tree_map, tree_map_with_path

    cfg = make_smoke(get_config(arch))
    cfg = cfg.replace(n_layers=n_layers or cfg.n_layers, dtype="bfloat16",
                      param_dtype="bfloat16")
    tag = "" if arch == "mixtral-8x7b" else f" {cfg.name}"
    if seed != 1:
        tag += f" seed {seed}"
    cpu = open_gates(torch, init_model(cfg, seed=seed, device="cpu"))
    gpu = tree_map(lambda t: t.to("cuda"), cpu)
    loss_fn = make_loss_fn(cfg)
    b = next(iter(batches(MarkovCorpus(vocab=cfg.vocab, seed=seed + 1), 2,
                          64, 1, seed=seed + 1)))
    bc = {k: torch.as_tensor(v) for k, v in b.items()}
    src = cross_source(torch, cfg, 2, seed=seed + 1)
    if src is not None:
        bc["cross_src"] = src
    bg = {k: t.to("cuda") for k, t in bc.items()}
    real, card_idx, moved = moe.gating, [], []

    def record(logits, *args):
        out = real(logits, *args)
        card_idx.append(out[1].detach().cpu())
        return out

    def card_routing(logits, top_k, router_type, renormalize):
        own = gating_plain(logits.detach(), top_k, router_type,
                           renormalize)[1]
        idx = card_idx[len(moved) % len(card_idx)].to(logits.device)
        moved.append(int((own.sort(-1).values != idx.sort(-1).values)
                         .any(-1).sum()))
        x = logits.float()
        probs = _probs(x, router_type)
        return _gates(x, probs, idx, router_type, renormalize), idx, probs

    def replay(params, batch, cfg_=cfg):
        """One more step on the card's routing; ``moved`` keeps the first
        replay's counts."""
        n = len(moved)
        out = value_and_grad(make_loss_fn(cfg_), params, batch)[1]
        del moved[n:]
        return out

    kernels.reset_launch_counts()
    wit = {}
    try:
        moe.gating = record
        (_, mg), gg = value_and_grad(loss_fn, gpu, bg)
        torch.cuda.synchronize()
        moe.gating = card_routing
        (_, mc), gc = value_and_grad(loss_fn, cpu, bc)
        counts = dict(kernels.LAUNCHES)
        if bf16_floor:
            cfg32 = cfg.replace(dtype="float32", param_dtype="float32")
            wit["f32"] = replay(
                tree_map(lambda t: t.float(), cpu),
                {k: (t.float() if t.is_floating_point() else t)
                 for k, t in bc.items()}, cfg32)
            with kernel_rounding(torch, ffn_ops, fa_ops):
                wit["rounded"] = replay(cpu, bc)
            with plain_on_card(ffn_ops, fa_ops):
                wit["card_plain"] = replay(gpu, bg)
    finally:
        moe.gating = real
    pattern = layer_pattern(cfg)
    need = (["gating_bwd", "expert_ffn_bwd"]
            if any(m == "moe" for _, m in pattern) else []) \
        + (["flash_attention_bwd"]
           if any(x != "mamba" for x, _ in pattern) else [])
    bwd = {k: counts[k] for k in need}
    errs = [rel_err(g.cpu(), r) for g, r in zip(tree_leaves(gg),
                                                tree_leaves(gc))]
    leaf_ok = [e < BF16_TOL for e in errs]
    if wit:
        paths = []
        tree_map_with_path(lambda path, t: paths.append(
            "/".join(map(str, path))), gg)
        leaves = {k: tree_leaves(v) for k, v in wit.items()}
        for i, (g, c) in enumerate(zip(tree_leaves(gg), tree_leaves(gc))):
            if leaf_ok[i]:
                continue
            f, g = leaves["f32"][i], g.cpu()
            cp, rd = leaves["card_plain"][i].cpu(), leaves["rounded"][i]
            e_cf, e_bf, e_pf, e_rd = (rel_err(t, f) for t in (g, c, cp, rd))
            limit = BF16_TOL + max(e_bf, e_rd, e_pf)
            leaf_ok[i] = e_cf <= limit
            print(f"train (b){tag} leaf {paths[i]}: card against CPU "
                  f"{errs[i]:.3e}; against the float32 step: card "
                  f"{e_cf:.3e}; CPU bfloat16 {e_bf:.3e}, the CPU with the "
                  f"kernels' rounding {e_rd:.3e}, the card's plain step "
                  f"{e_pf:.3e} (limit {limit:.3e}) | "
                  f"{'pass' if leaf_ok[i] else 'FAIL'} | card against the "
                  f"CPU with the kernels' rounding {rel_err(g, rd):.3e}, "
                  f"against its plain step {rel_err(g, cp):.3e}", flush=True)
    m_err = {k: rel_err(mg[k].cpu().reshape(1), mc[k].reshape(1))
             for k in ("ce", "aux", "router_z")}
    ok = (all(leaf_ok) and all(e < BF16_TOL for e in m_err.values())
          and int(mg["dropped"]) == int(mc["dropped"])
          and all(v > 0 for v in bwd.values()))
    print(f"train (b){tag}: one step's gradients, card (kernels) against "
          f"CPU (plain) on the card's routing ({sum(moved)} of "
          f"{len(moved) * b['tokens'].size} (layer, token) rows the CPU "
          f"would have routed elsewhere), {len(errs)} leaves: max rel_err "
          f"{max(errs):.3e} (leaf {errs.index(max(errs))}), "
          f"{sum(e >= BF16_TOL for e in errs)} outside {BF16_TOL}; ce / "
          "aux / router_z rel_err " + " / ".join(f"{m_err[k]:.3e}"
                                                  for k in m_err)
          + f"; dropped {int(mg['dropped'])} / {int(mc['dropped'])}; "
          f"backward recomputes {json.dumps(bwd)} | "
          f"{'pass' if ok else 'FAIL'}", flush=True)
    return ok


@contextlib.contextmanager
def kernel_rounding(torch, ffn_ops, fa_ops):
    """The CPU's plain K2 and K3 rounded where the CUDA kernels round: K2's
    SwiGLU product h to the activations' dtype before the down projection
    (as the reference's Pallas kernel does too); K3's operands to
    bfloat16, its unnormalised probabilities to bfloat16 before P V (the
    Pallas kernel keeps them in float32) and its output to bfloat16.  A
    witness for train_parity only."""
    real_ffn, real_fa = ffn_ops.expert_ffn_plain, fa_ops.flash_attention_plain

    def ffn(xe, w_gate, w_up, w_down, counts=None, expert_ids=None,
            act="silu"):
        G, C, d = xe.shape
        fn = ffn_ops.ACTS[act]
        valid = (torch.ones((G, C), dtype=torch.bool) if counts is None
                 else torch.arange(C)[None, :] < counts[:, None])
        x = torch.where(valid[..., None], xe, 0).float()
        eids = expert_ids.tolist() if expert_ids is not None else range(G)
        out = [((fn(x[g] @ w_gate[e].float()) * (x[g] @ w_up[e].float()))
                .to(xe.dtype).float() @ w_down[e].float())
               for g, e in enumerate(eids)]
        out = torch.stack(out) if out else x.new_zeros((0, C, d))
        return torch.where(valid[..., None], out, 0).to(xe.dtype)

    def fa(q, k, v, *, causal=True, window=0, softcap=0.0, scale=None):
        dt = q.dtype
        # the card's operands are bfloat16 (``attention._k3`` rounds a
        # float32 encoder's at the kernel's boundary)
        q, k, v = (t.to(torch.bfloat16) for t in (q, k, v))
        B, Sq, Hq, D = q.shape
        Sk, Hkv = k.shape[1], k.shape[2]
        scale = scale if scale is not None else D ** -0.5
        qg = q.reshape(B, Sq, Hkv, Hq // Hkv, D).float()
        s = torch.einsum("bqkgd,bskd->bkgqs", qg, k.float()) * scale
        if softcap:
            s = softcap * torch.tanh(s / softcap)
        valid = fa_ops.attn_mask(torch.arange(Sk - Sq, Sk),
                                 torch.arange(Sk), causal=causal,
                                 window=window)
        s = torch.where(valid[:, None, None], s, fa_ops.NEG_INF)
        p = torch.exp(s - s.amax(-1, keepdim=True))
        o = torch.einsum("bkgqs,bskd->bqkgd",
                         p.to(torch.bfloat16).float(), v.float())
        o = o / p.sum(-1).permute(0, 3, 1, 2)[..., None]
        return o.reshape(B, Sq, Hq, -1).to(torch.bfloat16).to(dt)

    ffn_ops.expert_ffn_plain, fa_ops.flash_attention_plain = ffn, fa
    try:
        yield
    finally:
        ffn_ops.expert_ffn_plain = real_ffn
        fa_ops.flash_attention_plain = real_fa


@contextlib.contextmanager
def plain_on_card(ffn_ops, fa_ops):
    """K2 and K3 on CUDA tensors through their plain versions (the kernels
    not launched, nothing counted).  A witness for train_parity only."""
    real_ffn, real_fa = ffn_ops._launch, fa_ops._launch
    ffn_ops._launch = (lambda xe, wg, wu, wd, counts, eids, act:
                       ffn_ops.expert_ffn_plain(xe, wg, wu, wd, counts, eids,
                                                act))
    fa_ops._launch = (lambda q, k, v, causal, window, softcap, scale:
                      fa_ops.flash_attention_plain(
                          q, k, v, causal=causal, window=window,
                          softcap=softcap, scale=scale))
    try:
        yield
    finally:
        ffn_ops._launch, fa_ops._launch = real_ffn, real_fa


def train_launcher_path(torch, name):
    import numpy as np

    from repro_torch.configs import get_config, make_smoke
    from repro_torch.core.residual import calibrate_residuals
    from repro_torch.core.tracing import capture_decode_trace
    from repro_torch.data.pipeline import MarkovCorpus
    from repro_torch.launch.train import train_loop
    from repro_torch.models.model import experts_to_host
    from repro_torch.serving.spec import OffloadSpec, ServeSpec
    from repro_torch.serving.steps import default_dali_config

    cfg = make_smoke(get_config("mixtral-8x7b")).replace(
        n_layers=4, dtype="bfloat16", param_dtype="bfloat16")
    corpus = MarkovCorpus(vocab=cfg.vocab, seed=0)
    t0 = time.perf_counter()
    params, _, hist = train_loop(cfg, SMOKE_STEPS, 8, 64, corpus=corpus,
                                 seed=0, device="cuda", log_every=40)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    falls = hist[-1] < hist[0]
    print(f"train (c): {cfg.name} at {cfg.n_layers} layers ({cfg.dtype}) "
          f"trained {SMOKE_STEPS} steps of batch 8 x 64 in {wall:.1f} s "
          f"({wall / SMOKE_STEPS * 1e3:.1f} ms per step, host clock): ce "
          f"{hist[0]:.4f} -> {hist[-1]:.4f}, falls: {falls} | on {name}",
          flush=True)
    rng = np.random.default_rng(1)
    calib = np.stack([corpus.sample(rng, 32) for _ in range(8)])
    res_full = np.stack(calibrate_residuals([capture_decode_trace(
        params, cfg, calib, n_decode=16)]))
    host = experts_to_host(params, cfg, "cuda")
    dcfg = default_dali_config(cfg, cache_ratio=0.5)
    spec = lambda mode: ServeSpec(cfg=cfg, policy="dali", dali_cfg=dcfg,
                                  batch_size=2, max_len=256, eos_id=-1,
                                  offload=OffloadSpec(mode=mode))
    rs = spec("pipelined").resolve(host)
    res_slot = slot_res_vecs(rs, cfg, calib, n_decode=16)
    same_res = bool(np.array_equal(res_full, res_slot))
    print(f"train (c): residual vectors full-resident and through the "
          f"pipelined slot pool bit-equal: {same_res} (|res| sum "
          f"{float(np.abs(res_full).sum()):.4f})", flush=True)
    reqs = [corpus.sample(rng, int(rng.integers(24, 65))) for _ in range(4)]
    outs = {}
    for mode, r in (("modeled", spec("modeled").resolve(params)),
                    ("pipelined", rs)):
        res = res_full if mode == "modeled" else res_slot
        server, done, wall = run_requests(torch, r.server(res_vecs=res),
                                          reqs, 16)
        outs[mode] = {d.rid: d.output for d in done}
        mt = server.metrics
        line = (f"train (c) serve {mode} batch=2: {len(done)} requests, "
                f"{mt.steps} steps in {wall:.2f} s | decode "
                f"{mt.decode_tokens / mt.decode_s:.1f} tok/s | "
                f"{mt.dali.summary()} hits={mt.dali.hits} "
                f"lookups={mt.dali.lookups}")
        if server.store is not None:
            st = server.store.stats()
            line += (f" | h2d_rows={st['h2d_rows']} fallback_fetches="
                     f"{st['fallback_fetches']}")
        print(f"{line} | on {name}", flush=True)
        del server
    same = outs["pipelined"] == outs["modeled"] and len(outs["modeled"]) == 4
    print(f"train (c): offloaded tokens identical to full-resident: {same}",
          flush=True)
    del rs, host, params
    free(torch)
    return falls and same_res and same


# --------------------------------------------------------------------------
# phase 10: Qwen3-30B-A3B and DeepSeek-V2-Lite
# --------------------------------------------------------------------------

NEW_MODEL_LAYERS = 8         # (b) and (c): the depth both serve at
MODEL_PATH_KERNELS = ("gating_warp", "expert_ffn_ragged",
                      "expert_ffn_grouped", "flash_attention")


def models_phase(torch, kernels, name):
    """(a) the smoke model of each family on the card against the CPU
    (phase 4) and one training step's gradients (phase 9 (b)); (b) 8
    layers at published widths, full-resident: residual calibration, then
    the ``dali`` policy through ``ContinuousBatchServer`` at batch 8 and
    batch 2, every kernel of the path launched; (c) the batch-2 requests
    offloaded (pipelined, fetch tier, cache ratio 0.25, calibrated through
    the slot pool), tokens equal to (b)'s; (d) every layer of each model,
    full-resident, one after the other.  Returns (ok, launch counts of (b)
    by model tag)."""
    t_phase = time.perf_counter()
    ok, counts, full = True, {}, []
    for tag, arch in NEW_MODELS:
        t0 = time.perf_counter()
        ok_a = reference_phase(torch, arch)
        ok_a = train_parity(torch, kernels, arch) and ok_a
        ok_b, counts[tag], ctx = model_serve(torch, kernels, name, arch)
        ok_c = model_offload(torch, name, ctx)
        full.append(ctx["full_bytes"])
        del ctx
        free(torch)
        print(f"models {tag}: (a) {'pass' if ok_a else 'FAIL'}, (b) "
              f"{'pass' if ok_b else 'FAIL'}, (c) "
              f"{'pass' if ok_c else 'FAIL'} in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        ok = ok and ok_a and ok_b and ok_c
    for (tag, arch), nbytes in zip(NEW_MODELS, full):
        ok = model_full_depth(torch, name, arch, nbytes) and ok
    print(f"models: phase {time.perf_counter() - t_phase:.1f} s", flush=True)
    return ok, counts


def model_serve(torch, kernels, name, arch):
    """(b): 8 layers of ``arch`` full-resident through the continuous
    server with ``dali``; the launch counters are zeroed just before and
    read just after."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.core.residual import calibrate_residuals
    from repro_torch.core.tracing import capture_decode_trace
    from repro_torch.data.pipeline import MarkovCorpus
    from repro_torch.models.model import init_model
    from repro_torch.serving.scheduler import Request
    from repro_torch.serving.spec import ServeSpec
    from repro_torch.serving.steps import default_dali_config
    from repro_torch.tree import tree_leaves

    full = get_config(arch)
    cfg = full.replace(n_layers=NEW_MODEL_LAYERS)
    a, m = cfg.attn, cfg.moe
    print(f"models: {cfg.name} at published widths (d_model {cfg.d_model}, "
          f"{m.n_routed} experts top-{m.top_k} of d_ff {m.d_expert}"
          + (f" + {m.n_shared} shared ({m.d_shared})" if m.n_shared else "")
          + (f", first {m.first_dense} dense (d_ff {cfg.d_ff})"
             if m.first_dense else "")
          + (f", MLA {a.n_heads} heads, latent {a.mla.kv_lora_rank}, q/k "
             f"{a.mla.qk_nope_head_dim}+{a.mla.qk_rope_head_dim}, v "
             f"{a.mla.v_head_dim}" if a.mla is not None else
             f", {a.n_heads}q/{a.n_kv_heads}kv heads of {a.head_dim}"
             + (" qk-norm" if a.qk_norm else ""))
          + f", vocab {cfg.vocab}); depth cut from {full.n_layers} to "
          f"{cfg.n_layers} layers", flush=True)
    t0 = time.perf_counter()
    params = init_model(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    nbytes = lambda tree: sum(t.numel() * t.element_size()
                              for t in tree_leaves(tree))
    n_super = cfg.n_layers - len(params["prefix"])
    block = nbytes(params["scan"]) / n_super
    full_bytes = nbytes(params) + (full.n_layers - cfg.n_layers) * block
    print(f"models {cfg.name}: random weights from seed 0, "
          f"{nbytes(params) / 1e9:.2f} GB at {cfg.n_layers} layers "
          f"({full_bytes / 1e9:.2f} GB at {full.n_layers}), "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    corpus = MarkovCorpus(vocab=cfg.vocab, seed=0)
    rng = np.random.default_rng(1)
    kernels.reset_launch_counts()          # this model's path starts here
    calib = np.stack([corpus.sample(rng, 32) for _ in range(8)])
    res_vecs = np.stack(calibrate_residuals([capture_decode_trace(
        params, cfg, calib, n_decode=8)]))
    dcfg = default_dali_config(cfg, cache_ratio=0.5)
    spec = lambda batch: ServeSpec(cfg=cfg, policy="dali", dali_cfg=dcfg,
                                   batch_size=batch, max_len=MAX_LEN,
                                   eos_id=-1)
    ok, batch2 = True, []
    for batch, n_req in ((8, 8), (2, 4)):
        prompts = [corpus.sample(rng, int(rng.integers(24, 201)))
                   for _ in range(n_req)]
        server, done, wall = run_requests(
            torch, spec(batch).resolve(params).server(res_vecs=res_vecs),
            prompts, 16)
        mt = server.metrics
        budget_ok = len(done) == n_req and all(len(r.output) == 16
                                               for r in done)
        ok = ok and budget_ok and mt.dali.lookups > 0
        ttft = [r.ttft for r in done]
        print(f"models {cfg.name} batch={batch}: {len(done)} requests, "
              f"{mt.prefill_tokens} prompt tokens, {mt.decode_tokens} decode "
              f"tokens, {mt.steps} steps in {wall:.2f} s | prefill "
              f"{mt.prefill_tokens / mt.prefill_s:.1f} tok/s, decode "
              f"{mt.decode_tokens / mt.decode_s:.1f} tok/s, TTFT p50 "
              f"{np.percentile(ttft, 50) * 1e3:.1f} ms | {mt.dali.summary()} "
              f"lookups={mt.dali.lookups} | budgets "
              f"{'ok' if budget_ok else 'FAIL'} | on {name}", flush=True)
        if batch == 2:
            got = {r.rid: r.output for r in done}
            batch2 = [(p, got[i]) for i, p in enumerate(prompts)]
        del server
    torch.cuda.synchronize()
    counts = kernels.launch_counts()       # ... and ends here
    launched = all(counts[k] > 0 for k in MODEL_PATH_KERNELS)
    print(f"models {cfg.name}: kernel launches {json.dumps(counts)}; "
          f"{', '.join(MODEL_PATH_KERNELS)} each launched: {launched}",
          flush=True)
    # where the time goes: 8 requests x 8 tokens at batch 8, profiled
    server = spec(8).resolve(params).server(res_vecs=res_vecs)
    for i in range(8):
        server.submit(Request(rid=i, prompt=corpus.sample(
            rng, int(rng.integers(24, 201))), max_new_tokens=8))
    profile_window(torch, server, name,
                   label=f"{cfg.name} {cfg.n_layers} layers batch=8 serve")
    del server
    ctx = {"cfg": cfg, "params": params, "calib": calib, "res": res_vecs,
           "batch2": batch2, "full_bytes": full_bytes}
    return ok and launched, counts, ctx


def model_offload(torch, name, ctx):
    """(c): (b)'s batch-2 requests offloaded, pipelined with the fetch tier
    at cache ratio 0.25, residual vectors calibrated through the slot pool
    (bit-equal to (b)'s): tokens equal to (b)'s; the routed stacks on the
    host, the dense prefix FFN and the shared experts on the card."""
    import numpy as np

    from repro_torch.models.model import experts_to_host
    from repro_torch.serving.spec import OffloadSpec, ServeSpec
    from repro_torch.serving.steps import default_dali_config

    cfg = ctx["cfg"]
    host = experts_to_host(ctx.pop("params"), cfg, "cuda")
    free(torch)
    rs = ServeSpec(cfg=cfg, policy="dali",
                   dali_cfg=default_dali_config(cfg, cache_ratio=0.25),
                   batch_size=2, max_len=MAX_LEN, eos_id=-1,
                   offload=OffloadSpec(mode="pipelined")).resolve(host)
    t0 = time.perf_counter()
    res = slot_res_vecs(rs, cfg, ctx["calib"])
    same_res = bool(np.array_equal(res, ctx["res"]))
    print(f"models {cfg.name} offloaded: residual vectors through the slot "
          f"pool in {time.perf_counter() - t0:.1f} s, bit-equal to the "
          f"full-resident ones: {same_res}", flush=True)
    mlp = rs.params["scan"][0]["mlp"]
    placed = (rs.store.host["gate"].device.type == "cpu"
              and rs.store.host["gate"].is_pinned()
              and all(k not in mlp for k in ("gate", "up", "down"))
              and all(t.is_cuda for p in rs.params["prefix"]
                      for t in p["mlp"].values())
              and all(t.is_cuda for t in mlp.get("shared", {}).values()))
    prompts = [p for p, _ in ctx["batch2"]]
    server, done, wall = run_requests(torch, rs.server(res_vecs=res),
                                      prompts, 16)
    got = {r.rid: r.output for r in done}
    same = [got.get(i) for i in range(len(prompts))] \
        == [out for _, out in ctx["batch2"]]
    lay = server.store.memory_layout()
    print(f"models {cfg.name} offloaded: pool {lay['pool_bytes'] / 1e9:.2f} "
          f"GB of {lay['full_resident_bytes'] / 1e9:.2f} GB experts "
          f"({server.store.n_slots} of {cfg.moe.n_routed} slots per layer); "
          "routed stacks on the host, dense prefix FFN and shared experts "
          f"on the card: {placed}", flush=True)
    st = server.store.stats()
    offload_line(f"{cfg.name} {cfg.n_layers} layers pipelined fetch "
                 f"cache_ratio=0.25 batch=2 (tokens "
                 f"{'identical to' if same else 'DIFFER from'} the "
                 f"full-resident serve; H2D {st['h2d_bytes'] / 1e9:.2f} GB "
                 "streamed)", server, done, wall, name)
    del server, rs, host
    return same_res and placed and same


def model_full_depth(torch, name, arch, full_bytes):
    """(d): every layer of ``arch`` at published widths, full-resident when
    its weights fit beside what the card already holds (else pipelined at
    cache ratio 0.25, said so): 2 requests x 8 tokens at batch 2."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import MarkovCorpus
    from repro_torch.models.model import init_model
    from repro_torch.serving.spec import OffloadSpec, ServeSpec
    from repro_torch.serving.steps import default_dali_config
    from repro_torch.tree import tree_leaves

    free(torch)
    cfg = get_config(arch)
    t0 = time.perf_counter()
    free_b = torch.cuda.mem_get_info()[0]
    resident = full_bytes + 4e9 < free_b
    print(f"models {cfg.name} full depth: {cfg.n_layers} layers, "
          f"{full_bytes / 1e9:.2f} GB of weights, {free_b / 1e9:.2f} GB "
          f"free on the card -> "
          f"{'full-resident' if resident else 'pipelined, cache ratio 0.25'}",
          flush=True)
    torch.cuda.reset_peak_memory_stats()
    params = init_model(cfg, seed=0, device="cuda",
                        experts="device" if resident else "host")
    torch.cuda.synchronize()
    weights = sum(t.numel() * t.element_size() for t in tree_leaves(params))
    print(f"models {cfg.name} full depth: random weights from seed 0, "
          f"{weights / 1e9:.2f} GB in {time.perf_counter() - t0:.1f} s",
          flush=True)
    rng = np.random.default_rng(3)
    corpus = MarkovCorpus(vocab=cfg.vocab, seed=0)
    prompts = [corpus.sample(rng, int(rng.integers(24, 201)))
               for _ in range(2)]
    spec = ServeSpec(cfg=cfg, policy="dali",
                     dali_cfg=default_dali_config(
                         cfg, cache_ratio=0.5 if resident else 0.25),
                     batch_size=2, max_len=MAX_LEN, eos_id=-1,
                     offload=OffloadSpec(
                         mode="modeled" if resident else "pipelined"))
    server, done, wall = run_requests(torch, spec.resolve(params).server(),
                                      prompts, 8)
    mt = server.metrics
    peak = torch.cuda.max_memory_allocated()
    ok = (len(done) == 2 and all(len(r.output) == 8 for r in done)
          and (peak < weights if not resident else True))
    print(f"models {cfg.name} full depth {cfg.n_layers} layers "
          f"{'full-resident' if resident else 'pipelined'}: {len(done)} "
          f"requests, {mt.steps} steps in {wall:.2f} s | decode "
          f"{mt.decode_tokens / mt.decode_s:.1f} tok/s, prefill "
          f"{mt.prefill_tokens / mt.prefill_s:.1f} tok/s | peak device "
          f"memory {peak / 1e9:.2f} GB | {'pass' if ok else 'FAIL'} | on "
          f"{name}", flush=True)
    del server, params
    free(torch)
    return ok


# --------------------------------------------------------------------------
# phase 11: fault-tolerant offload streaming
# --------------------------------------------------------------------------

FAULT_RUNS = ("transient_stall@2-5", "read_error@1-4", "corrupt_rows@1-8")
FAULT_NEW = 16               # (b): the first two requests, 16 tokens each
# (c): steps 1-4 calibrate the watchdog, 3 late steps from step 5 trip
# DEGRADED, 6 degraded steps move it to LITTLE; the slowdown ends at step
# 25 and 3 on-time probes (one each 3 steps) heal it
LADDER_FAULT = "link_degrade:x12@5-25"
LITTLE_TOL = 0.2             # the reference's bound on the little rung


class StepRecorder:
    """Wraps a server's ``ResilientDecode``: records each step's rung, the
    last-position logits of its live rows and the step's start (the host
    clock at the store's ``pre_step``), and zeroes the kernels' launch
    counters just before the first little step's decode and reads them
    just after the last one."""

    def __init__(self, torch, kernels, server):
        self.torch, self.kernels = torch, kernels
        self.decode, self.store = server._decode, server.store
        self.steps, self.little_counts = [], None
        self._in_little = False
        server._decode = self
        if self.store is not None:
            pre = self.store.pre_step

            def pre_step(*a, **kw):
                self.steps.append({"t": time.perf_counter()})
                return pre(*a, **kw)

            self.store.pre_step = pre_step

    def react(self):
        return self.decode.react()

    @property
    def active(self):
        return getattr(self.decode, "active", "healthy")

    def __call__(self, params, state, res_vecs=None):
        if self.store is None:
            self.steps.append({"t": time.perf_counter()})
        rung = self.active
        if rung == "little" and not self._in_little:
            self.torch.cuda.synchronize()
            self.kernels.reset_launch_counts()
            self._tel0 = self.store.stats()
            self._in_little = True
        elif rung != "little" and self._in_little:
            self._close_little()
        live = state["active"].clone()
        out = self.decode(params, state, res_vecs)
        self.steps[-1].update(rung=rung, logits=out[1][:, -1].float()[
            live].cpu())
        return out

    def _close_little(self):
        self.torch.cuda.synchronize()
        self.little_counts = self.kernels.launch_counts()
        tel = self.store.stats()
        self.little_tel = {k: tel[k] - self._tel0[k] for k in tel}
        self._in_little = False

    def rung_ms(self):
        """Median ms per step of each phase: healthy before the first
        fault transition, degraded, little, healthy after recovery."""
        import numpy as np
        out, seen_down = {}, False
        for a, b in zip(self.steps, self.steps[1:]):
            rung = a.get("rung", "healthy")
            seen_down = seen_down or rung != "healthy"
            key = ("recovered" if rung == "healthy" and seen_down else rung)
            out.setdefault(key, []).append((b["t"] - a["t"]) * 1e3)
        return {k: (float(np.median(v)), len(v)) for k, v in out.items()}


def faults_phase(torch, kernels, name, batch2, res_vecs):
    """(a) the link on the card: ``CostModel.calibrate_link`` fitted from
    copies of pinned expert-sized buffers, and one expert's copy against
    its bound at that rate; (b) phase 5's first two batch-2 requests under
    transient, read-error and corrupt-row faults in every mode (fetch tier,
    cache ratio 0.25) give phase 5's tokens; (c) the whole ladder in
    pipelined and overlap under a persistent x12 slowdown: healthy ->
    degraded -> little -> healthy, bit-equal logits before the little
    rung, the first little step within 0.2 of the fetch tier's, K4 launched
    on the little rung, fresh requests exact after recovery; (d) the
    launcher with ``--faults transient_stall --check-exact``.  Returns
    (ok, launch counts of (c)'s little window)."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.core.cost_model import CostModel
    from repro_torch.data.pipeline import MarkovCorpus
    from repro_torch.launch import serve as launcher
    from repro_torch.models.model import init_model
    from repro_torch.serving.expert_store import row_checksums
    from repro_torch.serving.spec import OffloadSpec, ServeSpec
    from repro_torch.serving.steps import default_dali_config
    from repro_torch.tree import tree_leaves

    t_phase = time.perf_counter()
    ok = True
    cfg = get_config("mixtral-8x7b").replace(n_layers=8)
    # (a) -- the link
    cm = CostModel.for_config(cfg)
    t0 = time.perf_counter()
    # a rejected fit (a negative latency: the link's tens of microseconds
    # lie below the jitter of copies that take milliseconds) is printed,
    # not failed: it is the fit's guard at work, and the watchdog
    # re-baselines from its own timings anyway
    fit = cm.calibrate_link(repeats=10)
    eb = int(cm.expert_bytes)
    print(f"faults (a): calibrate_link on the card (1, 2, 4, 8 experts of "
          f"{eb / 1e6:.1f} MB from pinned memory, 10 copies each, each "
          f"waited): {fit.link_gbps:.3f} GB/s, latency "
          f"{fit.link_latency_s * 1e6:.1f} us, link_fit_rejected="
          f"{fit.link_fit_rejected} (LOCAL_PC assumes "
          f"{cm.profile.link_gbps:.1f} GB/s, "
          f"{cm.profile.link_latency_s * 1e6:.0f} us); trans_time "
          f"{fit.trans_time * 1e3:.3f} ms against LOCAL_PC's "
          f"{cm.trans_time * 1e3:.3f} ms, {time.perf_counter() - t0:.1f} s "
          f"| on {name}", flush=True)

    t0 = time.perf_counter()
    host = init_model(cfg, seed=0, device="cuda", experts="host")
    torch.cuda.synchronize()
    weights = sum(t.numel() * t.element_size() for t in tree_leaves(host))
    print(f"faults: 8-layer Mixtral-8x7B from seed 0 ({weights / 1e9:.2f} "
          f"GB), experts pinned on the host, {time.perf_counter() - t0:.1f} "
          "s", flush=True)
    src = host["scan"][0]["mlp"]
    dst = {k: torch.empty(src[k].shape[2:], dtype=src[k].dtype,
                          device="cuda") for k in ("gate", "up", "down")}
    ms = []
    for _ in range(5):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for k in dst:
            dst[k].copy_(src[k][0, 0], non_blocking=True)
        b.record()
        b.synchronize()
        ms.append(a.elapsed_time(b))
    bound_ms = fit.trans_time * 1e3
    print(f"faults (a): one expert ({eb / 1e6:.1f} MB) from the pinned "
          f"store: {min(ms):.3f} ms best of 5 (CUDA events: "
          f"{', '.join(f'{m:.3f}' for m in ms)}), "
          f"{eb / (min(ms) / 1e3) / 1e9:.2f} GB/s, against "
          f"{bound_ms:.3f} ms at the fitted rate | on {name}", flush=True)
    del dst
    # the int8 quantizer on the card against the CPU, one expert
    w = src["gate"][0, 0]
    want = [w.float().abs().amax(dim=-2, keepdim=True)
            / torch.tensor(127.0)]
    want[0] = want[0].clamp_min(1e-8)
    want.append(torch.round(w.float() / want[0]).clamp_(-127, 127)
                .to(torch.int8))
    wc = w.cuda().float()
    sc = (wc.abs().amax(dim=-2, keepdim=True)
          / wc.new_tensor(127.0)).clamp_min(1e-8)
    got = [sc, torch.round(wc / sc).clamp_(-127, 127).to(torch.int8)]
    quant_ok = all(torch.equal(g.cpu(), r) for g, r in zip(got, want))
    sums = row_checksums(src["gate"][0, :4].cuda()).cpu()
    sums_ok = torch.equal(sums, row_checksums(src["gate"][0, :4]))
    ok = ok and quant_ok and sums_ok
    t0 = time.perf_counter()
    row_checksums(*(src[k][0, 1][None] for k in ("gate", "up", "down")))
    host_ms = (time.perf_counter() - t0) * 1e3
    print(f"faults (a): int8 twin of one expert card == CPU: {quant_ok}; "
          f"row checksums card == CPU: {sums_ok}; one expert's checksum "
          f"on the host (the pinned store's truth, once per (layer, "
          f"expert) and store): {host_ms:.1f} ms", flush=True)
    del w, wc, sc, got, want

    dcfg = default_dali_config(cfg, cache_ratio=0.25)

    def resolved(mode, faults):
        return ServeSpec(cfg=cfg, policy="dali", dali_cfg=dcfg,
                         batch_size=2, max_len=MAX_LEN, eos_id=-1,
                         offload=OffloadSpec(mode=mode, faults=faults)
                         ).resolve(host)

    # (b) -- transient and integrity faults are exact
    prompts = [p for p, _ in batch2[:2]]
    want_b = [out[:FAULT_NEW] for _, out in batch2[:2]]
    for mode in MODES:
        for faults in FAULT_RUNS:
            t0 = time.perf_counter()
            server, done, wall = run_requests(
                torch, resolved(mode, faults).server(res_vecs=res_vecs),
                prompts, FAULT_NEW)
            st = server.store.stats()
            got = {r.rid: r.output for r in done}
            same = [got.get(i) for i in range(2)] == want_b
            good = same and st["stage_aborts"] == 0
            if faults.startswith("transient"):
                good = good and st["stalls"] > 0
            elif faults.startswith("read_error"):
                good = good and st["read_errors"] > 0
            else:
                good = (good and st["corrupt_caught"] > 0
                        and st["restaged_rows"] >= st["corrupt_caught"])
            ok = ok and good
            print(f"faults (b) {mode} {faults}: tokens "
                  f"{'identical to' if same else 'DIFFER from'} phase 5's | "
                  f"{server.metrics.steps} steps in {wall:.2f} s, decode "
                  f"{server.metrics.decode_tokens / server.metrics.decode_s:.1f}"
                  f" tok/s | retries={st['retries']} stalls={st['stalls']} "
                  f"read_errors={st['read_errors']} stage_aborts="
                  f"{st['stage_aborts']} corrupt_caught={st['corrupt_caught']}"
                  f" restaged_rows={st['restaged_rows']} probes="
                  f"{st['probes']} h2d_rows={st['h2d_rows']} fallback_rows="
                  f"{st['fallback_rows']} | {'pass' if good else 'FAIL'} | "
                  f"on {name}", flush=True)
            del server
            free(torch)

    # (c) -- the whole ladder, against the fault-free fetch tier's steps
    prompts = [p for p, _ in batch2]
    ref_srv = resolved("pipelined", None).server(res_vecs=res_vecs)
    ref_rec = StepRecorder(torch, kernels, ref_srv)
    _, ref_done, _ = run_requests(torch, ref_srv, prompts, 32)
    ref_out = {r.rid: r.output for r in ref_done}
    same5 = [ref_out.get(i) for i in range(len(batch2))] \
        == [out for _, out in batch2]
    ok = ok and same5
    rng = np.random.default_rng(13)
    corpus = MarkovCorpus(vocab=cfg.vocab, seed=0)
    fresh = [corpus.sample(rng, int(rng.integers(24, 201))) for _ in range(2)]
    _, fresh_ref, _ = run_requests(torch, ref_srv, fresh, 8)
    fresh_ref = {r.rid: r.output for r in fresh_ref}
    del ref_srv
    little_counts = None
    for mode in ("pipelined", "overlap"):
        t0 = time.perf_counter()
        torch.cuda.reset_peak_memory_stats()
        server = resolved(mode, LADDER_FAULT).server(res_vecs=res_vecs)
        store = server.store
        t_little = time.perf_counter()
        store.little_view()            # the twins, built before the window
        torch.cuda.synchronize()
        t_little = time.perf_counter() - t_little
        rec = StepRecorder(torch, kernels, server)
        _, done, wall = run_requests(torch, server, prompts, 32)
        if rec._in_little:
            rec._close_little()
        rungs = [s.get("rung", "healthy") for s in rec.steps]
        trans = store.ladder.transitions
        path = [b for _, _, b in trans]
        full_ladder = path[:3] == ["degraded", "little", "healthy"]
        first = rungs.index("little") if "little" in rungs else len(rungs)
        pairs = list(zip(rec.steps[:first], ref_rec.steps[:first]))
        exact = all(torch.equal(a["logits"].argmax(-1),
                                b["logits"].argmax(-1)) for a, b in pairs)
        bitwise = all(torch.equal(a["logits"], b["logits"])
                      for a, b in pairs)
        err = float("nan")
        if first < len(rungs):
            a, b = rec.steps[first]["logits"], ref_rec.steps[first]["logits"]
            a, b = a[:, :cfg.vocab].double(), b[:, :cfg.vocab].double()
            err = float((a - b).norm() / b.norm())
        healed = store.ladder.state == "healthy"
        per = rec.rung_ms()
        n0 = len(rec.steps)
        _, fdone, _ = run_requests(torch, server, fresh, 8)
        fresh_ok = healed and {r.rid: r.output for r in fdone} == fresh_ref \
            and all(s.get("rung") == "healthy" for s in rec.steps[n0:])
        lc = rec.little_counts or {}
        k4 = lc.get("expert_ffn_grouped", 0) > 0
        lt = getattr(rec, "little_tel", {})
        good = (full_ladder and exact and err < LITTLE_TOL and fresh_ok
                and k4 and lt.get("fallback_rows", 0) > 0)
        ok = ok and good
        if mode == "pipelined":
            little_counts = lc
        st = store.stats()
        ttr = store.ladder.time_to_recover()
        down = next((s for s, a, _ in trans if a == "healthy"), None)
        up = next((s for s, _, b in reversed(trans) if b == "healthy"), None)
        rec_s = (rec.steps[up]["t"] - rec.steps[down]["t"]
                 if down is not None and up is not None
                 and up < len(rec.steps) else float("nan"))
        print(f"faults (c) {mode} {LADDER_FAULT}: transitions "
              + ", ".join(f"step {s}: {a}->{b}" for s, a, b in trans)
              + f" | full ladder: {full_ladder}; {first} steps before the "
              f"first little step: tokens equal to the fault-free run's "
              f"{exact}, logits bit-equal {bitwise}; "
              f"first little step's logits rel_err {err:.4f} against the "
              f"fetch tier (< {LITTLE_TOL}); time to recover {ttr} steps, "
              f"{rec_s:.2f} s; fresh requests after recovery identical to "
              f"the fault-free run: {fresh_ok} | "
              f"{'pass' if good else 'FAIL'} | on {name}", flush=True)
        print(f"faults (c) {mode}: ms per step (median, steps) "
              + ", ".join(f"{k} {v[0]:.1f} ({v[1]})" for k, v in per.items())
              + f" | little window: launches {json.dumps(lc)}, "
              f"fallback_rows {lt.get('fallback_rows', 0)}, h2d_rows "
              f"{lt.get('h2d_rows', 0)}, probes {lt.get('probes', 0)} | "
              f"retries={st['retries']} little_steps={st['little_steps']} "
              f"probes={st['probes']} host checksums {len(store._truth)} "
              f"deadline_misses="
              f"{store.watchdog.deadline_misses} refits="
              f"{store.watchdog.refits} | watchdog link "
              f"{store.watchdog.gbps:.2f} GB/s | on {name}", flush=True)
        lay = store.memory_layout()
        print(f"faults (c) {mode}: little_bytes "
              f"{lay['little_bytes'] / 1e9:.2f} GB (built in {t_little:.1f} "
              f"s), pool {lay['pool_bytes'] / 1e9:.2f} GB, peak device "
              f"memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB, "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        del server, store, rec
        free(torch)
    del host, ref_rec
    free(torch)

    # (d) -- the launcher
    t0 = time.perf_counter()
    try:
        launcher.main(["--offload", "pipelined", "--faults",
                       "transient_stall", "--check-exact", "--requests", "4",
                       "--batch", "2", "--train-steps", "0"])
        launched = True
    except SystemExit as e:
        launched = e.code in (0, None)
    ok = ok and launched
    print(f"faults (d): launcher --offload pipelined --faults "
          f"transient_stall --check-exact: "
          f"{'returned' if launched else 'FAILED'} in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    free(torch)
    print(f"faults: phase {time.perf_counter() - t_phase:.1f} s", flush=True)
    return ok, little_counts or {k: 0 for k in kernels.LAUNCHES}


# --------------------------------------------------------------------------
# phase 12: prompts past MOE_CHUNK_TOKENS
# --------------------------------------------------------------------------

@contextlib.contextmanager
def plain_launches():
    """Route every kernel wrapper's launch on CUDA tensors to its plain
    PyTorch version (on the same tensors, on the card) for the duration."""
    from repro_torch.kernels.expert_ffn import ops as ffn_ops
    from repro_torch.kernels.flash_attention import ops as attn_ops
    from repro_torch.kernels.gating import ops as gating_ops
    saved = gating_ops._launch, ffn_ops._launch, attn_ops._launch
    gating_ops._launch = gating_ops.gating_plain
    ffn_ops._launch = (lambda xe, wg, wu, wd, counts, expert_ids, act:
                       ffn_ops.expert_ffn_plain(xe, wg, wu, wd, counts,
                                                expert_ids, act))
    attn_ops._launch = (lambda q, k, v, causal, window, softcap, scale:
                        attn_ops.flash_attention_plain(
                            q, k, v, causal=causal, window=window,
                            softcap=softcap, scale=scale))
    try:
        yield
    finally:
        gating_ops._launch, ffn_ops._launch, attn_ops._launch = saved


def long_phase(torch, kernels, name, res_vecs):
    """Mixtral-8x7B at published widths, 8 layers, seed 0 (phase 5's
    weights, so phase 5's residual vectors): two ``MarkovCorpus`` prompts
    of 20000 tokens, 16 new tokens each, through ``ContinuousBatchServer``
    with ``dali`` at batch 2, max_len 20018.  (a) full-resident: K1, K2
    ragged (at C = 5120) and K3 must launch (counts zeroed just before, read
    just after); (b) the first admission's prefill with the kernels against
    the same prefill through the plain versions on the card: first-token
    logits within 3e-2 relative to max |ref| and the same token; (c) the
    two requests offloaded (pipelined, fetch tier, cache ratio 0.25,
    residual vectors calibrated through the slot pool) must give (a)'s
    tokens.  Returns (ok, (a)'s launch counts)."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import MarkovCorpus
    from repro_torch.models import moe as moe_mod
    from repro_torch.models.model import (apply_model, experts_to_host,
                                          init_caches, init_model)
    from repro_torch.serving.spec import OffloadSpec, ServeSpec
    from repro_torch.serving.steps import default_dali_config

    t_phase = time.perf_counter()
    free(torch)
    cfg = get_config("mixtral-8x7b").replace(n_layers=8)
    params = init_model(cfg, seed=0, device="cuda")
    corpus = MarkovCorpus(vocab=cfg.vocab, seed=0)
    rng = np.random.default_rng(LONG_SEED)
    prompts = [corpus.sample(rng, LONG_LEN) for _ in range(2)]
    dcfg = default_dali_config(cfg, cache_ratio=0.25)

    def spec(mode):
        return ServeSpec(cfg=cfg, policy="dali", dali_cfg=dcfg, batch_size=2,
                         max_len=LONG_MAX, eos_id=-1,
                         offload=OffloadSpec(mode=mode))

    # (a) -- full-resident; the ragged K2 buckets' capacities are recorded
    buckets = []
    real_ffn = moe_mod.expert_ffn

    def ffn_seen(xe, *a, counts=None, expert_ids=None, **kw):
        if counts is not None and expert_ids is None:
            buckets.append(xe.shape[1])
        return real_ffn(xe, *a, counts=counts, expert_ids=expert_ids, **kw)

    server = spec("modeled").resolve(params).server(res_vecs=res_vecs)
    torch.cuda.reset_peak_memory_stats()
    moe_mod.expert_ffn = ffn_seen
    kernels.reset_launch_counts()          # the long-prompt path starts here
    try:
        server, done, wall = run_requests(torch, server, prompts, LONG_NEW)
    finally:
        moe_mod.expert_ffn = real_ffn
    counts = kernels.launch_counts()       # ... and ends here
    peak = torch.cuda.max_memory_allocated()
    mt = server.metrics
    want = {r.rid: r.output for r in done}
    ttft = sorted(r.ttft for r in done)
    ok_a = (all(counts[k] > 0 for k in ("gating", "expert_ffn_ragged",
                                        "flash_attention"))
            and 5120 in buckets
            and [len(want.get(i, [])) for i in range(2)] == [LONG_NEW] * 2)
    print(f"long (a) full-resident batch=2, 2 x {LONG_LEN} tokens, max_len "
          f"{LONG_MAX}: {mt.steps} decode steps in {wall:.2f} s | prefill "
          f"{mt.prefill_tokens / mt.prefill_s:.1f} tok/s, TTFT "
          f"{ttft[0] * 1e3:.1f} / {ttft[1] * 1e3:.1f} ms, decode "
          f"{mt.decode_tokens / mt.decode_s:.1f} tok/s at ~{LONG_LEN} "
          f"context | peak device memory {peak / 1e9:.2f} GB | K2 ragged "
          f"buckets C={sorted(set(buckets))} | launches {json.dumps(counts)}"
          f" | {'pass' if ok_a else 'FAIL'} | on {name}", flush=True)
    del server
    free(torch)

    # (b) -- the first admission's prefill: kernels against plain versions
    toks = torch.zeros((1, LONG_MAX), dtype=torch.int32, device="cuda")
    toks[0, :LONG_LEN] = torch.as_tensor(prompts[0])
    pos = torch.arange(LONG_MAX, dtype=torch.int32, device="cuda")

    @torch.no_grad()
    def first_logits():
        t0 = time.perf_counter()
        lg, _, _ = apply_model(params, toks, cfg, positions=pos,
                               caches=init_caches(cfg, 1, LONG_MAX,
                                                  device="cuda"),
                               logit_index=LONG_LEN - 1)
        lg = lg[0, 0, :cfg.vocab].float()
        torch.cuda.synchronize()
        return lg, time.perf_counter() - t0

    lk, t_k = first_logits()
    with plain_launches():
        lp, t_p = first_logits()
    err = rel_err(lk, lp)
    tok_k, tok_p = int(lk.argmax()), int(lp.argmax())
    ok_b = err < BF16_TOL and tok_k == tok_p == want[0][0]
    print(f"long (b) first admission's prefill ({LONG_MAX} positions): "
          f"kernels {t_k:.2f} s, plain versions {t_p:.2f} s; first-token "
          f"logits rel_err {err:.3e} (< {BF16_TOL}), tokens {tok_k} / "
          f"{tok_p} (served {want[0][0]}) | {'pass' if ok_b else 'FAIL'} | "
          f"on {name}", flush=True)
    del lk, lp
    free(torch)

    # (c) -- offloaded, calibrated through the slot pool
    t0 = time.perf_counter()
    host = experts_to_host(params, cfg, "cuda")
    del params
    free(torch)
    rs = spec("pipelined").resolve(host)
    calib_rng = np.random.default_rng(1)          # phase 5's calibration
    calib = np.stack([corpus.sample(calib_rng, 32) for _ in range(8)])
    slot_rv = slot_res_vecs(rs, cfg, calib)
    same_rv = bool(np.array_equal(slot_rv, res_vecs))
    torch.cuda.reset_peak_memory_stats()
    server, done, wall = run_requests(
        torch, rs.server(res_vecs=slot_rv), prompts, LONG_NEW)
    got = {r.rid: r.output for r in done}
    ok_c = got == want and same_rv
    offload_line(f"long (c) pipelined fetch batch=2, 2 x {LONG_LEN} tokens "
                 f"(tokens {'identical to' if got == want else 'DIFFER from'}"
                 f" (a); slot-pool residual vectors equal phase 5's: "
                 f"{same_rv})", server, done, wall, name)
    print(f"long (c): peak device memory "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB, "
          f"{time.perf_counter() - t0:.1f} s with pinning and calibration | "
          f"{'pass' if ok_c else 'FAIL'}", flush=True)
    del server, rs, host
    free(torch)
    print(f"long: phase {time.perf_counter() - t_phase:.1f} s", flush=True)
    return ok_a and ok_b and ok_c, counts


# --------------------------------------------------------------------------
# phase 13: the port's examples on the card
# --------------------------------------------------------------------------

def examples_phase(torch, kernels, name):
    """Each example module's ``main`` at the reference's defaults, on the
    card.  Returns (ok, launch counts over the four)."""
    import warnings

    from repro_torch.examples import (offload_ablation, quickstart,
                                      serve_moe, train_tiny)

    t_phase = time.perf_counter()
    free(torch)
    kernels.reset_launch_counts()
    ok = True
    t0 = time.perf_counter()
    hist = train_tiny.main(["--tiny"])     # raises unless the ce falls
    print(f"examples train_tiny --tiny: ce {hist[0]:.3f} -> {hist[-1]:.3f} "
          f"in {len(hist)} steps, {time.perf_counter() - t0:.1f} s | on "
          f"{name}", flush=True)
    t0 = time.perf_counter()
    q = quickstart.main([])
    good = (q["greedy_makespan"] >= q["optimal_makespan"]
            and q["hits"] + q["misses"] > 0)
    ok = ok and good
    print(f"examples quickstart: greedy {q['greedy_makespan'] * 1e3:.2f} ms "
          f">= optimal {q['optimal_makespan'] * 1e3:.2f} ms, hits "
          f"{q['hits']} misses {q['misses']}, "
          f"{time.perf_counter() - t0:.1f} s | "
          f"{'pass' if good else 'FAIL'} | on {name}", flush=True)
    t0 = time.perf_counter()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        a = offload_ablation.main([])
    modes = [r[0] for r in a["offload"]]
    good = (len(a["ablation"]) == 4 and len(a["policies"]) == 6
            and modes == ["modeled", "blocking", "overlap", "pipelined"]
            and all(r[2] > 0 for r in a["offload"][1:]))
    ok = ok and good
    print(f"examples offload_ablation: {len(a['ablation'])} ablation rows, "
          f"{len(a['policies'])} policy rows, modes {modes} each "
          f"{offload_ablation.STEPS} timed steps, µs/step "
          + ", ".join(f"{m} {us:.0f}" for m, us, _, _ in a["offload"])
          + f", {time.perf_counter() - t0:.1f} s | "
          f"{'pass' if good else 'FAIL'} | on {name}", flush=True)
    t0 = time.perf_counter()
    _, done = serve_moe.main([])
    good = len(done) == 16
    ok = ok and good
    print(f"examples serve_moe: {len(done)} requests served, "
          f"{time.perf_counter() - t0:.1f} s | {'pass' if good else 'FAIL'}"
          f" | on {name}", flush=True)
    counts = kernels.launch_counts()
    free(torch)
    print(f"examples: phase {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    return ok, counts


# --------------------------------------------------------------------------
# phase 14: the remaining architectures
# --------------------------------------------------------------------------

# (tag, arch) of the nine architectures phase 14 adds, in the registry's
# order; the tags name their kernel rows and launch counts
ARCH_NEW = (("seamless", "seamless-m4t-large-v2"), ("llama3", "llama3-405b"),
            ("llama4", "llama4-maverick-400b-a17b"),
            ("qwen3_32b", "qwen3-32b"), ("vision", "llama-3.2-vision-11b"),
            ("gemma2", "gemma2-9b"), ("jamba", "jamba-1.5-large-398b"),
            ("olmo", "olmo-1b"), ("mamba2", "mamba2-780m"))
# (a)'s training steps: tests/test_archs_smoke.py's six trained archs less
# Mixtral and DeepSeek-V2-Lite (phases 9 and 10), and the two
# cross-attention archs
ARCH_TRAIN = ("olmo-1b", "mamba2-780m", "jamba-1.5-large-398b", "gemma2-9b",
              "llama-3.2-vision-11b", "seamless-m4t-large-v2")
TRAIN_SEEDS = (1, 2)         # (a)'s training steps: params and batch seeds
# (b): the shortest prefix of Jamba's 8-layer period with its attention
# layer and 2 MoE layers (38.7 GB of experts pinned), the depth cut from
# the whole period (8 layers) that keeps the script inside its time limit
JAMBA_LAYERS = 5
JAMBA_REQUESTS, JAMBA_NEW, JAMBA_SEED = 4, 8, 14
GEMMA_LONG = 5000            # (c): a prompt past Gemma-2's 4096 window
GEMMA_SHORT = 4000           # (c): one that stays inside it
VISION_S = 64                # (c): the cross checks' prompt
SEAMLESS_FRAMES = 1024       # (c): Seamless's encoder input (a choice)
ARCH_RESERVE = 6e9           # device bytes kept free beside the weights


def open_gates(torch, params):
    """``params`` with every cross-attention gate (a cross mixer's scalar
    ``gate``, a VLM cross layer's ``mlp_gate``) set to 0.5 in place: at
    their init of 0 (tanh 0) the cross path adds nothing, and a check of it
    would see nothing."""
    from repro_torch.tree import tree_map_with_path

    def fix(path, t):
        if path[-1] in ("gate", "mlp_gate") and t.dim() <= 1:
            t.fill_(0.5)
        return t

    return tree_map_with_path(fix, params)


def cross_source(torch, cfg, batch, seed, T=None, device="cpu"):
    """A seeded source (batch, T, d_model) for a VLM's cross layers (its
    vision tokens) or an audio arch's encoder (``T`` frames, 16 by
    default), float32 as the launcher's (and the reference's) source is;
    None for the other families."""
    if cfg.family == "vlm":
        T = T or cfg.n_vision_tokens
    elif cfg.family != "audio":
        return None
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    return torch.randn((batch, T or 16, cfg.d_model), generator=g,
                       device=device) * 0.1


@contextlib.contextmanager
def k3_forms():
    """K3's launches by form while the block runs, as its wrapper counts
    them at launch (``kernels.K3_FORMS``): non-causal (cross-attention and
    the encoder) and windowed with a softcap (Gemma-2's local layers)."""
    from repro_torch import kernels
    before, seen = dict(kernels.K3_FORMS), {}
    try:
        yield seen
    finally:
        seen.update({k: kernels.K3_FORMS[k] - v for k, v in before.items()})


def archs_phase(torch, kernels, name):
    """(a) each new arch's smoke model on the card against the CPU, and
    training steps; (b) Jamba-1.5-Large at published widths served
    offloaded through the wave server; (c) every other new arch at
    published widths.  Returns (ok, launch counts by tag)."""
    t_phase = time.perf_counter()
    free(torch)
    ok, counts = True, {}
    t0 = time.perf_counter()
    for _, arch in ARCH_NEW:
        ok = arch_parity(torch, arch) and ok
    for arch in ARCH_TRAIN:
        for seed in TRAIN_SEEDS:
            ok = train_parity(torch, kernels, arch, n_layers=None,
                              bf16_floor=True, seed=seed) and ok
    print(f"archs (a): {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    ok_b, counts["jamba"] = jamba_phase(torch, kernels, name)
    print(f"archs (b): {'pass' if ok_b else 'FAIL'} in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    ok = ok and ok_b
    for tag, arch in ARCH_NEW:
        if tag == "jamba":
            continue
        t0 = time.perf_counter()
        ok_c, counts[tag] = arch_full_width(torch, kernels, name, tag, arch)
        print(f"archs (c) {tag}: {'pass' if ok_c else 'FAIL'} in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        ok = ok and ok_c
    print(f"archs: phase {time.perf_counter() - t_phase:.1f} s", flush=True)
    return ok, counts


def arch_parity(torch, arch):
    """(a): ``arch``'s smoke model (its whole period, bfloat16, cross gates
    opened) on the card (kernels) against the CPU (plain versions): a
    20-token prefill into caches (with a cross source where the arch has
    cross layers), then two decode steps fed the CPU's greedy tokens.  The
    first token's logits within 3e-2 relative to max |ref| and the same
    token; a step whose MoE routing differs between the devices (a bf16
    near-tie) is reported and not compared, and every step differing
    fails."""
    from repro_torch.configs import get_config, make_smoke
    from repro_torch.models.model import (apply_model, collect_field,
                                          init_caches, init_model)
    from repro_torch.tree import tree_map

    cfg = make_smoke(get_config(arch)).replace(dtype="bfloat16",
                                               param_dtype="bfloat16")
    cpu = open_gates(torch, init_model(cfg, seed=1, device="cpu"))
    gpu = tree_map(lambda t: t.to("cuda"), cpu)
    src = cross_source(torch, cfg, 1, seed=3)
    toks = torch.randint(0, cfg.vocab, (1, 20), dtype=torch.int32,
                         generator=torch.Generator().manual_seed(2))
    n_cross = None if src is None else src.shape[1]
    caches = {d: init_caches(cfg, 1, 40, device=d, n_cross=n_cross)
              for d in ("cpu", "cuda")}
    moe = cfg.moe is not None
    checks, compared = [], 0
    for step in range(3):
        if step == 0:
            inp, kw = toks, dict(positions=torch.arange(20, dtype=torch.int32),
                                 cross_src=src, last_logit_only=True)
        else:
            inp, kw = nxt, dict(positions=torch.tensor([19 + step],
                                                       dtype=torch.int32))
        outs = {}
        for d, p in (("cpu", cpu), ("cuda", gpu)):
            kw_d = {k: (v.to(d) if torch.is_tensor(v) else v)
                    for k, v in kw.items()}
            lg, caches[d], infos = apply_model(p, inp.to(d), cfg,
                                               caches=caches[d], trace=moe,
                                               **kw_d)
            outs[d] = (lg[:, -1, :cfg.vocab].float().cpu(),
                       collect_field(infos, "topk_idx") if moe else None)
        nxt = outs["cpu"][0].argmax(-1)[:, None].to(torch.int32)
        checks.append(bool(torch.isfinite(outs["cuda"][0]).all()))
        if moe and not torch.equal(outs["cuda"][1].cpu(), outs["cpu"][1]):
            print(f"archs (a) {cfg.name} step {step}: routing diverged "
                  "between devices (bf16 near-tie); logits not compared",
                  flush=True)
            continue
        compared += 1
        err = rel_err(outs["cuda"][0], outs["cpu"][0])
        same = bool(torch.equal(outs["cuda"][0].argmax(-1),
                                outs["cpu"][0].argmax(-1)))
        good = err < BF16_TOL and (same or step > 0)
        checks.append(good)
        what = "first token" if step == 0 else f"decode step {step}"
        print(f"archs (a) {cfg.name} {what}: logits rel_err={err:.3e}, "
              f"same token {same} | "
              f"{'pass' if good else 'FAIL'}", flush=True)
    return all(checks) and compared > 0


def model_bytes(cfg):
    """bfloat16 bytes of ``cfg``'s parameters (``estimate_params``)."""
    from repro_torch.launch.sharding import estimate_params
    return 2 * estimate_params(cfg)


def jamba_phase(torch, kernels, name):
    """(b): Jamba-1.5-Large at published widths, one pattern period (8
    layers: 7 Mamba + 1 attention, 4 MoE + 4 dense), random bf16 weights
    from seed 0 with the routed stacks drawn into the pinned host store,
    residual vectors calibrated through the slot pool; 4 ``MarkovCorpus``
    requests x 8 new tokens at batch 2 through ``BatchServer`` with
    ``dali``, pipelined, fetch tier, at cache ratio 0.25 and a second
    ratio (0.5 where its pool and staging fit on the card, else 0.125):
    identical tokens, K1, K4 and K3 launched (counts zeroed just before the
    serves and read just after)."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import MarkovCorpus
    from repro_torch.models.config import layer_pattern
    from repro_torch.models.model import init_model
    from repro_torch.serving.spec import OffloadSpec, ServeSpec
    from repro_torch.serving.steps import default_dali_config
    from repro_torch.tree import tree_leaves

    full = get_config("jamba-1.5-large-398b")
    m = full.moe
    expert_b = 3 * full.d_model * m.d_expert * 2
    n_moe = lambda n: sum(1 for _, k in layer_pattern(full.replace(
        n_layers=n)) if k == "moe")
    avail, waited = settled_mem_available(torch)
    need = n_moe(JAMBA_LAYERS) * m.n_routed * expert_b
    cfg = full.replace(n_layers=JAMBA_LAYERS)
    pat = layer_pattern(cfg)
    print(f"archs (b): {cfg.name} at published widths (d_model "
          f"{cfg.d_model}, {m.n_routed} experts top-{m.top_k} of d_ff "
          f"{m.d_expert} on every other layer, Mamba-2/SSD d_state "
          f"{cfg.mamba.d_state} head_dim {cfg.mamba.head_dim}, "
          f"{cfg.attn.n_heads}q/{cfg.attn.n_kv_heads}kv heads, vocab "
          f"{cfg.vocab}); depth cut from {full.n_layers} to {JAMBA_LAYERS} "
          f"layers: {sum(x == 'mamba' for x, _ in pat)} Mamba + "
          f"{sum(x == 'attn' for x, _ in pat)} attention, "
          f"{sum(k == 'moe' for _, k in pat)} MoE; host MemAvailable "
          f"{avail / 1e9:.1f} GB (settled in {waited:.0f} s), "
          f"{need / 1e9:.1f} GB of experts pinned", flush=True)
    t0 = time.perf_counter()
    params = init_model(cfg, seed=0, device="cuda", experts="host")
    torch.cuda.synchronize()
    leaves = tree_leaves(params)
    total = sum(t.numel() * t.element_size() for t in leaves)
    host = sum(t.numel() * t.element_size() for t in leaves if not t.is_cuda)
    print(f"archs (b): random weights from seed 0 in "
          f"{time.perf_counter() - t0:.1f} s: {total / 1e9:.2f} GB of "
          f"weights, {host / 1e9:.2f} GB of routed experts pinned on the "
          f"host, {(total - host) / 1e9:.2f} GB on the card", flush=True)

    corpus = MarkovCorpus(vocab=cfg.vocab, seed=0)
    rng = np.random.default_rng(JAMBA_SEED)
    prompts = [corpus.sample(rng, int(rng.integers(24, 129)))
               for _ in range(JAMBA_REQUESTS)]
    calib = np.stack([corpus.sample(rng, 32) for _ in range(2)])

    def resolve(ratio):
        return ServeSpec(cfg=cfg, server="wave", policy="dali",
                         dali_cfg=default_dali_config(cfg, cache_ratio=ratio),
                         batch_size=2, max_len=MAX_LEN, eos_id=-1,
                         offload=OffloadSpec(mode="pipelined")).resolve(params)

    free_b = torch.cuda.mem_get_info()[0]
    second = None
    for ratio in (0.5, 0.125):
        lay = resolve(ratio).store.memory_layout()
        fits = lay["prefill_peak_bytes"] + ARCH_RESERVE < free_b
        print(f"archs (b): cache ratio {ratio}: pool + prefill staging "
              f"{lay['prefill_peak_bytes'] / 1e9:.2f} GB against "
              f"{free_b / 1e9:.2f} GB free on the card -> "
              f"{'fits' if fits else 'does not fit'}", flush=True)
        if fits:
            second = ratio
            break
    ratios = (0.25, second or 0.125)
    rs = resolve(ratios[0])
    t0 = time.perf_counter()
    res = slot_res_vecs(rs, cfg, calib, n_decode=4)
    print(f"archs (b): residual vectors calibrated through the slot pool "
          f"(2 x 32 tokens, 4 decode steps) in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    outs, ok = {}, True
    kernels.reset_launch_counts()          # the Jamba path starts here
    torch.cuda.reset_peak_memory_stats()
    for ratio in ratios:
        rs = resolve(ratio)
        server, done, wall = run_requests(torch, rs.server(res_vecs=res),
                                          prompts, JAMBA_NEW)
        mt, st = server.metrics, server.store.stats()
        outs[ratio] = {r.rid: r.output for r in done}
        streamed = st["h2d_rows"] + st["prefill_fetch_rows"] \
            + st["fallback_fetches"]
        nbytes = streamed * server.store.expert_bytes
        ok = ok and len(done) == JAMBA_REQUESTS and all(
            len(r.output) == JAMBA_NEW for r in done)
        print(f"archs (b) {cfg.name} {JAMBA_LAYERS} layers wave pipelined "
              f"fetch cache_ratio={ratio} ({server.store.n_slots} of "
              f"{m.n_routed} slots a layer): {len(done)} requests, "
              f"{mt.steps} steps in {wall:.2f} s | prefill "
              f"{mt.prefill_tokens / mt.prefill_s:.1f} tok/s, decode "
              f"{mt.decode_tokens / mt.decode_s:.1f} tok/s | experts "
              f"streamed {streamed} ({st['h2d_rows']} pool rows, "
              f"{st['prefill_fetch_rows']} prefill wave rows in "
              f"{st['prefill_waves']} waves, {st['fallback_fetches']} miss "
              f"fetches) = {nbytes / 1e9:.1f} GB, {nbytes / 1e9 / wall:.1f} "
              f"GB/s over the serve's wall time | "
              f"{mt.dali.summary()} | on {name}", flush=True)
        del server, rs
        free(torch)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()       # ... and ends here
    peak = torch.cuda.max_memory_allocated()
    same = outs[ratios[0]] == outs[ratios[1]]
    launched = all(counts[k] > 0 for k in ("gating", "expert_ffn_grouped",
                                           "flash_attention"))
    print(f"archs (b): tokens identical at cache ratios {ratios}: {same} | "
          f"kernel launches {json.dumps(counts)}; gating, "
          f"expert_ffn_grouped and flash_attention each launched: "
          f"{launched} | peak device memory {peak / 1e9:.2f} GB beside "
          f"{total / 1e9:.2f} GB of weights at {JAMBA_LAYERS} layers | on "
          f"{name}", flush=True)
    del params, leaves
    free(torch)
    return ok and same and launched, counts


def arch_depth(torch, full, host_experts):
    """The deepest depth of ``full`` (up to all its layers) whose weights
    fit on the card with ``ARCH_RESERVE`` to spare, and two blocks more
    while ``init_model`` builds a stack: the block being drawn, and the
    allocator's cached float32 draws, which a stack's one large allocation
    cannot reuse (Llama-3-405B at 9 layers failed so on the H100; none
    with ``host_experts``: each block's experts leave for the host)."""
    free_b = torch.cuda.mem_get_info()[0]
    n = full.n_layers
    while n > 1:
        nbytes = model_bytes(full.replace(n_layers=n))
        block = nbytes - model_bytes(full.replace(n_layers=n - 1))
        if nbytes + (0 if host_experts else 2 * block) + ARCH_RESERVE \
                < free_b:
            break
        n -= 1
    return n, free_b


def arch_full_width(torch, kernels, name, tag, arch):
    """(c): ``arch`` at published widths, random bf16 weights from seed 0,
    at full depth where the weights fit beside what the process holds,
    else the depth that fits (printed); full-resident (an MoE arch's
    experts are drawn through the host, so no block is held twice on the
    card, then moved to it).  2 requests x 8 tokens at batch 2 (the wave
    server for an SSM arch); the kernels the arch runs must launch.
    Gemma-2 then decodes after a 5000-token prompt within 3e-2 of its
    recompute; the vision and Seamless models run a cross source (1601
    vision tokens; 1024 frames through the encoder) through prefill, one
    decode step and the recompute, K3 non-causal launched."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import MarkovCorpus
    from repro_torch.models.config import layer_pattern
    from repro_torch.models.model import init_model
    from repro_torch.models.moe import is_expert_leaf
    from repro_torch.serving.spec import ServeSpec
    from repro_torch.serving.steps import default_dali_config
    from repro_torch.tree import tree_leaves, tree_map_with_path

    free(torch)
    full = get_config(arch)
    moe = full.moe is not None
    layers, free_b = arch_depth(torch, full, host_experts=moe)
    cfg = full.replace(n_layers=layers)
    pat = layer_pattern(cfg)
    print(f"archs (c) {cfg.name}: d_model {cfg.d_model}, "
          f"{full.n_layers} layers published, {layers} built "
          f"({model_bytes(cfg) / 1e9:.2f} GB of weights against "
          f"{free_b / 1e9:.2f} GB free on the card"
          + (")" if layers == full.n_layers else
             f"; {full.n_layers} would need "
             f"{model_bytes(full) / 1e9:.1f} GB)"), flush=True)
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    params = init_model(cfg, seed=0, device="cuda",
                        experts="host" if moe else "device")
    if moe:                                # the experts onto the card
        params = tree_map_with_path(
            lambda path, t: t.to("cuda") if is_expert_leaf(path, cfg)
            else t, params)
    torch.cuda.synchronize()
    weights = sum(t.numel() * t.element_size() for t in tree_leaves(params))
    print(f"archs (c) {cfg.name}: random weights from seed 0, "
          f"{weights / 1e9:.2f} GB in {time.perf_counter() - t0:.1f} s",
          flush=True)
    ssm = any(x == "mamba" for x, _ in pat)
    need = ([] if ssm and cfg.attn is None else ["flash_attention"]) + (
        [] if not moe else ["gating_warp" if cfg.moe.n_routed > 32
                            else "gating", "expert_ffn_ragged",
                            "expert_ffn_grouped"])
    rng = np.random.default_rng(3)
    corpus = MarkovCorpus(vocab=cfg.vocab, seed=0)
    prompts = [corpus.sample(rng, int(rng.integers(24, 201)))
               for _ in range(2)]
    spec = ServeSpec(cfg=cfg, server="wave" if ssm else "continuous",
                     policy="dali" if moe else "none",
                     dali_cfg=default_dali_config(cfg, cache_ratio=0.5),
                     batch_size=2, max_len=MAX_LEN, eos_id=-1)
    kernels.reset_launch_counts()          # this arch's path starts here
    server, done, wall = run_requests(torch, spec.resolve(params).server(),
                                      prompts, 8)
    mt = server.metrics
    ok = len(done) == 2 and all(len(r.output) == 8 for r in done)
    print(f"archs (c) {cfg.name} {layers} layers full-resident "
          f"{spec.server} batch=2: {len(done)} requests, {mt.steps} steps "
          f"in {wall:.2f} s | decode {mt.decode_tokens / mt.decode_s:.1f} "
          f"tok/s, prefill {mt.prefill_tokens / mt.prefill_s:.1f} tok/s | "
          f"peak device memory {torch.cuda.max_memory_allocated() / 1e9:.2f}"
          f" GB | {'pass' if ok else 'FAIL'} | on {name}", flush=True)
    del server
    if tag == "gemma2":
        ok = gemma_long_check(torch, cfg, params, corpus, name) and ok
    elif tag in ("vision", "seamless"):
        ok = cross_check(torch, cfg, params, corpus, name) and ok
    torch.cuda.synchronize()
    counts = kernels.launch_counts()       # ... and ends here
    launched = all(counts[k] > 0 for k in need)
    print(f"archs (c) {cfg.name}: kernel launches {json.dumps(counts)}; "
          + (f"{', '.join(need)} launched: {launched}" if need else
             "it needs no kernel (attention-free, no MoE)"), flush=True)
    del params
    free(torch)
    return ok and launched, counts


def gemma_long_check(torch, cfg, params, corpus, name):
    """Gemma-2 after a prompt of ``GEMMA_LONG`` tokens, past its 4096-token
    window (the local layers' rolling caches wrap: the ring repair at full
    width): admitted at exact length by the continuous server, then
    prefilled and decoded one step directly.  The local caches must hold
    the window's positions at slot ``pos % window``, and the decode's
    logits must be within 3e-2 of the recompute of prompt + token at 8
    layers (the first 8 of the same weights).  At all 42 layers bf16 alone
    puts decode and recompute ~4.5e-2 apart with no wrap at all (PERF.md
    §6, PR 20), so there the wrapped prompt must stay within 1.5x of a
    ``GEMMA_SHORT``-token prompt that does not wrap."""
    import numpy as np

    from repro_torch.models.model import apply_model, init_caches
    from repro_torch.serving.spec import ServeSpec
    from repro_torch.tree import tree_map

    rng = np.random.default_rng(5)
    prompt = corpus.sample(rng, GEMMA_LONG)
    max_len = GEMMA_LONG + 8
    t0 = time.perf_counter()
    server, done, _ = run_requests(torch, ServeSpec(
        cfg=cfg, server="continuous", policy="none", batch_size=1,
        max_len=max_len, eos_id=-1).resolve(params).server(), [prompt], 2)
    served = done[0].output
    del server
    W = cfg.attn.sliding_window

    def decode_vs_recompute(c, p, L):
        dev = "cuda"
        toks = torch.as_tensor(prompt[None, :L], device=dev)
        caches = init_caches(c, 1, L + 8, device=dev)
        lg, caches, _ = apply_model(
            p, toks, c, positions=torch.arange(L, dtype=torch.int32,
                                               device=dev),
            caches=caches, last_logit_only=True)
        first = lg[:, -1:].argmax(-1).to(torch.int32)
        dec, _, _ = apply_model(p, first, c, positions=torch.tensor(
            [L], dtype=torch.int32, device=dev), caches=caches)
        full, _, _ = apply_model(p, torch.cat([toks, first], 1), c,
                                 last_logit_only=True)
        # after the decode the local cache holds L + 1 - W .. L
        pos = caches["scan"][0]["pos"][0, 0].long().cpu()
        kept = torch.arange(max(0, L + 1 - W), L + 1)
        ring = bool(torch.equal(pos[kept % pos.numel()], kept))
        V = c.vocab
        return (rel_err(dec[:, -1, :V], full[:, -1, :V]), ring,
                [int(first), int(dec[0, -1, :V].argmax())],
                int(dec[0, -1, :V].argmax()) == int(full[0, -1, :V].argmax()))

    e_long, ring, direct, same = decode_vs_recompute(cfg, params, GEMMA_LONG)
    e_short, _, _, _ = decode_vs_recompute(cfg, params, GEMMA_SHORT)
    c8 = cfg.replace(n_layers=8)
    p8 = dict(params, scan=tuple(tree_map(lambda a: a[:4], st)
                                 for st in params["scan"]))
    e8, ring8, _, same8 = decode_vs_recompute(c8, p8, GEMMA_LONG)
    torch.cuda.synchronize()
    ok = (ring and ring8 and same and same8 and e8 < BF16_TOL
          and e_long <= 1.5 * e_short)
    print(f"archs (c) {cfg.name}: a {GEMMA_LONG}-token prompt past the "
          f"{W}-token window (the prefill wraps the local caches at slot "
          f"{(GEMMA_LONG - W) % W}): every kept position at slot pos % {W}: "
          f"{ring and ring8}; first decode step against the recompute "
          f"rel_err={e8:.3e} at 8 layers (limit {BF16_TOL}), {e_long:.3e} "
          f"at {cfg.n_layers} layers against {e_short:.3e} for a "
          f"{GEMMA_SHORT}-token prompt that does not wrap (limit 1.5x); "
          f"same token "
          f"{same and same8}; the continuous server (exact-length admission)"
          f" gave {served}, the direct path {direct} | "
          f"{time.perf_counter() - t0:.1f} s | {'pass' if ok else 'FAIL'} "
          f"| on {name}", flush=True)
    return ok


def cross_check(torch, cfg, params, corpus, name):
    """A VLM (1601 vision tokens) or Seamless (``SEAMLESS_FRAMES`` frames
    through its encoder) at full width with its cross gates opened: a
    full forward with the cross source, then a prefill into caches and one
    decode step, within 3e-2 of the recompute of prompt + token (the
    reference test's check); K3 runs non-causal (counted)."""
    import numpy as np

    from repro_torch.models.model import apply_model, init_caches

    open_gates(torch, params)
    dev = "cuda"
    src = cross_source(torch, cfg, 1, seed=7, device=dev,
                       T=SEAMLESS_FRAMES if cfg.family == "audio" else None)
    rng = np.random.default_rng(6)
    toks = torch.as_tensor(corpus.sample(rng, VISION_S)[None], device=dev)
    S = VISION_S
    t0 = time.perf_counter()
    with k3_forms() as seen:
        lg, _, _ = apply_model(params, toks, cfg, cross_src=src,
                               last_logit_only=True)
        n_cross = src.shape[1] if cfg.family == "vlm" else SEAMLESS_FRAMES
        caches = init_caches(cfg, 1, S + 8, device=dev, n_cross=n_cross)
        pf, caches, _ = apply_model(
            params, toks, cfg, positions=torch.arange(
                S, dtype=torch.int32, device=dev), caches=caches,
            cross_src=src, last_logit_only=True)
        nxt = pf[:, -1:].argmax(-1).to(torch.int32)
        dec, _, _ = apply_model(params, nxt, cfg, positions=torch.tensor(
            [S], dtype=torch.int32, device=dev), caches=caches)
        full, _, _ = apply_model(params, torch.cat([toks, nxt], 1), cfg,
                                 cross_src=src, last_logit_only=True)
        torch.cuda.synchronize()
    V = cfg.vocab
    err = rel_err(dec[:, -1, :V], full[:, -1, :V])
    pf_err = rel_err(pf[:, -1, :V], lg[:, -1, :V])
    ok = (err < BF16_TOL and pf_err < BF16_TOL and seen["noncausal"] > 0
          and bool(torch.isfinite(dec[..., :V]).all()))
    what = (f"{src.shape[1]} vision tokens" if cfg.family == "vlm" else
            f"{SEAMLESS_FRAMES} frames through the "
            f"{cfg.encoder.n_layers}-layer encoder")
    print(f"archs (c) {cfg.name}: cross source of {what}, gates opened "
          f"to 0.5: prefill against the full forward rel_err={pf_err:.3e}, "
          f"first decode step against the recompute rel_err={err:.3e}; K3 "
          f"non-causal launches {seen['noncausal']} | "
          f"{time.perf_counter() - t0:.1f} s | {'pass' if ok else 'FAIL'} "
          f"| on {name}", flush=True)
    del caches
    return ok


# --------------------------------------------------------------------------
# phase 15: the serving-path audit on the card, the dry run, remat
# --------------------------------------------------------------------------

AUDIT_STEPS = 10             # (a) and (b): decode steps under the sync check
AUDIT_PROMPT = 32            # (a) and (b): the wave's prompt length


def audit_prefill(torch, rs, cfg, rng, corpus):
    """A batch-8 wave state prefilled with ``AUDIT_PROMPT``-token prompts
    (through the slot pool for a physical store) and the decode of the
    healthy rung, warmed up by one step outside any check."""
    import numpy as np
    state = rs.init_state()
    prompts = torch.as_tensor(np.stack([corpus.sample(rng, AUDIT_PROMPT)
                                        for _ in range(8)]), device="cuda")
    nxt, _ = rs.prefill_step()(rs.params, prompts, state["caches"],
                               off=state.get("offload"))
    state["tokens"] = nxt
    state["pos"] = torch.full((), AUDIT_PROMPT, dtype=torch.int32,
                              device="cuda")
    decode = rs.resilient_decode().variant("healthy")
    state = decode(rs.params, state, None)[0]
    torch.cuda.synchronize()
    return state, decode


def audit_phase(torch, kernels, name, ctx):
    """(a) ten full-resident batch-8 decode steps of phase 5's 8-layer
    model under ``torch.cuda.set_sync_debug_mode("error")``; (b) ten
    pipelined steps (cache ratio 0.25) under "warn", the synchronising
    calls of each step against the host seams it entered (the CPU census's
    prediction, held exactly: one ``read_misses`` per MoE layer, and one
    miss-row upload per layer that fetched); (c) one full-resident decode step captured in
    a ``torch.cuda.CUDAGraph`` on a side stream (a check, not a gate); (d)
    the meta dry run's peak bytes for (a)'s serve against
    ``max_memory_allocated``.  Returns (ok, launch counts)."""
    import warnings

    import numpy as np

    from repro_torch.data.pipeline import MarkovCorpus
    from repro_torch.launch.dryrun import measure
    from repro_torch.launch.shapes import meta_serve_state
    from repro_torch.models.model import meta_model
    from repro_torch.models.moe import CALLBACK_SEAMS
    from repro_torch.serving.spec import OffloadSpec, ServeSpec
    from repro_torch.serving.steps import default_dali_config

    t_phase = time.perf_counter()
    params, cfg, res_np = ctx["params"], ctx["cfg"], ctx["res_vecs"]
    res = torch.as_tensor(res_np, dtype=torch.float32, device="cuda")
    corpus = MarkovCorpus(vocab=cfg.vocab, seed=0)
    rng = np.random.default_rng(15)
    dali_cfg = default_dali_config(cfg, cache_ratio=0.5)
    kernels.reset_launch_counts()          # the phase's path starts here

    # (a) full resident: no synchronising call in ten decode steps
    rs = ServeSpec(cfg=cfg, policy="dali", dali_cfg=dali_cfg, batch_size=8,
                   max_len=MAX_LEN, offload=OffloadSpec(mode="modeled")
                   ).resolve(params)
    state, decode = audit_prefill(torch, rs, cfg, rng, corpus)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(AUDIT_STEPS):
            state = decode(rs.params, state, res)[0]
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / AUDIT_STEPS
    peak = torch.cuda.max_memory_allocated()
    print(f"audit (a): {AUDIT_STEPS} full-resident batch-8 decode steps of "
          f"{cfg.name} ({cfg.n_layers} layers, published widths) under "
          f"set_sync_debug_mode(\"error\"): no synchronising call | "
          f"{ms:.2f} ms/step | pass | on {name}", flush=True)

    # (d) the dry run of the same serve on the meta device
    meta_state, meta_res = meta_serve_state(cfg, 8, MAX_LEN, rs.policy)
    dry = measure(decode, (meta_model(cfg), meta_state, meta_res))
    ratio = dry["peak_live_bytes"] / peak
    ok_d = 0.5 < ratio < 2.0
    print(f"audit (d): dry run of (a)'s decode on meta: peak "
          f"{dry['peak_live_bytes'] / 1e9:.2f} GB predicted (params "
          f"{dry['param_bytes'] / 1e9:.2f} GB), max_memory_allocated over "
          f"(a)'s steps {peak / 1e9:.2f} GB; ratio {ratio:.3f} | "
          f"{'pass' if ok_d else 'FAIL'} | on {name}", flush=True)

    # (c) capture one full-resident decode step in a CUDA graph
    graph = torch.cuda.CUDAGraph()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        decode(rs.params, state, res)
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    try:
        with torch.cuda.graph(graph, stream=side):
            decode(rs.params, state, res)
        captured = "captured"
    except Exception as e:               # noqa: BLE001 — printed: a check
        captured = f"not captured: {type(e).__name__}: {str(e)[:300]}"
    del graph
    torch.cuda.synchronize()
    print(f"audit (c): one full-resident decode step in a CUDA graph on a "
          f"side stream: {captured} | on {name}", flush=True)
    del state, decode, rs
    free(torch)

    # (b) pipelined: the synchronising calls of each step and its seams
    rs = ServeSpec(cfg=cfg, policy="dali",
                   dali_cfg=default_dali_config(cfg, cache_ratio=0.25),
                   batch_size=8, max_len=MAX_LEN,
                   offload=OffloadSpec(mode="pipelined")).resolve(params)
    state, decode = audit_prefill(torch, rs, cfg, rng, corpus)
    seams = {s.name: s for s in CALLBACK_SEAMS.values()}   # the store's
    per_step, ok_b = [], True
    for _ in range(AUDIT_STEPS):
        before = {k: s.entries for k, s in seams.items()}
        torch.cuda.set_sync_debug_mode("warn")
        try:
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                state = decode(rs.params, state, res)[0]
        finally:
            torch.cuda.set_sync_debug_mode(0)
        entered = {k: s.entries - before[k] for k, s in seams.items()
                   if s.entries > before[k]}
        n_sync = sum("synchroniz" in str(w.message) for w in caught)
        reads = entered.get("read_misses", 0)
        fetches = entered.get("fetch_weights", 0)
        per_step.append((n_sync, reads, fetches))
        ok_b = ok_b and reads == cfg.n_layers and n_sync == reads + fetches
    torch.cuda.synchronize()
    counts = kernels.launch_counts()       # ... and ends here
    print(f"audit (b): {AUDIT_STEPS} pipelined batch-8 decode steps at cache "
          f"ratio 0.25 under set_sync_debug_mode(\"warn\"): synchronising "
          f"calls per step {[n for n, _, _ in per_step]}; seams entered per "
          f"step: read_misses {[r for _, r, _ in per_step]}, fetch_weights "
          f"{[f for _, _, f in per_step]}; the census predicts read_misses + "
          f"fetch_weights = {[r + f for _, r, f in per_step]} | "
          f"{'pass' if ok_b else 'FAIL'} | on {name}", flush=True)
    del state, decode, rs
    free(torch)
    need = ("gating", "expert_ffn_ragged", "expert_ffn_grouped",
            "flash_attention")
    ran = all(counts[k] > 0 for k in need)
    print(f"audit: launches {json.dumps(counts)}; phase "
          f"{time.perf_counter() - t_phase:.1f} s", flush=True)
    return ok_d and ok_b and ran, counts


def remat_phase(torch, kernels, name):
    """(e) phase 9's training step (Mixtral-8x7B at published widths, 2
    layers, batch 8 x 128) with ``remat=True`` and without, 3 steps each
    on the same batch: ms per step (forward + backward, CUDA events), the
    device bytes the forward holds for the backward (what remat exists to
    cut; it must cut them), peak device memory over the steps, and the
    largest gradient difference between the two (each leaf relative to
    its max |g|, within 3e-2).  Only one step's gradients are on the card
    at a time: the previous step's are dropped before the next, and the
    run without remat moves its last ones to the host.  Returns (ok, launch counts of the
    remat steps)."""
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import MarkovCorpus, batches
    from repro_torch.models.model import init_model
    from repro_torch.training.train_step import make_loss_fn, value_and_grad
    from repro_torch.tree import tree_leaves, tree_map

    t_phase = time.perf_counter()
    cfg = get_config("mixtral-8x7b").replace(n_layers=TRAIN_LAYERS)
    params = init_model(cfg, seed=0, device="cuda")
    batch = {k: torch.as_tensor(v, device="cuda") for k, v in next(iter(
        batches(MarkovCorpus(vocab=cfg.vocab, seed=0), TRAIN_BATCH,
                TRAIN_SEQ, 1, seed=0))).items()}
    leaves = tree_leaves(params)

    def held_for_backward(loss_fn):
        """Device bytes a forward leaves allocated for its backward."""
        out = None
        for p in leaves:
            p.requires_grad_(True)
        try:
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            out = loss_fn(params, batch)
            torch.cuda.synchronize()
            return torch.cuda.memory_allocated() - base
        finally:
            out = None
            for p in leaves:
                p.requires_grad_(False)

    runs = {}
    for remat in (False, True):
        loss_fn = make_loss_fn(cfg.replace(remat=remat))
        value_and_grad(loss_fn, params, batch)            # warm-up
        held = held_for_backward(loss_fn)
        torch.cuda.synchronize()
        if remat:
            kernels.reset_launch_counts()  # the remat path starts here
        torch.cuda.reset_peak_memory_stats()
        times, grads = [], None
        for _ in range(TRAIN_STEPS):
            grads = None                   # the previous step's gradients
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            (_, m), grads = value_and_grad(loss_fn, params, batch)
            ev[1].record()
            ev[1].synchronize()
            times.append(ev[0].elapsed_time(ev[1]))
        peak = torch.cuda.max_memory_allocated()
        if not remat:                      # off the card for the remat run
            grads = tree_map(lambda g: g.cpu(), grads)
        runs[remat] = (times, held, peak, grads, float(m["loss"]))
        del grads
    counts = kernels.launch_counts()       # ... and ends here
    errs = [rel_err(a, b.cuda()) for a, b in zip(
        tree_leaves(runs[True][3]), tree_leaves(runs[False][3]))]
    cut = runs[True][1] < runs[False][1]
    ok = max(errs) < BF16_TOL and cut and all(
        counts[k] > 0 for k in ("gating", "expert_ffn_ragged",
                                "flash_attention"))
    nbytes = sum(p.nbytes for p in leaves)  # the params, and the grads
    for remat in (False, True):
        times, held, peak, _, loss = runs[remat]
        print(f"remat (e): {cfg.name} {cfg.n_layers} layers, batch "
              f"{TRAIN_BATCH} x {TRAIN_SEQ}, remat={remat}: forward + "
              f"backward {' / '.join(f'{t:.1f}' for t in times)} ms, held "
              f"by the forward for the backward {held / 1e6:.1f} MB, peak "
              f"device memory {peak / 1e9:.2f} GB = params {nbytes / 1e9:.2f}"
              f" + grads {nbytes / 1e9:.2f} + the rest "
              f"{(peak - 2 * nbytes) / 1e9:.2f} GB, loss {loss:.4f} | on "
              f"{name}", flush=True)
    print(f"remat (e): gradients with remat against without, {len(errs)} "
          f"leaves: max rel_err {max(errs):.3e}; remat cuts the forward's "
          f"held bytes: {cut}; launches under remat {json.dumps(counts)} "
          f"(each forward kernel twice a step: the forward and the "
          f"backward's recompute) | {'pass' if ok else 'FAIL'}; phase "
          f"{time.perf_counter() - t_phase:.1f} s", flush=True)
    del params, runs
    free(torch)
    return ok, counts


# --------------------------------------------------------------------------
# phase 16: expert parallelism on gloo ranks sharing the card
# --------------------------------------------------------------------------

EP_TP, EP_BATCH, EP_SEQ, EP_LAYERS, EP_SEED = 4, 4, 512, 2, 16
EP_TRIALS_WORLD = 8          # (c): the reference's (1, 8) mesh
EP_TIMEOUT_S = 600


def ep_rank(rank, world, tokens):
    """One rank of phase 16 (a) and (b) on the card: Mixtral-8x7B at
    published widths, 2 layers, bfloat16, capacity factor 0 (no row drops
    on either side), weights drawn on the card from seed 0 (the same on
    every rank); rank 0 first runs the single-process port on them (K2
    ragged).  Each rank then keeps its 'model' slots of the expert stacks
    (and a host copy of the first MoE layer's, for (b)'s re-route) and
    runs the prefill under ``rules(make_mesh(1, world))``."""
    import dataclasses
    import hashlib

    import numpy as np
    import torch

    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.core.cost_model import parse_topology
    from repro_torch.launch import sharding as shd
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.model import apply_model, collect_field, init_model
    from repro_torch.models.moe import apply_moe
    from repro_torch.models.moe_ep import (permute_expert_params,
                                           solve_placement)
    from repro_torch.tree import tree_map

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    dev = torch.device("cuda")
    full = get_config("mixtral-8x7b")
    cfg = full.replace(n_layers=EP_LAYERS, moe=dataclasses.replace(
        full.moe, capacity_factor=0.0))
    cfg125 = full.replace(n_layers=EP_LAYERS)     # the published 1.25
    E = cfg.moe.n_routed
    e_loc = E // world
    V = cfg.vocab
    tok = torch.as_tensor(tokens, device=dev)
    params = init_model(cfg, seed=0, device="cuda")
    out = {"rank": rank}
    checks = {}
    if rank == 0:
        kernels.reset_launch_counts()
        with torch.no_grad():
            ref_logits, _, ref_infos = apply_model(params, tok, cfg,
                                                   trace=True)
        torch.cuda.synchronize()
        out["ref_launches"] = kernels.launch_counts()
        ref_w0 = collect_field(ref_infos, "workload")[0]
        ref_logits = ref_logits[..., :V].float()
        del ref_infos
    mlp = params["scan"][0]["mlp"]
    host0 = {k: mlp[k][0].cpu() for k in ("gate", "up", "down")}
    for k in ("gate", "up", "down"):
        mlp[k] = mlp[k][:, rank * e_loc:(rank + 1) * e_loc].clone()
    import gc
    gc.collect()
    torch.cuda.empty_cache()
    mesh = make_mesh(1, world)
    torch.cuda.reset_peak_memory_stats()
    with shd.rules(mesh), torch.no_grad():
        # (a) the prefill through the EP path: counts zeroed just before
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        logits, _, infos = apply_model(params, tok, cfg, trace=True)
        torch.cuda.synchronize()
        out["prefill_s"] = time.perf_counter() - t0
        out["launches"] = kernels.launch_counts()
        logits = logits[..., :V]
        out["logits_sha1"] = hashlib.sha1(
            logits.float().cpu().numpy().tobytes()).hexdigest()
        checks["finite"] = bool(torch.isfinite(logits).all())
        cx = collect_field(infos, "ep_cx").cpu().tolist()
        dropped = collect_field(infos, "dropped").cpu().tolist()
        w0 = collect_field(infos, "workload")[0]
        C = (EP_BATCH * EP_SEQ) // world          # capacity factor 0
        out.update(ep_cx=cx, dropped=dropped, C=C)
        checks["no_drops"] = sum(dropped) == 0
        checks["ep_cx_at_most_C"] = all(c <= C for c in cx)
        if rank == 0:
            out["logits_rel_err"] = rel_err(logits.float(), ref_logits)
            checks["logits"] = out["logits_rel_err"] < BF16_TOL
            checks["workload_first_layer"] = bool(torch.equal(w0, ref_w0))
            del ref_logits
        x0 = collect_field(infos, "gate_in")[0].reshape(
            EP_BATCH, EP_SEQ, cfg.d_model)
        del infos, logits
        local0 = tree_map(lambda t: t[0], mlp)
        # (a) at the published capacity factor: both exchanges drop the
        # same rows
        y_r, i_r = apply_moe(local0, x0, cfg125)
        y_d, i_d = apply_moe(local0, x0, cfg125, force_exchange="dense")
        out["dropped_125"] = (int(i_r["dropped"]), int(i_d["dropped"]))
        out["ep_cx_125"] = (int(i_r["ep_cx"]), int(i_d["ep_cx"]))
        out["ragged_dense_rel_err"] = rel_err(y_r, y_d)
        checks["drops_125"] = out["dropped_125"][0] == out["dropped_125"][1]
        checks["ragged_dense_125"] = out["ragged_dense_rel_err"] < BF16_TOL
        del y_r, y_d, i_r, i_d
        # (b) a placement solved against a fabric with one slow pair: the
        # link from the rank holding the most demand to the next one, so
        # the hottest experts must move; each rank re-slices its slots
        # from the host copy
        y_id, i_id = apply_moe(local0, x0, cfg, demand_view=True)
        demand = i_id["ep_counts"].cpu().numpy()
        hot = int(demand.sum(0).reshape(world, e_loc).sum(1).argmax())
        fabric = f"flat,{hot}>{(hot + 1) % world}:x8"
        perm = solve_placement(demand, parse_topology(fabric, world))
        out["fabric"] = fabric
        phys = permute_expert_params(host0, perm)
        placed = dict(local0, **{k: phys[k][rank * e_loc:(rank + 1) * e_loc]
                                 .to(dev) for k in ("gate", "up", "down")})
        y_pl, i_pl = apply_moe(placed, x0, cfg, placement=perm,
                               demand_view=True)
        torch.cuda.synchronize()
        out["placement"] = perm.tolist()
        checks["placement_moves"] = not np.array_equal(perm, np.arange(E))
        checks["placement_bit_exact"] = bool(torch.equal(y_pl, y_id))
        checks["demand_view"] = bool(torch.equal(i_pl["ep_counts"],
                                                 i_id["ep_counts"]))
    out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    out["checks"] = checks
    out["seconds"] = time.perf_counter() - t_start
    return out


def ep_phase(torch, kernels, name):
    """Phase 16: (a) and (b) on ``EP_TP`` ranks (``ep_rank``), then (c)
    the reference's resilience trials on ``EP_TRIALS_WORLD`` ranks, every
    rank on this card through gloo.  Returns (ok, (a)'s launches summed
    over the ranks, (c)'s)."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import MarkovCorpus
    from repro_torch.launch.ep_serve import run_resilience_trials
    from repro_torch.launch.mesh import run_ranks

    t0 = time.perf_counter()
    cfg = get_config("mixtral-8x7b")
    corpus = MarkovCorpus(vocab=cfg.vocab, seed=0)
    rng = np.random.default_rng(EP_SEED)
    tokens = np.stack([corpus.sample(rng, EP_SEQ) for _ in range(EP_BATCH)]
                      ).astype(np.int32)
    print(f"ep: {cfg.name} at published widths, {EP_LAYERS} layers, "
          f"bfloat16, B={EP_BATCH} S={EP_SEQ} on a (1, {EP_TP}) mesh of "
          f"gloo ranks sharing the card (buckets staged through host "
          "memory)", flush=True)
    ranks = run_ranks(ep_rank, EP_TP, backend="gloo", device="cuda",
                      timeout_s=EP_TIMEOUT_S, args=(tokens,))
    t_a = time.perf_counter() - t0
    counts = {k: sum(r["launches"][k] for r in ranks)
              for k in ranks[0]["launches"]}
    ok = all(all(r["checks"].values()) for r in ranks)
    ok = ok and len({r["logits_sha1"] for r in ranks}) == 1
    r0 = ranks[0]
    for r in ranks:
        print(f"ep (a) rank {r['rank']}: ep_cx per layer {r['ep_cx']} "
              f"(C={r['C']}), dropped {r['dropped']}, prefill "
              f"{r['prefill_s']:.2f} s, peak {r['peak_gb']:.2f} GB, "
              f"{r['seconds']:.1f} s | checks "
              + " ".join(f"{k}={'pass' if v else 'FAIL'}"
                         for k, v in r["checks"].items()), flush=True)
    print(f"ep (a): logits against the single-process port (K2 ragged, "
          f"launches {json.dumps(r0['ref_launches'])}): rel_err "
          f"{r0['logits_rel_err']:.3e}; the same logits on every rank: "
          f"{len({r['logits_sha1'] for r in ranks}) == 1}; at capacity "
          f"factor 1.25 dropped ragged / dense {r0['dropped_125']}, ep_cx "
          f"{r0['ep_cx_125']}, rel_err {r0['ragged_dense_rel_err']:.3e}",
          flush=True)
    print(f"ep (b): placement against '{r0['fabric']}' "
          f"{r0['placement']}", flush=True)
    print(f"ep (a)+(b): kernel launches summed over the ranks "
          f"{json.dumps(counts)} ({t_a:.1f} s with the spawn)", flush=True)
    ok = ok and counts["gating"] > 0 and counts["expert_ffn_grouped"] > 0
    # (c) the reference's three trials at its geometry and faults
    t1 = time.perf_counter()
    res = run_resilience_trials(world=EP_TRIALS_WORLD, device="cuda")
    for tr in res["trials"]:
        fm, fb = tr["fault_ms_per_step"], tr["fault_pair_bytes_per_step"]
        print(f"ep (c) {tr['name']}: {tr['ms_per_step']:.2f} ms/step"
              + (f" | fault window {fm:.2f} ms/step" if fm else "")
              + (f" | degraded pair {fb / 1e3:.1f} KB/step" if fb else "")
              + f" | reroutes {tr['reroutes']}", flush=True)
    trial_counts = {k: sum(w["launches"][k] for w in res["workers"])
                    for k in counts}
    peaks = [round((w["peak_bytes"] or 0) / 1e9, 3) for w in res["workers"]]
    print(f"ep (c): {res['faults']} on {res['tp']} ranks, {res['dtype']}: "
          "verdicts " + " ".join(f"{k}={'PASS' if v else 'FAIL'}"
                                 for k, v in res["verdicts"].items())
          + f"; peak GB per rank {peaks}; launches {json.dumps(trial_counts)} "
          f"({time.perf_counter() - t1:.1f} s)", flush=True)
    ok = (ok and res["ok"] and trial_counts["gating_warp"] > 0
          and trial_counts["expert_ffn_grouped"] > 0)
    print(f"ep: phase {time.perf_counter() - t0:.1f} s on {name} | "
          f"{'pass' if ok else 'FAIL'}", flush=True)
    return ok, counts, trial_counts


# --------------------------------------------------------------------------
# phase 17: the GSPMD layout on DTensor, on gloo ranks sharing the card
# --------------------------------------------------------------------------

LAYOUT_MESH, LAYOUT_LAYERS, LAYOUT_SEED = (2, 2), 2, 17
LAYOUT_BATCH, LAYOUT_SEQ, LAYOUT_DECODE, LAYOUT_TRAIN_SEQ = 4, 512, 8, 128
# fsdp gathers every weight in every step through host memory (some 9 s
# a step on the card): it decodes one step where tp decodes 8 (the depth
# cut that keeps the script inside its time limit)
LAYOUT_DECODE_FSDP = 1
LAYOUT_TIMEOUT_S = 600
# (d): the archs whose laid-out layers came last, at published widths under
# tp: tag, arch, decoder layers, encoder layers (a depth cut for the time
# limit), batch, prompt, cross source positions
LAYOUT_ARCHS = (
    ("vision", "llama-3.2-vision-11b", 5, None, 2, 256, 1601),
    ("seamless", "seamless-m4t-large-v2", 4, 4, 2, 256, 1024),
    ("gemma2", "gemma2-9b", 2, None, 2, 5000, None),
)
LAYOUT_ARCH_DECODE = 4


def layout_cfg():
    """Mixtral-8x7B at published widths, ``LAYOUT_LAYERS`` layers,
    bfloat16 (its config's own dtypes)."""
    from repro_torch.configs import get_config
    return get_config("mixtral-8x7b").replace(n_layers=LAYOUT_LAYERS)


def _local_ref(lay, full, dt):
    """This rank's slice of the full reference tensor ``full`` as the
    DTensor ``dt`` lies."""
    lshape, off = lay.local_offset(full.shape, dt.placements, dt.device_mesh)
    for d, (o, n) in enumerate(zip(off, lshape)):
        full = full.narrow(d, o, n)
    return full


@contextlib.contextmanager
def recorded_routing(torch, replay=None):
    """Within: every K1 call's top-k choices appended to the yielded list;
    with ``replay`` (a list of (T, K) choices, one a call in order), each
    call takes those choices instead, its gates and probabilities from its
    own logits (``train_parity``'s way of holding two steps to the same
    function)."""
    import repro_torch.models.moe as moe
    from repro_torch.kernels.gating.ops import _gates, _probs
    real, got = moe.gating, []

    def gating(logits, top_k, router_type, renormalize):
        if replay is None:
            out = real(logits, top_k, router_type, renormalize)
            got.append(out[1].detach())
            return out
        idx = replay[len(got)].to(logits.device)
        got.append(idx)
        x = logits.float()
        probs = _probs(x, router_type)
        return _gates(x, probs, idx, router_type, renormalize), idx, probs

    moe.gating = gating
    try:
        yield got
    finally:
        moe.gating = real


def layout_steps(torch, cfg, params, toks, lbls, mesh, wmode, ref=None,
                 ref_grads=None):
    """Phase 17's steps laid out on ``mesh`` from the full ``params``
    (``meta`` for the fake group's dry run): the prefill into a
    sequence-sharded cache under ``prefill_32k``'s map (under tp after the
    B x S forward), ``LAYOUT_DECODE`` greedy decode steps under tp and
    ``LAYOUT_DECODE_FSDP`` under fsdp with ``decode_32k``'s, the gradients
    of one training step at B x ``LAYOUT_TRAIN_SEQ`` under ``train_4k``'s.
    Returns (results, each step's collectives as (kind, result bytes,
    group size, axes), the per-kind bytes).  With ``ref``
    (the single-process port's results, on every rank) each rank holds
    its own shards against the reference's slices: no result is gathered
    but the greedy tokens and the training step's routing:
    ``ref_grads(routing)`` gives the single process's gradients on the
    laid-out step's routing (``recorded_routing``), so that both steps
    differentiate the same function."""
    import torch.distributed as dist

    from repro_torch.launch import layout as lay
    from repro_torch.launch import sharding as shd
    from repro_torch.launch.collectives import CollectiveCount
    from repro_torch.models.model import apply_model, init_caches, meta_caches
    from repro_torch.serving.steps import (default_dali_config,
                                           init_serve_state,
                                           make_decode_step,
                                           make_prefill_step)
    from repro_torch.training.train_step import make_loss_fn, value_and_grad
    from repro_torch.tree import tree_leaves
    meta = toks.is_meta
    B, S = toks.shape
    lm = lambda shape: shd.logical_map_for(cfg, shape, mesh)
    sig, kinds, out, secs = {}, {}, {}, {}

    def count(name, cc, t0):
        if not meta:
            torch.cuda.synchronize()
        secs[name] = time.perf_counter() - t0
        sig[name] = cc.signature()
        for k, v in cc.summary().items():
            if not isinstance(v, dict):
                kinds[k] = kinds.get(k, 0) + v

    with shd.rules(mesh, lm("prefill_32k"), wmode), torch.no_grad():
        p = lay.distribute_params(params, cfg, mesh, wmode)
        t = lay.distribute_batch(toks, mesh)
        if wmode == "tp":
            t0 = time.perf_counter()
            with CollectiveCount(mesh) as cc:
                logits, _, infos = apply_model(p, t, cfg, trace=True)
            count("forward", cc, t0)
        if ref is not None and wmode == "tp":
            # each row's largest difference over the rank's vocab columns,
            # then over 'model'; each row against its own largest logit
            lg = logits.to_local().float().cpu()
            r = _local_ref(lay, ref["logits"], logits)
            diff = (lg - r).abs().amax(-1)
            dist.all_reduce(diff, op=dist.ReduceOp.MAX,
                            group=mesh.get_group("model"))
            b0, bl = lay.offset(logits, 0), lg.shape[0]
            rmax = ref["logits"][b0:b0 + bl].abs().amax(-1)
            out["row_err"] = (diff / (rmax + 1e-6)).flatten()
            idx = infos[-1][0]["topk_idx"].to_local().cpu()   # (L, T_l, K)
            ridx = ref["topk"][:, b0 * S:(b0 + bl) * S]
            flip = (idx.sort(-1).values != ridx.sort(-1).values).any(-1)
            out["flips"] = [int(f.sum()) for f in flip]        # per layer
            out["flipped"] = flip.any(0)                        # per token
        if wmode == "tp":
            del logits, infos
        n_dec = LAYOUT_DECODE if wmode == "tp" else LAYOUT_DECODE_FSDP
        max_len = S + n_dec
        caches = lay.distribute_caches(
            meta_caches(cfg, B, max_len, dtype=cfg.dtype) if meta
            else init_caches(cfg, B, max_len, device="cuda"), cfg,
            "prefill_32k", mesh)
        t0 = time.perf_counter()
        with CollectiveCount(mesh) as cc:
            first, caches = make_prefill_step(cfg)(p, t, caches)
        count("prefill", cc, t0)
    dcfg = default_dali_config(cfg)
    decode = make_decode_step(cfg, dcfg)
    with shd.rules(mesh, lm("decode_32k"), wmode), torch.no_grad():
        if meta:
            from repro_torch.launch.shapes import meta_serve_state
            from repro_torch.serving.steps import resolve_policy
            state, _ = meta_serve_state(cfg, B, max_len,
                                        resolve_policy(None, cfg, dcfg))
        else:
            state = init_serve_state(cfg, B, max_len, dali_cfg=dcfg,
                                     device="cuda")
        state.update(caches=caches, tokens=first, pos=torch.full(
            (), S, dtype=torch.int32, device=toks.device))
        got = [first]
        t0 = time.perf_counter()
        with CollectiveCount(mesh) as cc:
            for _ in range(n_dec):
                state, _, _ = decode(p, state)
                got.append(state["tokens"])
        count("decode", cc, t0)
        if ref is not None:
            out["tokens"] = [g.full_tensor().cpu() for g in got]
        del p, state, caches, got
    T = LAYOUT_TRAIN_SEQ
    with shd.rules(mesh, lm("train_4k"), wmode):
        p = lay.distribute_params(params, cfg, mesh, wmode)
        batch = lay.distribute_batch({"tokens": toks[:, :T],
                                      "labels": lbls[:, :T]}, mesh)
        t0 = time.perf_counter()
        with CollectiveCount(mesh) as cc, recorded_routing(torch) as route:
            (_, metrics), grads = value_and_grad(make_loss_fn(cfg), p,
                                                 batch)
        count("train", cc, t0)
        if ref is not None:
            # each MoE layer's choices, every rank's token block gathered
            from torch.distributed.tensor import DTensor
            blocks = torch.stack(route).reshape(
                (len(route),) + lay.local_offset(
                    (B, T), lay.place(("data", "model")))[0] + (-1,))
            full = DTensor.from_local(
                blocks, mesh, lay.place((None, "data", "model", None)),
                run_check=False).full_tensor()
            rg = ref_grads(full.reshape(len(route), B * T, -1).cpu())
            out["loss"] = float(metrics["loss"].full_tensor())
            out["ref_loss"] = rg["loss"]
            out["grad_ref_max"] = rg["max"]
            out["train_moved"] = rg["moved"]
            # per leaf, on the card: the largest difference of the shards
            out["grad_diff"] = [
                float((g.to_local().float() - _local_ref(lay, r, g).to(
                    g.to_local().device).float()).abs().max())
                for g, r in zip(tree_leaves(grads), tree_leaves(rg["grads"]))]
        del p, grads
    out["seconds"] = secs
    return out, sig, kinds


def layout_reference(torch, cfg, params, toks, lbls):
    """The single-process port on the card from the same params: logits,
    each MoE layer's top-k choices, the greedy tokens and each decode
    step's logits (on the host)."""
    from repro_torch.models.model import apply_model, init_caches
    from repro_torch.serving.steps import (default_dali_config,
                                           init_serve_state,
                                           make_decode_step,
                                           make_prefill_step)
    B, S = toks.shape
    ref = {}
    with torch.no_grad():
        logits, _, infos = apply_model(params, toks, cfg, trace=True)
        ref["logits"] = logits[..., :cfg.vocab].float().cpu()
        ref["topk"] = infos[-1][0]["topk_idx"].cpu()         # (L, T, K)
        del logits, infos
        caches = init_caches(cfg, B, S + LAYOUT_DECODE, device="cuda")
        first, caches = make_prefill_step(cfg)(params, toks, caches)
        dcfg = default_dali_config(cfg)
        state = init_serve_state(cfg, B, S + LAYOUT_DECODE, dali_cfg=dcfg,
                                 device="cuda")
        state.update(caches=caches, tokens=first,
                     pos=torch.full((), S, dtype=torch.int32, device="cuda"))
        decode = make_decode_step(cfg, dcfg)
        got, lgs = [first.cpu()], []
        for _ in range(LAYOUT_DECODE):
            state, lg, _ = decode(params, state)
            got.append(state["tokens"].cpu())
            lgs.append(lg[:, -1, :cfg.vocab].float().cpu())
        ref["tokens"], ref["dec_logits"] = got, torch.stack(lgs)
    return ref


def layout_ref_grads(torch, cfg, params, toks, labels, routing):
    """The single-process port's training-step gradients (on the host) on
    the laid-out step's ``routing`` (L, B x T, K), their loss, each leaf's
    largest magnitude, and how many of (layer, token) rows its own router
    would have sent elsewhere."""
    from repro_torch.models.model import apply_model
    from repro_torch.training.train_step import make_loss_fn, value_and_grad
    from repro_torch.tree import tree_leaves, tree_map
    with recorded_routing(torch, list(routing)):
        (_, m), grads = value_and_grad(make_loss_fn(cfg), params,
                                       {"tokens": toks, "labels": labels})
    with torch.no_grad(), recorded_routing(torch) as own:
        apply_model(params, toks, cfg)
    moved = sum(int((a.cpu().sort(-1).values != b.sort(-1).values)
                    .any(-1).sum()) for a, b in zip(own, routing))
    return {"grads": tree_map(lambda g: g.cpu(), grads),
            "loss": float(m["loss"]), "moved": moved,
            "max": [float(g.float().abs().max()) for g in tree_leaves(grads)]}


def layout_rank(rank, world, tokens, labels, ref_path):
    """One rank of phase 17 (a) and (d): weights drawn on the card from
    seed 0 (the same on every rank); rank 0 first runs the single-process
    port on them and writes its results to ``ref_path``, which every rank
    maps; every rank then runs ``layout_steps`` under ``tp`` and
    ``fsdp``, then (d) (``layout_archs``)."""
    import gc

    import torch

    from repro_torch import kernels
    from repro_torch.launch.mesh import make_mesh, wire_name
    from repro_torch.models.model import init_model
    from repro_torch.tree import tree_map

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    cfg = layout_cfg()
    toks = torch.as_tensor(tokens, device="cuda")
    lbls = torch.as_tensor(labels, device="cuda")
    params = init_model(cfg, seed=0, device="cuda")
    out = {"rank": rank, "wire": wire_name("gloo", "cuda")}
    if rank == 0:
        torch.cuda.reset_peak_memory_stats()
        ref = layout_reference(torch, cfg, params, toks, lbls)
        torch.cuda.synchronize()
        out["single_peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
        out["ref_tokens"] = ref["tokens"]
        out["ref_dec_logits"] = ref["dec_logits"]
        torch.save(ref, ref_path)
        del ref
    # four processes share the card: the full weights wait in host memory,
    # and only each rank's shards go to the card
    params = tree_map(lambda t: t.cpu(), params)
    gc.collect()
    torch.cuda.empty_cache()
    mesh = make_mesh(*LAYOUT_MESH, device_type="cuda")   # after rank 0's save
    ref = torch.load(ref_path, mmap=True, weights_only=True)
    saved = {}

    def ref_grads(routing):
        """Rank 0's single-process gradients on ``routing``, mapped by every
        rank (computed once per routing)."""
        import torch.distributed as dist
        key = routing.numpy().tobytes()
        if key not in saved:
            path = f"{ref_path}.{len(saved)}"
            dist.barrier()
            if rank == 0:
                from repro_torch.launch import sharding as shd
                counts = kernels.launch_counts()  # the reference's: uncounted
                with shd.rules(None):        # the single process, unlaid
                    rg = layout_ref_grads(torch, cfg, tree_map(
                        lambda t: t.cuda(), params),
                        toks[:, :LAYOUT_TRAIN_SEQ],
                        lbls[:, :LAYOUT_TRAIN_SEQ], routing)
                kernels.LAUNCHES.update(counts)
                torch.save(rg, path)
                del rg
                gc.collect()
                torch.cuda.empty_cache()
            dist.barrier()
            saved[key] = torch.load(path, mmap=True, weights_only=True)
        return saved[key]

    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    for wmode in ("tp", "fsdp"):
        t0 = time.perf_counter()
        res, sig, kinds = layout_steps(torch, cfg, params, toks, lbls, mesh,
                                       wmode, ref, ref_grads)
        torch.cuda.synchronize()
        out[wmode] = dict(res, sig=sig, kinds=kinds,
                          total_s=time.perf_counter() - t0)
        gc.collect()
        torch.cuda.empty_cache()
    out["launches"] = kernels.launch_counts()
    out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    out["seconds"] = time.perf_counter() - t_start
    del params, ref, saved
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    out["archs"] = layout_archs(torch, kernels, rank, mesh, ref_path)
    out["archs_s"] = time.perf_counter() - t0
    return out


def layout_arch_cfg(arch, n_layers, n_enc):
    """``arch`` at published widths cut to ``n_layers`` decoder layers (and
    ``n_enc`` encoder layers), bfloat16 (its config's own dtypes)."""
    import dataclasses

    from repro_torch.configs import get_config
    cfg = get_config(arch).replace(n_layers=n_layers)
    if n_enc is not None:
        cfg = cfg.replace(encoder=dataclasses.replace(cfg.encoder,
                                                      n_layers=n_enc))
    return cfg


def layout_arch_serve(torch, cfg, params, toks, src, mesh=None):
    """The prefill (its last logits) and ``LAYOUT_ARCH_DECODE`` greedy
    decode steps of (d), with the cross source where there is one: on one
    process (``mesh`` None) or laid out under tp on ``mesh`` (the prefill
    under prefill_32k's map, the decode under decode_32k's; the cache's
    sequence over 'model').  -> (each step's logits rows (steps, B, V) and
    greedy tokens (B, 1 + steps) on the host, the caches)."""
    from repro_torch.launch import layout as lay
    from repro_torch.launch import sharding as shd
    from repro_torch.models.model import apply_model, init_caches
    from repro_torch.serving.steps import init_serve_state, make_decode_step
    B, S = toks.shape
    V = cfg.vocab
    n = LAYOUT_ARCH_DECODE
    caches = init_caches(cfg, B, S + n, device="cuda",
                         n_cross=None if src is None else src.shape[1])
    rules = (lambda shape: shd.rules(mesh, shd.logical_map_for(
        cfg, shape, mesh), "tp")) if mesh is not None \
        else (lambda shape: contextlib.nullcontext())
    host = (lambda t: t.full_tensor().float().cpu()) if mesh is not None \
        else (lambda t: t.float().cpu())
    rows, toks_out = [], []
    with rules("prefill_32k"), torch.no_grad():
        p, t, x = params, toks, src
        if mesh is not None:
            p = lay.distribute_params(params, cfg, mesh, "tp")
            t = lay.distribute_batch(toks, mesh)
            x = None if src is None else lay.distribute_batch(src, mesh)
            caches = lay.distribute_caches(caches, cfg, "prefill_32k", mesh)
        lg, caches, _ = apply_model(
            p, t, cfg, positions=torch.arange(S, dtype=torch.int32,
                                              device="cuda"),
            caches=caches, cross_src=x, last_logit_only=True)
        nxt = lg[:, -1:].argmax(-1).to(torch.int32)
        rows.append(host(lg)[:, -1, :V])
        toks_out.append(host(nxt))
    decode = make_decode_step(cfg, None)
    with rules("decode_32k"), torch.no_grad():
        state = init_serve_state(cfg, B, S + n, dali_cfg=None, device="cuda")
        state.update(caches=caches, tokens=nxt, pos=torch.full(
            (), S, dtype=torch.int32, device="cuda"))
        for _ in range(n):
            state, lg, _ = decode(p, state)
            rows.append(host(lg)[:, -1, :V])
            toks_out.append(host(state["tokens"]))
        torch.cuda.synchronize()
    return torch.stack(rows), torch.cat(toks_out, 1).long(), caches


def rolling_slots_ok(torch, cache, S):
    """Whether this rank's shard of a rolling cache's ``pos`` (1, B, S_c),
    its sequence over 'model', holds at each slot j the latest of the
    positions 0..S-1 (the prompt's and the decoded tokens') congruent to j
    modulo S_c."""
    from repro_torch.launch import layout as lay
    pos = cache["pos"]
    S_c = pos.shape[-1]
    s0 = lay.offset(pos, 2)
    loc = pos.to_local()
    j = torch.arange(s0, s0 + loc.shape[-1], device=loc.device)
    want = j + S_c * torch.div(S - 1 - j, S_c, rounding_mode="floor")
    return bool((loc == want.to(loc.dtype)).all())


def layout_archs(torch, kernels, rank, mesh, ref_path):
    """(d) on one rank: each of ``LAYOUT_ARCHS`` drawn on the card from
    seed 0 (its cross gates opened to 0.5), rank 0 serving it on one
    process first (uncounted), then every rank laid out under tp, K3's
    forms counted (``k3_forms``).  -> per arch the laid-out rows and
    tokens (rank 0), the single process's, the K3 forms, whether every
    local rolling-cache position sits at its slot (Gemma-2), and the
    seconds; and the launches of the laid-out runs."""
    import gc

    import torch.distributed as dist

    from repro_torch.launch import sharding as shd
    from repro_torch.models.model import init_model
    out = {}
    kernels.reset_launch_counts()
    for tag, arch, n_layers, n_enc, B, S, T in LAYOUT_ARCHS:
        t0 = time.perf_counter()
        cfg = layout_arch_cfg(arch, n_layers, n_enc)
        params = open_gates(torch, init_model(cfg, seed=0, device="cuda"))
        g = torch.Generator(device="cuda")
        g.manual_seed(LAYOUT_SEED)
        toks = torch.randint(0, cfg.vocab, (B, S), generator=g,
                             device="cuda", dtype=torch.int32)
        src = None if T is None else (torch.randn(
            (B, T, cfg.d_model), generator=g, device="cuda") * 0.1).to(
                torch.bfloat16)
        path = f"{ref_path}.{tag}"
        if rank == 0:
            counts = kernels.launch_counts()   # the single process's: uncounted
            with shd.rules(None):
                rows, tk, _ = layout_arch_serve(torch, cfg, params, toks, src)
            kernels.LAUNCHES.update(counts)
            torch.save({"rows": rows, "tokens": tk}, path)
            del rows, tk
        dist.barrier()
        t1 = time.perf_counter()
        with k3_forms() as forms:
            rows, tk, caches = layout_arch_serve(torch, cfg, params, toks,
                                                 src, mesh)
        res = {"forms": dict(forms), "laid_s": time.perf_counter() - t1}
        if cfg.attn.sliding_window and S > cfg.attn.sliding_window:
            res["slots_ok"] = rolling_slots_ok(torch, caches["scan"][0],
                                               S + LAYOUT_ARCH_DECODE)
        if rank == 0:
            ref = torch.load(path, weights_only=True)
            res.update(rows=rows, tokens=tk, ref_rows=ref["rows"],
                       ref_tokens=ref["tokens"])
        res["seconds"] = time.perf_counter() - t0
        out[tag] = res
        del params, caches, toks, src
        gc.collect()
        torch.cuda.empty_cache()
    out["launches"] = kernels.launch_counts()
    return out


def layout_arch_verdict(torch, tag, ranks):
    """(d)'s gates for one arch: K3 launched in every rank in the arch's
    forms (non-causal for the cross layers and the encoder, windowed with
    a softcap for Gemma-2's local layer), Gemma-2's rolling-cache slots
    right in every rank, and ``layout_verdict``'s rule on rank 0's rows:
    each logits row within 3e-2 of the single process's, relative to its
    max, up to and including the step of a row's first token that
    differs; tokens equal, or the first that differs a tie within 3e-2 of
    the row's max.  -> (ok, lines)."""
    r0 = ranks[0]["archs"][tag]
    need = "window_softcap" if tag == "gemma2" else "noncausal"
    forms_ok = all(r["archs"][tag]["forms"][need] > 0 for r in ranks)
    slots_ok = all(r["archs"][tag].get("slots_ok", True) for r in ranks)
    rows, ref = r0["rows"], r0["ref_rows"]             # (steps, B, V)
    lay_t, ref_t = r0["tokens"], r0["ref_tokens"]      # (B, steps)
    errs, tok_ok, notes = [], True, []
    for i in range(lay_t.shape[0]):
        diff = (lay_t[i] != ref_t[i]).nonzero()
        last = int(diff[0]) if len(diff) else lay_t.shape[1] - 1
        for k in range(last + 1):
            errs.append(float((rows[k, i] - ref[k, i]).abs().max()
                              / (ref[k, i].abs().max() + 1e-6)))
        if len(diff):
            lg = ref[last, i]
            gap = float(lg[ref_t[i, last]] - lg[lay_t[i, last]])
            tie = gap <= BF16_TOL * float(lg.abs().max())
            tok_ok = tok_ok and tie
            notes.append(f"row {i} first differs at step {last} "
                         f"({'a tie' if tie else 'NOT a tie'}, gap "
                         f"{gap:.4f})")
    row_ok = max(errs) < BF16_TOL
    ok = forms_ok and slots_ok and row_ok and tok_ok
    forms = [r["archs"][tag]["forms"][need] for r in ranks]
    lines = [f"rows rel_err max {max(errs):.3e} over {len(errs)} rows; "
             f"tokens {'equal' if not notes else '; '.join(notes)}; K3 "
             f"{need.replace('_', ' + ')} launches per rank {forms}"
             + ("" if tag != "gemma2" else
                f"; rolling-cache slots pos % window in every rank: "
                f"{slots_ok}")
             + f"; laid out {r0['laid_s']:.1f} s, with the single process "
             f"{r0['seconds']:.1f} s | {'pass' if ok else 'FAIL'}"]
    return ok, lines


def layout_verdict(torch, r0, ranks, wmode):
    """(a)'s gates for one weight mode.  bfloat16 rounds the ranks' partial
    sums where the single process rounds one sum, so a token whose router
    scores two experts within that rounding may take another expert
    (printed per MoE layer); such a token's row, and the rows a flip feeds,
    are the single process's only in distribution.  So: every row whose
    token took the same experts in every layer within 3e-2; at most 1 %
    of the tokens flipped; each greedy token equal, or the first that
    differs in its row one the single process scores within 3e-2 of its
    own choice (a tie at bfloat16's resolution; the row's later tokens
    follow other inputs); each gradient leaf within 3e-2 of the single
    process's step on the laid-out step's routing.  -> (ok, lines)."""
    w = r0[wmode]
    firsts = [r for r in ranks if r["rank"] % LAYOUT_MESH[1] == 0]
    if "row_err" not in w:
        return _verdict_rest(torch, r0, ranks, wmode, [])
    rows = torch.cat([r[wmode]["row_err"] for r in firsts])
    flipped = torch.cat([r[wmode]["flipped"] for r in firsts])
    flips = [sum(r[wmode]["flips"][i] for r in firsts)
             for i in range(len(w["flips"]))]
    kept = rows[~flipped]
    row_ok = float(kept.max()) < BF16_TOL
    flip_ok = int(flipped.sum()) <= 0.01 * rows.numel()
    lines = [f": logits row rel_err max {float(rows.max()):.3e}, median "
             f"{float(rows.median()):.3e}; {int((rows >= BF16_TOL).sum())} "
             f"of {rows.numel()} rows at 3e-2 or more; tokens that took "
             f"other experts than the single process, per MoE layer {flips}"
             f" ({int(flipped.sum())} tokens); the rows of the others: max "
             f"{float(kept.max()):.3e} | "
             f"{'pass' if row_ok and flip_ok else 'FAIL'}"]
    ok, lines = _verdict_rest(torch, r0, ranks, wmode, lines)
    return ok and row_ok and flip_ok, lines


def _verdict_rest(torch, r0, ranks, wmode, lines):
    """``layout_verdict``'s tokens and gradients."""
    w = r0[wmode]
    # greedy tokens: equal, or the first difference a tie
    lay_t = torch.cat(w["tokens"], 1)
    ref_t = torch.cat(r0["ref_tokens"], 1)[:, :lay_t.shape[1]]
    tok_ok = True
    for i in range(lay_t.shape[0]):
        diff = (lay_t[i] != ref_t[i]).nonzero()
        note = "the same"
        if len(diff):
            step = int(diff[0])
            if step == 0:
                tok_ok, note = False, "differs at the prefill's token"
            else:
                lg = r0["ref_dec_logits"][step - 1, i]
                gap = float(lg[ref_t[i, step]] - lg[lay_t[i, step]])
                tie = gap <= BF16_TOL * float(lg.abs().max())
                tok_ok = tok_ok and tie
                note = (f"first differs at decode step {step}, where the "
                        f"single process scores the laid-out choice "
                        f"{gap:.4f} under its own (row max "
                        f"{float(lg.abs().max()):.2f}): "
                        f"{'a tie' if tie else 'NOT a tie'}")
        lines.append(f" row {i}: laid out {lay_t[i].tolist()} | single "
                     f"{ref_t[i].tolist()} | {note}")
    lines.append(f": greedy tokens {'pass' if tok_ok else 'FAIL'}")
    lines.append(": rank 0's collectives, bytes per device "
                 + json.dumps({k: v for k, v in w["kinds"].items()}))
    if "grad_diff" not in w:
        return tok_ok, lines
    gmax = w["grad_ref_max"]
    gd = [max(r[wmode]["grad_diff"][k] for r in ranks)
          for k in range(len(gmax))]
    gerr = [d / (m + 1e-6) for d, m in zip(gd, gmax)]
    grad_ok = all(e < BF16_TOL for e in gerr)
    lines.append(f": the single process's training step on the laid-out "
                 f"step's routing ({w['train_moved']} (layer, token) rows its "
                 f"own router would have sent elsewhere); gradients max "
                 f"rel_err {max(gerr):.3e} "
                 f"({sum(e >= BF16_TOL for e in gerr)} of {len(gerr)} "
                 f"leaves at 3e-2 or more); "
                 f"loss {w['loss']:.5f} against {w['ref_loss']:.5f} | "
                 f"{'pass' if grad_ok else 'FAIL'}")
    return tok_ok and grad_ok, lines


def layout_dry(torch, tokens_shape):
    """(b): the same steps on ``meta`` as rank 0 of a fake group of 4."""
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.launch.dryrun import fake_world
    from repro_torch.models.model import meta_model
    cfg = layout_cfg()
    meta = lambda: torch.empty(tokens_shape, dtype=torch.int32,
                               device="meta")
    sigs = {}
    with fake_world(LAYOUT_MESH[0] * LAYOUT_MESH[1]):
        mesh = init_device_mesh("cpu", LAYOUT_MESH,
                                mesh_dim_names=("data", "model"))
        for wmode in ("tp", "fsdp"):
            sigs[wmode] = layout_steps(torch, cfg, meta_model(cfg), meta(),
                                       meta(), mesh, wmode)[1]
    return sigs


def layout_phase(torch, kernels, card):
    """Phase 17: (a) the layout on ``LAYOUT_MESH`` gloo ranks sharing the
    card, against the single-process port; (b) the fake group's ``meta``
    run of the same steps counts the same collectives; (c) the production
    mesh's dry run of Mixtral-8x7B decode_32k (subprocesses started first,
    read last); (d) on the same ranks after (a), Llama-3.2-Vision's cross
    layer, SeamlessM4T's encoder and decoder and Gemma-2's rolling cache
    past its window at published widths under tp, against the single
    process.  Returns (ok, the ranks' launches summed in (a), in (d))."""
    import os

    import numpy as np

    from repro_torch.data.pipeline import MarkovCorpus
    from repro_torch.launch.mesh import run_ranks

    t0 = time.perf_counter()
    env = dict(os.environ, PYTHONPATH=str(SRC))
    dry = {mesh: subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "mixtral-8x7b", "--shape", "decode_32k", "--mesh", mesh, "--force"],
        cwd=str(ROOT), env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for mesh in ("pod", "multi-pod")}
    cfg = layout_cfg()
    corpus = MarkovCorpus(vocab=cfg.vocab, seed=0)
    rng = np.random.default_rng(LAYOUT_SEED)
    tokens = np.stack([corpus.sample(rng, LAYOUT_SEQ + 1)
                       for _ in range(LAYOUT_BATCH)]).astype(np.int32)
    toks, lbls = tokens[:, :-1], tokens[:, 1:]
    # (b) runs on the host beside (a), in a process of its own (the fake
    # group is per process)
    dry_b = subprocess.Popen(
        [sys.executable, "-c", "import json, sys, torch; "
         f"sys.path[:0] = [{str(SRC)!r}, {str(ROOT)!r}]; import chip_smoke; "
         "print(json.dumps(chip_smoke.layout_dry(torch, "
         f"{tuple(toks.shape)!r})))"],
        cwd=str(ROOT), env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    print(f"layout: {cfg.name} at published widths, {LAYOUT_LAYERS} layers, "
          f"bfloat16, on a {LAYOUT_MESH} mesh of gloo ranks sharing the "
          f"card: prefill B={LAYOUT_BATCH} S={LAYOUT_SEQ} (prefill_32k; "
          f"under tp the forward's logits too), {LAYOUT_DECODE} greedy "
          f"decode steps under tp and {LAYOUT_DECODE_FSDP} under fsdp "
          f"(decode_32k, the cache's sequence over 'model'), under both the "
          f"gradients of a training step at S={LAYOUT_TRAIN_SEQ} (train_4k); "
          f"then (d) on the same ranks under tp: prefill and "
          f"{LAYOUT_ARCH_DECODE} greedy decode steps of "
          + ", ".join(a for _, a, *_ in LAYOUT_ARCHS), flush=True)
    import shutil
    import tempfile
    tmp = tempfile.mkdtemp(prefix="layout-ref-")
    try:
        ranks = run_ranks(layout_rank, LAYOUT_MESH[0] * LAYOUT_MESH[1],
                          backend="gloo", device="cuda",
                          timeout_s=LAYOUT_TIMEOUT_S,
                          args=(np.ascontiguousarray(toks),
                                np.ascontiguousarray(lbls),
                                os.path.join(tmp, "ref.pt")))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    t_a = time.perf_counter() - t0
    r0 = ranks[0]
    ok = True
    counts = {k: sum(r["launches"][k] for r in ranks)
              for k in r0["launches"]}
    for r in ranks:
        lc = r["launches"]
        good = all(lc[k] > 0 for k in ("gating", "expert_ffn_ragged",
                                       "flash_attention"))
        good = good and r["archs"]["launches"]["flash_attention"] > 0
        ok = ok and good
        print(f"layout (a) rank {r['rank']}: K1 {lc['gating']} K2 ragged "
              f"{lc['expert_ffn_ragged']} K3 {lc['flash_attention']} "
              f"(K2 grouped {lc['expert_ffn_grouped']}), peak "
              f"{r['peak_gb']:.2f} GB, tp {r['tp']['total_s']:.1f} s "
              f"{json.dumps({k: round(v, 2) for k, v in r['tp']['seconds'].items()})}"
              f", fsdp {r['fsdp']['total_s']:.1f} s "
              f"{json.dumps({k: round(v, 2) for k, v in r['fsdp']['seconds'].items()})}"
              f" | launched {'pass' if good else 'FAIL'}", flush=True)
    print(f"layout (a): wire {r0['wire']}; the single-process port's peak "
          f"{r0['single_peak_gb']:.2f} GB on rank 0", flush=True)
    for wmode in ("tp", "fsdp"):
        good, lines = layout_verdict(torch, r0, ranks, wmode)
        ok = ok and good
        for line in lines:
            print(f"layout (a) {wmode}{line}", flush=True)
    # (b) the fake group's meta run of the same steps
    stdout, stderr = dry_b.communicate(timeout=LAYOUT_TIMEOUT_S)
    if dry_b.returncode != 0:
        print(f"layout (b): FAIL\n{stderr[-2000:]}", flush=True)
        ok = False
    dry_sigs = json.loads(stdout) if dry_b.returncode == 0 else {}
    norm = lambda sig: [[e[0], e[1], e[2], list(e[3])] for e in sig]
    for wmode, steps in dry_sigs.items():
        for step, want in steps.items():
            got = r0[wmode]["sig"][step]
            same = norm(got) == norm(want)
            ok = ok and same
            print(f"layout (b) {wmode} {step}: ranks {len(got)} collectives "
                  f"{sum(e[1] for e in got)} result bytes, meta {len(want)} "
                  f"/ {sum(e[1] for e in want)}: the same kind for kind and "
                  f"byte for byte: {same}", flush=True)
    # (c) the production mesh's dry run
    for mesh, proc in dry.items():
        stdout, stderr = proc.communicate(timeout=LAYOUT_TIMEOUT_S)
        rec_ok = proc.returncode == 0
        ok = ok and rec_ok
        if not rec_ok:
            print(f"layout (c) {mesh}: FAIL\n{stderr[-2000:]}", flush=True)
            continue
        path = ROOT / "reports" / "dryrun_torch" / \
            f"mixtral-8x7b__decode_32k__{mesh}.json"
        rec = json.loads(path.read_text())
        r = rec["roofline"]
        by_axis = {a: round(b / 1e9, 4) for a, b in
                   rec["collectives"]["by_axis"].items()}
        print(f"layout (c) {mesh} (predictions at the data sheet's rates, "
              f"{rec['links']['model']['link']} "
              f"{rec['links']['model']['bytes_s'] / 1e9:.0f} GB/s and "
              f"{rec['links']['data']['link']} "
              f"{rec['links']['data']['bytes_s'] / 1e9:.0f} GB/s a card, "
              f"{r['peaks']['flops'] / 1e12:.0f} TFLOP/s, "
              f"{r['peaks']['hbm_bytes_s'] / 1e12:.2f} TB/s; run on {card}): "
              f"{r['n_chips']} cards, wmode {rec['weight_mode']}, per-card "
              f"peak {rec['peak_live_bytes'] / 1e9:.2f} GB, collective GB by "
              f"axis {by_axis}, compute {r['compute_s'] * 1e3:.3f} ms, "
              f"memory {r['memory_s'] * 1e3:.3f} ms, collective "
              f"{r['collective_s'] * 1e3:.3f} ms, dominant {r['dominant']}",
              flush=True)
    # (d) the archs whose laid-out layers came last, on the same ranks
    arch_counts = {k: sum(r["archs"]["launches"][k] for r in ranks)
                   for k in r0["archs"]["launches"]}
    for tag, arch, n_layers, n_enc, B, S, T in LAYOUT_ARCHS:
        good, lines = layout_arch_verdict(torch, tag, ranks)
        ok = ok and good
        what = (f"{n_layers} layers" + (f" and {n_enc} encoder layers (a "
                                        "depth cut for the time limit)"
                                        if n_enc else "")
                + f", B={B} S={S}" + (f", a {T}-position bf16 cross source, "
                                      "gates 0.5" if T else ""))
        for line in lines:
            print(f"layout (d) {arch} ({what}): {line}", flush=True)
    print(f"layout (d): launches summed over the ranks "
          f"{json.dumps(arch_counts)}; {max(r['archs_s'] for r in ranks):.1f}"
          " s", flush=True)
    print(f"layout: launches summed over the ranks {json.dumps(counts)} "
          f"((a) and (d) {t_a:.1f} s with the spawn)", flush=True)
    print(f"layout: phase {time.perf_counter() - t0:.1f} s on {card} | "
          f"{'pass' if ok else 'FAIL'}", flush=True)
    return ok, counts, arch_counts


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
    wave = wave_prompts(get_config("mixtral-8x7b"))
    t0 = time.perf_counter()
    rows = kernel_phase(torch, get_config("mixtral-8x7b"), wave[1])
    kernels_ok = all(r["ok"] for r in rows)
    print(f"kernels: phase {time.perf_counter() - t0:.1f} s", flush=True)

    # -- phase 4: the port on the card against the port on the CPU ----------
    t0 = time.perf_counter()
    reference_ok = reference_phase(torch)
    print(f"reference: phase {time.perf_counter() - t0:.1f} s", flush=True)

    # -- phase 5: serve -----------------------------------------------------
    t0 = time.perf_counter()
    serve_ok, counts, ctx = serve_phase(torch, kernels, name)
    print(f"serve: phase {time.perf_counter() - t0:.1f} s", flush=True)
    print(f"serve: kernel launches {json.dumps(counts)}", flush=True)
    launched_ok = all(counts[k] > 0 for k in (
        "gating", "expert_ffn_ragged", "expert_ffn_grouped",
        "flash_attention"))

    # -- phase 15 (a)-(d): the serving-path audit on phase 5's model ---------
    # (run here, while phase 5's model is on the card; phase 6 takes it)
    t0 = time.perf_counter()
    audit_ok, audit_counts = audit_phase(torch, kernels, card, ctx)
    print(f"audit: phase {time.perf_counter() - t0:.1f} s", flush=True)

    # -- phase 6: physical offload -------------------------------------------
    cfg8, res_vecs, batch2 = ctx["cfg"], ctx["res_vecs"], ctx["batch2"]
    offload_ok, off_counts = offload_phase(torch, kernels, name, ctx)
    print(f"offload: kernel launches {json.dumps(off_counts)}", flush=True)
    launched_ok = launched_ok and all(off_counts[k] > 0 for k in (
        "gating", "expert_ffn_grouped", "flash_attention"))

    # -- phase 7: the wave server --------------------------------------------
    wave_ok, wave_counts, hold = wave_phase(torch, kernels, name, cfg8,
                                            res_vecs, wave)
    print(f"wave: kernel launches {json.dumps(wave_counts)}", flush=True)
    launched_ok = launched_ok and all(wave_counts[k] > 0 for k in (
        "gating", "expert_ffn_ragged", "flash_attention"))

    # -- phase 8: the baseline policies --------------------------------------
    policies_ok, pol_counts = policy_phase(torch, kernels, name, hold,
                                           batch2, res_vecs)
    print(f"policies: kernel launches {json.dumps(pol_counts)}", flush=True)
    launched_ok = launched_ok and all(pol_counts[k] > 0 for k in (
        "gating", "expert_ffn_grouped", "flash_attention"))
    del hold

    # -- phase 9: training ---------------------------------------------------
    # every phase-9 reading carries the card's name and power limit
    train_ok, train_counts = train_phase(torch, kernels, card)
    # -- phase 15 (e): cfg.remat at phase 9's shapes -------------------------
    remat_ok, remat_counts = remat_phase(torch, kernels, card)

    # -- phase 10: Qwen3-30B-A3B and DeepSeek-V2-Lite -------------------------
    models_ok, model_counts = models_phase(torch, kernels, card)

    # -- phase 11: fault-tolerant offload streaming --------------------------
    faults_ok, fault_counts = faults_phase(torch, kernels, card, batch2,
                                           res_vecs)
    print(f"faults: kernel launches in the little window "
          f"{json.dumps(fault_counts)}", flush=True)
    launched_ok = launched_ok and fault_counts["expert_ffn_grouped"] > 0

    # -- phase 12: prompts past MOE_CHUNK_TOKENS -----------------------------
    long_ok, long_counts = long_phase(torch, kernels, card, res_vecs)

    # -- phase 13: the examples ----------------------------------------------
    examples_ok, example_counts = examples_phase(torch, kernels, card)
    print(f"examples: kernel launches {json.dumps(example_counts)}",
          flush=True)

    # -- phase 14: the remaining architectures -------------------------------
    archs_ok, arch_counts = archs_phase(torch, kernels, card)

    # -- phase 16: expert parallelism, once this process has let go of the
    # card's memory ---------------------------------------------------------
    free(torch)
    ep_ok, ep_counts, ep_trial_counts = ep_phase(torch, kernels, card)

    # -- phase 17: the GSPMD layout on DTensor ------------------------------
    free(torch)
    layout_ok, layout_counts, layout_arch_counts = layout_phase(
        torch, kernels, card)

    out = []
    for r in rows:
        # a row at the offload path's, the wave's, training's, a phase-10
        # model's or the long prompts' shapes counts that path's launches
        tag = r["shape"].split(" ")[0]
        path = (off_counts if r["shape"].startswith(("pool", "decode miss"))
                else wave_counts if tag == "wave"
                else long_counts if tag == "long"
                else ep_counts if tag == "ep"
                else train_counts if tag == "train"
                else model_counts[tag] if tag in model_counts
                else arch_counts[tag] if tag in arch_counts
                else counts)
        out.append({"name": f"{r['name']} [{r['shape']}]", "route": "cuda",
                    "source": SOURCE[r["name"]],
                    "replaces": REPLACES[r["name"]],
                    "launches": path[r["name"]],
                    "launches_serve": counts[r["name"]],
                    "launches_offload": off_counts[r["name"]],
                    "launches_wave": wave_counts[r["name"]],
                    "launches_policies": pol_counts[r["name"]],
                    "launches_train": train_counts[r["name"]],
                    **{f"launches_{t}": c[r["name"]]
                       for t, c in model_counts.items()},
                    "launches_faults_little": fault_counts[r["name"]],
                    "launches_long": long_counts[r["name"]],
                    "launches_examples": example_counts[r["name"]],
                    "launches_audit": audit_counts[r["name"]],
                    "launches_remat": remat_counts[r["name"]],
                    **{f"launches_{t}": c[r["name"]]
                       for t, c in arch_counts.items()},
                    "launches_ep": ep_counts[r["name"]],
                    "launches_ep_trials": ep_trial_counts[r["name"]],
                    "launches_layout": layout_counts[r["name"]],
                    "launches_layout_archs": layout_arch_counts[r["name"]],
                    "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                    "device_ms": r["device_ms"],
                    "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                    "bound_by": r["bound_by"],
                    "library_ms": r["library_ms"],
                    "library_device_ms": r["library_device_ms"],
                    **{k: r[k] for k in ("floor_device_ms", "floor_ms",
                                         "floor_bound_ms",
                                         "unpadded_bound_ms", "row_rel_err")
                       if k in r}})
    print(card, flush=True)
    print(json.dumps({"kernels": out}), flush=True)
    failed = [p for p, ok in (("kernels", kernels_ok),
                              ("reference", reference_ok),
                              ("serve", serve_ok),
                              ("offload", offload_ok),
                              ("wave", wave_ok),
                              ("policies", policies_ok),
                              ("train", train_ok),
                              ("models", models_ok),
                              ("faults", faults_ok),
                              ("long", long_ok),
                              ("examples", examples_ok),
                              ("archs", archs_ok),
                              ("audit", audit_ok),
                              ("remat", remat_ok),
                              ("ep", ep_ok),
                              ("layout", layout_ok),
                              ("launches", launched_ok)) if not ok]
    if failed:
        fail("phases failed: " + ", ".join(failed))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": count}}), flush=True)


if __name__ == "__main__":
    main()
