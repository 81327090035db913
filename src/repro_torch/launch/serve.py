"""Serving launcher of the port: the continuous-batching server (or the
wave server, ``--server wave``) with a registered offload policy
(``--policy dali|static|all_gpu|lru|score|statistical|random|none``).

  PYTHONPATH=src python -m repro_torch.launch.serve --arch mixtral-8x7b \\
      --requests 16 --max-new 32 --server continuous --policy dali

``--arch`` is any of the twelve architectures of ``repro_torch.configs``:
the paper's three evaluation models, mixtral-8x7b, qwen3-30b-a3b (qk-norm,
128 experts top-8) and deepseek-v2-lite-16b (MLA, a dense first layer, 2
shared experts beside 64 routed top-6); the MoE llama4-maverick-400b-a17b
(128 experts top-1, sigmoid router, a shared expert) and
jamba-1.5-large-398b (Mamba layers with attention on 1 in 8, 16 experts
top-2 on every other layer); the dense llama3-405b, qwen3-32b, olmo-1b
(non-parametric LayerNorm) and gemma2-9b (local / global windows,
softcaps, sandwich norms); mamba2-780m (SSD); and llama-3.2-vision-11b and
seamless-m4t-large-v2 (cross-attention; served, as by the JAX launcher,
with empty cross caches).  SSM and hybrid archs need ``--server wave``:
the continuous server refuses them, as the reference's does.  A dense or
SSM arch serves without the policy (``default_dali_config`` is None).

As the JAX launcher does, it first trains the model ``--train-steps``
AdamW steps on the ``MarkovCorpus`` (batch 8 x 64 tokens,
``launch/train.py``) so that routing has real structure, from random
weights made from ``--seed`` or from weights carried from the JAX package
(``--weights``, an ``.npz`` written by ``repro_torch.bridge.save_npz``).
It then calibrates the residual vectors (paper Eq. 11) from a short
decode trace of the trained model, serves ``--requests`` prompts drawn
from the corpus and prints the server's metrics, the DALI telemetry and
latency percentiles.  ``--scale smoke`` (default) serves the JAX
launcher's model, the smoke variant at ``--layers`` layers, trained 120
steps by default; ``--scale full`` serves the published widths at
``--layers`` layers, untrained by default (with a non-zero
``--train-steps`` it first checks that the gradients and the AdamW
moments fit on the card beside the params it built).  It runs on
``cuda`` unless ``--device cpu`` is given; the CUDA kernels take
bfloat16, so ``--dtype`` defaults to it.

``--offload`` picks how the policy's decisions reach the card: "modeled"
(every expert resident, decisions feed telemetry only) or "blocking",
"overlap", "pipelined" (pinned host store + device slot pool, see
serving/expert_store.py; the expert stacks then live in host memory, and
the calibration trace runs through the store's slot path, so the
residual vectors equal the full-resident ones bit for bit).
``--faults SPEC`` injects link and store faults into the physical
offload path (serving/faults.py; e.g. ``link_degrade:x12@8-26`` or a bare
preset name such as ``transient_stall``) and arms the link watchdog and the
degradation ladder.  ``--check-exact`` re-serves the same requests and
exits non-zero unless every request's tokens are identical: with
``--faults`` against the same mode without faults (recovery is exact),
otherwise against the full-resident ("modeled") serve:

  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \
      --dtype float32 --server wave --policy lru --offload pipelined \
      --check-exact
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \
      --dtype float32 --offload overlap --faults corrupt_rows,read_error \
      --check-exact
"""
from __future__ import annotations

import argparse

import numpy as np
import torch


def main(argv=None):
    from repro_torch.bridge import load_npz
    from repro_torch.configs import get_config, make_smoke
    from repro_torch.core.residual import calibrate_residuals
    from repro_torch.core.tracing import capture_decode_trace
    from repro_torch.data.pipeline import MarkovCorpus
    from repro_torch.device import resolve_device
    from repro_torch.launch.train import train_loop, training_bytes
    from repro_torch.models.model import experts_to_host, init_model
    from repro_torch.serving.scheduler import SERVER_PRESETS, Request
    from repro_torch.serving.spec import OffloadSpec, ServeSpec
    from repro_torch.serving.steps import default_dali_config

    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="mixtral-8x7b")
    ap.add_argument("--scale", default="smoke", choices=["smoke", "full"])
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--dtype", default="bfloat16",
                    choices=["bfloat16", "float32"])
    ap.add_argument("--server", default="continuous",
                    choices=sorted(SERVER_PRESETS))
    # no choices=: the policy registry (core/policy.py) is the one place
    # names are checked, and its error lists them
    ap.add_argument("--policy", default="dali",
                    help="offload policy: dali|static|all_gpu|lru|score|"
                         "statistical|random|none")
    ap.add_argument("--offload", default="modeled",
                    choices=["modeled", "blocking", "overlap", "pipelined"])
    ap.add_argument("--weights", default=None,
                    help=".npz of parameters carried from the JAX package "
                         "(repro_torch.bridge.save_npz)")
    ap.add_argument("--train-steps", type=int, default=None,
                    help="AdamW steps before serving (default: 120 at "
                         "--scale smoke, as the JAX launcher, 0 at --scale "
                         "full)")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--max-new", type=int, default=32)
    ap.add_argument("--cache-ratio", type=float, default=0.5)
    ap.add_argument("--no-dali", action="store_true")
    ap.add_argument("--faults", default=None,
                    help="fault schedule for the offload path: comma-"
                         "separated kind[:xFACTOR][@START[-STOP]] specs, kind "
                         "in link_degrade|transient_stall|read_error|"
                         "corrupt_rows (a bare kind takes its preset), e.g. "
                         "'link_degrade:x12@8-26,read_error@30'; needs a "
                         "physical --offload")
    ap.add_argument("--topology", default=None,
                    help="per-link fabric spec "
                         "(core/cost_model.parse_topology): 'flat', "
                         "'island:K' (K-device NVLink-style islands), "
                         "plus comma-separated 'SRC>DST:xF' slow-link or "
                         "'SRC>DST:gGBPS[:lLAT]' absolute overrides, "
                         "e.g. 'island:4,0>3:x8'; attaches per-link "
                         "constants to the offload cost model")
    ap.add_argument("--check-exact", action="store_true",
                    help="re-serve without faults (with --faults) or "
                         "full-resident (modeled) and exit non-zero unless "
                         "every request's tokens are identical")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.scale == "smoke":
        cfg = make_smoke(cfg)
    cfg = cfg.replace(n_layers=args.layers, dtype=args.dtype,
                      param_dtype=args.dtype)
    train_steps = args.train_steps
    if train_steps is None:
        train_steps = 120 if args.scale == "smoke" else 0
    if args.check_exact and args.offload == "modeled":
        raise SystemExit("--check-exact needs a physical --offload (it "
                         "compares the run against a fault-free or a "
                         "full-resident one)")
    if args.faults and args.offload == "modeled":
        raise SystemExit("--faults needs a physical --offload "
                         "(blocking | overlap | pipelined)")
    # the reference run of --check-exact: the same mode without faults
    # (recovery is exact), or full-resident
    ref_offload = args.offload if args.faults else "modeled"
    dev = resolve_device(args.device)
    corpus = MarkovCorpus(vocab=cfg.vocab, seed=args.seed)
    # a physical store reads the experts from the host: draw them there,
    # unless training or a full-resident run needs them on the device
    host_experts = args.offload != "modeled" and not (
        args.check_exact and ref_offload == "modeled")
    experts = "host" if host_experts and not train_steps else "device"
    if args.weights:
        params = load_npz(args.weights, device=dev, experts=experts,
                          cfg=cfg)
        print(f"== serving {cfg.name} with weights from {args.weights}")
    else:
        params = init_model(cfg, seed=args.seed, device=dev,
                            experts=experts)
        print(f"== serving {cfg.name} ({cfg.n_layers} layers, "
              f"d_model {cfg.d_model}) with random weights, seed "
              f"{args.seed}")
    if train_steps and dev.type == "cuda":
        need, free = training_bytes(params), torch.cuda.mem_get_info(dev)[0]
        if need > free:
            raise SystemExit(
                f"training {cfg.name} at {cfg.n_layers} layers needs "
                f"{need / 1e9:.1f} GB for gradients and AdamW moments "
                f"beside its params; the card has {free / 1e9:.1f} GB free "
                "(pass --train-steps 0 or fewer --layers)")
    if train_steps:
        print(f"== training {cfg.name} for {train_steps} steps (so routing "
              "has real structure)")
        params, _, hist = train_loop(cfg, train_steps, 8, 64, corpus=corpus,
                                     seed=args.seed, device=dev,
                                     params=params)
        print(f"   ce {hist[0]:.2f} -> {hist[-1]:.2f}")
        if host_experts:
            params = experts_to_host(params, cfg, dev)

    policy = "none" if args.no_dali else args.policy
    dali_cfg = None
    if cfg.moe is not None and policy != "none":
        dali_cfg = default_dali_config(cfg, cache_ratio=args.cache_ratio)

    def resolve(offload, faults=None):
        return ServeSpec(cfg=cfg, server=args.server, policy=policy,
                         dali_cfg=dali_cfg, batch_size=args.batch,
                         max_len=args.prompt_len + args.max_new + 2,
                         offload=OffloadSpec(mode=offload, faults=faults,
                                             topology=args.topology),
                         device=dev).resolve(params)

    rs = resolve(args.offload, args.faults)
    res_vecs = None
    if dali_cfg is not None:
        print("== calibrating residual vectors (paper Eq. 11)"
              + (" through the slot pool" if rs.store is not None else ""))
        rng = np.random.default_rng(args.seed + 1)
        calib = np.stack([corpus.sample(rng, args.prompt_len)
                          for _ in range(8)])
        off = (rs.init_state()["offload"] if rs.store is not None
               else None)
        tr = capture_decode_trace(rs.params, cfg, calib, n_decode=16,
                                  device=dev, store=rs.store, off=off)
        res_vecs = np.stack(calibrate_residuals([tr]))
        if rs.store is not None:
            del off
            rs.store.reset_stats()

    def serve_once(rs):
        server = rs.server(res_vecs=res_vecs)
        rng = np.random.default_rng(args.seed + 2)
        for i in range(args.requests):
            server.submit(Request(rid=i,
                                  prompt=corpus.sample(rng, args.prompt_len),
                                  max_new_tokens=args.max_new))
        return server, server.run()

    server, done = serve_once(rs)
    lat = [r.latency for r in done]
    ttft = [r.ttft for r in done if r.first_token_at]
    print(f"== served {len(done)} requests via {args.server} "
          f"(policy={policy}, offload={args.offload}"
          + (f", faults={args.faults}" if args.faults else "")
          + f", device={server.device}) | {server.metrics.summary()}")
    if server.store is not None:
        st = server.store.stats()
        print(f"   physical offload: streamed {st['h2d_rows']} experts "
              f"({st['h2d_bytes'] / 1e6:.1f} MB) | miss fallback "
              f"{st['fallback_rows']} (token,k) rows | prefill waves "
              f"{st['prefill_waves']} | miss reads "
              f"{st['miss_reads'] / max(server.metrics.steps, 1):.1f} per "
              "decode step")
        if args.faults:
            h = server.store.health()
            trans = ", ".join(f"step {t}: {a}->{b}"
                              for t, a, b in h["transitions"])
            print(f"   resilience: state={h['ladder_state']} "
                  f"retries={st['retries']} stalls={st['stalls']} "
                  f"read_errors={st['read_errors']} "
                  f"stage_aborts={st['stage_aborts']} "
                  f"corrupt_caught={st['corrupt_caught']} "
                  f"restaged={st['restaged_rows']} "
                  f"little_steps={st['little_steps']} "
                  f"probes={st['probes']}"
                  + (f" | transitions: {trans}" if trans else ""))
            for name, lr in sorted(server.metrics.links.items()):
                print(f"   link {name}: misses={lr['deadline_misses']} "
                      f"refits={lr['refits']} "
                      f"refit_rej={lr['refit_rejections']} "
                      f"degrade_events={lr['degrade_events']} "
                      f"gbps={lr['gbps']:.3g}")
    print(f"   latency p50={np.percentile(lat, 50):.2f}s "
          f"p95={np.percentile(lat, 95):.2f}s"
          + (f" | ttft p50={np.percentile(ttft, 50):.2f}s" if ttft else ""))

    if args.check_exact:
        ref_name = ("fault-free" if args.faults
                    else "full-resident (modeled)")
        print(f"== --check-exact: re-serving the same requests against the "
              f"{ref_name} run")
        _, ref = serve_once(resolve(ref_offload))
        by_rid = {r.rid: r.output for r in ref}
        bad = [r.rid for r in done if r.output != by_rid.get(r.rid)]
        if bad:
            print(f"   MISMATCH: requests {bad} diverged from the "
                  f"{ref_name} run")
            raise SystemExit(1)
        print(f"   exact-output parity verified: all {len(done)} requests "
              f"identical to the {ref_name} run")
    return server, done


if __name__ == "__main__":
    main()
