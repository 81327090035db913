"""Faulted expert-parallel serve: degraded-link detection + expert
re-route over ``world`` ranks (port of ``repro/launch/ep_serve.py``,
DESIGN.md §13).

Serves a cycle of zipf-routed requests through the EP MoE layer
(models/moe_ep.py) on a (1, world) mesh three times over the SAME inputs:

  healthy        — no faults, canonical expert layout
  fault_static   — an injected per-link slowdown
                   (``link_degrade[0>3]:x8@6-18``), placement frozen:
                   the no-re-route baseline that keeps paying the bad
                   link every step
  fault_reroute  — same fault, the :class:`EPResilience` controller
                   armed: per-link watchdogs detect the slow pair, the
                   placement re-solves against the refit topology, and
                   the victim ranks' hot experts move to well-connected
                   ones

and then checks the re-route contract (exit non-zero on any failure):
every request's outputs are bit-identical across all three trials (a
re-route only moves WHERE experts compute), the re-route actually
engaged, and the re-routed trial beats the frozen baseline on ms/step
inside the fault window because the demand bytes crossing the degraded
pair collapsed.

The ranks are processes (``launch/mesh.py::run_ranks``, gloo): on the
card all of them share it (``--device cuda``, the default; the experts
run through K4 and the router through K1, in bfloat16, which the kernels
take), or they run on the CPU (``--device cpu``, the reference's
float32).
Their exchange has no real interconnect to price, so per-pair transfer
time is charged analytically from the modeled fabric constants below and
injected slowdowns pay their *extra* time as a real sleep on rank 0 (the
others wait for it in the placement broadcast) — wall-clock ms/step
honestly reflects the fault and the saving.

  PYTHONPATH=src python -m repro_torch.launch.ep_serve \\
      --faults 'link_degrade[0>3]:x8@6-18' --steps 26 [--device cpu]
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.core.cost_model import LOCAL_PC, LinkTopology, parse_topology
from repro_torch.device import torch_dtype
from repro_torch.models.config import ModelConfig, MoEConfig
from repro_torch.serving.faults import parse_faults

E, K, D_MODEL, D_EXPERT = 64, 2, 128, 256
DEFAULT_FAULTS = "link_degrade[0>3]:x8@6-18"
DEFAULT_WORLD = 8
TIMEOUT_S = 600.0            # the ranks' collectives and their whole run
# Modeled fabric for the wall-clock charging: slow enough that one
# degraded pair's extra time dominates the toy step's compute jitter
# (~tens of KB/step on the hot pair -> tens of ms at x8).
BENCH_GBPS = 0.002
BENCH_LAT_S = 2e-4
BENCH_PROFILE = dataclasses.replace(LOCAL_PC, name="ep-bench-fabric",
                                    link_gbps=BENCH_GBPS,
                                    link_latency_s=BENCH_LAT_S)


def build_model(dtype: str = "float32", seed: int = 0, device="cpu"):
    """The EP bench toy (E=64 top-2, d=128, f=256) drawn from ``seed`` on
    ``device`` by the port's ``init_moe``, with a deterministic 6*eye
    router so routing follows the input's argmax."""
    from repro_torch.models.moe import init_moe
    cfg = ModelConfig(d_model=D_MODEL, d_ff=D_EXPERT, vocab=64,
                      dtype=dtype, param_dtype=dtype,
                      moe=MoEConfig(n_routed=E, top_k=K,
                                    d_expert=D_EXPERT,
                                    capacity_factor=0.0))
    dev = torch.device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    params = init_moe(gen, cfg, dev)
    params["router"] = 6.0 * torch.eye(D_MODEL, E, dtype=torch.float32,
                                       device=dev)
    return cfg, params


def zipf_request(B: int, S: int, dtype, seed: int):
    """One request batch (CPU) whose top-1 expert follows zipf(1.2) — the
    paper-style skew where moving hot experts off a bad link pays."""
    rng = np.random.default_rng(seed)
    T = B * S
    x = 0.05 * rng.standard_normal((T, D_MODEL))
    p = 1.0 / np.arange(1, E + 1) ** 1.2
    tgt = rng.choice(E, size=T, p=p / p.sum())
    x[np.arange(T), tgt] += 3.0
    return torch.from_numpy(x.reshape(B, S, D_MODEL)).to(torch_dtype(dtype))


def _trials_rank(rank, world, steps, faults, topology, B, S, n_requests,
                 seed, dtype, device, verbose):
    """One rank of ``run_resilience_trials``: the three trials in lockstep
    with the other ranks.  Rank 0 steps the controller, times the steps
    and returns the record; every rank returns its K1/K4 launches and
    peak device memory."""
    from repro_torch import kernels
    from repro_torch.launch import sharding as shd
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.moe_ep import (apply_moe_ep, ep_applicable,
                                           permute_expert_params)
    from repro_torch.serving.ep_resilience import EPResilience, step_ranks
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    cfg, params = build_model(dtype, seed, dev)
    host = {k: v.cpu() for k, v in params.items()}  # the re-route's source
    del params
    mesh = make_mesh(1, world)
    tp = world
    e_loc = E // tp
    topo = (topology if isinstance(topology, LinkTopology)
            else parse_topology(topology, tp, BENCH_PROFILE))
    link_specs = [s for s in parse_faults(faults)
                  if s.kind == "link_degrade"]
    fault_pairs = [p for p in topo.pairs()
                   if any(s.matches_link(p) for s in link_specs)]
    itemsize = torch_dtype(cfg.dtype).itemsize
    xs = [zipf_request(B, S, cfg.dtype, seed + 10 + r).to(dev)
          for r in range(n_requests)]

    def local(placement):
        """This rank's slots of the physical-order stacks, on the device."""
        phys = permute_expert_params(host, placement)
        out = {k: phys[k][rank * e_loc:(rank + 1) * e_loc].to(dev)
               for k in ("gate", "up", "down")}
        out["router"] = host["router"].to(dev)
        return out

    def sync():
        if cuda:
            torch.cuda.synchronize(dev)

    # the reference's logical map (ep_serve.py:125-127); the trials call
    # the EP layer on plain tensors, which reads only the mesh and wmode
    with shd.rules(mesh, shd.logical_map_for(cfg, "prefill_32k", mesh),
                   "tp"):
        if not ep_applicable(cfg, B, S):
            raise ValueError(f"EP path not applicable at B={B}, S={S}")

        def step_fn(p, x, perm):
            return apply_moe_ep(p, x, cfg, placement=perm, demand_view=True)

        ident = np.arange(E, dtype=np.int32)
        step_fn(local(ident), xs[0], ident)        # warm-up
        sync()
        if cuda:
            torch.cuda.reset_peak_memory_stats(dev)
        kernels.reset_launch_counts()

        def run_trial(name: str, trial_faults: Optional[str],
                      reroute: bool) -> Dict:
            ctrl = EPResilience(topo, n_experts=E, d_model=D_MODEL,
                                itemsize=itemsize, faults=trial_faults,
                                seed=seed, reroute=reroute)
            placement = ctrl.placement.copy()
            phys = local(placement)
            outs, ms, fault_ms, fault_bytes = [], [], [], []
            for t in range(steps):
                x = xs[t % n_requests]
                t0 = time.perf_counter()
                y, info = step_fn(phys, x, placement)
                sync()
                new, rep = step_ranks(ctrl, info["ep_counts"].cpu().numpy())
                dt_ms = (time.perf_counter() - t0) * 1e3
                if not np.array_equal(new, placement):
                    placement = new
                    phys = local(placement)
                    if verbose and rank == 0:
                        print(f"   [{name}] step {t}: re-route -> "
                              f"placement {placement[:8].tolist()}...",
                              flush=True)
                if rank:
                    continue
                ms.append(dt_ms)
                if trial_faults is not None and any(
                        s.active(t) for s in link_specs):
                    fault_ms.append(dt_ms)
                    fault_bytes.append(sum(
                        int(rep["pair_bytes"][i, j])
                        for i, j in fault_pairs))
                outs.append(y.cpu())
            if rank:
                return None
            return {
                "name": name,
                "ms_per_step": float(np.mean(ms)),
                "fault_ms_per_step": (float(np.mean(fault_ms))
                                      if fault_ms else None),
                "fault_pair_bytes_per_step": (float(np.mean(fault_bytes))
                                              if fault_bytes else None),
                "reroutes": ctrl.reroutes,
                "slept_s": ctrl.slept_s,
                "events": [list(e) for e in ctrl.events],
                "links": ctrl.link_report(),
                "_outputs": outs,
            }

        trials = [run_trial("healthy", None, False),
                  run_trial("fault_static", faults, False),
                  run_trial("fault_reroute", faults, True)]
    worker = {"launches": kernels.launch_counts(),
              "peak_bytes": (torch.cuda.max_memory_allocated(dev)
                             if cuda else None)}
    if rank:
        return {"worker": worker}
    return {"worker": worker, "trials": trials, "tp": tp,
            "topology": topo.name,
            "fault_pairs": [f"{i}>{j}" for i, j in fault_pairs]}


def run_resilience_trials(*, steps: int = 26, faults: str = DEFAULT_FAULTS,
                          topology=None, B: int = 4, S: int = 160,
                          n_requests: int = 4, seed: int = 0,
                          world: int = DEFAULT_WORLD, device="cuda",
                          verbose: bool = False) -> Dict:
    """Healthy / fault-static / fault-reroute trials over one request
    cycle on ``world`` gloo ranks on ``device`` (bfloat16 on the card,
    which the kernels take; the reference's float32 on the CPU); returns
    the JSON-ready record with per-trial timings, the per-pair byte
    accounting and the verdicts (plus each rank's kernel launches and peak
    device memory under ``workers``)."""
    from repro_torch.launch.mesh import run_ranks
    specs = parse_faults(faults)
    if not any(s.kind == "link_degrade" for s in specs):
        raise SystemExit(f"--faults {faults!r} has no link_degrade spec: "
                         "the resilience trial needs a slow link to "
                         "detect and route around")
    dtype = "bfloat16" if torch.device(device).type == "cuda" else "float32"
    got = run_ranks(_trials_rank, world, backend="gloo", device=device,
                    timeout_s=TIMEOUT_S,
                    args=(steps, faults, topology, B, S, n_requests, seed,
                          dtype, str(device), verbose))
    head = got[0]
    trials = head["trials"]
    ref = trials[0]["_outputs"]

    def bit_equal(tr) -> Dict[int, bool]:
        eq = {}
        for t, y in enumerate(tr["_outputs"]):
            rid = t % n_requests
            eq[rid] = eq.get(rid, True) and bool(torch.equal(y, ref[t]))
        return eq

    eq_static = bit_equal(trials[1])
    eq_reroute = bit_equal(trials[2])
    rr = trials[2]
    st = trials[1]
    verdicts = {
        "static_bit_exact": all(eq_static.values()),
        "reroute_bit_exact": all(eq_reroute.values()),
        "reroute_engaged": rr["reroutes"] >= 1 and any(
            e[3] == "degraded" for e in rr["events"]),
        "reroute_faster": (rr["fault_ms_per_step"] is not None
                           and st["fault_ms_per_step"] is not None
                           and rr["fault_ms_per_step"]
                           < st["fault_ms_per_step"]),
        "degraded_bytes_drop": (
            rr["fault_pair_bytes_per_step"] is not None
            and st["fault_pair_bytes_per_step"] is not None
            and rr["fault_pair_bytes_per_step"]
            < st["fault_pair_bytes_per_step"]),
    }
    for tr in trials:
        tr.pop("_outputs")
    return {
        "steps": steps, "B": B, "S": S, "n_requests": n_requests,
        "faults": str(faults), "fault_pairs": head["fault_pairs"],
        "topology": head["topology"], "tp": head["tp"], "E": E,
        "device": str(device), "dtype": dtype,
        "bench_gbps": BENCH_GBPS, "bench_latency_s": BENCH_LAT_S,
        "per_request_bit_exact": {
            "fault_static": eq_static, "fault_reroute": eq_reroute},
        "trials": trials,
        "verdicts": verdicts,
        "ok": all(verdicts.values()),
        "workers": [g["worker"] for g in got],
    }


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="faulted EP serve: degraded-link re-route trial")
    ap.add_argument("--steps", type=int, default=26)
    ap.add_argument("--faults", default=DEFAULT_FAULTS,
                    help="fault schedule (serving/faults.py grammar); "
                         "must include a link_degrade, optionally "
                         "link-selected, e.g. 'link_degrade[0>3]:x8@6-18'")
    ap.add_argument("--topology", default=None,
                    help="fabric spec (core/cost_model.parse_topology): "
                         "'flat', 'island:K', plus 'SRC>DST:xF' "
                         "overrides; default = flat bench fabric")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seqlen", type=int, default=160)
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--world", type=int, default=DEFAULT_WORLD,
                    help="ranks on the (1, world) mesh")
    ap.add_argument("--device", default="cuda",
                    help="where every rank computes: cuda (the kernels, "
                         "bfloat16) or cpu (their plain versions, float32)")
    ap.add_argument("--json", default=None, help="write the record here")
    args = ap.parse_args(argv)

    res = run_resilience_trials(
        steps=args.steps, faults=args.faults, topology=args.topology,
        B=args.batch, S=args.seqlen, n_requests=args.requests,
        seed=args.seed, world=args.world, device=args.device,
        verbose=True)

    print(f"== EP resilience trial: {res['faults']} on "
          f"{res['topology']} fabric (tp={res['tp']}, {res['device']}, "
          f"{res['dtype']})")
    for tr in res["trials"]:
        fm = tr["fault_ms_per_step"]
        fb = tr["fault_pair_bytes_per_step"]
        print(f"   {tr['name']:>14}: {tr['ms_per_step']:7.2f} ms/step"
              + (f" | fault window {fm:7.2f} ms/step" if fm else "")
              + (f" | degraded-pair {fb / 1e3:8.1f} KB/step" if fb else "")
              + (f" | reroutes={tr['reroutes']}" if tr['reroutes'] else ""))
    rr = res["trials"][2]
    bad_links = [(n, l) for n, l in rr["links"].items()
                 if l["degrade_events"] or l["refit_rejections"]]
    for name, l in bad_links:
        print(f"   link {name}: state={l['state']} "
              f"misses={l['deadline_misses']} refits={l['refits']} "
              f"refit_rej={l['refit_rejections']} "
              f"degr={l['degrade_events']}")
    print("   verdicts: " + " ".join(
        f"{k}={'PASS' if v else 'FAIL'}"
        for k, v in res["verdicts"].items()))

    if args.json:
        os.makedirs(os.path.dirname(args.json) or ".", exist_ok=True)
        with open(args.json, "w") as f:
            json.dump(res, f, indent=2)
        print(f"wrote {args.json}")
    if not res["ok"]:
        raise SystemExit(1)
    print("   re-route contract verified: outputs bit-identical across "
          "all trials, re-route engaged and beat the frozen baseline")
    return res


if __name__ == "__main__":
    main()
