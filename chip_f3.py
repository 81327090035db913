#!/usr/bin/env python3
"""F3 by rounding point: which rounding sets the gradient leaves where one
bfloat16 training step on the card and the same step on the CPU part by
more than 3e-2 (ROADMAP.md, queue 3, F3).

  python3 chip_f3.py [--device cuda] [--archs jamba-1.5-large-398b,...]

For each arch (Jamba-1.5-Large and SeamlessM4T by default, the smoke model
of each over its whole period, bfloat16, cross gates opened, a float32
cross source for Seamless) and each seed (1 and 2), as
``chip_smoke.py::train_parity(bf16_floor=True)`` sets them up: one step's
gradients on the card (the kernels) and on the CPU (the plain versions),
both on the card's routing.  The leaves outside 3e-2 (relative to max |ref|)
are F3's.  Then each rounding point alone is aligned between the two
sides, and the step run again on the side that lacks it:

  k3_p       K3 rounds its unnormalised probabilities P to bfloat16 before
             P V (the Pallas kernel keeps them in float32): the CPU's plain
             K3 rounds P too;
  k2_h       K2 rounds the SwiGLU product h to bfloat16 before the down
             projection (as the Pallas kernel does): the CPU's plain K2
             rounds h too;
  cross_src  K3 takes a float32 cross source's operands in bfloat16 and
             returns bfloat16 (``models/attention.py::_k3``; the reference
             attends in float32): the CPU rounds them there too;
  ssd        the Mamba-2/SSD plain path's sums run in the card's order: the
             card's step runs ``ssd_chunked`` on the CPU instead.

Per point it prints, over the F3 leaves: how many the point alone moves
by 3e-2 or more (the aligned step against the unaligned one on its side),
and how many stay outside 3e-2 once the two sides agree on the point,
with the leaves that come inside and those that go out.  ``--device
cpu`` rehearses the script with the CPU standing in for the card.
"""
import argparse
import contextlib
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

ARCHS = ("jamba-1.5-large-398b", "seamless-m4t-large-v2")
SEEDS = (1, 2)
TOL = 3e-2
POINTS = ("k3_p", "k2_h", "cross_src", "ssd")


@contextlib.contextmanager
def patched(obj, name, value):
    real = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, real)


def k3_p_rounded(torch, fa_ops):
    """K3's plain version with P rounded to bfloat16 before P V and
    nothing else changed."""
    def fa(q, k, v, *, causal=True, window=0, softcap=0.0, scale=None):
        B, Sq, Hq, D = q.shape
        Sk, Hkv = k.shape[1], k.shape[2]
        scale = scale if scale is not None else D ** -0.5
        qg = q.reshape(B, Sq, Hkv, Hq // Hkv, D).float()
        s = torch.einsum("bqkgd,bskd->bkgqs", qg, k.float()) * scale
        if softcap:
            s = softcap * torch.tanh(s / softcap)
        valid = fa_ops.attn_mask(torch.arange(Sk - Sq, Sk, device=q.device),
                                 torch.arange(Sk, device=q.device),
                                 causal=causal, window=window)
        s = torch.where(valid[:, None, None], s, fa_ops.NEG_INF)
        p = torch.exp(s - s.amax(-1, keepdim=True))
        o = torch.einsum("bkgqs,bskd->bqkgd",
                         p.to(torch.bfloat16).float(), v.float())
        o = o / p.sum(-1).permute(0, 3, 1, 2)[..., None]
        return o.reshape(B, Sq, Hq, -1).to(q.dtype)
    return fa


def k2_h_rounded(torch, ffn_ops):
    """K2's plain version with h rounded to the activations' dtype."""
    def ffn(xe, w_gate, w_up, w_down, counts=None, expert_ids=None,
            act="silu"):
        G, C, d = xe.shape
        fn = ffn_ops.ACTS[act]
        valid = (torch.ones((G, C), dtype=torch.bool, device=xe.device)
                 if counts is None
                 else torch.arange(C, device=xe.device)[None, :]
                 < counts[:, None])
        x = torch.where(valid[..., None], xe, 0).float()
        eids = expert_ids.tolist() if expert_ids is not None else range(G)
        out = [((fn(x[g] @ w_gate[e].float()) * (x[g] @ w_up[e].float()))
                .to(xe.dtype).float() @ w_down[e].float())
               for g, e in enumerate(eids)]
        out = torch.stack(out) if out else x.new_zeros((0, C, d))
        return torch.where(valid[..., None], out, 0).to(xe.dtype)
    return ffn


def k3_boundary_rounded(torch, attention):
    """``_k3`` rounding a wider operand to ``cfg.dtype`` and the output
    back, as it does on the card, on any device."""
    from repro_torch.device import torch_dtype

    def k3(q, k, v, cfg, **kw):
        dt = torch_dtype(cfg.dtype)
        if any(t.dtype != dt for t in (q, k, v)):
            return attention.flash_attention(
                *(t.to(dt).contiguous() for t in (q, k, v)),
                **kw).to(q.dtype)
        return attention.flash_attention(q.contiguous(), k.contiguous(),
                                         v.contiguous(), **kw)
    return k3


def ssd_on_cpu(mamba):
    """``ssd_chunked`` computed on the CPU whatever its inputs' device."""
    real = mamba.ssd_chunked

    def ssd(xh, dt, A, Bm, Cm, cfg, init_state=None):
        dev = xh.device
        cpu = lambda t: None if t is None else t.cpu()     # noqa: E731
        y, st = real(cpu(xh), cpu(dt), cpu(A), cpu(Bm), cpu(Cm), cfg,
                     init_state=cpu(init_state))
        return y.to(dev), st.to(dev)
    return ssd


def measure(torch, arch, seed, card):
    import chip_smoke as cs
    import repro_torch.kernels.expert_ffn.ops as ffn_ops
    import repro_torch.kernels.flash_attention.ops as fa_ops
    import repro_torch.models.attention as attention
    import repro_torch.models.mamba as mamba
    import repro_torch.models.moe as moe
    from repro_torch.configs import get_config, make_smoke
    from repro_torch.data.pipeline import MarkovCorpus, batches
    from repro_torch.kernels.gating.ops import _gates, _probs
    from repro_torch.models.model import init_model
    from repro_torch.training.train_step import make_loss_fn, value_and_grad
    from repro_torch.tree import tree_leaves, tree_map, tree_map_with_path

    cfg = make_smoke(get_config(arch))
    cfg = cfg.replace(dtype="bfloat16", param_dtype="bfloat16")
    cpu = cs.open_gates(torch, init_model(cfg, seed=seed, device="cpu"))
    gpu = tree_map(lambda t: t.to(card), cpu)
    b = next(iter(batches(MarkovCorpus(vocab=cfg.vocab, seed=seed + 1), 2,
                          64, 1, seed=seed + 1)))
    bc = {k: torch.as_tensor(v) for k, v in b.items()}
    src = cs.cross_source(torch, cfg, 2, seed=seed + 1)
    if src is not None:
        bc["cross_src"] = src
    bg = {k: t.to(card) for k, t in bc.items()}
    loss_fn = make_loss_fn(cfg)
    real_gating, card_idx, calls = moe.gating, [], [0]

    def record(logits, *args):
        out = real_gating(logits, *args)
        card_idx.append(out[1].detach().cpu())
        return out

    def card_routing(logits, top_k, router_type, renormalize):
        idx = card_idx[calls[0] % len(card_idx)].to(logits.device)
        calls[0] += 1
        x = logits.float()
        probs = _probs(x, router_type)
        return _gates(x, probs, idx, router_type, renormalize), idx, probs

    def step(params, batch):
        return [t.float().cpu() for t in
                tree_leaves(value_and_grad(loss_fn, params, batch)[1])]

    t0 = time.perf_counter()
    try:
        moe.gating = record
        g_card = step(gpu, bg)
        moe.gating = card_routing
        g_cpu = step(cpu, bc)
        aligned = {}
        with patched(fa_ops, "flash_attention_plain",
                     k3_p_rounded(torch, fa_ops)):
            aligned["k3_p"] = ("cpu", step(cpu, bc))
        with patched(ffn_ops, "expert_ffn_plain",
                     k2_h_rounded(torch, ffn_ops)):
            aligned["k2_h"] = ("cpu", step(cpu, bc))
        with patched(attention, "_k3", k3_boundary_rounded(torch,
                                                           attention)):
            aligned["cross_src"] = ("cpu", step(cpu, bc))
        with patched(mamba, "ssd_chunked", ssd_on_cpu(mamba)):
            aligned["ssd"] = ("card", step(gpu, bg))
    finally:
        moe.gating = real_gating
    paths = []
    tree_map_with_path(lambda p, t: paths.append("/".join(map(str, p))),
                       cpu)
    base = [cs.rel_err(g, c) for g, c in zip(g_card, g_cpu)]
    f3 = [i for i, e in enumerate(base) if e >= TOL]
    rec = {"arch": arch, "seed": seed, "leaves": len(base),
           "outside": len(f3), "seconds": time.perf_counter() - t0,
           "points": {}}
    for name, (side, g_al) in aligned.items():
        # the point alone: the aligned step against the unaligned one on
        # the side it was applied to; then the two sides with it aligned
        own = g_cpu if side == "cpu" else g_card
        card_side = g_card if side == "cpu" else g_al
        cpu_side = g_al if side == "cpu" else g_cpu
        moved = [cs.rel_err(a, o) for a, o in zip(g_al, own)]
        after = [cs.rel_err(c, p) for c, p in zip(card_side, cpu_side)]
        rec["points"][name] = {
            "side": side,
            "moves_f3_leaves": sum(moved[i] >= TOL for i in f3),
            "moves_any_leaf": sum(m >= TOL for m in moved),
            "outside_after": sum(e >= TOL for e in after),
            "came_inside": [paths[i] for i in f3 if after[i] < TOL],
            "went_outside": [paths[i] for i in range(len(base))
                             if base[i] < TOL <= after[i]],
            "max_moved": max(moved),
        }
    rec["f3_leaves"] = {paths[i]: base[i] for i in f3}
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="the card (cuda); cpu rehearses the script")
    ap.add_argument("--archs", default=",".join(ARCHS))
    ap.add_argument("--seeds", default=",".join(map(str, SEEDS)))
    ap.add_argument("--json", default=None, help="write the records here")
    args = ap.parse_args(argv)
    import torch
    if args.device == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit("no CUDA card: pass --device cpu to rehearse")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        from repro_torch.kernels import build
        build.library()
        print(f"device: {torch.cuda.get_device_name(0)}", flush=True)
    recs = []
    for arch in args.archs.split(","):
        for seed in map(int, args.seeds.split(",")):
            rec = measure(torch, arch, seed, args.device)
            recs.append(rec)
            print(f"f3 {arch} seed {seed}: {rec['outside']} of "
                  f"{rec['leaves']} leaves outside {TOL} "
                  f"({rec['seconds']:.1f} s)", flush=True)
            for name, p in rec["points"].items():
                print(f"f3 {arch} seed {seed} {name} ({p['side']} side): "
                      f"moves {p['moves_f3_leaves']} of the "
                      f"{rec['outside']} by >= {TOL} (any leaf: "
                      f"{p['moves_any_leaf']}, max {p['max_moved']:.3e}); "
                      f"aligned: {p['outside_after']} outside, "
                      f"{len(p['came_inside'])} came inside, "
                      f"{len(p['went_outside'])} went outside", flush=True)
    total = sum(r["outside"] for r in recs)
    per = {n: sum(r["points"][n]["outside_after"] for r in recs)
           for n in POINTS}
    print(f"f3 total: {total} leaves outside {TOL}; aligned on one point: "
          + json.dumps(per), flush=True)
    if args.json:
        Path(args.json).parent.mkdir(parents=True, exist_ok=True)
        Path(args.json).write_text(json.dumps(recs, indent=1))


if __name__ == "__main__":
    main()
