"""The comparison that decides ``correct``.

What the window served is kept as it is produced (``capture.py``): every
token, and for a sample of the requests, drawn from the seed before the
window opens and always holding the longest, the logits each of their
tokens was taken from (the admission prefill's for the first, a decode
step's for the rest).  Once the window has closed and the program's state
is freed, the plain float32 reference (``reference/``) runs once over each
sampled prompt followed by its served tokens, so each token is judged at
the position it was served from.  A cell's file (``cells/<cell>.json`` ->
``check``) names the numbers it compares, each with its limit:

  ``logit_err.<stat>``  a statistic of the root mean square, over the
                        vocabulary, of each served token's kept logits
                        minus the reference's: ``median``, ``p90`` or
                        ``mean`` over the sample's tokens, or
                        ``worst_request``, the largest over the sampled
                        requests of the median over each request's tokens.
                        The median over all tokens cannot see a fault that
                        touches a minority of them (one slot's cache, only
                        the longest prompt); the worst request's median
                        can, and a scattered routing flip does not move it;
  ``not_argmax``        the sampled tokens that are not the first of the
                        logits kept for them (or have none kept): an exact
                        count, limit 0.

Together they say that each served token is the greedy choice of logits
that agree with the reference.  Why logits and not the gap of the served
token below the reference's best, which needs no logits: greedy bf16
serving of a top-k MoE flips a routing choice at a near-tie now and then,
and a flipped expert moves that position's logits by up to about 1.7 at
Mixtral's published widths, in the port and in a float32 reference whose
operands are rounded to bf16 alike; the float8 control's widest gap is no
wider, and its mean gap only about three times the program's.  The logit
error away from those few positions separates them (PERF.md has the
readings).  The mean gap is logged beside them.

With ``control`` the same numbers are read for the control, the reference
itself computed in float8 e4m3 (``reference.common.fp8_mm``): its logits
stand in for the kept ones at the same positions.
"""
from __future__ import annotations

import numpy as np

STATS = {"median": np.median, "p90": lambda v: np.percentile(v, 90),
         "mean": np.mean}


def sample(sizes, n: int, seed: int) -> list:
    """Indices of ``n`` of the requests whose sizes (prompt plus output
    tokens) are ``sizes``, drawn from ``seed``, the longest always among
    them."""
    if not sizes:
        return []
    longest = int(np.argmax(sizes))
    rest = [i for i in range(len(sizes)) if i != longest]
    rng = np.random.default_rng([seed, 3])
    pick = rng.choice(len(rest), size=min(n - 1, len(rest)), replace=False)
    return [longest] + sorted(rest[int(j)] for j in pick)


def _sequences(outputs, idx):
    """(token lists, rows whose logits give the served tokens) of the
    requests ``idx``."""
    seqs, rows = [], []
    for i in idx:
        prompt, out = outputs[i]["prompt"], outputs[i]["served"]
        seqs.append(list(prompt) + list(out[:-1]))
        rows.append(list(range(len(prompt) - 1, len(prompt) - 1 + len(out))))
    return seqs, rows


def gaps(logits, tokens) -> list:
    """best logit - logit of each token, per row of ``logits``."""
    import torch
    t = torch.as_tensor(tokens, dtype=torch.long, device=logits.device)
    best = logits.max(-1).values
    return (best - logits.gather(1, t[:, None])[:, 0]).tolist()


def _rms_rows(a, b) -> list:
    """Per-row root mean square of ``a - b`` (rows, vocab)."""
    n = b.shape[-1]
    return (a[..., :n].float().to(b.device) - b).pow(2).mean(-1).sqrt() \
        .tolist()


def stats(per_request) -> dict:
    """The ``logit_err`` statistics of the per-token errors of each
    request (a list of lists)."""
    errs = [e for r in per_request for e in r]
    out = {f"logit_err.{k}": float(f(errs)) for k, f in STATS.items()}
    out["logit_err.worst_request"] = float(max(np.median(r)
                                               for r in per_request if r))
    return out


def compare(ref, spec, seed: int, outputs, idx, check_cfg: dict, device,
            served_dtype, control: bool = False) -> dict:
    """``outputs``: one dict per request, ``prompt`` and ``served`` ids and
    ``logits``, the kept logits of each served token (None where none were
    kept); ``idx`` the sampled ones.  -> {"numbers": {name: {value, limit}},
    "correct", "sample", "tokens", "info", "errors" (each sampled
    request's per-token errors)[, "control"]}."""
    idx = [i for i in idx if outputs[i] is not None]
    seqs, rows = _sequences(outputs, idx)
    f32 = (ref.forward_logits(spec, seed, seqs, rows, device, served_dtype)
           if seqs else [])
    errs, not_argmax, gap = [], 0, []
    for i, lg in zip(idx, f32):
        served, kept = outputs[i]["served"], outputs[i]["logits"]
        gap += gaps(lg, served)
        errs.append([])
        for j, k in enumerate(kept):
            if k is None or int(k.reshape(-1).argmax()) != served[j]:
                not_argmax += 1
            if k is not None:
                errs[-1] += _rms_rows(k.reshape(1, -1), lg[j:j + 1])
    values = dict(stats(errs)) if any(errs) else {}
    values["not_argmax"] = not_argmax
    info = dict(values, mean_gap=float(np.mean(gap)) if gap else None)
    numbers = {k: {"value": values.get(k), "limit": check_cfg[k]}
               for k in check_cfg if k != "sample"}
    ok = bool(seqs) and all(c["value"] is not None
                            and c["value"] <= c["limit"]
                            for c in numbers.values())
    out = {"numbers": numbers, "correct": ok, "sample": len(idx),
           "tokens": sum(len(r) for r in rows), "info": info,
           "errors": {"program": errs}}
    if control and seqs:
        from dali_bench.reference.common import fp8_mm
        low = ref.forward_logits(spec, seed, seqs, rows, device,
                                 served_dtype, mm=fp8_mm)
        cerr = [_rms_rows(a, b) for a, b in zip(low, f32)]
        cgap = [g for a, b in zip(f32, low)
                for g in gaps(a, b.argmax(-1).tolist())]
        out["control"] = dict(stats(cerr), mean_gap=float(np.mean(cgap)))
        out["errors"]["control"] = cerr
    return out
