"""``python -m repro_torch.analysis.audit`` — the per-build serving-path
gate (port of ``repro/analysis/audit.py``, DESIGN.md §12).

Builds a smoke-scale server per offload mode through
``ServeSpec.resolve()`` (expert stacks stripped, exactly like serving),
runs and audits every entry point (``step_audit``), runs the convention
lint, cross-checks the measured costs against the CostModel, and exits
non-zero on any violation.  ``--self-test`` runs the seeded-violation
fixtures instead, proving each defect class fails with its own code.

Examples::

  python -m repro_torch.analysis.audit --device cpu          # full matrix
  python -m repro_torch.analysis.audit --device cpu --modes pipelined \\
      --rungs healthy,little
  python -m repro_torch.analysis.audit --self-test
  python -m repro_torch.analysis.audit --lint-only
  python -m repro_torch.analysis.audit --device cpu --json audit.json

The physical modes do not pass today: every slot-path MoE layer enters
``read_misses`` on every step, also where every row hits
(``E_CALLBACK_UNGUARDED``, ROADMAP item 12).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time
from typing import Any, Dict, List, Optional

from repro_torch.serving.spec import OFFLOAD_MODES

RUNGS = ("healthy", "degraded", "little")


def build_resolution(mode: str, config: str = "mixtral-8x7b",
                     n_routed: int = 8, n_layers: int = 4,
                     batch: int = 2, max_len: int = 32, device="cuda"):
    """A smoke-scale resolved server for one offload mode — the same
    ``ServeSpec.resolve()`` path production construction uses, so the
    audited steps ARE the serving steps (stripped params and all)."""
    from repro_torch.configs import get_config, make_smoke
    from repro_torch.models.model import init_model
    from repro_torch.serving.spec import OffloadSpec, ServeSpec
    cfg = make_smoke(get_config(config)).replace(n_layers=n_layers)
    cfg = cfg.replace(moe=dataclasses.replace(cfg.moe, n_routed=n_routed))
    params = init_model(cfg, seed=0, device=device)
    return ServeSpec(cfg=cfg, policy="dali", batch_size=batch,
                     max_len=max_len, device=device,
                     offload=OffloadSpec(mode=mode)).resolve(params)


def run_audit(modes: List[str], rungs: List[str], with_costs: bool = True,
              with_lint: bool = True, device="cuda") -> Dict[str, Any]:
    from repro_torch.analysis.cost_audit import audit_costs
    from repro_torch.analysis.lint import lint_tree
    from repro_torch.analysis.step_audit import audit_resolved

    report: Dict[str, Any] = {"modes": {}, "violations": [],
                              "lint": [], "ok": True}
    reference_flops: Optional[float] = None
    for mode in modes:
        t0 = time.time()
        rs = build_resolution(mode, device=device)
        mode_rungs = [r for r in rungs
                      if mode != "modeled" or r == "healthy"]
        rec = audit_resolved(rs, rungs=tuple(mode_rungs),
                             raise_on_violation=False)
        if with_costs:
            costs = audit_costs(rs, reference_flops=reference_flops)
            if mode == "modeled":
                reference_flops = costs["decode_flops"]
            rec["costs"] = costs
            rec["violations"].extend(costs["violations"])
        rec["elapsed_s"] = round(time.time() - t0, 1)
        rec["ok"] = not rec["violations"]
        report["modes"][mode] = rec
        report["violations"].extend(rec["violations"])

    if with_lint:
        findings = lint_tree()
        report["lint"] = [f.asdict() for f in findings]
        report["ok"] = not report["violations"] and not findings
    else:
        report["ok"] = not report["violations"]
    return report


def _print_summary(report: Dict[str, Any]):
    for mode, rec in report.get("modes", {}).items():
        n_entries = len(rec.get("entries", []))
        n_v = len(rec.get("violations", []))
        status = "ok" if rec.get("ok") else f"{n_v} VIOLATION(S)"
        print(f"  {mode:10s} {n_entries:2d} entry point(s) "
              f"[{rec.get('elapsed_s', '?')}s] ... {status}")
        for v in rec.get("violations", []):
            print(f"    [{v['code']}] {v['entry']}: {v['detail']}")
    lint = report.get("lint", [])
    print(f"  lint       {len(lint)} finding(s)")
    for f in lint:
        print(f"    {f['path']}:{f['line']}: {f['code']} {f['detail']}")


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        description="serving-path audit of the port (DESIGN.md §12)")
    ap.add_argument("--modes", default=",".join(OFFLOAD_MODES),
                    help=f"comma list of {'|'.join(OFFLOAD_MODES)}")
    ap.add_argument("--rungs", default=",".join(RUNGS),
                    help=f"comma list of {'|'.join(RUNGS)} "
                         f"(physical modes only)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where the audited servers run")
    ap.add_argument("--json", metavar="PATH",
                    help="write the machine-readable report here")
    ap.add_argument("--no-cost", action="store_true",
                    help="skip the cost cross-checks")
    ap.add_argument("--lint-only", action="store_true",
                    help="run only the AST lint")
    ap.add_argument("--self-test", action="store_true",
                    help="run the seeded-violation fixtures: each must "
                         "fail with its own distinct code")
    args = ap.parse_args(argv)

    if args.self_test:
        from repro_torch.analysis.selftest import run_selftest
        report = run_selftest()
        for r in report["fixtures"]:
            mark = "ok" if r["ok"] else "FAILED"
            print(f"  {r['fixture']:35s} expected {r['expected']:25s} "
                  f"got {','.join(r['got']) or '(nothing)'} ... {mark}")
        print("self-test:", "ok — every seeded violation fired its own "
              "code" if report["ok"] else "FAILED — the audit is vacuous "
              "for at least one defect class")
        rc = 0 if report["ok"] else 1
    elif args.lint_only:
        from repro_torch.analysis.lint import lint_tree
        findings = lint_tree()
        report = {"lint": [f.asdict() for f in findings],
                  "ok": not findings}
        for f in findings:
            print(f)
        print(f"lint: {len(findings)} finding(s)")
        rc = 0 if report["ok"] else 1
    else:
        modes = [m.strip() for m in args.modes.split(",") if m.strip()]
        bad = [m for m in modes if m not in OFFLOAD_MODES]
        if bad:
            ap.error(f"unknown mode(s) {bad}; choose from "
                     f"{'|'.join(OFFLOAD_MODES)}")
        rungs = [r.strip() for r in args.rungs.split(",") if r.strip()]
        bad = [r for r in rungs if r not in RUNGS]
        if bad:
            ap.error(f"unknown rung(s) {bad}; choose from "
                     f"{'|'.join(RUNGS)}")
        report = run_audit(modes, rungs, with_costs=not args.no_cost,
                           device=args.device)
        _print_summary(report)
        print("audit:", "ok" if report["ok"] else "FAILED")
        rc = 0 if report["ok"] else 1

    if args.json:
        os.makedirs(os.path.dirname(args.json) or ".", exist_ok=True)
        with open(args.json, "w", encoding="utf-8") as fh:
            json.dump(report, fh, indent=2, sort_keys=True)
        print(f"report -> {args.json}")
    return rc


if __name__ == "__main__":
    sys.exit(main())
