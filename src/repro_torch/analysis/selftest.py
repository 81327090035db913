"""Seeded-violation fixtures proving the audit fails LOUDLY, not vacuously
(port of ``repro/analysis/selftest.py``, DESIGN.md §12): each fixture
builds a deliberately broken step and must trip EXACTLY its expected
violation code.  ``python -m repro_torch.analysis.audit --self-test`` runs
them beside the green audit — a green audit is only trustworthy beside a
red self-test.

Fixtures:

* ``const_capture``   — a step closing over a deliberately captured
  256 KiB weight (the ``strip_expert_params`` regression);
* ``donation_dropped``— a pool update that reallocates the pool tensor
  instead of writing into it (the O(pool)-copy regression);
* ``unregistered_callback`` — a ``.cpu()`` read of device data outside any
  registered seam;
* ``unguarded_callback``    — a registered cond-required seam entered on
  a step where nothing missed (the decode fast-path regression);
* ``sync_census``           — a stray ``.item()`` left on the hot path (a
  host sync that is not a seam at all).
"""
from __future__ import annotations

from typing import Any, Dict, List

import torch

from repro_torch.analysis.contracts import (E_CALLBACK_UNGUARDED,
                                            E_CALLBACK_UNREGISTERED,
                                            E_CONST_CAPTURE,
                                            E_DONATION_DROPPED,
                                            E_SYNC_CENSUS, EntryPoint,
                                            GraphContract)
from repro_torch.analysis.step_audit import audit_entry
from repro_torch.models.moe import callback_seam


class _HostReader:
    """A registered read seam: registration is legal, entering it on a
    step with no miss is the violation."""

    @callback_seam("selftest_guarded", kind="read")
    def read(self, lid: int, t):
        return t.cpu().numpy()


def _fx_const_capture() -> EntryPoint:
    big = torch.ones((256, 256))                        # 256 KiB

    def f(x):
        return x @ big

    return EntryPoint(name="selftest/const_capture", fn=f,
                      args=(torch.zeros((2, 256)),))


def _fx_donation_dropped() -> EntryPoint:
    def f(pool):
        pool["gate"] = pool["gate"] * 2.0       # a new tensor, not in place
        return pool

    return EntryPoint(name="selftest/donation_dropped", fn=f,
                      args=({"gate": torch.zeros((8,))},),
                      contract=GraphContract(in_place=("gate",)),
                      kept=lambda args, result: {"gate": args[0]["gate"]})


def _fx_unregistered_callback() -> EntryPoint:
    def f(x):
        host = x.cpu()                          # a read outside any seam
        return x + float(len(host))

    return EntryPoint(name="selftest/unregistered_callback", fn=f,
                      args=(torch.zeros((4,)),))


def _fx_unguarded_callback() -> EntryPoint:
    reader = _HostReader()

    def f(x):
        reader.read(0, x)       # every step pays the host round trip
        return x + 1.0

    return EntryPoint(name="selftest/unguarded_callback", fn=f,
                      args=(torch.zeros((4,)),))


def _fx_sync_census() -> EntryPoint:
    def f(x):
        scale = x.sum().item()                  # a forgotten host sync
        return x * scale

    return EntryPoint(name="selftest/sync_census", fn=f,
                      args=(torch.ones((4,)),))


FIXTURES = (
    (_fx_const_capture, E_CONST_CAPTURE),
    (_fx_donation_dropped, E_DONATION_DROPPED),
    (_fx_unregistered_callback, E_CALLBACK_UNREGISTERED),
    (_fx_unguarded_callback, E_CALLBACK_UNGUARDED),
    (_fx_sync_census, E_SYNC_CENSUS),
)


def run_selftest() -> Dict[str, Any]:
    """Run every seeded-violation fixture.  ``ok`` iff each produced
    exactly its expected code — distinct and actionable, per fixture."""
    results: List[Dict[str, Any]] = []
    ok = True
    for build, expected in FIXTURES:
        ep = build()
        rec = audit_entry(ep)
        codes = sorted({v.code for v in rec["violations"]})
        hit = codes == [expected]
        ok &= hit
        results.append({"fixture": ep.name, "expected": expected,
                        "got": codes, "ok": hit,
                        "details": [str(v) for v in rec["violations"]]})
    return {"ok": ok, "fixtures": results}
