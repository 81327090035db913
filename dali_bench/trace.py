"""The device trace of a ``--trace 1`` run: ``torch.profiler``'s kineto
activity on the card (kernels, copies, memsets) over the measured window,
and the benchmark's own host spans, reduced to

  * ``busy_s``: the union of every device operation's interval (streams
    that overlap count once), and ``window_s``, the traced window;
  * device seconds by group of kernel names, ``KERNEL_GROUPS`` (a frozen
    copy of ``chip_smoke.py``'s, with cuBLAS's ``nvjet`` kernels, which
    it left in "other", among the matmuls), the host-to-card copies among
    them;
  * the idle gaps (no device operation running) by the innermost host
    span open when each gap began.

The host spans are ranges the benchmark stamps on ``time.time_ns()``'s
clock (kineto's) around calls into the program's layers (``SPANS``), on
the objects of this run only, in the traced run only; the program's files
are not touched.  The profiler records no CPU operations: that kept every
aten call's record on the host, which slowed the host-paced decode steps
by a fifth.
"""
from __future__ import annotations

import bisect
import contextlib
import time

KERNEL_GROUPS = (("K2 expert_ffn", ("ffn_gate_up_kernel", "ffn_down_kernel")),
                 ("K3 flash_attention", ("flash_kernel",)),
                 ("K1 gating", ("gating_row_kernel", "gating_warp_kernel")),
                 ("K1 floor (no-op kernel, not on the path)",
                  ("noop_kernel",)),
                 ("matmul (projections, router, lm head)",
                  ("gemm", "gemv", "cutlass", "xmma", "splitK", "nvjet")),
                 ("sort / scatter / index", ("sort", "Sort", "scatter",
                                             "index", "gather", "Scan")),
                 ("copies host to device (expert fetches, streaming)",
                  ("Memcpy HtoD",)))
OTHER = "other (elementwise, reductions, copies)"

# (owner, attribute, span name): the calls into the program's layers that
# the traced run wraps, where the object has them
SPANS = (("server", "_admit_request", "scheduler.admit+prefill"),
         ("server", "_decode", "steps.decode"),
         ("store", "pre_step", "store.pre_step"),
         ("store", "post_dispatch", "store.post_dispatch"),
         ("store", "next_target", "policy.next_target"),
         ("store", "read_misses", "store.read_misses"),
         ("store", "fetch_weights", "store.fetch_weights"),
         ("store", "prefill_fetch", "store.prefill_fetch"),
         ("store", "prefill_barrier", "store.prefill_barrier"))


def group_of(name: str) -> str:
    for g, keys in KERNEL_GROUPS:
        if any(k in name for k in keys):
            return g
    return OTHER


class _Spanned:
    """A callable of the program inside a host span, appended to ``log`` as
    (start ns, end ns, name); every other attribute is the callable's own
    (the server's decode also has ``react``)."""

    def __init__(self, fn, span: str, log: list):
        self._fn, self._span, self._log = fn, span, log

    def __call__(self, *a, **kw):
        t0 = time.time_ns()
        try:
            return self._fn(*a, **kw)
        finally:
            self._log.append((t0, time.time_ns(), self._span))

    def __getattr__(self, name):
        return getattr(self._fn, name)


def wrap_spans(objects: dict, log: list):
    """Stamp a span around each of ``SPANS`` that the objects (``{"server":
    ..., "store": ...}``) have into ``log``; instance attributes, so nothing
    outside this run changes."""
    for owner, attr, span in SPANS:
        obj = objects.get(owner)
        fn = getattr(obj, attr, None) if obj is not None else None
        if fn is not None:
            setattr(obj, attr, _Spanned(fn, span, log))


@contextlib.contextmanager
def profiled(result: dict):
    """Trace the body with kineto's CUDA activity.  The body sets
    ``result["t0_ns"]`` / ``["t1_ns"]``, the window on ``time.time_ns()``'s
    clock (kineto stamps its events on it), and ``result["spans"]`` holds
    the host spans; on exit ``result`` gets ``reduce``'s reading."""
    from torch._C._profiler import _ExperimentalConfig
    from torch.autograd import (ProfilerActivity, ProfilerConfig,
                                ProfilerState, _disable_profiler,
                                _enable_profiler, _prepare_profiler)
    cfg = ProfilerConfig(ProfilerState.KINETO, False, False, False, False,
                         False, _ExperimentalConfig())
    acts = {ProfilerActivity.CUDA}
    _prepare_profiler(cfg, acts)
    _enable_profiler(cfg, acts)
    events = None
    try:
        yield
    finally:
        events = _disable_profiler().events()
    result.update(reduce(events, result.pop("spans"), result.pop("t0_ns"),
                         result.pop("t1_ns")))


def _union(intervals):
    """Merged, sorted intervals of ``intervals`` [(start, end)]."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def reduce(events, spans, t0_ns: int, t1_ns: int) -> dict:
    """Busy, groups and idle gaps of kineto ``events`` clipped to the window
    [t0_ns, t1_ns], the gaps labelled by the host ``spans`` [(start, end,
    name)] (both on ``time.time_ns()``'s clock)."""
    dev = []
    groups = {}
    for e in events:
        if e.is_user_annotation() or not str(e.device_type()).endswith(
                "CUDA"):
            continue
        a, b = e.start_ns(), e.start_ns() + e.duration_ns()
        a, b = max(a, t0_ns), min(b, t1_ns)
        if b <= a:
            continue
        dev.append((a, b))
        g = group_of(e.name())
        groups[g] = groups.get(g, 0) + (b - a)
    busy = _union(dev)
    busy_ns = sum(b - a for a, b in busy)
    # idle gaps: between busy intervals, and at the window's two ends
    gaps, at = [], t0_ns
    for a, b in busy:
        if a > at:
            gaps.append((at, a))
        at = max(at, b)
    if t1_ns > at:
        gaps.append((at, t1_ns))
    spans = sorted(spans)
    starts = [s[0] for s in spans]
    idle = {}
    for a, b in gaps:
        # the innermost span open at the gap's start: the latest-starting
        # one among those that began before it and end after it
        label = "host, outside every span"
        i = bisect.bisect_right(starts, a)
        for s0, s1, name in reversed(spans[max(0, i - 256):i]):
            if s1 > a:
                label = name
                break
        idle[label] = idle.get(label, 0) + (b - a)
    top = lambda d: [[k, v / 1e9] for k, v in
                     sorted(d.items(), key=lambda kv: -kv[1])[:10]]
    return {"busy_s": busy_ns / 1e9, "window_s": (t1_ns - t0_ns) / 1e9,
            "groups_s": {k: v / 1e9 for k, v in groups.items()},
            "breakdown": {"device_ops": top(groups), "idle_gaps": top(idle)}}



def idle_share(tr: dict) -> float:
    """The share of the traced window with no device operation, in %."""
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
