"""Scheduler: host waits on the card per decode step, the scheduler's
(``ServeMetrics.host_syncs``: token reads, admissions' uploads and first
tokens, the policy telemetry's reads) and the store's (``host_syncs`` of
``stats()``: miss reads, staging-index uploads, the pool target's read) in
the window, over ``ServeMetrics.steps``."""


def read(ctx):
    m, st = ctx["serve"], ctx["store"]
    n = getattr(m, "host_syncs", None)
    if n is None or st is None or "host_syncs" not in st or not m.steps:
        return None
    return (n + st["host_syncs"]) / m.steps
