"""Scheduler: host-clock ms per decode step (``ServeMetrics.decode_s /
steps``: dispatch, the store's hooks and the token read of one step)."""


def read(ctx):
    m = ctx["serve"]
    return m.decode_s / m.steps * 1e3 if m.steps else None
