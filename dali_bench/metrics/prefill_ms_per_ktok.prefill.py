"""Scheduler: host-clock ms of admission prefill per 1000 prompt tokens
(``ServeMetrics.prefill_s / prefill_tokens``)."""


def read(ctx):
    m = ctx["serve"]
    return m.prefill_s / m.prefill_tokens * 1e6 if m.prefill_tokens else None
