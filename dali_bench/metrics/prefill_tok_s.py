"""Prompt tokens served over the whole window."""


def read(ctx):
    n = sum(len(r.prompt) for r in ctx["requests"])
    return n / ctx["window_s"] if n and ctx["window_s"] > 0 else None
