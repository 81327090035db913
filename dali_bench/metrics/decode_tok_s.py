"""Output tokens of every request over the whole window (first admission
to last completion), prefill stalls included."""


def read(ctx):
    n = sum(len(r.output) for r in ctx["requests"])
    return n / ctx["window_s"] if n and ctx["window_s"] > 0 else None
