"""Device: the share of the traced window in which no kernel, copy or
memset ran on the card, in %."""
from dali_bench.trace import idle_share


def read(ctx):
    tr = ctx["trace"]
    return idle_share(tr) if tr is not None and tr["window_s"] > 0 else None
