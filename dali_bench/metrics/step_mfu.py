"""Whole step: the model FLOPs of the window's requests
(``costs.request_flops``: projections, the top-k experts, shared experts,
attention over each token's context and the LM head's sampled rows) over
the traced window at the bf16 peak (989 TFLOP/s), in %."""
from dali_bench.costs import step_mfu


def read(ctx):
    if ctx["trace"] is None or ctx["window_s"] <= 0:
        return None
    return step_mfu(ctx["spec"], ctx["requests"], ctx["window_s"])
