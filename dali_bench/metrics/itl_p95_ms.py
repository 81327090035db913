"""The 95th percentile of every gap between a request's successive output
tokens in the window (host clock, as each token reaches the host), all
requests' gaps together."""
import numpy as np


def read(ctx):
    gaps = np.concatenate([np.diff(r.output.times) for r in ctx["requests"]]
                          or [np.zeros(0)])
    return float(np.percentile(gaps, 95) * 1e3) if gaps.size else None
