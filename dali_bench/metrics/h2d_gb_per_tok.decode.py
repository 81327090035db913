"""Expert store: GB copied host to card per decode token, the pool's
planned moves (``h2d_bytes``) and the demand fetches of misses
(``fallback_fetches`` x one expert's bytes, from the configuration)."""
from dali_bench.costs import expert_bytes


def read(ctx):
    st = ctx["store"]
    if st is None:
        return None
    n = sum(len(r.output) - 1 for r in ctx["requests"])
    if not n:
        return None
    fetched = st["fallback_fetches"] * expert_bytes(ctx["spec"],
                                                    ctx["elem_bytes"])
    return (st["h2d_bytes"] + fetched) / n / 1e9
