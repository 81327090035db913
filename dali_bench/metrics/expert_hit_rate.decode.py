"""Policy: the share of decode (token, k) rows whose expert was in the slot
pool, 100 * (1 - the store's ``fallback_rows`` / (decode tokens x top_k x
MoE layers)).  The denominator is counted from the traffic: every output
token after a request's first is one decode row per layer and k."""


def read(ctx):
    st = ctx["store"]
    if st is None:
        return None
    spec = ctx["spec"]
    rows = (sum(len(r.output) - 1 for r in ctx["requests"])
            * spec["top_k"] * spec["moe_layers"])
    return 100.0 * (1.0 - st["fallback_rows"] / rows) if rows else None
