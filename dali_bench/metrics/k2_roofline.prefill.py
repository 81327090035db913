"""Kernels: K2's share of its roofline over the window's prefills, 100 x
the sum of each prompt's bound (``costs.k2_prefill_bound``: the larger of
its FLOPs at the bf16 peak and its bytes at HBM's) over K2's device time
in the trace (``ffn_gate_up_kernel`` and ``ffn_down_kernel``)."""
from dali_bench.costs import k2_prefill_bound
from dali_bench.trace import KERNEL_GROUPS


def read(ctx):
    tr = ctx["trace"]
    if tr is None:
        return None
    k2 = tr["groups_s"].get(KERNEL_GROUPS[0][0], 0.0)
    if k2 <= 0:
        return None
    bound = sum(k2_prefill_bound(ctx["spec"], len(r.prompt),
                                 ctx["elem_bytes"])["seconds"]
                for r in ctx["requests"])
    return 100.0 * bound / k2
