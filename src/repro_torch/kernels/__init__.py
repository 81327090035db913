"""Hand-written Hopper kernels of the port and their launch counters.

Each wrapper (``gating.ops.gating``, ``expert_ffn.ops.expert_ffn``,
``flash_attention.ops.flash_attention``) runs its plain PyTorch version for
CPU tensors and launches its CUDA kernel for CUDA tensors, adding one to
its entry in ``LAUNCHES`` at each launch and nowhere else.  A run can thus
show that the main path went through the kernels.
"""
from __future__ import annotations

LAUNCHES = {
    "gating": 0,            # K1's row variant (E <= 32)
    "gating_warp": 0,       # K1's warp variant (E > 32)
    "expert_ffn_dense": 0,
    "expert_ffn_ragged": 0,
    "expert_ffn_grouped": 0,
    "flash_attention": 0,
}


def reset_launch_counts():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def launch_counts() -> dict:
    return dict(LAUNCHES)
