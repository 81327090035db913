"""Typed serving construction: one spec, one ``resolve()`` (port of
``repro/serving/spec.py`` for the full-resident ``"modeled"`` mode).

``ServeSpec`` says what to serve (config, server preset, policy, batch
geometry, device); ``OffloadSpec`` says how expert weights reach the
device.  ``ServeSpec.resolve(params)`` validates both once, resolves the
policy and returns a ``ResolvedServe`` whose factories build the step
functions, the serve state and the server.

Only ``mode="modeled"`` is ported: every expert stays on the device and
the policy's decisions feed telemetry only.  The physical modes
(blocking, overlap, pipelined), faults and topologies come with physical
offload (ROADMAP.md, "Physical offload").
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

from repro_torch.device import resolve_device
from repro_torch.tree import tree_leaves

OFFLOAD_MODES = ("modeled", "blocking", "overlap", "pipelined")


@dataclasses.dataclass(frozen=True)
class OffloadSpec:
    """How expert weights reach the device.

    mode    — "modeled" (every expert resident; the policy feeds
              telemetry only).  The reference's physical modes raise
              ``NotImplementedError`` until they are ported.
    """
    mode: str = "modeled"

    def resolve(self):
        """Validate the mode; returns the expert store (None: modeled)."""
        if self.mode not in OFFLOAD_MODES:
            raise ValueError(f"offload must be one of "
                             f"{'|'.join(OFFLOAD_MODES)}, got {self.mode!r}")
        if self.mode != "modeled":
            raise NotImplementedError(
                f"offload mode {self.mode!r} is ported with physical offload "
                "(ROADMAP.md, 'Physical offload')")
        return None


@dataclasses.dataclass(frozen=True)
class ServeSpec:
    """What to serve and how — the single construction surface.

    ``device`` is where the server runs: ``"cuda"`` unless the caller
    asks for ``"cpu"`` (the tests do); asking for ``cuda`` without a card
    raises at ``resolve``."""
    cfg: Any
    server: str = "continuous"
    policy: Any = None                  # name | policy instance | None
    dali_cfg: Any = None
    batch_size: int = 8
    max_len: int = 256
    eos_id: int = 1
    min_bucket: int = 16
    moe_capacity: Optional[int] = None
    offload: OffloadSpec = dataclasses.field(default_factory=OffloadSpec)
    device: Any = "cuda"

    def resolve(self, params) -> "ResolvedServe":
        """Validate + build the policy; check the params live on the
        spec's device."""
        from repro_torch.serving.steps import resolve_policy
        dev = resolve_device(self.device)
        if self.server != "continuous":
            raise NotImplementedError(
                f"server preset {self.server!r} is ported with the other "
                "policies (ROADMAP.md, 'other policies and the wave "
                "server'); the port serves 'continuous'")
        store = self.offload.resolve()
        policy = resolve_policy(self.policy, self.cfg, self.dali_cfg)
        wrong = {str(t.device) for t in tree_leaves(params)
                 if t.device.type != dev.type}
        if wrong:
            raise ValueError(f"params live on {sorted(wrong)} but the spec "
                             f"serves on {dev}")
        return ResolvedServe(spec=self, policy=policy, store=store,
                             params=params, device=dev)


@dataclasses.dataclass
class ResolvedServe:
    """A resolved spec: policy + params + device, with factory methods for
    the steps, the serve state and the server."""
    spec: ServeSpec
    policy: Any
    store: Any
    params: Any
    device: Any

    def decode_step(self):
        from repro_torch.serving.steps import make_decode_step
        return make_decode_step(self.spec.cfg, policy=self.policy,
                                moe_capacity=self.spec.moe_capacity)

    def admit_prefill(self):
        from repro_torch.serving.steps import make_admit_prefill
        return make_admit_prefill(self.spec.cfg,
                                  moe_capacity=self.spec.moe_capacity)

    def init_state(self, seed: int = 0, batch: Optional[int] = None,
                   max_len: Optional[int] = None):
        from repro_torch.serving.steps import init_serve_state
        s = self.spec
        return init_serve_state(s.cfg, batch or s.batch_size,
                                max_len or s.max_len, policy=self.policy,
                                seed=seed, device=self.device)

    def server(self, res_vecs=None):
        """The server the spec names, built from this resolution."""
        from repro_torch.serving.scheduler import ContinuousBatchServer
        return ContinuousBatchServer(self.params, resolved=self,
                                     res_vecs=res_vecs)
