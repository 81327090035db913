"""Routing-trace capture (port of ``repro/core/tracing.py``): run the model
and record, per decode step and per MoE layer, the quantities DALI's
scheduler, prefetcher and cache operate on.  The residual vectors of the
policy (paper Eq. 11) are calibrated from such a trace
(``core/residual.py``).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models.config import ModelConfig, layer_pattern, scan_pattern
from repro_torch.models.model import apply_model, init_caches


def moe_layer_indices(cfg: ModelConfig) -> List[int]:
    """Indices of the MoE layers in ``layer_pattern`` order."""
    return [i for i, (_, mlp) in enumerate(layer_pattern(cfg))
            if mlp == "moe"]


def _np(t):
    return t.detach().float().cpu().numpy() if t.is_floating_point() \
        else t.detach().cpu().numpy()


def flatten_moe_infos(infos, cfg: ModelConfig):
    """apply_model's infos -> a flat per-MoE-layer list (layer order), each
    a dict of numpy arrays."""
    prefix_pat, period_pat, n_super = scan_pattern(cfg)
    out = []
    n_prefix = len(prefix_pat)
    for i in range(n_prefix):
        if infos[i] is not None:
            out.append({k: _np(v) for k, v in infos[i].items()})
    per_pos = list(infos[n_prefix]) if len(infos) > n_prefix else []
    for s in range(n_super):
        for info in per_pos:
            if info is not None:
                out.append({k: _np(v[s]) for k, v in info.items()})
    return out


@dataclass
class RoutingTrace:
    cfg: ModelConfig
    workload: List[List[np.ndarray]] = field(default_factory=list)
    gate_in: List[List[np.ndarray]] = field(default_factory=list)
    gates_sum: List[List[np.ndarray]] = field(default_factory=list)
    n_tokens: int = 0

    @property
    def n_steps(self) -> int:
        return len(self.workload)

    @property
    def n_moe_layers(self) -> int:
        return len(self.workload[0]) if self.workload else 0

    def append_step(self, flat_infos, n_tokens: int):
        self.workload.append([f["workload"] for f in flat_infos])
        self.gate_in.append([f["gate_in"].astype(np.float32)
                             for f in flat_infos])
        self.gates_sum.append([f["probs"].sum(0) for f in flat_infos])
        self.n_tokens = n_tokens


def gate_weights(params, cfg: ModelConfig) -> List[np.ndarray]:
    """Router weight (d, E) per MoE layer, in layer order, as numpy."""
    prefix_pat, period_pat, n_super = scan_pattern(cfg)
    out = [_np(params["prefix"][i]["mlp"]["router"])
           for i, (_, mlp) in enumerate(prefix_pat) if mlp == "moe"]
    stacked = [_np(params["scan"][p]["mlp"]["router"]) if mlp == "moe"
               else None for p, (_, mlp) in enumerate(period_pat)]
    for s in range(n_super):
        out += [stacked[p][s] for p, (_, mlp) in enumerate(period_pat)
                if mlp == "moe"]
    return out


@torch.no_grad()
def capture_decode_trace(params, cfg: ModelConfig, prompt_tokens,
                         n_decode: int, max_len: Optional[int] = None,
                         greedy: bool = True, seed: int = 0,
                         device="cuda", store=None,
                         off=None) -> RoutingTrace:
    """Prefill the prompt (B, S) then decode ``n_decode`` tokens, recording
    routing observables at every decode step (the regime the paper's cache
    and prefetch operate in).  ``greedy=False`` draws each token from the
    softmax of its logits with a ``torch.Generator`` seeded by ``seed``
    (the reference's ``jax.random.categorical`` draws differ); the first
    token after the prefill is the argmax either way, as in the reference.

    With a physical-offload ``store`` (an ``ExpertStore``) and its device
    state ``off`` (``state["offload"]``), ``params`` may be stripped of the
    expert stacks: every MoE layer then runs through the slot pool, with
    misses fetched from the host store.  Every step takes the slot path's
    "prefill" regime, which keeps the full-resident path's shapes (its
    capacity sweep and its drops, or its grouped decode path), so the
    trace equals a full-resident capture bit for bit."""
    dev = resolve_device(device)
    tokens = torch.as_tensor(np.asarray(prompt_tokens), device=dev)
    B, S = tokens.shape
    max_len = max_len or (S + n_decode + 1)
    caches = init_caches(cfg, B, max_len, device=dev)
    slot_kw = ({} if store is None else
               dict(expert_slots=store.build_view(off), slot_fetch=store,
                    slot_phase="prefill"))
    trace = RoutingTrace(cfg)
    pos = torch.arange(S, dtype=torch.int32, device=dev)
    logits, caches, _ = apply_model(params, tokens, cfg, positions=pos,
                                    caches=caches, last_logit_only=True,
                                    **slot_kw)
    tok = logits[:, -1:].argmax(-1).to(torch.int32)
    gen = None
    if not greedy:
        from repro_torch.serving.steps import sample_tokens
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
    for t in range(n_decode):
        pos = torch.arange(S + t, S + t + 1, dtype=torch.int32, device=dev)
        logits, caches, infos = apply_model(params, tok, cfg, positions=pos,
                                            caches=caches, trace=True,
                                            **slot_kw)
        trace.append_step(flatten_moe_infos(infos, cfg), n_tokens=B)
        if greedy:
            tok = logits[:, -1:].argmax(-1).to(torch.int32)
        else:
            tok = sample_tokens(logits[:, -1], 1.0, gen)
    return trace


@torch.no_grad()
def capture_prefill_trace(params, cfg: ModelConfig, tokens,
                          device="cuda") -> RoutingTrace:
    """One full-sequence forward of ``tokens`` (B, S): the prefill phase's
    routing observables as a one-step trace."""
    tokens = torch.as_tensor(np.asarray(tokens), device=resolve_device(device))
    _, _, infos = apply_model(params, tokens, cfg, trace=True,
                              last_logit_only=True)
    trace = RoutingTrace(cfg)
    trace.append_step(flatten_moe_infos(infos, cfg),
                      n_tokens=int(np.prod(tokens.shape)))
    return trace
