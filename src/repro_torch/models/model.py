"""Full-model assembly (port of ``repro/models/model.py``): embedding ->
prefix blocks -> stacked super-blocks -> final norm -> unembedding, and
for encoder-decoder archs a bidirectional encoder stack whose output feeds
the decoder's cross-attention.

Parameters keep the reference's nesting: ``embed``, ``final_norm``,
``prefix`` (a tuple of per-layer dicts) and ``scan`` (a tuple over the
period's positions whose leaves are stacked ``(n_super, ...)``).  Where
the reference runs ``lax.scan`` over the stacked leaves, the port runs a
Python loop over views of them; caches are stacked the same way and
updated in place through those views.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.device import pinned_empty, resolve_device, torch_dtype
from repro_torch.launch.layout import local_kernel, tp_laid, unstack
from repro_torch.spans import span
from repro_torch.tree import tree_map, tree_map_with_path

from .blocks import apply_block, init_block, init_block_cache
from .config import ModelConfig, scan_pattern
from .layers import apply_norm, embed, init_embedding, init_norm, unembed
from .moe import is_expert_leaf


# --------------------------------------------------------------------------
# init
# --------------------------------------------------------------------------

def experts_on_host(experts: str) -> bool:
    """Whether an ``experts`` placement ("device" | "host") keeps the routed
    expert stacks in host memory."""
    if experts not in ("device", "host"):
        raise ValueError(f"experts must be 'device' or 'host', got "
                         f"{experts!r}")
    return experts == "host"


def host_empty(shape, dtype, device):
    """Host memory for expert stacks kept off a ``device``: page-locked when
    the device is a card (copies from it are then asynchronous DMA)."""
    if torch.device(device).type == "cuda":
        return pinned_empty(shape, dtype)
    return torch.empty(shape, dtype=dtype)


def experts_to_host(params, cfg: ModelConfig, device):
    """``params`` with each routed expert stack (``is_expert_leaf``) copied
    into host memory (page-locked when ``device`` is a card); every other
    leaf, the shared experts and dense FFNs included, stays where it is."""
    return tree_map_with_path(
        lambda path, t: host_empty(t.shape, t.dtype, device).copy_(t)
        if is_expert_leaf(path, cfg) else t, params)


def _init_stack(gen, cfg: ModelConfig, pattern, n_super: int, device,
                host_experts: bool):
    """Stacked params, leaves (n_super, ...), filled one block at a time so
    the peak is one block above the model's own size (with
    ``host_experts``, one block above the model without its experts).

    With ``host_experts`` each routed expert matrix of every MoE position
    lives in ONE host tensor (n_super * P, E, ...) in the layer order of an
    expert store (super-block major over the P MoE positions), and
    position j's stack is its view ``[j::P]``: a store adopts that tensor
    without a copy (``ExpertStore._host_stack``), also for a hybrid such as
    Jamba whose period holds several MoE positions."""
    moe_pos = [p for p, (_, mlp) in enumerate(pattern) if mlp == "moe"]
    big = {}

    def empty(p, path, a):
        if host_experts and is_expert_leaf(("scan", p) + path, cfg):
            if path[-1] not in big:
                big[path[-1]] = host_empty(
                    (n_super * len(moe_pos),) + tuple(a.shape), a.dtype,
                    device)
            return big[path[-1]][moe_pos.index(p)::len(moe_pos)]
        return a.new_empty((n_super,) + tuple(a.shape))

    out = []
    for p, kinds in enumerate(pattern):
        stacked = None
        for i in range(n_super):
            blk = init_block(gen, cfg, kinds, device)
            if stacked is None:
                stacked = tree_map_with_path(
                    lambda path, a, p=p: empty(p, path, a), blk)
            tree_map(lambda s, a: s[i].copy_(a), stacked, blk)
            del blk
        out.append(stacked)
    return tuple(out)


def init_model(cfg: ModelConfig, seed: int = 0, device="cuda",
               experts: str = "device"):
    """Random parameters from ``seed`` (a ``torch.Generator`` on the target
    device).  The draws differ from ``jax.random``; tests that compare with
    the reference carry its parameters over with ``repro_torch.bridge``.

    ``experts="host"`` keeps the routed expert stacks in host memory (for a
    physical-offload store): each layer's experts are drawn on ``device``,
    as for ``"device"`` (so the weights are the same), and moved to the host
    before the next layer is drawn, so a model whose experts do not fit on
    the card is never held there whole.  An encoder-decoder arch gets
    ``params["encoder"] = {"stack", "final_norm"}``: one stacked
    ``("attn", "dense")`` position of ``cfg.encoder.n_layers`` layers."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    return _init_params(cfg, gen, dev, experts_on_host(experts))


def meta_model(cfg: ModelConfig):
    """``init_model(cfg)``'s tree on the ``meta`` device: every leaf's shape
    and dtype, no storage (the shape dry run's counterpart of the
    reference's ``jax.eval_shape(init_model)``; a CPU generator feeds draws
    that draw nothing)."""
    return _init_params(cfg, torch.Generator(), torch.device("meta"), False)


def _init_params(cfg: ModelConfig, gen, dev, host: bool):
    def block(i, kinds):
        blk = init_block(gen, cfg, kinds, dev)
        if not host:
            return blk
        return tree_map_with_path(
            lambda path, a: host_empty(a.shape, a.dtype, dev).copy_(a)
            if is_expert_leaf(("prefix", i) + path, cfg) else a, blk)

    prefix_pat, period_pat, n_super = scan_pattern(cfg)
    params = {
        "embed": init_embedding(gen, cfg, dev),
        "final_norm": init_norm(cfg, dev),
        "prefix": tuple(block(i, kinds)
                        for i, kinds in enumerate(prefix_pat)),
        "scan": _init_stack(gen, cfg, period_pat, n_super, dev, host),
    }
    if cfg.encoder is not None:
        params["encoder"] = {
            "stack": _init_stack(gen, cfg, (("attn", "dense"),),
                                 cfg.encoder.n_layers, dev, False),
            "final_norm": init_norm(cfg, dev),
        }
    return params


# --------------------------------------------------------------------------
# caches
# --------------------------------------------------------------------------

def init_caches(cfg: ModelConfig, batch: int, max_len: int, device="cuda",
                dtype=None, n_cross: Optional[int] = None):
    return _build_caches(cfg, batch, max_len, resolve_device(device), dtype,
                         n_cross)


def meta_caches(cfg: ModelConfig, batch: int, max_len: int, dtype=None,
                n_cross: Optional[int] = None):
    """``init_caches``' tree on the ``meta`` device (shapes and dtypes)."""
    return _build_caches(cfg, batch, max_len, torch.device("meta"), dtype,
                         n_cross)


def _build_caches(cfg: ModelConfig, batch: int, max_len: int, dev, dtype,
                  n_cross):
    prefix_pat, period_pat, n_super = scan_pattern(cfg)
    mk = lambda kinds: init_block_cache(cfg, kinds, batch, max_len, dev,
                                        dtype=dtype, n_cross=n_cross)
    stack = lambda c: tree_map(
        lambda a: a[None].repeat((n_super,) + (1,) * a.dim()), c)
    return {
        "prefix": tuple(mk(kinds) for kinds in prefix_pat),
        "scan": tuple(stack(mk(kinds)) for kinds in period_pat),
    }


# --------------------------------------------------------------------------
# apply
# --------------------------------------------------------------------------

def _trim_info(info, trace: bool):
    if info is None or trace:
        return info
    return {k: info[k] for k in ("workload", "aux_loss", "z_loss", "dropped")}


def apply_encoder(params, src, cfg: ModelConfig):
    """Bidirectional encoder over precomputed frame embeddings (B, T, d):
    every layer attends non-causally (K3 with ``causal=False``).  A source
    wider than the weights (the reference's float32 frames) runs the
    encoder in its dtype, each weight promoted as JAX promotes it."""
    from repro_torch.launch.sharding import hint, layout_active
    laid = layout_active()
    T = src.shape[1]
    positions = torch.arange(T, dtype=torch.int32, device=src.device)
    up = lambda a: (a.to(torch.promote_types(a.dtype, src.dtype))
                    if a.is_floating_point() and a.dtype != src.dtype
                    else a)
    x = src
    stack = params["stack"][0]
    if laid:
        # the residual stream as the decoder's lies; each layer's leaves
        # indexed on the stack's local tensor (unstack)
        from .layers import norm_laid
        x = hint(src, "batch", "res_seq", "embed")
        stack = tree_map(unstack, stack)
    for s in range(cfg.encoder.n_layers):
        layer = tree_map(lambda a: up(a[s]), stack)
        if laid:
            layer = tp_laid(layer)
        x, _, _ = apply_block(layer, x, cfg, ("attn", "dense"),
                              positions=positions, causal=False)
    if laid:
        return norm_laid(tree_map(up, params["final_norm"]), x, cfg)
    return apply_norm(tree_map(up, params["final_norm"]), x, cfg)


def apply_model(params, tokens, cfg: ModelConfig, *, positions=None,
                caches=None, cross_src=None,
                moe_capacity: Optional[int] = None,
                trace: bool = False, last_logit_only: bool = False,
                logit_index: Optional[int] = None, expert_slots=None,
                slot_fetch=None, slot_live=None, slot_phase: str = "decode"):
    """tokens (B, S) int.  Returns (logits, caches, infos): ``caches`` is
    the given cache tree, updated in place (None without caches); ``infos``
    is one entry per prefix layer plus one tuple over the period's
    positions whose leaves are stacked (n_super, ...), as in the reference.

    ``positions`` is (S,) shared by the batch or (B, S) per slot.
    ``cross_src`` (B, T, d) is the source of the cross-attention layers:
    vision embeddings (VLM) or audio frames, which an encoder-decoder arch
    first encodes; without it cross layers read their caches.  It keeps
    its dtype where that is wider than ``cfg.dtype``: as in the reference,
    a float32 source promotes the encoder and the cross keys and values to
    float32 (a cache keeps them in its own dtype), and K3 takes them in
    ``cfg.dtype`` at its boundary.
    ``logit_index`` unembeds only that position: the admission prefill of a
    right-padded prompt samples from position ``length - 1``.

    ``expert_slots`` (an ``ExpertStore.build_view`` tree: per MoE layer its
    slot-pool slices, a scan position one entry per super-block) plus
    ``slot_fetch`` (the store) switch MoE layers to the physical-offload
    slot path; ``slot_live`` (B,) bool marks live batch slots (decode) and
    ``slot_phase`` ("decode" | "prefill") picks the slot regime."""
    from repro_torch.launch.sharding import hint, layout_active
    laid = layout_active()
    prefix_pat, period_pat, n_super = scan_pattern(cfg)
    B, S = tokens.shape
    if positions is None:
        positions = torch.arange(S, dtype=torch.int32, device=tokens.device)
    if laid and expert_slots is not None:
        raise NotImplementedError("the laid-out model runs without a slot "
                                  "pool")
    if cross_src is not None:
        if not laid:
            cross_src = torch.as_tensor(cross_src, device=tokens.device)
        src_dt = (torch.float32 if cross_src.dtype == torch.float64
                  else cross_src.dtype)     # JAX computes without x64
        dt = torch.promote_types(src_dt, torch_dtype(cfg.dtype))
        if cross_src.dtype != dt:
            cross_src = cross_src.to(dt)
        if cfg.encoder is not None:
            cross_src = apply_encoder(params["encoder"], cross_src, cfg)
    with span("model.embed"):
        if laid:
            # the laid-out model (launch/sharding.py::rules): DTensor
            # inputs, the residual stream as the reference hints it
            # (model.py:135)
            from .layers import embed_laid
            x = hint(embed_laid(params["embed"], tokens, cfg),
                     "batch", "res_seq", "embed")
        else:
            x = embed(params["embed"], tokens, cfg)

    slot_kw = dict(cross_src=cross_src, slot_fetch=slot_fetch,
                   slot_live=slot_live, slot_phase=slot_phase)
    phase = "decode" if S == 1 else "prefill"
    infos = []
    for i, kinds in enumerate(prefix_pat):
        with span("model.layer", layer=i, phase=phase):
            c = caches["prefix"][i] if caches is not None else None
            sl = (expert_slots["prefix"][i] if expert_slots is not None
                  else None)
            x, _, info = apply_block(params["prefix"][i], x, cfg, kinds,
                                     positions=positions, cache=c,
                                     moe_capacity=moe_capacity, slots=sl,
                                     layer=i, **slot_kw)
            infos.append(_trim_info(info, trace))

    # laid out, each stacked leaf is indexed on its local tensor (unstack)
    scan_p = tree_map(unstack, params["scan"]) if laid else params["scan"]
    scan_c = (None if caches is None else tree_map(unstack, caches["scan"])
              if laid else caches["scan"])

    def super_block(x, s):
        """The period's blocks of super-block ``s`` -> (x, their infos)."""
        out = []
        for p, kinds in enumerate(period_pat):
            i = len(prefix_pat) + s * len(period_pat) + p
            with span("model.layer", layer=i, phase=phase):
                with span("model.slice", layer=i):
                    p_slice = tree_map(lambda a: a[s], scan_p[p])
                    c = (tree_map(lambda a: a[s], scan_c[p])
                         if caches is not None else None)
                    sl = (expert_slots["scan"][p][s]
                          if expert_slots is not None
                          and expert_slots["scan"][p] is not None else None)
                x, _, info = apply_block(p_slice, x, cfg, kinds,
                                         positions=positions, cache=c,
                                         moe_capacity=moe_capacity, slots=sl,
                                         layer=i, **slot_kw)
                x = hint(x, "batch", "res_seq", "embed")   # model.py:182
                out.append(_trim_info(info, trace))
        return x, out

    # cfg.remat: each super-block of the stack (not the prefix layers, as in
    # the reference's jax.checkpoint of the scan body) keeps only its input
    # for the backward and runs its forward again there.  The infos come
    # from the first forward (the recompute's are dropped); the forward has
    # no randomness, so no RNG state is kept.  Under remat a training step
    # runs each super-block's forward twice, so K1, K2 and K3 launch twice
    # (kernels.LAUNCHES counts both), and their autograd Functions'
    # backwards then recompute through the plain versions once, as without
    # remat.
    remat = cfg.remat and torch.is_grad_enabled()
    per_pos = [[] for _ in period_pat]
    for s in range(n_super):
        if remat:
            x, out = checkpoint(super_block, x, s, use_reentrant=False,
                                preserve_rng_state=False)
        else:
            x, out = super_block(x, s)
        for p, info in enumerate(out):
            per_pos[p].append(info)
    with span("model.head", phase=phase):
        return _head(params, x, cfg, caches, infos, per_pos, laid,
                     logit_index, last_logit_only)


def _head(params, x, cfg: ModelConfig, caches, infos, per_pos, laid: bool,
          logit_index: Optional[int], last_logit_only: bool):
    """``apply_model``'s tail: the stacked infos, the final norm and the
    logits of the positions asked for."""
    from repro_torch.launch.sharding import hint
    infos.append(tuple(
        None if rows[0] is None
        else {k: torch.stack([r[k] for r in rows]) for k in rows[0]}
        for rows in per_pos))

    if logit_index is not None:
        x = x[:, logit_index:logit_index + 1]
    elif last_logit_only:
        x = x[:, -1:] if not laid else local_kernel(
            lambda t: t[:, -1:], [x.placements], x.placements)(
                hint(x, "batch", "seq", "embed"))
    if laid:
        from .layers import norm_laid, unembed_laid
        x = norm_laid(params["final_norm"], x, cfg)
        logits = hint(unembed_laid(params["embed"],
                                   hint(x, "batch", "seq", "embed"), cfg),
                      "batch", "seq", "vocab")             # model.py:200
        if logits.shape[1] == 1:
            # a serving step's one position: the vocab gathered, so that its
            # argmax or draw runs on every rank's whole row
            logits = hint(logits, "batch", "seq", None)
        return logits, caches, infos
    x = apply_norm(params["final_norm"], x, cfg)
    logits = unembed(params["embed"], x, cfg)
    return logits, caches, infos


# --------------------------------------------------------------------------
# info reduction helpers (layer order: prefix, then super-block-major)
# --------------------------------------------------------------------------

def collect_moe_scalars(infos):
    """Sum the aux / z losses and the drops over every MoE block (prefix and
    scanned stacks), in the reference's order (0-d CPU zeros without MoE
    blocks; they add to a tensor on any device)."""
    aux = z = dropped = 0
    for info in infos:
        if info is None:
            continue
        subs = [s for s in info if s is not None] \
            if isinstance(info, tuple) else [info]
        for sub in subs:
            aux = aux + sub["aux_loss"].sum()
            z = z + sub["z_loss"].sum()
            dropped = dropped + sub["dropped"].sum().to(torch.int32)
    zero = lambda v, dt: (torch.zeros((), dtype=dt) if isinstance(v, int)
                          else v)
    return {"aux_loss": zero(aux, torch.float32),
            "z_loss": zero(z, torch.float32),
            "dropped": zero(dropped, torch.int32)}


def collect_workloads(infos):
    """Per-MoE-layer workload vectors -> (n_moe_layers, E) in layer order
    (prefix first, then the stacks super-block-major)."""
    return collect_field(infos, "workload")


def collect_field(infos, field):
    """Stack a per-MoE-layer info field -> (n_moe_layers, ...) in true layer
    order (prefix first, then the stacks super-block-major)."""
    rows = []
    for info in infos:
        if info is None:
            continue
        if isinstance(info, tuple):
            per_pos = [sub[field] for sub in info if sub is not None]
            if not per_pos:
                continue
            stacked = torch.stack(per_pos, dim=1)   # (n_super, n_pos, ...)
            rows.append(stacked.reshape((-1,) + tuple(stacked.shape[2:])))
        else:
            rows.append(info[field][None])
    return torch.cat(rows, dim=0) if rows else None


def stack_routers(params, cfg: ModelConfig):
    """Router weights (n_moe_layers, d, E) in ``collect_field``'s order."""
    prefix_pat, period_pat, n_super = scan_pattern(cfg)
    rows = [params["prefix"][i]["mlp"]["router"][None]
            for i, (_, mlp) in enumerate(prefix_pat) if mlp == "moe"]
    per_pos = [params["scan"][p]["mlp"]["router"]
               for p, (_, mlp) in enumerate(period_pat) if mlp == "moe"]
    if per_pos:
        stacked = torch.stack(per_pos, dim=1)       # (n_super, n_pos, d, E)
        rows.append(stacked.reshape((-1,) + tuple(stacked.shape[2:])))
    return torch.cat(rows, dim=0) if rows else None


def collect_policy_obs(params, infos, cfg: ModelConfig, token_mask=None,
                       res_vecs=None):
    """``(workloads, Observation)`` for a policy step from a traced forward
    (``apply_model(trace=True)``).  With a ``token_mask`` (live slots) the
    workloads are recounted from per-token choices so the policy sees only
    real traffic."""
    from repro_torch.core.engine import masked_workloads
    from repro_torch.core.policy import Observation
    from repro_torch.launch.layout import gather
    # the laid-out model's observables and routers: replicated plain
    # tensors, as the policy computes on one device
    infos = gather(infos)
    gate_in = collect_field(infos, "gate_in")               # (L, T, d)
    routers = gather(stack_routers(params, cfg))            # (L, d, E)
    if token_mask is not None:
        topk = collect_field(infos, "topk_idx")             # (L, T, K)
        workloads = masked_workloads(topk, cfg.moe.n_routed, token_mask)
    else:
        workloads = collect_field(infos, "workload")        # (L, E)
    if res_vecs is None:
        res_vecs = torch.zeros((workloads.shape[0], cfg.d_model),
                               dtype=torch.float32, device=workloads.device)
    return workloads, Observation(gate_in=gate_in, routers=routers,
                                  res_vecs=res_vecs, token_mask=token_mask)
