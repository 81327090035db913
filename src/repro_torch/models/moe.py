"""Mixture-of-Experts layer (port of ``repro/models/moe.py``; its
expert-parallel path is ``models/moe_ep.py``).

Routing runs the fused router kernel K1; the expert FFN runs kernel K2 on
one of two paths, chosen statically from shapes as in the reference
(``use_sparse_path``):

* **dense** — sort/gather dispatch into (E, C, d) capacity buckets
  (``local_dispatch``), then K2 in its ragged form with the per-expert
  ``counts``, so empty capacity tiles skip their work and their weight
  bytes;
* **sparse decode path** — K2 in its grouped form with one row group per
  activated (token, k) slot and ``expert_ids = idx.reshape(-1)``: each group
  reads its expert's weights by index, so the (T*K, d, f) gathered weight
  copies of the reference are never built.

With a physical-offload expert store (``serving/expert_store.py``) the
weights come from the device slot pool instead: decode steps take the
grouped path with ``expert_ids`` = pool slots (``slot_expert_ffn``), and
prefill sweeps run K2 grouped over the (E, C, d) buckets with
``expert_ids`` = pool rows or the rows of a wave of streamed misses
(``slot_expert_sweep``).  Both keep each row's arithmetic the
full-resident one, so the fetch tier is bit-equal to full-resident
execution; the little tier runs the same launches over experts
dequantized from the store's int8 twins.

Shared experts (DeepSeek-V2-Lite's ``n_shared``) are one dense FFN that
every token runs, added on every path as in the reference; they stay on
the device in an offloaded serve, unseen by the store and the policy.

Inputs of more than ``MOE_CHUNK_TOKENS`` tokens run chunk by chunk, as
the reference's scan does: the tokens are padded to whole chunks, the pad
is masked out by ``valid`` (it takes no capacity slot, counts toward no
workload and fetches no expert), and each chunk routes, dispatches and, on
the slot path, streams its own waves.

The layer returns the same routing observables (``info``) as the
reference: workloads, top-k choices, gates, router probabilities, gate
inputs, aux/z losses and drops — what the DALI policy schedules on.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import numpy as np
import torch

from repro_torch.kernels.expert_ffn.ops import expert_ffn
from repro_torch.kernels.gating.ops import gating
from repro_torch.spans import span

from .config import ModelConfig, MoEConfig, scan_pattern
from .layers import apply_mlp, dense_init, init_mlp

# --------------------------------------------------------------------------
# Host seam registry (the reference's callback seams, DESIGN.md §12)
# --------------------------------------------------------------------------
# The registered seams are the ONLY functions a decode or prefill step may
# use to read device data on the host or to compute on the host; the
# serving-path audit (repro_torch/analysis/step_audit.py) flags a host read
# anywhere else.  Where the reference's seams are ``pure_callback`` /
# ``io_callback`` targets inside a jitted graph, the port's are the expert
# store's methods that the eager step calls (serving/expert_store.py),
# registered by the ``callback_seam`` decorator.  A seam counts its
# entries, and an active census (``add_seam_listener``) sees each entry
# with its arguments: on the CPU ``.cpu()`` dispatches nothing, so the
# entries are how the audit sees a step leave the device there.

SEAM_KINDS = ("read", "stage", "host")


@dataclasses.dataclass
class CallbackSeam:
    """One registered host seam.

    kind           — "read" (a device-to-host read of device data) |
                     "stage" (host-chosen weights copied or dequantized
                     into device staging rows; reads nothing back) |
                     "host" (computes on the host)
    cond_required  — the seam may be entered only on a step that needs it
                     (a miss to serve), so an all-hit step never leaves the
                     device (the decode fast-path contract)
    entries        — times the seam was entered in this process
    """
    name: str
    kind: str
    cond_required: bool = True
    module: str = ""
    entries: int = 0


CALLBACK_SEAMS: dict = {}
_SEAM_LISTENERS: list = []


def register_callback_seam(name: str, func, *, kind: str = "read",
                           cond_required: bool = True) -> CallbackSeam:
    """Declare ``func`` (a function or bound/unbound method) as a legal
    host seam of serving steps.  Idempotent per function."""
    if kind not in SEAM_KINDS:
        raise ValueError(f"kind must be one of {'|'.join(SEAM_KINDS)}, "
                         f"got {kind!r}")
    fn = getattr(func, "__func__", func)
    seam = CallbackSeam(name=name, kind=kind, cond_required=cond_required,
                        module=getattr(fn, "__module__", ""))
    CALLBACK_SEAMS[fn] = seam
    return seam


def lookup_callback_seam(func):
    """The :class:`CallbackSeam` registered for ``func`` (unwrapping bound
    methods and ``functools.partial`` chains), or None."""
    fn = func
    while True:
        if hasattr(fn, "__func__"):
            fn = fn.__func__
        elif isinstance(fn, functools.partial):
            fn = fn.func
        else:
            break
    return CALLBACK_SEAMS.get(fn)


def callback_seam(name: str, *, kind: str, cond_required: bool = True):
    """Decorator: register the function as a host seam; each call counts
    one entry and is announced to the active listeners (``enter(seam,
    args)`` before the body, ``exit(seam)`` after it)."""
    def wrap(fn):
        @functools.wraps(fn)
        def entered(*args, **kwargs):
            seam.entries += 1
            listeners = tuple(_SEAM_LISTENERS)
            for ls in listeners:
                ls.enter(seam, args)
            try:
                return fn(*args, **kwargs)
            finally:
                for ls in listeners:
                    ls.exit(seam)

        seam = register_callback_seam(name, entered, kind=kind,
                                      cond_required=cond_required)
        return entered
    return wrap


def add_seam_listener(listener):
    _SEAM_LISTENERS.append(listener)


def remove_seam_listener(listener):
    _SEAM_LISTENERS.remove(listener)


# the routed expert stacks of an MoE layer's params: what a physical-offload
# store keeps on the host and ``strip_expert_params`` removes
EXPERT_KEYS = ("gate", "up", "down")


def is_expert_leaf(path, cfg: ModelConfig) -> bool:
    """Whether a key path from the params' root is a routed expert stack:
    ``gate`` / ``up`` / ``down`` directly under the ``mlp`` of a block whose
    MLP kind in ``scan_pattern(cfg)`` is "moe" (``("prefix", i, "mlp",
    key)`` or ``("scan", p, "mlp", key)``).  A dense block's FFN, such as
    DeepSeek-V2-Lite's first layer, has the same keys and is not one; nor
    are the shared experts (``mlp/shared/*``)."""
    if len(path) != 4 or path[0] not in ("prefix", "scan") \
            or path[2] != "mlp" or path[3] not in EXPERT_KEYS:
        return False
    prefix_pat, period_pat, _ = scan_pattern(cfg)
    pattern = prefix_pat if path[0] == "prefix" else period_pat
    return pattern[path[1]][1] == "moe"


# inputs above this many tokens run in chunks of it (``apply_moe``); read
# at call time, so a test can make it small
MOE_CHUNK_TOKENS = 16384
SPARSE_CMIN = 4
SPARSE_OVERHEAD = 4


def expert_capacity(cfg_m: MoEConfig, n_tokens: int) -> int:
    if cfg_m.capacity_factor <= 0:          # "full": no token ever dropped
        return n_tokens
    c = int(np.ceil(n_tokens * cfg_m.top_k / cfg_m.n_routed
                    * cfg_m.capacity_factor))
    return max(4, int(np.ceil(c / 4)) * 4)


def use_sparse_path(m: MoEConfig, n_tokens: int,
                    capacity: Optional[int]) -> bool:
    """Take the grouped sparse path when the activated (token, k) slots
    undercut the dense sweep's minimum bucket work E * C_min by the
    reference's gather-overhead factor.  Shape-only, as in the reference."""
    return (capacity is None
            and n_tokens * m.top_k * SPARSE_OVERHEAD
            < m.n_routed * SPARSE_CMIN)


def init_moe(gen, cfg: ModelConfig, device):
    """Router, routed expert stacks (E, ...) and, with ``n_shared``, the
    shared experts as one dense FFN of width ``d_shared`` (default
    ``n_shared * d_expert``), which every token runs."""
    m = cfg.moe
    d = cfg.d_model
    de = m.d_expert or cfg.d_ff
    dt = cfg.param_dtype

    def stack(shape):
        return torch.stack([dense_init(gen, shape, dt, device)
                            for _ in range(m.n_routed)])

    p = {
        "router": dense_init(gen, (d, m.n_routed), "float32", device),
        "gate": stack((d, de)),
        "up": stack((d, de)),
        "down": stack((de, d)),
    }
    if m.n_shared:
        p["shared"] = init_mlp(gen, cfg, device,
                               d_ff=m.d_shared or m.n_shared * de)
    return p


def route(params, x_flat, m: MoEConfig):
    """x_flat (T, d) -> (gates (T,k), idx (T,k), probs (T,E), logits)."""
    logits = x_flat.float() @ params["router"]               # (T, E)
    gates, idx, probs = gating(logits.contiguous(), m.top_k, m.router_type,
                               m.renormalize)
    if m.router_type == "sigmoid" and m.renormalize:
        # route renormalises sigmoid gates; the kernel (like the Pallas one)
        # does not
        gates = gates / (gates.sum(-1, keepdim=True) + 1e-9)
    return gates, idx, probs, logits


def _combine_topk(ys, gates):
    """Weighted sum of per-(token, k) rows back to (T, d)."""
    T, K = gates.shape
    return (ys.reshape(T, K, -1) * gates.to(ys.dtype)[..., None]).sum(1)


def grouped_expert_ffn(params, xf, idx, gates, cfg: ModelConfig,
                       e0: Optional[int] = None):
    """Sparse decode path: one K2 row group per activated (token, k) slot,
    weights read by expert index (no gathered copies).  xf (T, d),
    idx/gates (T, K) -> combined output (T, d).  ``e0``: the stacks hold
    experts [e0, e0 + E_l) of the layer (a rank's own, laid out), and rows
    routed to others contribute zero."""
    T, d = xf.shape
    K = idx.shape[1]
    xs = xf.repeat_interleave(K, dim=0)[:, None, :].contiguous()  # (T*K,1,d)
    ids = idx.reshape(-1)
    if e0 is None:
        counts = torch.ones((T * K,), dtype=torch.int32, device=xf.device)
    else:
        e_l = params["gate"].shape[0]
        counts = ((ids >= e0) & (ids < e0 + e_l)).to(torch.int32)
        ids = (ids - e0).clamp(0, e_l - 1).to(torch.int32)
    ys = expert_ffn(xs, params["gate"], params["up"], params["down"],
                    counts=counts, expert_ids=ids.contiguous(), act=cfg.act)
    return _combine_topk(ys[:, 0], gates)


def _bucket_rows(ye, se, rank, inv, keep, e0: int = 0):
    """Each (token, k) row's expert output, in token order (T * K, d):
    bucket row ``rank`` of expert ``se`` in ``ye`` (E_l, C_l, d), the
    buckets of experts [e0, e0 + E_l), zero where not ``keep`` (dropped,
    padded, or another rank's expert)."""
    E_l, C_l = ye.shape[:2]
    contrib = ye[(se - e0 if e0 else se).clamp(0, E_l - 1),
                 rank.clamp(0, C_l - 1)]
    return torch.where(keep[:, None], contrib, 0)[inv]


def slot_expert_ffn(slots, slot_fetch, xf, idx, gates, cfg: ModelConfig,
                    live=None, phase: str = "decode"):
    """Physical-offload decode path: one K2 row group per (token, k) slot,
    weights from the layer's device slot pool (``slots``: one entry of
    ``ExpertStore.build_view``).  Pooled experts read their slot rows;
    misses take the store's tier:

      * "fetch" — the missing experts are copied from the pinned host
        store into the miss-staging buffer and a second K2 launch runs the
        miss rows over it, so every row is computed as full-resident
        decode computes it (bit-equal);
      * "host" — the missing rows' FFN runs on the CPU in float32 and only
        the (d,) rows come back;
      * "little" — the missing experts are dequantized from the store's
        device-resident int8 twins into the miss-staging rows, and the
        second K2 launch runs over them (no host read, int8 quality).

    ``live`` (T,) bool marks live batch slots: a dead row never counts as a
    miss (a retired slot's garbage token must not fetch); its output comes
    from whatever slot row the clipped index lands on and is discarded.
    The host learns the misses from one small device-to-host read, and a
    layer that misses uploads its rows' staging indices (or, "host", their
    outputs) from pageable memory: both wait on the card (the store's
    ``host_syncs``)."""
    T, d = xf.shape
    K = idx.shape[1]
    lid = slots["lid"]
    with span("moe.dispatch", layer=lid, phase=phase):
        slot_fetch.wait_layer(lid)
        flat_e = idx.reshape(-1).to(torch.int32)
        slot = slots["slot_of"][flat_e.long()]             # (T*K,) int32
        hit = slot >= 0
        if live is not None:
            hit = hit | ~live.repeat_interleave(K)
        rows = torch.stack([flat_e, hit.to(torch.int32)])
    got = slot_fetch.read_misses(lid, rows)
    e_np, hit_np = got[0], got[1].astype(bool)
    with span("moe.k2_pool", layer=lid, phase=phase):
        xs = xf.repeat_interleave(K, dim=0)[:, None, :].contiguous()
        ys = expert_ffn(xs, slots["gate"], slots["up"], slots["down"],
                        counts=hit.to(torch.int32),
                        expert_ids=slot.clamp(min=0).contiguous(),
                        act=cfg.act)[:, 0]
    ym = miss = None
    if not hit_np.all():
        miss = ~hit
        if slot_fetch.fallback == "host":
            ym = slot_fetch.host_ffn(lid, xf, e_np, hit_np)
            with span("moe.miss_upload", layer=lid, phase=phase):
                ym = ym.to(xf.device)
            slot_fetch.count_sync()
        else:
            stage = (slot_fetch.little_weights
                     if slot_fetch.fallback == "little"
                     else slot_fetch.fetch_weights)
            wg, wu, wd, srow = stage(lid, e_np, hit_np)
            with span("moe.miss_upload", layer=lid, phase=phase):
                srow = torch.from_numpy(srow).to(xf.device)
            slot_fetch.count_sync()
            with span("moe.k2_miss", layer=lid, phase=phase):
                ym = expert_ffn(xs, wg, wu, wd, counts=miss.to(torch.int32),
                                expert_ids=srow, act=cfg.act)[:, 0]
    with span("moe.combine", layer=lid, phase=phase):
        if ym is not None:
            ys = torch.where(miss[:, None], ym, ys)
        return _combine_topk(ys, gates)


def slot_expert_sweep(slots, slot_fetch, xe, counts, cfg: ModelConfig,
                      phase: str = "prefill"):
    """Physical-offload capacity sweep: (E, C, d) buckets -> (E, C, d).

    One K2 grouped launch runs the pooled experts' buckets with
    ``expert_ids`` = their pool slots; the activated-but-unpooled experts'
    buckets ("fetch") run in waves of at most ``prefill_rows`` experts, each
    wave copied from the pinned host store into the staging rows its launch
    reads.  K2 skips empty groups, so experts without tokens need no
    weights, and every bucket is computed as the full-resident sweep
    computes it (bit-equal).  "little" runs the same waves over experts
    dequantized from the store's int8 twins.  Returns ``(ye, need)``:
    ``need`` (E,) bool marks the experts the "host" tier still has to run
    (their buckets are zero in ``ye``); all False for "fetch" and
    "little"."""
    lid = slots["lid"]
    slot_fetch.wait_layer(lid)
    E = xe.shape[0]
    slot_of = slots["slot_of"]
    need = ((slot_fetch.read_misses(lid, counts, prefill=True) > 0)
            & (slots["slot_of_np"] < 0))
    with span("moe.k2_pool", layer=lid, phase=phase):
        ye = expert_ffn(xe, slots["gate"], slots["up"], slots["down"],
                        counts=torch.where(slot_of >= 0, counts, 0),
                        expert_ids=slot_of.clamp(min=0).contiguous(),
                        act=cfg.act)
    if slot_fetch.fallback == "host":
        return ye, need
    ids = np.nonzero(need)[0]
    P = slot_fetch.prefill_rows
    stage = (slot_fetch.prefill_little if slot_fetch.fallback == "little"
             else slot_fetch.prefill_fetch)
    for w in range(0, len(ids), P):
        wave = ids[w:w + P]
        wg, wu, wd = stage(lid, wave)
        rows = np.zeros(E, np.int32)
        rows[wave] = np.arange(len(wave), dtype=np.int32)
        sel = np.zeros(E, bool)
        sel[wave] = True
        with span("moe.miss_upload", layer=lid, phase=phase):
            sel = torch.from_numpy(sel).to(xe.device)
            rows = torch.from_numpy(rows).to(xe.device)
        slot_fetch.count_sync(2)
        with span("moe.k2_miss", layer=lid, phase=phase):
            yw = expert_ffn(xe, wg, wu, wd,
                            counts=torch.where(sel, counts, 0),
                            expert_ids=rows, act=cfg.act)
            ye = torch.where(sel[:, None, None], yw, ye)
    return ye, np.zeros(E, bool)


def expert_ffn_dense(params, xe, cfg: ModelConfig, counts=None):
    """Capacity-bucket sweep (E, C, d) -> (E, C, d) through K2 (ragged with
    ``counts``; rows at or beyond counts[e] are zero)."""
    return expert_ffn(xe.contiguous(), params["gate"], params["up"],
                      params["down"],
                      counts=None if counts is None
                      else counts.to(torch.int32).contiguous(),
                      act=cfg.act)


def _bincount(keys, n: int):
    """Counts of each value in [0, n) among ``keys``.  A scatter-add, not
    ``torch.bincount``, which reads the largest key back to the host."""
    counts = torch.zeros((n,), dtype=torch.int32, device=keys.device)
    return counts.scatter_add_(0, keys.long(),
                               torch.ones_like(keys, dtype=torch.int32))


def _workload_counts(flat_e, E, valid_rep=None):
    """Per-expert token counts over the activated (token, k) slots; with a
    validity mask the invalid slots go to a virtual expert E, sliced off."""
    if valid_rep is None:
        return _bincount(flat_e, E)
    return _bincount(torch.where(valid_rep, flat_e, E), E + 1)[:E]


def local_dispatch(xf, idx, E, K, C, valid_rep=None):
    """Sort/gather capacity-bucket dispatch (reference ``moe.py:450``):
    returns the (E, C, d) buckets (rows past the packed count zero-filled),
    the per-expert demand, and the combine contract (sorted-slot expert
    keys ``se``, E for invalid slots, in-expert ranks ``rank``, inverse
    permutation ``inv``).  Invalid (token, k) slots (``valid_rep`` False)
    sort into a virtual expert E, so they take no capacity slot and count
    toward no workload."""
    T = xf.shape[0]
    dev = xf.device
    key = idx.reshape(-1).long()                              # (T*K,)
    if valid_rep is not None:
        key = torch.where(valid_rep, key, E)
    flat_t = torch.arange(T, device=dev).repeat_interleave(K)
    se, order = torch.sort(key, stable=True)
    st = flat_t[order]
    counts_ext = _bincount(key, E + 1).long()
    counts = counts_ext[:E]
    offsets = torch.cat([counts_ext.new_zeros(1), counts_ext.cumsum(0)[:-1]])
    rank = torch.arange(T * K, device=dev) - offsets[se]
    pos = offsets[:E, None] + torch.arange(C, device=dev)[None, :]   # (E, C)
    bucket_valid = torch.arange(C, device=dev)[None, :] \
        < torch.clamp(counts[:, None], max=C)
    src = st[pos.clamp(0, T * K - 1)]
    xe = torch.where(bucket_valid[..., None], xf[src], 0)
    inv = torch.empty_like(order)
    inv[order] = torch.arange(T * K, device=dev)
    return xe, counts.to(torch.int32), se, rank, inv


def _apply_moe_chunked(params, x, cfg: ModelConfig, chunk: int, *,
                       capacity, valid, **kw):
    """``apply_moe`` over chunks of ``chunk`` tokens (the reference's scan
    at ``moe.py:547-592``, as a loop): the tokens are padded to whole
    chunks and the pad masked invalid; each chunk gets ``ceil(capacity /
    n_chunks)`` slots per expert.  Workloads and drops add up; the aux and
    z losses, per-chunk means over valid tokens, are weighted by each
    chunk's share of the valid tokens."""
    B, S, d = x.shape
    T = B * S
    n_chunks = -(-T // chunk)
    cap_c = -(-capacity // n_chunks) if capacity is not None else None
    xf = x.reshape(T, d)
    vmask = torch.arange(n_chunks * chunk, device=x.device) < T
    if valid is not None:
        vmask[:T] = valid
    ys, infos = [], []
    for c in range(n_chunks):
        lo, hi = c * chunk, min((c + 1) * chunk, T)
        xc = xf[lo:hi]
        if hi - lo < chunk:                    # ragged tail: pad + mask
            xc = torch.cat([xc, xc.new_zeros((chunk - (hi - lo), d))])
        y, info = apply_moe(params, xc[None], cfg, capacity=cap_c,
                            valid=vmask[c * chunk:(c + 1) * chunk], **kw)
        ys.append(y[0, :hi - lo])
        infos.append(info)
    n_valid = vmask.reshape(n_chunks, chunk).sum(1).float()
    w_chunk = n_valid / n_valid.sum().clamp(min=1)
    cat = lambda k: torch.cat([i[k] for i in infos])[:T]
    stack = lambda k: torch.stack([i[k] for i in infos])
    info = {
        "workload": stack("workload").sum(0).to(torch.int32),
        "topk_idx": cat("topk_idx"),
        "gates": cat("gates"),
        "probs": cat("probs"),
        "gate_in": xf,                 # the chunks' inputs, pad trimmed
        "aux_loss": (stack("aux_loss") * w_chunk).sum(),
        "z_loss": (stack("z_loss") * w_chunk).sum(),
        "dropped": stack("dropped").sum().to(torch.int32),
    }
    return torch.cat(ys).reshape(B, S, d), info


def apply_moe(params, x, cfg: ModelConfig, *,
              capacity: Optional[int] = None, valid=None,
              force_path: Optional[str] = None,
              force_exchange: Optional[str] = None,
              count_overlap: Optional[bool] = None,
              placement=None, demand_view: bool = False,
              slots=None, slot_fetch=None, slot_live=None,
              slot_phase: str = "decode"):
    """Returns (y, info) with DALI's routing observables (reference
    ``apply_moe``).

    Under active expert-parallel rules (``launch/sharding.py::rules``) a
    full-resident call without ``force_path`` or ``valid`` takes the EP
    path wherever ``moe_ep.ep_applicable`` holds (``models/moe_ep.py``);
    ``force_exchange``, ``count_overlap``, ``placement`` and
    ``demand_view`` are that path's controls, and the last two raise off
    it.  Decode-sized steps, single-rank runs and the slot-pool path keep
    the paths below.

    ``valid`` (T,) bool marks real tokens (None: all real): invalid tokens
    take no capacity slot, count toward no workload or aux loss, fetch no
    expert on the slot path, and their output rows are zero (plus the
    shared experts' output, which the chunked caller slices off).  Inputs
    of more than ``MOE_CHUNK_TOKENS`` tokens run chunk by chunk
    (``_apply_moe_chunked``).

    ``slots`` (one layer's ``ExpertStore.build_view`` entry) + ``slot_fetch``
    (the store) select the physical-offload slot-pool path; ``slot_live``
    (T,) bool keeps dead batch slots from counting as misses.
    ``slot_phase`` "decode" always takes the grouped path (a step's
    activated rows are few; more than a chunk of them raises); "prefill"
    keeps ``use_sparse_path``'s rule, so the offloaded sweep has the
    full-resident path's shapes, and chunks as full-resident execution
    does."""
    if force_path not in (None, "dense", "sparse"):
        raise ValueError(f"force_path must be None|'dense'|'sparse', "
                         f"got {force_path!r}")
    from repro_torch.launch.sharding import layout_active

    from .moe_ep import apply_moe_ep, ep_applicable
    if layout_active():
        if slots is not None or valid is not None or force_path is not None:
            raise NotImplementedError("the laid-out MoE layer runs the "
                                      "full-resident paths")
        return _moe_laid(params, x, cfg, capacity=capacity)
    m = cfg.moe
    B, S, d = x.shape
    T = B * S
    if (slots is None and force_path is None and valid is None
            and ep_applicable(cfg, B, S)):
        return apply_moe_ep(params, x, cfg, capacity=capacity,
                            force_exchange=force_exchange,
                            count_overlap=count_overlap,
                            placement=placement, demand_view=demand_view)
    if placement is not None or demand_view:
        raise ValueError("placement / demand_view are expert-parallel "
                         "re-route controls (models/moe_ep.py) and "
                         "require the EP path to be applicable")
    chunk = MOE_CHUNK_TOKENS
    if slots is not None and T > chunk and slot_phase != "prefill":
        raise ValueError("the slot-pool path serves decode-sized steps; "
                         f"{T} tokens exceed MOE_CHUNK_TOKENS "
                         "(prefill-sized inputs stream with "
                         "slot_phase='prefill')")
    if T > chunk:
        return _apply_moe_chunked(
            params, x, cfg, chunk, capacity=capacity, valid=valid,
            force_path=force_path, slots=slots, slot_fetch=slot_fetch,
            slot_phase=slot_phase)
    E, K = m.n_routed, m.top_k
    xf = x.reshape(T, d)
    # the spans' attributes: the store's layer id on the slot path
    at = {"phase": "decode" if S == 1 else "prefill"}
    if slots is not None:
        at["layer"] = slots["lid"]

    with span("moe.route", **at):
        gates, idx, probs, logits = route(params, xf, m)
    vrep = None if valid is None else valid.repeat_interleave(K)
    sparse = (force_path == "sparse" if force_path is not None
              else ((slots is not None and slot_phase == "decode")
                    or use_sparse_path(m, T, capacity)))
    if sparse:
        if slots is not None:
            # a prefill chunk's pad tokens take the dead-slot seam: they
            # never count as misses (their output rows are zeroed below)
            live = slot_live if slot_live is not None else \
                (valid if slot_phase == "prefill" else None)
            y = slot_expert_ffn(slots, slot_fetch, xf, idx, gates, cfg,
                                live=live, phase=at["phase"])
        else:
            with span("moe.k2", **at):
                y = grouped_expert_ffn(params, xf, idx, gates, cfg)
    else:
        C = capacity if capacity is not None else expert_capacity(m, T)
        with span("moe.dispatch", **at):
            xe, counts, se, rank, inv = local_dispatch(xf, idx, E, K, C,
                                                       valid_rep=vrep)
        host_need = None
        if slots is not None:
            ye, host_need = slot_expert_sweep(slots, slot_fetch, xe, counts,
                                              cfg, phase=at["phase"])
        else:
            with span("moe.k2", **at):
                ye = expert_ffn_dense(params, xe, cfg, counts=counts)
        with span("moe.combine", **at):
            keep_s = (rank < C) & (se < E)
            contrib = _bucket_rows(ye, se, rank, inv, keep_s)
        if host_need is not None and host_need.any():
            # the CPU tier at (token, k)-row granularity: host rows replace
            # their (zero) device contributions under the same drops;
            # invalid rows read as the virtual expert E, never needed
            key = idx.reshape(-1) if vrep is None else \
                torch.where(vrep, idx.reshape(-1), E)
            e_np = slot_fetch.read_misses(slots["lid"], key, prefill=True)
            host_hit = ~np.append(host_need, False)[e_np]
            ys_host = slot_fetch.prefill_host(slots["lid"], xf, e_np,
                                              host_hit)
            with span("moe.miss_upload", **at):
                ys_host = ys_host.to(x.device)
                host_miss = ~torch.from_numpy(host_hit).to(x.device)
            slot_fetch.count_sync(2)
            contrib = torch.where((host_miss & keep_s[inv])[:, None],
                                  ys_host.to(contrib.dtype), contrib)
    with span("moe.combine", **at):
        if sparse:
            counts = _workload_counts(idx.reshape(-1), E, vrep)
            if valid is not None:
                y = torch.where(valid[:, None], y, 0)
            dropped = torch.zeros((), dtype=torch.int32, device=x.device)
        else:
            y = _combine_topk(contrib, gates)
            dropped = ((se < E) & (rank >= C)).sum().to(torch.int32)
        y = y.to(x.dtype)
        if m.n_shared:
            y = y + apply_mlp(params["shared"], xf, cfg)

        lse2 = torch.logsumexp(logits, dim=-1) ** 2
        if valid is None:
            frac_tokens = counts.float() / (T * K)
            mean_prob = probs.mean(0)
            z_loss = lse2.mean()
        else:
            n_valid = valid.sum().clamp(min=1).float()
            frac_tokens = counts.float() / (n_valid * K)
            vf = valid.float()
            mean_prob = (probs * vf[:, None]).sum(0) / n_valid
            z_loss = (lse2 * vf).sum() / n_valid
        aux_loss = E * (frac_tokens * mean_prob).sum()
    info = {
        "workload": counts,                        # (E,) tokens per expert
        "topk_idx": idx,                           # (T, K)
        "gates": gates,                            # (T, K)
        "probs": probs,                            # (T, E) router scores
        "gate_in": xf,                             # (T, d) gate input
        "aux_loss": aux_loss * m.aux_loss_weight,
        "z_loss": z_loss * m.router_z_weight,
        "dropped": dropped,
    }
    return y.reshape(B, S, d), info


# --------------------------------------------------------------------------
# the laid-out layer (DTensor inputs under launch/sharding.py::rules)
# --------------------------------------------------------------------------

def _flat_tokens(*ts):
    """(B, S, ...) DTensors -> (B * S, ...) over the same mesh axes, each
    rank's block flattened in place (the global order is rank-major where
    the sequence is sharded too)."""
    from repro_torch.launch import layout as lay
    pls = [t.placements for t in ts]
    out = []
    for t, pl in zip(ts, pls):
        spec = lay.spec_from(pl, t.dim())
        axes = [a for a in spec[:2] if a is not None]
        flat = tuple(x for a in axes
                     for x in (a if isinstance(a, tuple) else (a,)))
        tok = None if not flat else flat[0] if len(flat) == 1 else flat
        out_pl = lay.place((tok,) + tuple(spec[2:]))
        out.append(lay.local_kernel(
            lambda t: t.reshape((-1,) + tuple(t.shape[2:])), [pl],
            out_pl)(t))
    return out


def _moe_laid(params, x, cfg: ModelConfig, *, capacity):
    """The MoE layer on the layout.  ``x`` (B, S, d) lies with the batch
    over the data axes and, in training, the sequence over 'model'.

    * K1 routes each rank's own tokens (``route``) inside
      ``local_kernel``; the per-expert counts, the router's mean
      probabilities and the z-loss terms are summed over the ranks in one
      reduction.
    * E >= 16 (``param_pspecs`` shards the experts over 'model'): where
      ``moe_ep.ep_applicable`` holds, the expert-parallel exchange of
      ``models/moe_ep.py`` on each rank's (B/dp, S/tp) block and its local
      stacks; otherwise (decode) each rank runs its own experts' buckets
      and its output is ``Partial`` over 'model'.
    * E < 16: the stacks' f dim lies over 'model'; K2 runs every expert on
      the rank's f slice, over the tokens of its data shard (gathered over
      'model' in training), and the output is ``Partial`` over 'model'.

    Drops are the single-device layer's: a token's rank within its expert
    counts the tokens of the data shards before its own."""
    from repro_torch.launch import layout as lay
    from repro_torch.launch.sharding import expert_parallel

    from .layers import apply_mlp
    from .moe_ep import apply_moe_ep, ep_applicable
    m = cfg.moe
    E, K = m.n_routed, m.top_k
    B, S, d = x.shape
    T = B * S
    xp = x.placements
    bspec = lay.spec_from(xp, 3)[:2]
    ep = expert_parallel(cfg)
    if ep and ep_applicable(cfg, B, S):
        blk = lay.place((bspec[0], "model", None))
        xb = x.redistribute(x.device_mesh, blk)
        # the shared experts whole over 'model' (each rank's own tokens
        # meet every hidden unit; the reference's shard_map in_specs,
        # moe_ep.py:279-286), still over 'data' under fsdp.  Every rank's
        # block of tokens differs, so a leaf replicated on a mesh dim (the
        # router; the shared experts over 'model'; the stacks over 'data'
        # under tp) takes a Partial gradient there, summed when settled
        # (the reference's shard_map transpose psums it)
        local = {k: (lay.local_of(v, blk) if lay.is_dtensor(v)
                     else {kk: lay.local_of(vv.redistribute(
                         vv.device_mesh,
                         lay.replicated_on(vv.placements, ("model",))), blk)
                         for kk, vv in v.items()})
                 for k, v in params.items()}
        yb, info = apply_moe_ep(local, xb.to_local(), cfg, capacity=capacity,
                                local=True)
        from torch.distributed.tensor import DTensor
        mesh = x.device_mesh
        y = DTensor.from_local(yb, mesh, blk, run_check=False)
        repl = lay.place(())
        b = bspec[0] if isinstance(bspec[0], tuple) else (bspec[0],)
        tok = lay.place((tuple(a for a in b if a) + ("model",), None))
        for k in ("topk_idx", "gates", "probs", "gate_in"):
            info[k] = DTensor.from_local(info[k], mesh, tok, run_check=False)
        for k in ("workload", "aux_loss", "z_loss", "dropped", "ep_cx"):
            info[k] = DTensor.from_local(info[k], mesh, repl,
                                         run_check=False)
        return y, info

    # -- routing on each rank's tokens (K1) ---------------------------------
    def rt(x, router):
        Bl, Sl = x.shape[:2]
        gates, idx, probs, logits = route({"router": router},
                                          x.reshape(-1, d), m)
        cnt = _bincount(idx.reshape(-1), E)
        stats = torch.cat([cnt.float(), probs.sum(0),
                           (torch.logsumexp(logits, dim=-1) ** 2).sum()[None]])
        tok = lambda t: t.reshape(Bl, Sl, -1)
        return (tok(gates), tok(idx), tok(probs), stats,
                cnt.reshape(1, 1, E))

    r3 = lay.place(tuple(bspec) + (None,))
    sums = lay.sums_of(xp)
    gates, idx, probs, stats, cnt_blk = lay.local_kernel(
        rt, [xp, lay.place((None, None))],
        (r3, r3, r3, sums, r3))(x, params["router"])
    stats = stats.redistribute(x.device_mesh, lay.place((None,)))
    counts = stats[:E]
    aux = E * ((counts / (T * K)) * (stats[E:2 * E] / T)).sum()
    z = stats[2 * E] / T

    # -- the experts on the rank's f slice or its own experts ---------------
    C = capacity if capacity is not None else expert_capacity(m, T)
    sparse = use_sparse_path(m, T, capacity)
    rows = lay.place((bspec[0], None, None))       # the data shard, whole
    need_off = not sparse and C < T
    e_loc = params["gate"].to_local().shape[0]
    e0 = lay.offset(params["gate"], 0) if e_loc != E else 0
    shard_i = lay.offset(x, 0) // max(x.to_local().shape[0], 1)
    has_shared = bool(m.n_shared)
    ws = [params["gate"], params["up"], params["down"]]
    if has_shared:
        ws += [params["shared"][k] for k in sorted(params["shared"])]

    def experts(x, gates, idx, *rest):
        if need_off:
            cnt_all, rest = rest[0], rest[1:]
        wg, wu, wd = rest[:3]
        Bl = x.shape[0]
        xf = x.reshape(-1, d)
        idx = idx.reshape(-1, K)
        gates = gates.reshape(-1, K)
        mine = dict(gate=wg, up=wu, down=wd)
        if sparse:
            y = grouped_expert_ffn(mine, xf, idx, gates, cfg, e0=e0)
            drop = torch.zeros((), dtype=torch.int32, device=x.device)
        else:
            # no expert holds more than the shard's tokens: its buckets are
            # at most that deep (the drops still go by the global rank)
            C_l = min(C, xf.shape[0])
            xe, cnt, se, rank, inv = local_dispatch(xf, idx, E, K, C_l)
            g_rank = rank
            if need_off:
                # tokens of the data shards before this one come first
                per_shard = cnt_all.sum(1).to(torch.long)     # (n_dp, E)
                off = per_shard[:shard_i].sum(0)
                off = torch.cat([off, off.new_zeros(1)])
                g_rank = rank + off[se]
            ye = expert_ffn_dense(mine, xe[e0:e0 + e_loc], cfg,
                                  counts=cnt[e0:e0 + e_loc])
            own = (se >= e0) & (se < e0 + e_loc)
            keep = (g_rank < C) & (se < E) & own
            y = _combine_topk(_bucket_rows(ye, se, rank, inv, keep, e0),
                              gates)
            # the data shard's drops, the same on every 'model' rank
            drop = ((se < E) & (g_rank >= C)).sum().to(torch.int32)
        y = y.to(x.dtype)
        if has_shared:
            sh = dict(zip(sorted(params["shared"]), rest[3:]))
            y = y + apply_mlp(sh, xf, cfg)
        return y.reshape(Bl, -1, d), drop

    ins = [x, gates, idx]
    in_pls = [rows, rows, rows]
    if need_off:
        ins.append(cnt_blk)
        in_pls.append(lay.place((None, None, None)))
    ins += ws
    in_pls += [lay.gathered_weight(w) for w in ws]
    y, drop = lay.local_kernel(
        experts, in_pls,
        (lay.place((bspec[0], None, None), partial=("model",)),
         lay.sums_of(rows)))(*ins)
    dropped = drop.redistribute(x.device_mesh, lay.place(()))
    tk_idx, tk_gates, tk_probs, tk_x = _flat_tokens(idx, gates, probs, x)
    info = {
        "workload": counts.to(torch.int32),
        "topk_idx": tk_idx,
        "gates": tk_gates,
        "probs": tk_probs,
        "gate_in": tk_x,
        "aux_loss": aux * m.aux_loss_weight,
        "z_loss": z * m.router_z_weight,
        "dropped": dropped,
    }
    return y, info
