"""The port's span recorder (``repro_torch.spans``) and its host-sync
counter on an offloaded serve of the smoke Mixtral (two layers, 8 experts,
float32, CPU, pipelined store) and of the smoke DeepSeek-V2-Lite (a dense
first layer, then MoE layers):

* off (the default), a serve records nothing and makes no span object;
* on, it serves the same tokens and the same store counters as off;
* the span tree: one ``scheduler.decode_step`` per decode step, holding
  one ``model.decode``, one ``policy.step`` and one ``store.read_misses``
  per MoE layer; parents enclose their children; ``rid`` and ``step``
  name the admissions and the steps in order;
* a tensor attribute raises;
* ``ServeMetrics.host_syncs`` plus the store's ``host_syncs`` equal the
  count of every sync site the serve ran times its waits, exactly.
"""
import collections
import dataclasses

import numpy as np
import pytest
import torch

import repro_torch.configs as tconfigs
import repro_torch.models.model as tmodel
from repro_torch import spans
from repro_torch.models.config import layer_pattern
from repro_torch.serving.scheduler import Request
from repro_torch.serving.spec import OffloadSpec, ServeSpec
from repro_torch.serving.steps import default_dali_config

ARCHS = ("mixtral_8x7b", "deepseek_v2_lite_16b")
PROMPTS = (10, 15, 20)
MAX_NEW = 5


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
    spans.stop()


@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    cfg = tconfigs.make_smoke(tconfigs.get_config(request.param))
    if request.param == "mixtral_8x7b":
        cfg = cfg.replace(n_layers=2,
                          moe=dataclasses.replace(cfg.moe, n_routed=8))
    return cfg, tmodel.init_model(cfg, seed=0, device="cpu", experts="host")


def _serve(model, on: bool, server: str = "continuous", patch=None):
    cfg, params = model
    rs = ServeSpec(cfg=cfg, server=server, policy="dali",
                   dali_cfg=default_dali_config(cfg, cache_ratio=0.25),
                   batch_size=2, max_len=64, eos_id=-1,
                   offload=OffloadSpec(mode="pipelined"),
                   device="cpu").resolve(params)
    srv = rs.server()
    if patch is not None:
        patch(srv)
    rng = np.random.default_rng(0)
    for i, n in enumerate(PROMPTS):
        srv.submit(Request(rid=100 + i, max_new_tokens=MAX_NEW,
                           prompt=rng.integers(2, cfg.vocab, n)
                           .astype(np.int32)))
    if on:
        spans.start()
    done = srv.run()
    recs = spans.stop() if on else None
    return ({r.rid: list(r.output) for r in done}, rs.store.stats(),
            srv.metrics, recs)


def test_off_records_nothing_and_makes_no_span(model, monkeypatch):
    _serve(model, False)                  # every site's object made once
    made = []

    class Counted(spans._Span):
        __slots__ = ()

        def __init__(self, *a):
            made.append(a)
            super().__init__(*a)

    monkeypatch.setattr(spans, "_Span", Counted)
    out = _serve(model, False)
    assert made == [] and spans._records == [] and out[3] is None
    assert spans.stop() == []


@pytest.mark.parametrize("server", ["continuous", "wave"])
def test_on_serves_the_same_tokens_and_counters(model, server):
    off = _serve(model, False, server)
    on = _serve(model, True, server)
    assert on[0] == off[0] and len(on[0]) == len(PROMPTS)
    assert on[1] == off[1]
    assert on[2].host_syncs == off[2].host_syncs
    assert on[3]


def _descendants(recs, i):
    """Indices of record ``i``'s descendants (records open in order, so
    they follow it)."""
    out, inside = [], {i}
    for j in range(i + 1, len(recs)):
        if recs[j][3] in inside:
            inside.add(j)
            out.append(j)
    return out


@pytest.mark.parametrize("server", ["continuous", "wave"])
def test_span_tree(model, server):
    cfg, _ = model
    n_moe = sum(1 for _, mlp in layer_pattern(cfg) if mlp == "moe")
    _, _, metrics, recs = _serve(model, True, server)
    for i, (a, b, name, parent, attrs) in enumerate(recs):
        assert a <= b and isinstance(attrs, dict)
        if parent >= 0:
            pa, pb = recs[parent][:2]
            assert parent < i and pa <= a and b <= pb, (name, i)
    steps = [i for i, r in enumerate(recs)
             if r[2] == "scheduler.decode_step"]
    assert len(steps) == metrics.steps > 0
    assert [recs[i][4]["step"] for i in steps] == list(range(len(steps)))
    assert all(recs[i][3] == -1 for i in steps)
    for i in steps:
        names = collections.Counter(recs[j][2] for j in _descendants(recs, i))
        assert names["model.decode"] == names["policy.step"] == 1
        assert names["store.read_misses"] == n_moe
        assert names["policy.next_target"] == 1
        assert names["scheduler.token_sync"] == 1
        assert names["model.layer"] == cfg.n_layers
    layers = [r for r in recs if r[2] == "model.layer"]
    assert {r[4]["phase"] for r in layers} == {"decode", "prefill"}
    # every MoE span names its layer and phase, and sits in a model.moe
    # span of a model.layer
    for i, r in enumerate(recs):
        if r[2].startswith("moe."):
            assert set(r[4]) == {"layer", "phase"}, r
            up = [r[3]]
            while up[-1] >= 0:
                up.append(recs[up[-1]][3])
            names = [recs[j][2] for j in up[:-1]]
            assert "model.moe" in names and "model.layer" in names, names
    admits = [r[4]["rid"] for r in recs if r[2] == "scheduler.admit"]
    if server == "continuous":
        assert admits == [100 + i for i in range(len(PROMPTS))]
        for i in (i for i, r in enumerate(recs)
                  if r[2] == "scheduler.admit"):
            names = collections.Counter(recs[j][2]
                                        for j in _descendants(recs, i))
            assert names["model.prefill"] == names["scheduler.first_token"] \
                == 1
            assert names["store.read_misses"] == n_moe
    else:
        assert admits == [100, 102]          # one per wave of two


def test_a_tensor_attribute_raises():
    spans.start()
    with pytest.raises(TypeError, match="not a host scalar"):
        with spans.span("model.layer", layer=torch.ones(())):
            pass
    with spans.span("model.layer", layer=np.int64(3), phase="decode"):
        pass
    recs = spans.stop()
    assert [r[2] for r in recs] == ["model.layer"]
    assert recs[0][4] == {"layer": 3, "phase": "decode"}


def test_the_decorator_spans_each_call():
    calls = []

    @spans.span("policy.step")
    def step(x):
        calls.append(x)
        return x + 1

    assert step(1) == 2                   # off: the function alone
    spans.start()
    with spans.span("scheduler.decode_step", step=0):
        assert step(2) == 3
    recs = spans.stop()
    assert calls == [1, 2]
    assert [(r[2], r[3]) for r in recs] == [("scheduler.decode_step", -1),
                                            ("policy.step", 0)]


def test_host_syncs_equal_the_sites_count(model):
    """Each sync site the serve ran, counted from its span (or, for the
    store's two uploads of its slot table and its copy-stream wait, from
    their calls), times the host waits it makes."""
    calls = collections.Counter()

    def patch(srv):
        store = srv.store
        for name in ("_set_dev_cur", "_sync_copies"):
            real = getattr(store, name)

            def counted(*a, _real=real, _name=name):
                calls[_name] += 1
                return _real(*a)
            setattr(store, name, counted)

    _, stats, metrics, recs = _serve(model, True, patch=patch)
    n = collections.Counter((r[2], r[4].get("phase")) for r in recs)
    flushes = -(-metrics.steps // 16)            # every 16th step and the end
    admits = n["scheduler.admit", None]
    scheduler = (n["scheduler.token_sync", None]
                 + n["scheduler.prompt_upload", None]
                 + 2 * admits                     # the slot's pos and flag
                 + n["scheduler.first_token", None]
                 + len(PROMPTS)                   # each retirement's flag
                 + 6 * flushes)                   # the accumulator's 6 reads
    store = (n["store.read_misses", None]
             + n["moe.miss_upload", "decode"]      # the staging rows
             + 2 * n["moe.miss_upload", "prefill"]  # a wave's ids and rows
             + n["policy.next_target", None]
             + 1                                  # the initial resident set
             + 2 * calls["_set_dev_cur"] + calls["_sync_copies"])
    assert metrics.host_syncs == scheduler
    assert stats["host_syncs"] == store
    assert n["scheduler.token_sync", None] == metrics.steps
    assert n["scheduler.slot_write", None] == admits + len(PROMPTS)
    assert n["store.read_misses", None] == \
        stats["miss_reads"] + stats["prefill_miss_reads"]
    assert 2 * n["moe.miss_upload", "prefill"] == 2 * stats["prefill_waves"]
