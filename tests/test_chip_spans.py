"""``chip_spans.py``'s reading of a device trace with the program's spans,
on made-up events:

* ``label_gaps`` files every idle gap exactly where
  ``dali_bench/trace.py::reduce`` looks back only 256 spans, and gives
  that reduce's labels on traces of the benchmark's own nine spans;
* every span a served request opens has one kind (sync, launch, host);
* the readings (idle shares, policy ms a step) and the admission's idle
  seconds of a made-up window.
"""
import collections
import dataclasses
import pathlib
import sys

import numpy as np
import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import chip_spans  # noqa: E402
from dali_bench import trace  # noqa: E402


class Ev:
    def __init__(self, a, b, name="gemm"):
        self._a, self._b, self._n = a, b, name

    def name(self):
        return self._n

    def start_ns(self):
        return self._a

    def duration_ns(self):
        return self._b - self._a

    def device_type(self):
        return "DeviceType.CUDA"

    def is_user_annotation(self):
        return False


def _harness_trace(seed: int):
    """A made-up traced window with the benchmark's nine spans only: decode
    steps as the harness stamps them (``steps.decode`` around the store's
    seams, the pre-step, post-dispatch and next-target hooks beside it),
    admissions with their barrier and prefill waves, a few spans crossing
    one another, and device operations between them."""
    rng = np.random.default_rng(seed)
    names = [s[2] for s in trace.SPANS]
    spans, events, t = [], [], 0
    for _ in range(int(rng.integers(5, 40))):
        if rng.random() < 0.2:                    # an admission
            a = t
            spans.append((t, t + 5, "store.prefill_barrier"))
            t += 10
            for _ in range(int(rng.integers(0, 6))):
                spans.append((t, t + int(rng.integers(1, 30)),
                              "store.prefill_fetch"))
                t += int(rng.integers(10, 50))
            spans.append((a, t, "scheduler.admit+prefill"))
        spans.append((t, t + int(rng.integers(1, 20)), "store.pre_step"))
        t += 20
        a = t
        for _ in range(int(rng.integers(1, 28))):
            spans.append((t, t + int(rng.integers(1, 9)),
                          "store.read_misses"))
            t += int(rng.integers(9, 20))
            if rng.random() < 0.6:
                spans.append((t, t + int(rng.integers(1, 9)),
                              "store.fetch_weights"))
                t += int(rng.integers(9, 20))
        spans.append((a, t, "steps.decode"))
        spans.append((t, t + 3, "store.post_dispatch"))
        spans.append((t + 5, t + 12, "policy.next_target"))
        t += int(rng.integers(12, 40))
    for _ in range(int(rng.integers(0, 6))):      # crossing spans
        a = int(rng.integers(0, t))
        spans.append((a, a + int(rng.integers(1, 400)),
                      names[int(rng.integers(len(names)))]))
    at = 0
    while at < t:
        a = at + int(rng.integers(0, 12))
        b = a + int(rng.integers(1, 25))
        events.append(Ev(a, b))
        at = b
    return events, [spans[i] for i in rng.permutation(len(spans))], 0, t


@pytest.mark.parametrize("seed", range(12))
def test_labels_are_the_benchmarks_on_its_own_spans(seed):
    """At most ten labels (nine spans and "outside"), so ``reduce``'s top
    ten is its whole labelling."""
    events, spans, t0, t1 = _harness_trace(seed)
    idle = chip_spans.label_gaps(chip_spans.idle_gaps(events, t0, t1), spans)
    want = trace.reduce(events, spans, t0, t1)["breakdown"]["idle_gaps"]
    got = sorted(((k, v / 1e9) for k, v in idle.items()),
                 key=lambda kv: -kv[1])
    assert len(got) <= 10 and got == [tuple(kv) for kv in want]


def test_a_gap_past_256_closed_spans_is_its_open_spans():
    """A DeepSeek decode step holds some 400 of the program's spans: a gap
    that follows more than 256 closed children is their open parent's,
    where the benchmark's reduce, looking back 256 spans, files it outside
    every span."""
    events = [Ev(0, 10), Ev(3100, 3110)]
    spans = [(5, 6000, "scheduler.decode_step")]
    spans += [(1000 + 5 * i, 1000 + 5 * i + 1, "moe.k2_pool")
              for i in range(300)]
    gaps = chip_spans.idle_gaps(events, 0, 6000)
    assert gaps == [(10, 3100), (3110, 6000)]
    assert chip_spans.label_gaps(gaps, spans) == {
        "scheduler.decode_step": 3090 + 2890}
    old = dict(trace.reduce(events, spans, 0, 6000)["breakdown"]
               ["idle_gaps"])
    assert old == {"scheduler.decode_step": 3090 / 1e9,
                   chip_spans.OUTSIDE: 2890 / 1e9}


def test_every_span_of_a_serve_has_one_kind():
    import repro_torch.configs as tconfigs
    import repro_torch.models.model as tmodel
    from repro_torch import spans
    from repro_torch.serving.scheduler import Request
    from repro_torch.serving.spec import OffloadSpec, ServeSpec
    from repro_torch.serving.steps import default_dali_config
    kinds = [set(chip_spans.SYNC), set(chip_spans.LAUNCH),
             set(chip_spans.HOST)]
    assert sum(map(len, kinds)) == len(set().union(*kinds))
    assert set(chip_spans.POLICY) <= kinds[1]
    cfg = tconfigs.make_smoke(tconfigs.get_config("mixtral_8x7b"))
    cfg = cfg.replace(n_layers=2, moe=dataclasses.replace(cfg.moe,
                                                          n_routed=8))
    params = tmodel.init_model(cfg, seed=0, device="cpu", experts="host")
    names = collections.Counter()
    for server in ("continuous", "wave"):
        srv = ServeSpec(cfg=cfg, server=server, policy="dali",
                        dali_cfg=default_dali_config(cfg, cache_ratio=0.25),
                        batch_size=2, max_len=48, eos_id=-1,
                        offload=OffloadSpec(mode="pipelined"),
                        device="cpu").resolve(params).server()
        for i in range(3):
            srv.submit(Request(rid=i, max_new_tokens=3,
                               prompt=np.arange(2, 12 + i, dtype=np.int32)))
        spans.start()
        try:
            srv.run()
        finally:
            names.update(r[2] for r in spans.stop())
    assert names and set(names) <= set().union(*kinds), \
        set(names) - set().union(*kinds)


def test_readings_and_admission_idle_of_a_made_up_window():
    recs = [(0, 4_000_000, "scheduler.decode_step", -1, {"step": 0}),
            (100, 1_000_100, "policy.observe", 0, {}),
            (1_000_100, 3_000_100, "policy.step", 0, {}),
            (1_200_000, 1_300_000, "policy.assign", 2, {}),
            (5_000_000, 9_000_000, "scheduler.decode_step", -1, {"step": 1}),
            (5_000_000, 6_000_000, "policy.step", 4, {}),
            (9_500_000, 9_900_000, "scheduler.admit", -1, {"rid": 3})]
    idle = {"store.read_misses": 0.5, "scheduler.token_sync": 0.25,
            "moe.k2_pool": 1.0, "scheduler.decode_step": 0.5,
            "steps.decode": 2.0, chip_spans.OUTSIDE: 0.75}
    r = chip_spans.readings(idle, 10.0, recs, steps=2)
    assert r["idle_sync_share"] == pytest.approx(7.5)
    assert r["idle_launch_share"] == pytest.approx(15.0)
    # 1 + 2 + 1 ms of policy.observe and policy.step over 2 steps; the
    # child policy.assign lies inside policy.step's
    assert r["policy_ms"] == pytest.approx(2.0)
    assert r["spans_per_step"] == pytest.approx(3.5)
    gaps = [(9_400_000, 9_450_000), (9_600_000, 9_700_000),
            (9_900_000, 9_950_000)]
    assert chip_spans.admission_idle_ns(gaps, recs) == 100_000
