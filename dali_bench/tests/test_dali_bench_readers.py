"""Every metric of ``BENCHMARK.json`` has a reader, and the reader of the
program's host-sync counter reads a made-up run, reads None for a program
without the counter (the parent of the counter), and reads a traced run of
a tiny decode cell on the CPU."""
import types

import pytest

from dali_bench import harness
from dali_bench.tests import tiny

NAME = "host_syncs_per_step.decode"


def _entries():
    bench = tiny.bench()
    return [m for key in ("end_to_end", "per_layer") for m in bench[key]]


@pytest.mark.parametrize("name", [m["name"] for m in _entries()])
def test_every_metric_has_a_reader(name):
    assert callable(harness.reader(name))


def test_the_sync_counter_is_an_entry_of_both_decode_cells():
    got = {m["name"]: m for m in tiny.bench()["per_layer"]}[NAME]
    assert got["workloads"] == ["mixtral.off25.decode",
                                "deepseek.off25.decode"]
    assert got["moves"] == "decode_tok_s"
    assert got["source"] == "program_counter"


def _ctx(counters=True, steps=2):
    serve = types.SimpleNamespace(steps=steps)
    if counters:
        serve.host_syncs = 5
    return {"serve": serve, "trace": None,
            "store": {"host_syncs": 31} if counters else {"miss_reads": 3}}


def test_host_syncs_per_step_on_a_made_up_run():
    assert harness.reader(NAME)(_ctx()) == pytest.approx((5 + 31) / 2)


@pytest.mark.parametrize("ctx", [_ctx(counters=False), _ctx(steps=0),
                                 dict(_ctx(), store=None)])
def test_host_syncs_per_step_reads_nothing_without_its_counters(ctx):
    assert harness.reader(NAME)(ctx) is None


def test_a_traced_run_on_the_cpu_reads_the_sync_counter():
    """A traced run of a tiny decode cell on the CPU (no device trace
    there): the program's syncs per step are read, the device's idle share
    is not."""
    found = tiny.found(tiny.MIXTRAL, "mixtral.off25.decode")
    out = harness.run_cell(found, tiny.bench(), 2**31 + 7, 10, True,
                           device="cpu", log=lambda s: None)
    assert out["correct"]
    assert out["metrics"][NAME]["value"] > 2
    assert "device_idle_share.decode" not in out["metrics"]
