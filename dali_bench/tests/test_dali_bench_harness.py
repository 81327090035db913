"""A whole run of the harness on the CPU at a small size (everything but
the look for a card): sound runs are correct, the float8 control and each
fault the cells can have are not, and a cell, a configuration and a metric
are found by name from files and ``BENCHMARK.json`` entries."""
import json
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from dali_bench import harness
from dali_bench.tests import tiny

SEED = 2**31 + 101
ROOT = Path(__file__).resolve().parents[2]


def _stats():
    """The logit statistics the benchmark's cells compare, in any cell."""
    return sorted({k for cell in (ROOT / "dali_bench" / "cells").glob("*.json")
                   for k in harness.load_json(cell)["check"]
                   if k.startswith("logit_err")})


def _check(limit=1e-4):
    return dict({"sample": 99, "not_argmax": 0},
                **{k: limit for k in _stats()})


CELLS = {
    "mixtral-decode": (tiny.MIXTRAL, "mixtral.off25.decode", "pipelined",
                       2, None),
    "deepseek-decode": (tiny.DEEPSEEK, "deepseek.off25.decode", "pipelined",
                        2, None),
    "mixtral-prefill-resident": (tiny.MIXTRAL, "mixtral.resident.prefill",
                                 "modeled", 1, tiny.DOCS),
}


def _run(name, patch=None, control=False, trace=False, seed=SEED):
    cfg, workload, offload, slots, traffic = CELLS[name]
    found = tiny.found(cfg, workload, offload=offload, slots=slots,
                       traffic=traffic, check=_check())
    lines = []
    out = harness.run_cell(found, tiny.bench(), seed, 10, trace,
                           device="cpu", log=lines.append, patch=patch,
                           control=control)
    return out, lines


@pytest.mark.parametrize("name", sorted(CELLS))
def test_sound_run_is_correct(name):
    out, _ = _run(name)
    assert out["correct"] and out["failed"] == 0
    assert list(out)[-1] == "checks"
    assert all(out["checks"][k]["value"] < 1e-5 for k in _stats())
    assert out["checks"]["not_argmax"]["value"] == 0
    want = {m["name"] for m in harness.metrics_of(
        tiny.bench(), CELLS[name][1], False)}
    assert set(out["metrics"]) == want
    assert all(v["value"] > 0 for v in out["metrics"].values())


@pytest.mark.parametrize("name", sorted(CELLS))
def test_float8_control_is_not_correct(name):
    """The control, the reference computed in float8 e4m3 in the program's
    place, reads far above the limit the program passes."""
    out, lines = _run(name, control=True)
    ctl = json.loads(next(ln for ln in lines
                          if ln.startswith("control")).split(": ", 1)[1])
    assert out["correct"]
    assert all(ctl[k] > 100 * out["checks"][k]["limit"] for k in _stats())


def _decode_fault(kind):
    """A fault planted in the server's decode step (``patch``)."""
    def patch(objects):
        server = objects["server"]
        real = server._decode
        calls = {"n": 0}

        class Faulty:
            def __call__(self, params, state, res_vecs):
                old = {k: (v.clone() if torch.is_tensor(v) else v)
                       for k, v in state.items() if k in ("tokens", "pos")}
                new, logits, tel = real(params, state, res_vecs)
                calls["n"] += 1
                if kind == "state_unchanged":
                    return dict(new, **old), logits, tel
                if kind == "half_batch":
                    h = new["tokens"].shape[0] // 2
                    new["tokens"][h:] = old["tokens"][h:]
                    logits = logits.clone()
                    logits[h:] = 0
                    return new, logits, tel
                if kind == "token_altered" and calls["n"] == 3:
                    new["tokens"][0] = (new["tokens"][0] + 1) % logits.shape[-1]
                return new, logits, tel

            def __getattr__(self, name):
                return getattr(real, name)
        server._decode = Faulty()
    return patch


def _prefill_fault(objects):
    """The admission prefill's token altered where it is produced."""
    server = objects["server"]
    real = server._prefill

    def prefill(*a, **kw):
        tok, caches = real(*a, **kw)
        return (tok + 1) % server.cfg.vocab, caches
    server._prefill = prefill


@pytest.mark.parametrize("name,fault", [
    ("mixtral-decode", "state_unchanged"),
    ("mixtral-decode", "half_batch"),
    ("mixtral-decode", "token_altered"),
    ("deepseek-decode", "state_unchanged"),
    ("deepseek-decode", "half_batch"),
    ("deepseek-decode", "token_altered"),
    ("mixtral-prefill-resident", "token_altered"),
])
def test_each_fault_is_not_correct(name, fault):
    """A step that returns its state unchanged, half of the slot table
    left out, a token altered where it is produced.  (One card: there is
    no exchange between cards to leave out; the prefill cells run no
    decode step and serve one slot.)"""
    patch = _prefill_fault if "prefill" in name else _decode_fault(fault)
    out, _ = _run(name, patch=patch)
    assert not out["correct"]


def _longest_only(objects, fault):
    """A fault that touches only the request with the longest prompt, and
    leaves every served token the greedy choice of the logits kept for it:
    ``cache``, its slot's cache scaled once the admission prefill has
    written it (the decode steps read it); ``attention``, its admission
    prefill's attention scaled."""
    from repro_torch.models import attention
    server = objects["server"]
    longest = max(len(r.prompt) for r in objects["requests"])
    if fault == "cache":
        real = server._admit

        def admit(state, fresh, first_tok, slot, L):
            if L == longest:
                for c in list(fresh["prefix"]) + list(fresh["scan"]):
                    for k, v in c.items():
                        if k != "pos" and torch.is_tensor(v) \
                                and v.is_floating_point():
                            v.mul_(1.5)
            return real(state, fresh, first_tok, slot, L)
        server._admit = admit
        return
    real_prefill, real_attn = server._prefill, attention.flash_attention

    def prefill(params, toks, fresh, L, off):
        if L == longest:
            attention.flash_attention = \
                lambda *a, **kw: 1.5 * real_attn(*a, **kw)
        try:
            return real_prefill(params, toks, fresh, L, off)
        finally:
            attention.flash_attention = real_attn
    server._prefill = prefill


@pytest.mark.parametrize("name,fault", [
    ("deepseek-decode", "cache"),
    ("deepseek-decode", "attention"),
    ("mixtral-decode", "cache"),
    ("mixtral-decode", "attention"),
    ("mixtral-prefill-resident", "attention"),
])
def test_a_fault_in_one_request_is_not_correct(name, fault):
    """A fault in one slot's cache, or in the longest prompt's attention
    alone: its logits stay self-consistent (no served token leaves the
    argmax) and the median over all tokens stays under its limit, but the
    worst request's median does not.  (Of the benchmark's cells only
    DeepSeek's compares it: in Mixtral's a bf16 routing flip in one prompt
    moves that whole request as far as the float8 control does; PERF.md
    has the readings.)"""
    out, _ = _run(name, patch=lambda o: _longest_only(o, fault))
    c = out["checks"]
    assert c["not_argmax"]["value"] == 0
    assert c["logit_err.median"]["value"] <= c["logit_err.median"]["limit"]
    assert c["logit_err.worst_request"]["value"] > \
        100 * c["logit_err.worst_request"]["limit"]
    assert not out["correct"]


def test_cell_config_and_metric_found_by_name(tmp_path):
    """A new configuration, traffic, cell and per-layer metric are files
    plus ``BENCHMARK.json`` entries; the harness finds them by name."""
    bench_dir = tmp_path / "dali_bench"
    shutil.copytree(ROOT / "dali_bench", bench_dir,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    (bench_dir / "configs" / "tiny.l2.json").write_text(
        json.dumps(tiny.MIXTRAL))
    (bench_dir / "traffic" / "tiny.chat.json").write_text(
        json.dumps(tiny.CHAT))
    (bench_dir / "cells" / "tiny.cell.json").write_text(json.dumps(
        {"offload": "pipelined", "fallback": "fetch", "cache_ratio": 0.5,
         "policy": "dali", "slots": 2, "requests_per_s": 0.5,
         "check": _check()}))
    (bench_dir / "metrics" / "dummy_steps.decode.py").write_text(
        "def read(ctx):\n    return float(ctx['serve'].steps)\n")
    bench = tiny.bench()
    bench["configs"].append({"name": "tiny.l2", "source": "tests",
                             "file": "dali_bench/configs/tiny.l2.json",
                             "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": "tiny.cell", "config": "tiny.l2",
                               "traffic": "tiny.chat", "chips": 1,
                               "why": "a test"})
    bench["per_layer"].append({"name": "dummy_steps.decode", "unit": "steps",
                               "better": "lower", "source": "program_counter",
                               "layer": "scheduler", "moves": "decode_tok_s",
                               "workloads": ["tiny.cell"]})
    found = harness.find_cell(bench, "tiny.cell", root=tmp_path)
    out = harness.run_cell(found, bench, SEED, 10, True, device="cpu",
                           log=lambda s: None)
    assert out["correct"]
    assert out["metrics"]["dummy_steps.decode"]["value"] > 0
    assert "step_ms.decode" not in out["metrics"]


def _bench_files(dst: Path):
    shutil.copy(ROOT / "BENCHMARK.json", dst / "BENCHMARK.json")
    shutil.copytree(ROOT / "dali_bench", dst / "dali_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))


@pytest.mark.parametrize("where", ["checkout", "benchmark_files_only"])
def test_run_fails_without_a_card(tmp_path, where):
    """No card (and, with only the benchmark's files, no program either):
    exit code not 0, and no result line."""
    cwd = ROOT
    if where == "benchmark_files_only":
        _bench_files(tmp_path)
        cwd = tmp_path
    r = subprocess.run([sys.executable, "dali_bench/run.py", "--workload",
                        "mixtral.off25.decode", "--seed", "1", "--seconds",
                        "1", "--trace", "0"], cwd=cwd, capture_output=True,
                       text=True, timeout=300,
                       env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": ""})
    assert r.returncode != 0
    assert not any(ln.startswith("{") for ln in r.stdout.splitlines())


@pytest.mark.gpu
def test_tiny_cells_on_the_card():
    """The tiny cells through the card's kernels in bf16: correct, and the
    control reads above the program."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    card = {"mixtral": tiny.MIXTRAL_CARD, "deepseek": tiny.DEEPSEEK_CARD}
    for name in sorted(CELLS):
        _, workload, offload, slots, traffic = CELLS[name]
        found = tiny.found(card[name.split("-")[0]], workload,
                           offload=offload, slots=slots, traffic=traffic,
                           check=_check(limit=0.1))
        out = harness.run_cell(found, tiny.bench(), SEED, 10, False,
                               device="cuda", log=lambda s: None)
        assert out["correct"], (name, out["checks"])
