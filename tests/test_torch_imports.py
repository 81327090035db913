"""The port stands alone: importing every module of ``repro_torch`` loads
neither JAX nor any module of the JAX package ``repro``."""
import os
import pathlib
import re
import subprocess
import sys

import pytest

SRC = pathlib.Path(__file__).resolve().parents[1] / "src"
PKG = SRC / "repro_torch"


def _modules():
    out = []
    for p in sorted(PKG.rglob("*.py")):
        rel = p.relative_to(SRC).with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__init__":
            parts = parts[:-1]
        out.append(".".join(parts))
    return out


def test_importing_every_module_loads_no_jax_and_no_repro():
    code = (
        "import importlib, sys\n"
        f"for m in {_modules()!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' "
        "or m.startswith('jax.') or m == 'repro' or m.startswith('repro.'))\n"
        "print('LOADED', bad)\n"
        "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(SRC))
    r = subprocess.run([sys.executable, "-c", code], env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "LOADED []" in r.stdout


@pytest.mark.parametrize("pattern", [
    r"^\s*(import|from)\s+jax\b",
    r"^\s*(import|from)\s+repro(\.|\s|$)",
    r"^(import|from)\s+triton\b",
])
def test_sources_never_import_jax_repro_or_module_level_triton(pattern):
    rx = re.compile(pattern)
    bad = []
    for p in PKG.rglob("*.py"):
        for i, line in enumerate(p.read_text().splitlines(), 1):
            if rx.match(line):
                bad.append(f"{p.relative_to(SRC)}:{i}: {line.strip()}")
    assert not bad, bad


def test_chip_smoke_imports_no_jax_and_no_repro():
    text = (SRC.parent / "chip_smoke.py").read_text()
    assert not re.search(r"^\s*(import|from)\s+(jax|repro)(\.|\s|$)", text,
                         re.M)
