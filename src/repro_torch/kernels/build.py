"""Build and bind the port's CUDA kernels.

Every source under ``repro_torch/csrc/`` is compiled by ``nvcc`` for
``sm_90a`` (one process per source, all started together), linked into one
shared library with a plain C interface, and loaded through ``ctypes``.
The library lands in ``build/kernels/`` at the root of the checkout, named
by a hash of the sources and flags, so it is rebuilt exactly when a source
changes.  A failed build raises; nothing falls back to the plain versions.

Nothing here runs at import time: the CPU tests import every module of the
port on a machine without ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
SOURCES = ("gating.cu", "expert_ffn.cu", "flash_attention.cu", "noop.cu")
# included by the sources: part of the digest
HEADERS = ("hopper.cuh", "gating.cuh")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LOCK = threading.Lock()
_LIB = None
BUILD_INFO: dict = {}      # seconds, path and ptxas report of the last build

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_SIGNATURES = {
    # logits, gates, idx, probs, T, E, k, router_type, renormalize, variant,
    # width, stream
    "gating_launch": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P),
    # xe, wg, wu, wd, counts, expert_ids, h, y, G, E, C, d, f, act,
    # mw, ns_up, ns_down, stream
    "expert_ffn_launch": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                          _I, _I, _I, _I, _P),
    # q, k, v, o, B, Sq, Sk, Hq, Hkv, D, causal, window, softcap, scale, stream
    "flash_attention_launch": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
                               _F, _F, _P),
    # T, variant, stream (K1's launch shape, no work)
    "noop_launch": (_I, _I, _P),
}


def _nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None and Path("/usr/local/cuda/bin/nvcc").exists():
        path = "/usr/local/cuda/bin/nvcc"
    if path is None:
        raise RuntimeError("nvcc not found: the CUDA kernels are built with "
                           "the CUDA toolkit on the machine with the card")
    return path


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile (if needed) and return the path of the shared library."""
    out = BUILD_DIR / f"libkernels-{_digest()}.so"
    if out.exists():
        BUILD_INFO.setdefault("path", str(out))
        BUILD_INFO.setdefault("seconds", 0.0)
        return out
    nvcc = _nvcc()
    work = BUILD_DIR / f"tmp-{os.getpid()}"
    work.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    procs = []
    for name in SOURCES:
        obj = work / (Path(name).stem + ".o")
        procs.append((name, obj, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", str(CSRC / name), "-o", str(obj)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    reports, failed = [], []
    for name, obj, p in procs:
        log, _ = p.communicate()
        reports.append(f"== {name}\n{log}")
        if p.returncode != 0:
            failed.append(name)
    if failed:
        raise RuntimeError("nvcc failed on " + ", ".join(failed) + ":\n"
                           + "\n".join(reports))
    tmp = work / out.name
    link = subprocess.run([nvcc, "-shared", "-o", str(tmp),
                           *[str(obj) for _, obj, _ in procs]],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                          text=True)
    if link.returncode != 0:
        raise RuntimeError("linking the kernel library failed:\n" + link.stdout)
    os.replace(tmp, out)
    shutil.rmtree(work, ignore_errors=True)
    BUILD_INFO.update(path=str(out), seconds=time.perf_counter() - t0,
                      ptxas="\n".join(reports))
    return out


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(str(build()))
            for fn, argtypes in _SIGNATURES.items():
                getattr(lib, fn).argtypes = list(argtypes)
                getattr(lib, fn).restype = ctypes.c_int
            _LIB = lib
    return _LIB


def check(err: int, what: str):
    """Raise on a non-zero cudaError_t returned by a launch."""
    if err != 0:
        raise RuntimeError(f"{what} launch failed with cudaError_t {err}")
