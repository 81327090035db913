"""CPU checks of what surrounds the port's CUDA kernels: the expert FFN's
tile plan, the router's variant rule, the profile's attribution of every
kernel, and the ctypes bindings against the C entry points.  No card, no
nvcc, no JAX."""
import re
import sys
from pathlib import Path

import pytest

from repro_torch.kernels import build
from repro_torch.kernels.expert_ffn.ops import plan
from repro_torch.kernels.gating import ops as gating_ops

ROOT = Path(__file__).resolve().parents[1]
CSRC = ROOT / "src" / "repro_torch" / "csrc"


def _chip_smoke():
    sys.path.insert(0, str(ROOT))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(ROOT))
    return chip_smoke


def _sources():
    return {p.name: p.read_text() for p in sorted(CSRC.glob("*.cu"))}


def test_every_global_kernel_is_booked_by_the_profile():
    """The profile window books device time by kernel name; a kernel that
    no KERNEL_GROUPS entry matches would land under "other"."""
    groups = _chip_smoke().KERNEL_GROUPS
    names = []
    for text in _sources().values():
        names += re.findall(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*"
                            r"\)\s*)?(\w+)\s*\(", text)
    assert len(names) >= 4
    for name in names:
        hits = [g for g, keys in groups if any(k in name for k in keys)]
        assert hits[:1] and hits[0].startswith("K"), (name, hits)


def test_ctypes_signatures_match_the_c_entry_points():
    decls = {}
    for text in _sources().values():
        for name, args in re.findall(r'extern "C" int (\w+)\(([^)]*)\)', text):
            decls[name] = len([a for a in args.split(",") if a.strip()])
    assert decls.keys() == build._SIGNATURES.keys()
    for name, n in decls.items():
        assert len(build._SIGNATURES[name]) == n, name


def test_build_digest_covers_every_included_header():
    for text in _sources().values():
        for inc in re.findall(r'#include "([^"]+)"', text):
            assert inc in build.HEADERS
            assert (CSRC / inc).exists()
    assert set(build.SOURCES) == set(_sources())


@pytest.mark.parametrize("C,d,f,want", [
    (1, 4096, 14336, (1, 2, 2)),      # sparse decode path, grouped
    (4, 4096, 14336, (1, 2, 2)),      # decode batch on the capacity sweep
    (12, 4096, 14336, (1, 2, 2)),     # admission buckets S = 32 .. 256
    (20, 4096, 14336, (1, 2, 2)),
    (40, 4096, 14336, (1, 2, 2)),
    (64, 4096, 14336, (1, 2, 2)),
    (80, 4096, 14336, (2, 2, 2)),
    (150, 128, 192, (2, 1, 2)),       # f not a multiple of 128
    (65, 192, 256, (2, 2, 1)),        # d not a multiple of 128
    (16, 64, 64, (1, 1, 1)),
])
def test_expert_ffn_plan_by_shape(C, d, f, want):
    assert plan(C, d, f) == want


@pytest.mark.parametrize("C", [1, 16, 64, 65, 128, 129, 300])
@pytest.mark.parametrize("d,f", [(64, 64), (128, 192), (4096, 14336),
                                 (320, 448)])
def test_expert_ffn_plan_tiles_divide_every_accepted_shape(C, d, f):
    """Every d, f the wrapper accepts (multiples of 64) gets N tiles that
    divide them, within the kernel's instantiations."""
    mw, ns_up, ns_down = plan(C, d, f)
    assert mw in (1, 2) and ns_up in (1, 2) and ns_down in (1, 2)
    assert f % (64 * ns_up) == 0 and d % (64 * ns_down) == 0
    assert (mw == 1) == (C <= 64)


@pytest.mark.parametrize("k", range(1, 17))
def test_gating_plan_for_every_E(k):
    """Every E in k..256: the row variant with the narrowest padded width
    that holds the row up to E = 32, the warp variant with ceil(E/32)
    columns per lane above."""
    for E in range(k, 257):
        variant, width = gating_ops.plan(E, k)
        if E <= 32:
            assert variant == "row" and width in (8, 16, 32), (E, k)
            assert E <= width and (width == 8 or E > width // 2), (E, k)
        else:
            assert variant == "warp", (E, k)
            assert width == (E + 31) // 32 and 2 <= width <= 8, (E, k)


@pytest.mark.parametrize("E,k", [(0, 1), (257, 1), (8, 0), (8, 9), (4, 5),
                                 (64, 17), (256, 17)])
def test_gating_plan_refuses_what_no_variant_takes(E, k):
    with pytest.raises(ValueError):
        gating_ops.plan(E, k)


def test_gating_variants_and_widths_match_the_c_side():
    """The variant ids are csrc/gating.cuh's, every row width the plan
    gives is a case of gating_launch, and each variant has its own launch
    counter."""
    header = (CSRC / "gating.cuh").read_text()
    enum = dict(re.findall(r"k(Row|Warp)Variant = (\d+)", header))
    assert {k.lower(): int(v) for k, v in enum.items()} == gating_ops.VARIANTS
    cases = re.findall(r"case (\d+): return launch_row_width<(\d+)>",
                       _sources()["gating.cu"])
    assert [int(a) for a, b in cases if a == b] == list(gating_ops.ROW_WIDTHS)
    from repro_torch import kernels
    assert set(gating_ops.LAUNCH_KEY.values()) <= set(kernels.LAUNCHES)
    assert set(gating_ops.LAUNCH_KEY) == set(gating_ops.VARIANTS)
