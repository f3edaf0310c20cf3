"""The port's kernel sources against the instrumentation that reports them.

``chip_smoke.py`` names every kernel of ``ray_tpu_torch/csrc`` to read its
registers, shared memory and spills from the build, and files profiled
kernels by kind to say where a step's device time goes; ``_build`` names
every library by a hash of its source and of the headers in ``csrc/``.
These tests hold each of those to the sources, on the CPU: a kernel added
or renamed, or a header included from outside ``csrc/``, must not drop out
of them.  The last ones hold ``chip_smoke.py``'s checks of the flash
forward and backward and of the paged decode to the faults they are there
to catch.
"""

from __future__ import annotations

import importlib.util
import pathlib
import re

import numpy as np
import pytest
import torch

from ray_tpu_torch.ops import _build
from ray_tpu_torch.ops import paged_attention as paged
from ray_tpu_torch.ops.attention import (_flash_bwd_plain, _scores,
                                         reference_attention)

REPO = pathlib.Path(__file__).resolve().parent.parent
_GLOBAL = re.compile(
    r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s+)?(\w+)\s*\(")
_INCLUDE = re.compile(r'^\s*#\s*include\s+([<"])([^>"]+)[>"]', re.M)


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _kernels(path: pathlib.Path):
    return _GLOBAL.findall(path.read_text())


def _own_kind(stem: str, kernel: str) -> str:
    """The kind a kernel of csrc/<stem>.cu is reported under: its source's,
    with flash_bwd.cu's two kernels and its test-only check told apart."""
    if stem == "flash_bwd":
        for kind in ("flash_bwd_dq", "flash_bwd_dkv"):
            if kernel.startswith(kind):
                return kind
        return "flash_bwd (test-only check)"
    return stem


@pytest.mark.parametrize("stem", _build.SOURCES)
def test_kernel_declarations_are_found(stem):
    """The pattern the tests below read kernels with finds them all."""
    path = _build.CSRC_DIR / f"{stem}.cu"
    found = _kernels(path)
    assert found and len(found) == path.read_text().count("__global__")


@pytest.mark.parametrize("stem", _build.SOURCES)
def test_every_kernel_is_named_in_chip_smoke(stem):
    names = _chip_smoke().KERNEL_NAMES
    for kernel in _kernels(_build.CSRC_DIR / f"{stem}.cu"):
        assert kernel in names, f"{stem}.cu: {kernel} not in KERNEL_NAMES"


@pytest.mark.parametrize("stem", _build.SOURCES)
def test_every_kernel_is_filed_under_its_own_kind(stem):
    """As the profiler names a kernel (demangled, with template arguments
    and parameter types), also when CUTLASS or CuTe types appear in it."""
    kind_of = _chip_smoke()._kernel_kind
    for kernel in _kernels(_build.CSRC_DIR / f"{stem}.cu"):
        want = _own_kind(stem, kernel)
        for shown in (
                f"void (anonymous namespace)::{kernel}<128>(Params)",
                f"void (anonymous namespace)::{kernel}<128>(CUtensorMap_st, "
                f"CUtensorMap_st, CUtensorMap_st, (anonymous namespace)::"
                f"Params)",
                f"void {kernel}<cutlass::bfloat16_t, cute::tuple<cute::C<"
                f"128>>>(cutlass::gemm::GemmCoord)"):
            assert kind_of(shown) == want, (shown, kind_of(shown), want)


@pytest.mark.parametrize("stem", _build.SOURCES)
def test_every_included_header_is_hashed(stem):
    """A quoted include names a .cuh in csrc/ itself, which library_path
    hashes into every library; anything else must come from the toolkit
    (<...>) so that no header outside csrc/ can change a kernel unseen."""
    text = (_build.CSRC_DIR / f"{stem}.cu").read_text()
    hashed = {p.name for p in _build.CSRC_DIR.glob("*.cuh")}
    for bracket, name in _INCLUDE.findall(text):
        if bracket == '"':
            assert "/" not in name and name in hashed, (
                f"{stem}.cu includes {name!r}, not a csrc/*.cuh")
        else:
            assert not (_build.CSRC_DIR / name).exists(), (
                f"{stem}.cu includes csrc/{name} as a system header")


@pytest.mark.parametrize("D", [64, 128])
def test_flash_fwd_check_sees_faults_on_long_rows(D):
    """bf16, causal, S 2048: an output rounded otherwise (the fp32 plain
    version cast to bf16) passes both of kernel_check's limits; each planted
    fault on the last query tile's rows fails the row-relative one, and the
    5% one would pass the absolute limit alone."""
    cs = _chip_smoke()
    gen = torch.Generator().manual_seed(D)
    q, k, v = (torch.randn(1, 2, 2048, D, generator=gen).bfloat16()
               for _ in range(3))
    ref = reference_attention(q, k, v, causal=True)
    clean = reference_attention(q.float(), k.float(), v.float(),
                                causal=True).bfloat16()
    assert (clean.float() - ref.float()).abs().max().item() \
        <= cs.TOL["bfloat16"]
    assert cs.row_rel_err(clean, ref) <= cs.TOL_ROW_REL["bfloat16"] / 2
    faults = cs.planted_fwd_faults(q, k, v, clean, ref)
    assert set(faults) == set(cs.PLANTED_FWD_FAULTS)
    for name, (_abs, rel) in faults.items():
        assert rel > 2 * cs.TOL_ROW_REL["bfloat16"], (name, rel)
    assert faults["rows_x1.05"][0] <= cs.TOL["bfloat16"]


@pytest.mark.parametrize("D", [64, 128])
def test_flash_bwd_check_sees_faults_on_edge_rows(D):
    """bf16, causal, S 2048: gradients rounded otherwise (the fp32 plain
    backward cast to bf16) pass both of kernel_check's limits; each planted
    fault on the edge tiles (the last key tile of dk/dv, the last query
    tile of dq) fails the row-relative one, and the 5% ones would pass the
    limit relative to the largest magnitude alone."""
    cs = _chip_smoke()
    gen = torch.Generator().manual_seed(100 + D)
    q, k, v, dout = (torch.randn(1, 2, 2048, D, generator=gen).bfloat16()
                     for _ in range(4))
    scale = D ** -0.5
    out = reference_attention(q, k, v, causal=True)
    lse = torch.logsumexp(_scores(q, k, True, scale, 0), dim=-1)
    ref = _flash_bwd_plain(q, k, v, out, lse, dout, True, scale, 0)
    clean = [g.bfloat16() for g in _flash_bwd_plain(
        q.float(), k.float(), v.float(), out.float(), lse, dout.float(), True,
        scale, 0)]
    for g, r in zip(clean, ref):
        assert cs._grad_errs(g, r)[1] <= cs.TOL_BWD["bfloat16"]
        assert cs.row_rel_err(g, r, cs.BWD_ROW_FLOOR) \
            <= cs.TOL_BWD_ROW_REL["bfloat16"] / 2
    faults = cs.planted_bwd_faults(clean, ref)
    assert set(faults) == set(cs.PLANTED_BWD_FAULTS)
    for name, (rel_max, rel_row) in faults.items():
        assert rel_row > 2 * cs.TOL_BWD_ROW_REL["bfloat16"], (name, rel_row)
        if "x1.05" in name:
            assert rel_max <= cs.TOL_BWD["bfloat16"], (name, rel_max)


@pytest.mark.parametrize("B,lens,P,splits", [
    (8, (256, 384), 24, 2),        # serving's lengths, 2 splits
    (1, (2048, 2048), 128, 32),    # long context, 32 splits
])
def test_paged_check_sees_faults(B, lens, P, splits):
    """bf16, H 16 / Hkv 8, D 128, page 16: the split-and-merge's output
    (another summation order) passes both of kernel_check's limits; each
    planted fault (the last split's partial dropped, the last page
    skipped) fails the row-relative one; at long context the page fault
    would pass the absolute limit alone."""
    cs = _chip_smoke()
    rng = np.random.default_rng(B)
    ln = rng.integers(lens[0], lens[1] + 1, size=B).tolist()
    NP = B * P + 1
    bt = rng.permutation(np.arange(1, NP))[:B * P].reshape(B, P)
    gen = torch.Generator().manual_seed(B)
    kv = torch.randn(NP, 16, 16, 128, generator=gen).bfloat16()
    q = torch.randn(B, 16, 128, generator=gen).bfloat16()
    bt = torch.from_numpy(bt.astype(np.int32))
    sl = torch.tensor(ln, dtype=torch.int32)
    ref = paged._exact_path(q, kv, bt, sl, 16)
    clean = paged._split_path(q, kv, bt, sl, 16, splits)
    tol, tol_row = cs.TOL["bfloat16"], cs.TOL_PAGED_ROW_REL["bfloat16"]
    assert (clean.float() - ref.float()).abs().max().item() <= tol
    assert cs.row_rel_err(clean, ref) <= tol_row / 2
    faults = cs.planted_paged_faults(q, kv, bt, sl, 16, clean, ref, splits)
    assert set(faults) == set(cs.PLANTED_PAGED_FAULTS)
    for name, (_abs, rel) in faults.items():
        assert rel > 2 * tol_row, (name, rel)
    if B == 1:
        assert faults["last_page_skipped"][0] <= tol, faults


def test_launch_struct_agrees_with_the_kernel():
    """paged_attention._Launch lays out the kernel's struct Launch: the
    same fields in the same order, a pointer and then ints and a float."""
    src = (_build.CSRC_DIR / "paged_decode.cu").read_text()
    body = re.search(r"struct Launch \{(.*?)\};", src, re.S).group(1)
    fields = []
    for decl in re.sub(r"//[^\n]*", "", body).split(";"):
        if decl.strip():
            kind, names = re.match(r"\s*(float\*|int|float)\s+(.*)",
                                   decl, re.S).groups()
            fields += [(kind, n.strip()) for n in names.split(",")]
    ctype = {"float*": "c_void_p", "int": "c_int", "float": "c_float"}
    assert [(n, ctype[k]) for k, n in fields] == [
        (n, t.__name__) for n, t in paged._Launch._fields_]


@pytest.mark.parametrize("name", ["MIN_PAGES_PER_SPLIT", "MAX_SPLITS"])
def test_split_constants_agree_with_the_kernel(name):
    """The split rule and _split_path use these; the kernel's own
    constants must be the same."""
    src = (_build.CSRC_DIR / "paged_decode.cu").read_text()
    m = re.search(rf"constexpr int {name} = (\d+);", src)
    assert m and int(m.group(1)) == getattr(paged, name)
