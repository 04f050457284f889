"""The Cell kernel's two walks (``cuda_src.cell_source``), on the CPU.

Every Cell CPlan of the six algorithms' main paths at full width takes the
vector walk (four-cell groups, one 16-byte load per bind, U groups in
flight); CPlans with an (m,1) side over more than one column, a column
slice, or a row / column aggregate keep the scalar walk.  The generated
``Prog`` constants are held to the ``KernelSource`` fields the wrapper
sizes its launch from, the sources stay independent of the row count m,
and, where ``g++`` is installed, every generated Cell source parses
against the stub of the CUDA declarations in ``tests/cuda_stub``.  The
kernels themselves run only on the card (``tests/test_torch_gpu.py``,
``chip_smoke.py``).
"""

import re
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.kernels import build, cellwise, cuda_src, ref, sweep

from torch_regions import chip_smoke

PATHS = ("l2svm", "mlogreg", "glm", "kmeans", "autoencoder")
STUB = Path(__file__).resolve().parent / "cuda_stub"
M_BIG = 10_000_000
CELL_CASES = [c for c in sweep.cases() if c.template == "cell"]


def _cell_cplans(path: str, m: int = M_BIG, n: int = 100):
    smoke = chip_smoke()
    if path == "l2svm":
        cps = smoke.main_path_cplans(m, n)
    else:
        (p,) = [p for p in smoke.algo_paths(m) if p.name == path]
        cps = smoke.path_cplans(p)
    return [(label, cp) for label, cp in cps
            if cuda_src.source_for(cp).template == "cell"]


def _case(name: str):
    return next(c for c in sweep.cases() if c.name == name)


def _consts(text: str) -> dict:
    """The integer constants of a generated ``struct Prog``."""
    out = {}
    for decl in re.findall(r"static constexpr int ([^;(]*);", text):
        for name, val in re.findall(r"(\w+) = (-?\d+)", decl):
            out[name] = int(val)
    return out


def _sweep_sources(case):
    shapes = [(33, 7), (33, 1), (33, 4), (2_000_003, 100)]
    return [cuda_src.source_for(sweep.fused_cplan(case, *s)[0])
            for s in shapes if s[1] >= case.min_n]


@pytest.mark.parametrize("path", PATHS)
def test_main_path_cell_cplans_take_the_vector_walk(path):
    cps = _cell_cplans(path)
    if path == "kmeans":                  # KMeans runs no Cell CPlan
        assert cps == []
        return
    assert cps
    for label, cp in cps:
        src = cuda_src.source_for(cp)
        assert cp.variant in ("no_agg", "full_agg"), label
        assert src.walk == "vector" and "WALK = 1" in src.text, label
        assert src.group == 4 and src.unroll in (2, 3, 4), label
        assert "vload(" in src.text and "veval(" in src.text


@pytest.mark.parametrize("name,shape", [
    ("cell/no_agg", (33, 7)), ("cell/no_agg", (2_000_003, 100)),
    ("cell/full_agg_sum", (2_000_003, 100)),
    ("cell/full_agg_abs_sum", (33, 7)),
    ("cell/idx_where", (33, 7)), ("cell/idx_where", (2_000_003, 100)),
    ("cell/row_agg_sum", (33, 1)), ("cell/row_agg_mean", (2_000_003, 100)),
    ("cell/col_agg_max", (33, 1)), ("cell/col_agg_sum", (2_000_003, 100)),
    ("cell/no_agg_row_side", (33, 7)),
    ("cell/full_agg_row_side", (33, 7))])
def test_other_cplans_keep_the_scalar_walk(name, shape):
    """An (m,1) side over N > 1, a column slice, row and column aggregates,
    and a (1,N) side with N % 4 != 0 keep the scalar walk."""
    src = cuda_src.source_for(sweep.fused_cplan(_case(name), *shape)[0])
    assert src.walk == "scalar" and "WALK = 0" in src.text
    assert (src.group, src.unroll) == (1, 1)
    assert "vload(" not in src.text


@pytest.mark.parametrize("name,shape", [
    ("cell/no_agg", (33, 1)), ("cell/full_agg_mean", (33, 1)),
    ("cell/magg_single", (2_000_003, 100)),
    ("cell/no_agg_row_side", (33, 4)),
    ("cell/no_agg_row_side", (2_000_003, 100)),
    ("cell/full_agg_row_side", (512, 784))])
def test_domain_shaped_and_row_sides_take_the_vector_walk(name, shape):
    """Binds of the domain's shape, (1,1) and (1,N) with N % 4 == 0: the
    vector walk, a (1,N) side loaded at its group's column."""
    cp = sweep.fused_cplan(_case(name), *shape)[0]
    src = cuda_src.source_for(cp)
    assert src.walk == "vector"
    k = _consts(src.text)
    assert k["NV"] == sum(tuple(b.shape) != (1, 1) for b in cp.binds)
    side = any(tuple(b.shape) == (1, shape[1]) and shape[0] > 1
               and shape[1] > 1 for b in cp.binds)
    assert (f"(int)(e % {shape[1]})" in src.text) == side


def _all_cell_sources():
    srcs = [s for c in CELL_CASES for s in _sweep_sources(c)]
    srcs += [cuda_src.source_for(cp) for p in PATHS
             for _l, cp in _cell_cplans(p)]
    return {s.key: s for s in srcs}.values()


def test_prog_constants_equal_the_source_fields():
    """Group width, U, threads, CTAs per SM, partials: what ``cell.cuh``
    reads from ``Prog`` is what ``cellwise.cell`` sizes the launch from."""
    for src in _all_cell_sources():
        k = _consts(src.text)
        assert k["WALK"] == int(src.walk == "vector")
        assert (k["G"], k["U"], k["T"], k["CTAS"], k["PARTS"]) == (
            src.group, src.unroll, src.threads, src.ctas, src.elems)
        assert src.parts_per_cta == int(src.elems > 0)
        assert k["T"] == 256 and k["N"] == src.domain[1]


@pytest.mark.parametrize("name,n", [
    ("cell/no_agg", 1), ("cell/full_agg_abs_sum", 1),
    ("cell/full_agg_abs_sum", 100), ("cell/col_agg_mean", 100),
    ("cell/no_agg_row_side", 100), ("cell/idx_where", 100)])
def test_cell_source_is_independent_of_m(name, n):
    case = _case(name)
    small = cuda_src.source_for(sweep.fused_cplan(case, 33, n)[0])
    big = cuda_src.source_for(sweep.fused_cplan(case, M_BIG, n)[0])
    assert small.text == big.text and small.key == big.key


@pytest.mark.parametrize("path", ("l2svm", "mlogreg", "glm", "autoencoder"))
def test_main_path_cell_sources_are_independent_of_m(path):
    a = [cuda_src.source_for(cp).text for _l, cp in _cell_cplans(path, 4099)]
    b = [cuda_src.source_for(cp).text for _l, cp in _cell_cplans(path)]
    if path in ("l2svm", "mlogreg"):       # their Cells are over w and B
        assert a == b
    else:
        assert a == b and len(a) >= 3


@pytest.mark.parametrize("name,m,n,ctas", [
    ("cell/no_agg", 100, 1, 1), ("cell/no_agg_row_side", 100, 4, 1),
    ("cell/no_agg_row_side", 512, 500, 125),
    ("cell/full_agg_row_side", 512, 784, 196),
    ("cell/no_agg", M_BIG, 1, 132 * 4)])
def test_launch_grid_is_persistent_and_no_larger_than_the_work(name, m, n,
                                                               ctas):
    """At most the SM count times CTAS, no more CTAs than steps of
    4 U threads cells: a (100,1) domain runs one CTA."""
    src = cuda_src.source_for(sweep.fused_cplan(_case(name), m, n)[0])
    assert src.walk == "vector"
    step = src.group * src.unroll * src.threads
    assert cellwise.grid(src, m, 132) == ctas == min(-(-m * n // step),
                                                     132 * src.ctas)


def test_misaligned_vector_operand_raises():
    """The vector walk reads float4: an operand 4 bytes off a 16-byte
    boundary is refused, a (1,1) bind is read as a scalar and may lie
    anywhere, and the scalar walk takes any address."""
    case = _case("cell/no_agg_row_side")
    cp = sweep.fused_cplan(case, 64, 4)[0]
    src = cuda_src.source_for(cp)
    binds = [torch.zeros(tuple(b.shape)) for b in cp.binds]
    cellwise.check_alignment(src, binds)
    for k, b in enumerate(cp.binds):
        shifted = list(binds)
        flat = torch.zeros(int(np.prod(b.shape)) + 1)
        shifted[k] = flat[1:].view(tuple(b.shape))
        assert shifted[k].data_ptr() % 16
        with pytest.raises(ValueError, match="16-byte"):
            cellwise.check_alignment(src, shifted)
    scal = cuda_src.source_for(sweep.fused_cplan(case, 64, 7)[0])
    odd = [torch.zeros(int(np.prod(b.shape)) + 1)[1:].view(tuple(b.shape))
           for b in sweep.fused_cplan(case, 64, 7)[0].binds]
    cellwise.check_alignment(scal, odd)


@pytest.mark.parametrize("name", ["cell/no_agg", "cell/full_agg_abs_sum",
                                  "cell/no_agg_row_side"])
def test_with_rows_is_the_plan_at_that_row_count(name):
    """``sweep.with_rows`` (the card checks' way to one cell) gives the
    CPlan the planner builds at that row count, and the same source."""
    case = _case(name)
    n = 4 if "row_side" in name else 1
    cp33 = sweep.fused_cplan(case, 33, n)[0]
    rng = np.random.default_rng(3)
    for m in (3, 5, 7, 1023):
        want = sweep.fused_cplan(case, m, n)[0]
        got = sweep.with_rows(cp33, m)
        assert [tuple(b.shape) for b in got.binds] == \
            [tuple(b.shape) for b in want.binds]
        assert tuple(got.out_shape) == tuple(want.out_shape)
        assert cuda_src.source_for(got).text == \
            cuda_src.source_for(want).text
    one = sweep.with_rows(cp33, 1)
    env = {b.nid: torch.tensor(rng.normal(size=tuple(b.shape)),
                               dtype=torch.float32) for b in one.binds}
    out = ref.execute_dense(one, env)
    assert tuple(out.shape) == tuple(one.out_shape)
    if one.variant == "no_agg":
        assert tuple(out.shape) == (1, n)


def test_reductions_launch_once_and_fold_in_the_kernel():
    """No second pass: the Cell skeleton folds its partials itself (an
    integer ticket, no float atomics), names its kernels after Cell, and
    keeps the planted faults of the fold and of the vector groups."""
    text = (build.CSRC / "cell.cuh").read_text()
    code = "\n".join(ln.split("//")[0] for ln in text.splitlines())
    assert "rk::combine" not in code and "magg_scan" not in code
    assert '#include "magg.cuh"' not in text
    assert re.findall(r"atomicAdd\((\w+)", code) == ["ticket"]
    assert "unsigned* ticket" in code
    for kernel in ("cell_no_agg", "cell_full_agg", "cell_row_agg",
                   "cell_col_agg"):
        assert re.search(rf"__global__ void[^;{{]*\n{kernel}\(", text)
    assert code.count("<<<") == 4
    assert "#ifdef RK_PLANTED_FAULT" in text
    assert "#ifdef RK_PLANTED_GROUP" in text


def test_planted_group_fault_is_only_in_vector_builds():
    smoke = chip_smoke()
    vec = cuda_src.source_for(sweep.fused_cplan(
        _case("cell/full_agg_row_side"), 33, 4)[0])
    bad = smoke.planted(vec, group=True)
    assert bad.text == smoke.PLANT_GROUP + vec.text and bad.key != vec.key
    assert "RK_PLANTED_GROUP" not in vec.text
    scal = cuda_src.source_for(sweep.fused_cplan(
        _case("cell/full_agg_row_side"), 33, 7)[0])
    assert smoke.planted(scal, group=True) is scal
    assert set(smoke.PLANTED_GROUP) <= {c.name for c in CELL_CASES}
    for name in smoke.PLANTED_GROUP:
        src = cuda_src.source_for(sweep.fused_cplan(
            _case(name), 2_000_003, 100)[0])
        assert src.walk == "vector"


def _gxx():
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to parse the generated sources")
    return gxx


def _parse(sources, tmp_path):
    """``g++ -fsyntax-only`` of each source against the CUDA stub, with
    the skeleton headers' launches rewritten to plain calls; returns
    [(key, return code, compiler output)]."""
    gxx = _gxx()
    for h in build.CSRC.glob("*.cuh"):
        (tmp_path / h.name).write_text(
            re.sub(r"<<<.*?>>>", "", h.read_text(), flags=re.S))
    out = []
    for src in sources:
        f = tmp_path / f"{src.key}.cpp"
        f.write_text(src.text)
        r = subprocess.run([gxx, "-std=c++17", "-fsyntax-only", "-I",
                            str(tmp_path), "-I", str(STUB), str(f)],
                           capture_output=True, text=True, timeout=120)
        out.append((src.key, r.returncode, r.stderr[-2000:]))
    return out


@pytest.mark.parametrize("case", [pytest.param(c, id=c.name)
                                  for c in CELL_CASES])
def test_sweep_cell_sources_parse(case, tmp_path):
    srcs = {s.key: s for s in _sweep_sources(case)}.values()
    for key, rc, err in _parse(srcs, tmp_path):
        assert rc == 0, f"{case.name} {key}:\n{err}"


@pytest.mark.parametrize("path", ("l2svm", "mlogreg", "glm", "autoencoder"))
def test_main_path_cell_sources_parse(path, tmp_path):
    smoke = chip_smoke()
    srcs = [cuda_src.source_for(cp) for _l, cp in _cell_cplans(path)]
    srcs += [smoke.planted(s) for s in srcs]
    srcs += [smoke.planted(s, group=True) for s in srcs]
    for key, rc, err in _parse({s.key: s for s in srcs}.values(), tmp_path):
        assert rc == 0, f"{path} {key}:\n{err}"


def test_the_parse_check_rejects_a_broken_source(tmp_path):
    """The stub check is live: a source that calls what ``Prog`` lacks
    fails it."""
    src = cuda_src.source_for(sweep.fused_cplan(_case("cell/no_agg"),
                                                33, 1)[0])
    broken = src.text.replace("void vload(", "void vload_renamed(")
    assert broken != src.text
    import dataclasses
    (key, rc, _err), = _parse([dataclasses.replace(src, text=broken)],
                              tmp_path)
    assert rc != 0
