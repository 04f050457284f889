"""The Row kernel's two layouts (``cuda_src.row_source``), on the CPU.

Every Row CPlan of the six algorithms' main paths at full width takes the
tile layout (a thread per row over tiles of rows in shared memory) with a
shared-memory sum that two CTAs of an SM can hold; programs with wide
computed values keep the warp layout.  The generated ``Prog`` constants
are held to an independent sum written here the way ``csrc/row.cuh``
writes its ``static_assert``s, and the sources stay independent of the
row count m.  The kernels themselves run only on the card
(``tests/test_torch_gpu.py``, ``chip_smoke.py``).
"""

import re

import pytest

from repro_torch.core import cplan, ir, select, templates
from repro_torch.kernels import cuda_src, sweep

from torch_regions import chip_smoke

#: bytes of shared memory a CTA may have, of an SM, and kept per CTA
CTA_MAX, SM_SMEM, RESERVED = 232_448, 233_472, 1024
PATHS = ("l2svm", "mlogreg", "glm", "kmeans", "autoencoder")


def _row_cplans(path: str, m: int = 10_000_000, n: int = 100):
    smoke = chip_smoke()
    if path == "l2svm":
        cps = smoke.main_path_cplans(m, n)
    else:
        (p,) = [p for p in smoke.algo_paths(m) if p.name == path]
        cps = smoke.path_cplans(p)
    return [(label, cp) for label, cp in cps
            if cuda_src.source_for(cp).template == "row"]


def _consts(text: str) -> dict:
    """The integer constants of a generated ``struct Prog``."""
    out = {}
    for decl in re.findall(r"static constexpr int ([^;(]*);", text):
        for name, val in re.findall(r"(\w+) = (-?\d+)", decl):
            out[name] = int(val)
    return out


def _select(text: str, fn: str) -> list[int]:
    """The values of a generated ``fn(k)`` select, in k order."""
    body = re.search(fn + r"\(int k\) \{ return (.*?); \}", text).group(1)
    return [int(v) for v in re.findall(r"\? (-?\d+) :", body)]


def _smem(text: str) -> int:
    """Dynamic shared memory of a tile-layout source, summed from its
    constants as ``row.cuh``'s ``rowtile::Layout`` sums it."""
    k = _consts(text)
    pad4 = lambda x: -(-x // 4) * 4
    widths, offs = _select(text, "tile_width"), _select(text, "tile_off")
    assert len(widths) == len(offs) == k["NT"]
    at = 0
    for w, off in zip(widths, offs):
        assert off == at
        at += pad4(k["R"] * w)
    main = k["STAGES"] * at + pad4(k["R"] * k["GP"]) + k["SBF"]
    fold = {3: k["T"], 2: k["T"] * k["C"],
            4: k["SL"] * k["KC"] * k["C"]}.get(k["VARIANT"], 0)
    return 4 * max(main, fold)


@pytest.mark.parametrize("path", PATHS)
def test_main_path_row_cplans_take_the_tile_layout(path):
    cps = _row_cplans(path)
    assert cps
    for label, cp in cps:
        src = cuda_src.source_for(cp)
        assert src.layout == "tile", label
        assert src.smem <= CTA_MAX and src.ctas >= 2, label
        assert src.ctas * (src.smem + RESERVED) <= SM_SMEM, label
        assert "LAYOUT = 1" in src.text and f"SMEM = {src.smem};" in src.text
        assert src.threads % 32 == 0 and src.parts_per_cta == 1


@pytest.mark.parametrize("path", PATHS)
def test_tile_shared_memory_sum_matches_the_header(path):
    for label, cp in _row_cplans(path):
        src = cuda_src.source_for(cp)
        k = _consts(src.text)
        assert _smem(src.text) == src.smem == k["SMEM"], label
        assert (k["T"], k["R"], k["STAGES"], k["CTAS"]) == (
            src.threads, src.rows, src.stages, src.ctas)


def test_mlogreg_closes_and_wide_gradient_run_in_phase_b():
    """The ∇B and HVP closes keep 4 closer columns × 5 root columns per
    thread; the ∇X product writes its 100 columns from phase B."""
    phases = {}
    for label, cp in _row_cplans("mlogreg"):
        k = _consts(cuda_src.source_for(cp).text)
        phases.setdefault(k["PHASE_B"], []).append((label, k))
    closes = phases[1]
    assert len(closes) == 2
    for _label, k in closes:
        assert (k["KT"], k["C"], k["KC"]) == (4, 5, 100)
        assert k["NG"] * k["SL"] <= k["T"]
    ((_label, wide),) = phases[2]
    assert (wide["C"], wide["K"], wide["CW"]) == (100, 5, 100)


@pytest.mark.parametrize("case", [
    pytest.param(c, id=c.name) for c in sweep.cases()
    if c.template == "row"])
def test_sweep_tile_sources_sum_their_shared_memory(case):
    for shape in ((33, 7), (2_000_003, 100)):
        src = cuda_src.source_for(sweep.fused_cplan(case, *shape)[0])
        if src.layout == "tile":
            assert _smem(src.text) == src.smem <= CTA_MAX
        else:
            assert src.layout == "warp" and "LAYOUT = 0" in src.text


@pytest.mark.parametrize("name,shape", [
    ("row/no_agg_mm256", (33, 7)), ("row/no_agg_mm256", (2_000_003, 100)),
    ("row/col_agg_sum", (2_000_003, 100))])
def test_wide_computed_values_keep_the_warp_layout(name, shape):
    """A 256-column product, and a column aggregate over an element-wise
    value of a 100-wide row (100 accumulators a thread), need the warp
    layout."""
    case = next(c for c in sweep.cases() if c.name == name)
    src = cuda_src.source_for(sweep.fused_cplan(case, *shape)[0])
    assert src.layout == "warp" and src.smem == 0


def _mm_cplan(width: int, m: int = 4099, n: int = 100):
    """``exp(X @ B) * 0.5`` with B (n, width), planned as the sweep plans."""
    X, B = ir.matrix("X", (m, n)), ir.matrix("B", (n, width))
    g = ir.Graph.build([ir.exp(X @ B) * 0.5])
    p = select.plan(g, "gen")
    spec = [s for s in p.specs if getattr(s, "fused", False)][-1]
    return cplan.build_cplan(g, spec)


@pytest.mark.parametrize("width,layout", [
    (cuda_src.NARROW, "tile"), (cuda_src.NARROW + 1, "warp")])
def test_narrow_limit_picks_the_layout(width, layout):
    cp = _mm_cplan(width)
    assert cp.ttype == templates.TType.ROW
    assert cuda_src.source_for(cp).layout == layout


@pytest.mark.parametrize("name", ["row/col_t_agg_hvp_mm5",
                                  "row/no_agg_wide_tb",
                                  "row/row_agg_min_w5"])
def test_tile_source_is_independent_of_m(name):
    case = next(c for c in sweep.cases() if c.name == name)
    small = cuda_src.source_for(sweep.fused_cplan(case, 33, 100)[0])
    big = cuda_src.source_for(sweep.fused_cplan(case, 10_000_000, 100)[0])
    assert small.layout == "tile" and small.text == big.text
    assert small.key == big.key


def test_lm_rmsnorm_is_one_warp_row_cplan_with_a_planted_row_mean():
    """The LM path's fused rmsnorm at minitron-4b's width (2,048 x 3,072):
    one ROW no_agg CPlan of 8 nodes whose row mean feeds every element,
    in the warp layout (96 register slots a lane); chip_smoke's planted
    build of it drops the middle lane's partial of the row mean."""
    smoke = chip_smoke()
    (label, cp), = smoke.lm_norm_cplans()
    src = cuda_src.source_for(cp)
    assert (label, src.template, src.variant, src.layout) == \
        ("_rms", "row", "no_agg", "warp")
    assert [op for (_n, op, *_r) in cp.prog] == [
        "pow2", "mean", "add", "sqrt", "recip", "mul", "add", "mul"]
    assert [tuple(b.shape) for b in cp.binds] == [(2048, 3072), (1, 1),
                                                  (1, 3072)]
    consts = _consts(src.text)
    assert (consts["C"], consts["L"], consts["TR"]) == (3072, 32, 96)
    assert "!(rowtile::kPlanted && sub == 16)" in src.text
    bad = smoke.planted(src)
    assert bad.text == smoke.PLANT + src.text and bad.key != src.key


@pytest.mark.parametrize("d", [2048, 4096])
def test_lm_rmsnorm_at_the_moe_and_hybrid_widths_is_a_warp_row_cplan(d):
    """The fused rmsnorm of [lm-moe] / [lm-xlstm] (2,048 columns) and
    [lm-hybrid] (4,096): the same 8-node ROW no_agg CPlan in the warp
    layout, d / 32 register slots a lane, with the planted row mean."""
    smoke = chip_smoke()
    assert d in smoke.lm_norm_widths()
    (label, cp), = smoke.lm_norm_cplans(d)
    src = cuda_src.source_for(cp)
    assert (label, src.template, src.variant, src.layout) == \
        ("_rms", "row", "no_agg", "warp")
    assert [tuple(b.shape) for b in cp.binds] == [(2048, d), (1, 1), (1, d)]
    consts = _consts(src.text)
    assert (consts["C"], consts["L"], consts["TR"]) == (d, 32, d // 32)
    assert "!(rowtile::kPlanted && sub == 16)" in src.text


def test_lm_rmsnorm_sources_parse(tmp_path):
    from test_torch_cell_layout import _parse
    smoke = chip_smoke()
    srcs = [cuda_src.source_for(cp) for d in smoke.lm_norm_widths()
            for _l, cp in smoke.lm_norm_cplans(d)]
    srcs += [smoke.planted(s) for s in srcs]
    for key, rc, err in _parse(srcs, tmp_path):
        assert rc == 0, f"{key}:\n{err}"


# --------------------------------------------------------------------------
# the streaming layout: vocabulary-wide rows (the fused softmax-CE loss)
# --------------------------------------------------------------------------

def _loss_cplans(V: int):
    return dict(chip_smoke().loss_cplans(V))


@pytest.mark.parametrize("V", [32_000, 262_144])
def test_loss_cplans_take_the_streaming_layout(V):
    for label, cp in _loss_cplans(V).items():
        src = cuda_src.source_for(cp)
        assert (src.template, src.variant, src.layout) == \
            ("row", "no_agg", "stream"), label
        consts = _consts(src.text)
        assert consts["LAYOUT"] == 2 and consts["T"] == src.threads
        assert src.ctas == consts["CTAS"] and src.rows == 1
        # the warp layout would hold 3 (forward) or 11 (backward) arrays
        # of V / 32 floats a lane
        warp = cuda_src._warp_source(cp)
        assert warp.floats == (3 if label == "_lse" else 11) * (V // 32)
        assert warp.floats > cuda_src.WARP_FLOATS_MAX


def test_loss_at_2048_and_the_rmsnorm_keep_their_layouts():
    """The selection threshold keeps every CPlan that took the tile or
    warp layout before the streaming one existed: the loss at musicgen's
    2,048 columns (forward tile; backward warp, 704 floats a lane) and the
    rmsnorm at 2,048-4,096 columns (warp, up to 768)."""
    small = _loss_cplans(2048)
    assert cuda_src.source_for(small["_lse"]).layout == "tile"
    bwd = cuda_src.source_for(small["_lse:vjp"])
    assert bwd.layout == "warp" and bwd.floats == 704
    smoke = chip_smoke()
    for d in (2048, 3072, 4096):
        (_l, cp), = smoke.lm_norm_cplans(d)
        src = cuda_src.source_for(cp)
        assert src.layout == "warp"
        assert src.floats == 6 * d // 32 <= cuda_src.WARP_FLOATS_MAX


@pytest.mark.parametrize("path", PATHS)
def test_main_path_row_cplans_never_stream(path):
    for label, cp in _row_cplans(path):
        assert cuda_src.source_for(cp).layout in ("tile", "warp"), label


def test_sweep_row_cases_never_stream():
    for case in sweep.cases():
        if case.template != "row":
            continue
        for shape in ((33, 7), (2_000_003, 100)):
            if shape[1] >= case.min_n:
                src = cuda_src.source_for(sweep.fused_cplan(case, *shape)[0])
                assert src.layout in ("tile", "warp"), case.name


def test_streamed_sources_hold_no_row_wide_array():
    """No generated ``float x[n]`` array grows with the row width: the
    streamed sources at two widths differ only in the width itself."""
    arrays = lambda t: re.findall(r"float \w+\[(\w+)\]", t)
    a, b = _loss_cplans(32_000), _loss_cplans(262_144)
    for label in a:
        sa = cuda_src.source_for(a[label]).text
        sb = cuda_src.source_for(b[label]).text
        assert arrays(sa) == arrays(sb) == []
        norm = lambda t, V: re.sub(r"== \d+\) continue", "== MID) continue",
                                   t.replace(str(V), "V"))
        assert norm(sa, 32_000) == norm(sb, 262_144)


def _passes(cp) -> tuple[int, int, int]:
    """An independent count of a streamed no_agg program's passes: each
    row aggregate over a row-wide value is folded one pass after the
    latest aggregate its operand depends on; returns (fold passes,
    aggregates folded, write pass)."""
    M, N = cp.main.shape
    width = {("b", b.nid): b.shape[1] for b in cp.binds}
    after = {("b", b.nid): 0 for b in cp.binds}    # passes needed first
    folds = []
    for nid, op, ins, shape, attrs in cp.prog:
        deps = [after[tuple(r)] for r in ins if r[0] != "l"]
        if dict(attrs).get("axis") == "row" and width[tuple(ins[0])] == N:
            after[("n", nid)] = deps[0] + 1
            folds.append(deps[0] + 1)
        else:
            after[("n", nid)] = max(deps + [0])
        width[("n", nid)] = shape[1]
    return max(folds), len(folds), int(width[("n", cp.prog_root)] == N)


@pytest.mark.parametrize("V", [32_000, 256_000])
def test_stream_pass_split_matches_an_independent_count(V):
    """The forward folds its max, then Σ exp(L - max) (2 reads of the
    row, the log-sum-exp in the tail); the backward folds the max, then
    Σ exp and the tie count (``eq`` → ``sum``), then Σ of the scaled
    softmax, and writes the row (4 reads)."""
    want = {"_lse": (2, 2, 0), "_lse:vjp": (3, 4, 1)}
    for label, cp in _loss_cplans(V).items():
        src = cuda_src.source_for(cp)
        consts = _consts(src.text)
        npass, nfold, write = _passes(cp)
        assert (npass, nfold, write) == want[label]
        assert (consts["NPASS"], consts["NS"], consts["WRITE"]) == \
            (npass, nfold, write)
        assert consts["PASSES"] == src.passes == npass + write
        assert src.text.count("rowstream::fold<") == nfold
        assert src.text.count("// pass ") == npass + write
        # the planted fault sits in the last fold pass, in both walks
        assert src.text.count("rowtile::kPlanted") == 2
        mid = -(-V // (4 * cuda_src.STREAM_THREADS)) // 2
        assert f"== {mid}) continue;" in src.text


def _wide_cplan(expr, V: int = 65_536, m: int = 512):
    X = ir.matrix("X", (m, V))
    g = ir.Graph.build([expr(X)])
    p = select.plan(g, "gen")
    spec = [s for s in p.specs if getattr(s, "fused", False)][-1]
    return cplan.build_cplan(g, spec)


@pytest.mark.parametrize("name,expr,variant", [
    ("row_agg", lambda X: ir.exp(X * 0.5).rowsums(), "row_agg"),
    ("full_agg", lambda X: ir.exp(X - X.rowmaxs()).sum(), "full_agg"),
])
def test_row_and_full_aggregates_stream_at_wide_rows(name, expr, variant,
                                                     tmp_path):
    cp = _wide_cplan(expr)
    assert cp.variant == variant
    src = cuda_src.source_for(cp)
    assert src.layout == "stream"
    assert src.elems == (1 if variant == "full_agg" else 0)
    from test_torch_cell_layout import _parse
    for key, rc, err in _parse([src], tmp_path):
        assert rc == 0, f"{name} {key}:\n{err}"


def test_column_aggregates_do_not_stream():
    """A column aggregate over rows too wide for the warp layout has no
    layout: the generator raises with its reason instead of handing back a
    warp source that would spill past what the card can reserve."""
    cp = _wide_cplan(lambda X: ir.exp(X).colsums(), V=65_536)
    with pytest.raises(NotImplementedError, match="column aggregate"):
        cuda_src._stream_source(cp)
    with pytest.raises(NotImplementedError, match="column aggregate"):
        cuda_src.source_for(cp)


def test_stream_sources_parse(tmp_path):
    from test_torch_cell_layout import _parse
    smoke = chip_smoke()
    srcs = smoke.loss_sources()
    assert sum(s.layout == "stream" for s in srcs) == 18
    assert len({s.key for s in srcs}) == len(srcs)
    for key, rc, err in _parse(srcs, tmp_path):
        assert rc == 0, f"{key}:\n{err}"
