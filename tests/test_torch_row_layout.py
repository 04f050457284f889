"""The Row kernel's layouts (``cuda_src.row_source``), on the CPU.

Every Row CPlan of the six algorithms' main paths at full width takes the
tile layout (a thread per row over tiles of rows in shared memory) with a
shared-memory sum that two CTAs of an SM can hold; programs with wide
computed values keep the warp layout while it compiles without spill;
the fused loss from 2,048 columns up (its backward; its forward from
32,000) and the LM rmsnorm take the staged layout (each row copied once
into the shared memory of a CTA or of a cluster), and only rows wider
than a cluster holds stream.  The generated ``Prog`` constants are held
to independent sums written here the way ``csrc/row.cuh`` and
``csrc/row_staged.cuh`` write their ``static_assert``s, and the sources
stay independent of the row count m.  The kernels themselves run only on
the card (``tests/test_torch_gpu.py``, ``chip_smoke.py``).
"""

import re

import pytest

from repro_torch.core import cplan, ir, select, templates
from repro_torch.kernels import build, cuda_src, sweep

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
    one ROW no_agg CPlan of 8 nodes whose row mean feeds every element.
    Its warp-layout build would hold 576 register floats a lane (96
    slots, six arrays), past ``WARP_FLOATS_MAX``, so it takes the staged
    layout: one CTA a row in a ring of row stages, the (1, d) scale
    staged once.  chip_smoke's planted build of it never copies the middle
    chunk of a row (``rowtile::kPlanted`` in the header); the warp build
    keeps its own planted row mean."""
    smoke = chip_smoke()
    (label, cp), = smoke.lm_norm_cplans()
    src = cuda_src.source_for(cp)
    assert (label, src.template, src.variant, src.layout) == \
        ("_rms", "row", "no_agg", "staged")
    assert [op for (_n, op, *_r) in cp.prog] == [
        "pow2", "mean", "add", "sqrt", "recip", "mul", "add", "mul"]
    assert [tuple(b.shape) for b in cp.binds] == [(2048, 3072), (1, 1),
                                                  (1, 3072)]
    consts = _consts(src.text)
    assert (consts["K"], consts["NK"], consts["NR"], consts["NSD"]) == \
        (1, 3072, 1, 1)
    assert consts["S"] == cuda_src.STAGED_RING and consts["CH"] == 1
    warp = cuda_src._warp_source(cp)
    assert _consts(warp.text)["TR"] == 96 and warp.floats == 576
    assert warp.floats > cuda_src.WARP_FLOATS_MAX
    assert "!(rowtile::kPlanted && sub == 16)" in warp.text
    bad = smoke.planted(src)
    assert bad.text == smoke.PLANT + src.text and bad.key != src.key
    assert smoke.planted(src, rank=True) is src      # one CTA: no ranks


@pytest.mark.parametrize("d", [2048, 4096])
def test_lm_rmsnorm_at_the_moe_and_hybrid_widths_is_a_warp_row_cplan(d):
    """The fused rmsnorm of [lm-moe] / [lm-xlstm] (2,048 columns) and
    [lm-hybrid] (4,096): the same 8-node ROW no_agg CPlan, in the staged
    layout at both (its warp build, d / 32 register slots a lane in six
    arrays, spills at both)."""
    smoke = chip_smoke()
    assert d in smoke.lm_norm_widths()
    (label, cp), = smoke.lm_norm_cplans(d)
    src = cuda_src.source_for(cp)
    assert (label, src.template, src.variant, src.layout) == \
        ("_rms", "row", "no_agg", "staged")
    assert [tuple(b.shape) for b in cp.binds] == [(2048, d), (1, 1), (1, d)]
    consts = _consts(src.text)
    assert (consts["K"], consts["NK"], consts["VEC"]) == (1, d, 1)
    warp = cuda_src._warp_source(cp)
    assert _consts(warp.text)["TR"] == d // 32
    assert "!(rowtile::kPlanted && sub == 16)" in warp.text


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


@pytest.mark.parametrize("V", [1_048_576, 2_097_152])
def test_loss_cplans_take_the_streaming_layout(V):
    """Rows wider than a cluster of 16 CTAs holds (4 MB and more) stream."""
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
        assert warp.floats > cuda_src.WARP_FLOATS_LIMIT
        with pytest.raises(cuda_src._ClusterTooSmall):
            cuda_src._staged_source(cp)


def test_loss_at_2048_and_the_rmsnorm_keep_their_layouts():
    """The loss at musicgen's 2,048 columns keeps its tile-layout forward;
    its backward (704 register floats a lane in the warp layout) and the
    rmsnorm at 2,048-4,096 columns (384-768) are past ``WARP_FLOATS_MAX``
    and take the staged layout, one CTA a row in a ring of stages."""
    small = _loss_cplans(2048)
    assert cuda_src.source_for(small["_lse"]).layout == "tile"
    bwd = cuda_src.source_for(small["_lse:vjp"])
    assert bwd.layout == "staged" and bwd.cluster == 1
    assert cuda_src._warp_source(small["_lse:vjp"]).floats == 704
    smoke = chip_smoke()
    for d in (2048, 3072, 4096):
        (_l, cp), = smoke.lm_norm_cplans(d)
        src = cuda_src.source_for(cp)
        assert src.layout == "staged" and src.cluster == 1
        assert src.stages == cuda_src.STAGED_RING
        assert cuda_src._warp_source(cp).floats == 6 * d // 32 > \
            cuda_src.WARP_FLOATS_MAX


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
    a, b = _loss_cplans(1_048_576), _loss_cplans(4_194_304)
    for label in a:
        sa = cuda_src.source_for(a[label]).text
        sb = cuda_src.source_for(b[label]).text
        assert arrays(sa) == arrays(sb) == []
        norm = lambda t, V: re.sub(r"== \d+\) continue", "== MID) continue",
                                   t.replace(str(V), "V"))
        assert norm(sa, 1_048_576) == norm(sb, 4_194_304)


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


@pytest.mark.parametrize("V", [1_048_576, 2_097_152])
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
    cp = _wide_cplan(expr, V=1_048_576)
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
    """[lm-train]'s sources: the forward and backward at every shape, the
    two planted staged builds at 256,000, and the streaming layout's pair
    and its planted pair at rows wider than a cluster holds."""
    from test_torch_cell_layout import _parse
    smoke = chip_smoke()
    srcs = smoke.loss_sources()
    assert sum(s.layout == "stream" for s in srcs) == 4
    assert sum(s.layout == "staged" for s in srcs) == 21
    assert len({s.key for s in srcs}) == len(srcs)
    for key, rc, err in _parse(srcs, tmp_path):
        assert rc == 0, f"{key}:\n{err}"


# --------------------------------------------------------------------------
# the staged layout: each row copied once into the shared memory of a CTA
# or of a thread-block cluster (the fused loss, the LM rmsnorm)
# --------------------------------------------------------------------------

#: the most CTAs a cluster may have (16 is non-portable: the launcher
#: opts into it), and the cluster sizes that are portable
CLUSTER_MAX, PORTABLE = 16, 8
STAGED_WIDTHS = [V for V in chip_smoke().LOSS_WIDTHS if V >= 32_000]


def _staged_smem(text: str) -> int:
    """Dynamic shared memory of a staged source, summed from its constants
    as ``row_staged.cuh``'s ``rowstaged::Layout`` sums it: S row stages of
    NR slices of NK floats, NSD side slices, NA x T / 32 warp partials, NS
    row scalars, 2 x NS cluster partials (each padded to 4 floats), then
    an 8-byte mbarrier a chunk a stage and one for the sides."""
    k = _consts(text)
    pad4 = lambda x: -(-x // 4) * 4
    floats = (k["S"] * k["NR"] * k["NK"] + k["NSD"] * k["NK"]
              + pad4(k["NA"] * k["T"] // 32) + pad4(k["NS"])
              + pad4(2 * k["NS"]))
    return 4 * floats + 8 * (k["S"] * k["CH"] + 1)


def _staged(cp) -> dict:
    src = cuda_src.source_for(cp)
    assert src.layout == "staged" and "LAYOUT = 3" in src.text
    k = _consts(src.text)
    N = int(re.search(r"long long N = (\d+);", src.text).group(1))
    return {"src": src, "k": k, "N": N}


def _staged_cases():
    smoke = chip_smoke()
    out = [(f"loss{V}{label}", cp) for V in STAGED_WIDTHS
           for label, cp in smoke.loss_cplans(V)]
    out += [(f"loss2048{label}", cp)
            for label, cp in smoke.loss_cplans(2048) if label == "_lse:vjp"]
    out += [(f"rms{d}", cp) for d in (2048, 3072, 4096)
            for _l, cp in smoke.lm_norm_cplans(d)]
    return out


@pytest.mark.parametrize("V", STAGED_WIDTHS)
def test_loss_takes_the_staged_layout_from_32000_up(V):
    for label, cp in _loss_cplans(V).items():
        st = _staged(cp)
        assert (st["src"].variant, st["N"]) == ("no_agg", V), label
        assert st["src"].cluster == st["k"]["K"]


@pytest.mark.parametrize("name,cp", _staged_cases(),
                         ids=[n for n, _c in _staged_cases()])
def test_staged_shared_memory_and_cluster_fit_the_card(name, cp):
    """Every staged source: the header's shared-memory sum equals the
    generated SMEM and fits a CTA; K CTAs of NK columns cover the row, K a
    power of two up to 16; one CTA where the row fits one, and only then;
    chunks of whole 4T-column steps cover a slice."""
    st = _staged(cp)
    src, k, N = st["src"], st["k"], st["N"]
    assert _staged_smem(src.text) == src.smem == k["SMEM"] <= CTA_MAX
    K = k["K"]
    assert K in (1, 2, 4, 8, 16) and K <= CLUSTER_MAX
    assert k["NK"] % 4 == 0 and K * k["NK"] >= N > (K - 1) * k["NK"]
    one = cuda_src.staged_smem(k["T"], k["S"], k["CH"], k["NR"], k["NSD"],
                               -(-N // 4) * 4, k["NS"], k["NA"])
    assert (K == 1) == (one <= CTA_MAX or k["NR"] * N * 4 <= 16 * 1024)
    step = 4 * k["T"]
    assert k["CHW"] % step == 0
    assert (k["CH"] - 1) * k["CHW"] < k["NK"] <= k["CH"] * k["CHW"]
    assert src.ctas >= 1 and src.ctas * (src.smem + RESERVED) <= SM_SMEM
    if K > PORTABLE:
        # the launcher opts into the non-portable cluster size
        assert "cudaFuncAttributeNonPortableClusterSizeAllowed" in (
            build.CSRC / "row_staged.cuh").read_text()


def _wide_bind_reads(cp, text: str) -> dict:
    """An independent count of where a staged body reads each bind: the
    binds of the row's width with m rows must be staged row binds, those
    with one row side binds, and no pass may read either from global
    memory (``b.p[k]``); a row scalar is read once with ``__ldg``."""
    M, N = cp.main.shape
    body = text[text.index("float row("):text.index("extern \"C\"")]
    reads = {}
    for k, b in enumerate(cp.binds):
        r, c = b.shape
        kind = ("row" if c == N and r == M > 1 else
                "side" if c == N else "scalar")
        reads[k] = (kind, body.count(f"b.p[{k}]"),
                    len(re.findall(rf"const float\* r{k} = (st|sd) \+", body)))
    return reads


@pytest.mark.parametrize("name,cp", _staged_cases(),
                         ids=[n for n, _c in _staged_cases()])
def test_staged_reads_each_wide_bind_from_hbm_once_a_row(name, cp):
    """Each row-wide bind is a staged slice that every pass reads in
    shared memory: listed once in ``row_bind`` (copied into a stage once a
    row by the header's one bulk copy a chunk) or ``side_bind`` (once a
    CTA), never read from global memory by the passes; a row scalar is one
    ``__ldg`` a row."""
    st = _staged(cp)
    text, k = st["src"].text, st["k"]
    reads = _wide_bind_reads(cp, text)
    rows = [i for i, (kind, _g, _s) in reads.items() if kind == "row"]
    sides = [i for i, (kind, _g, _s) in reads.items() if kind == "side"]
    assert (k["NR"], k["NSD"]) == (len(rows), len(sides))
    assert _select(text, "row_bind") == rows
    assert _select(text, "side_bind") == sides
    for i, (kind, glob, staged) in reads.items():
        if kind == "scalar":
            assert (glob, staged) == (1, 0), (name, i)
        else:
            assert (glob, staged) == (0, 1), (name, i)
    header = (build.CSRC / "row_staged.cuh").read_text()
    # the header's copies: the sides once, then one bulk copy a chunk of
    # each row bind's slice a row; the scalar path's plain copies
    assert header.count("rowstaged::bulk_load(") == 2
    assert header.count("__ldg(") == 2


@pytest.mark.parametrize("V", [2048, 32_000, 256_000])
def test_staged_pass_split_matches_an_independent_count(V):
    """The staged layout keeps the streaming layout's pass split (the
    independent count of :func:`_passes`), every pass reading shared
    memory, and folds all aggregates of a pass in one exchange: the
    backward's Σ exp and tie count share pass 1 (NA = 2)."""
    want = {"_lse": (2, 2, 0), "_lse:vjp": (3, 4, 1)}
    for label, cp in _loss_cplans(V).items():
        src = cuda_src.source_for(cp)
        if src.layout != "staged":
            continue
        k = _consts(src.text)
        npass, nfold, write = _passes(cp)
        assert (npass, nfold, write) == want[label]
        assert (k["NPASS"], k["NS"], k["WRITE"]) == (npass, nfold, write)
        assert k["PASSES"] == src.passes == npass + write
        assert src.text.count("rowstaged::fold<") == npass
        assert k["NA"] == (2 if label == "_lse:vjp" else 1)
        # the first pass waits on each chunk's barrier, the others do not
        assert src.text.count("rowstaged::wait(bars + c, par);") == 1
        assert "__ldg(r" not in src.text and "rowstaged::lds4(r0 + j)" \
            in src.text
        assert "kPlanted" not in src.text


def test_staged_reciprocal_only_where_the_numerator_is_zero_or_one():
    """The backward's tie share (L == max) / count multiplies by the
    count's reciprocal (exact for a numerator of 0 or 1); a division of a
    general value by a row scalar stays a division."""
    bwd = cuda_src.source_for(_loss_cplans(32_000)["_lse:vjp"]).text
    (den,) = re.findall(r"const float rc_(s\d+) = 1\.f / \1;", bwd)
    assert f"* rc_{den})" in bwd and f"/ {den})" not in bwd
    cp = _wide_cplan(lambda X: X / X.rowsums(), V=65_536)
    src = cuda_src.source_for(cp)
    assert src.layout == "staged"
    assert "rc_" not in src.text and re.search(r"\(w0 / s\d+\)", src.text)


@pytest.mark.parametrize("name,expr,variant", [
    ("row_agg", lambda X: ir.exp(X * 0.5).rowsums(), "row_agg"),
    ("full_agg", lambda X: ir.exp(X - X.rowmaxs()).sum(), "full_agg"),
])
def test_row_and_full_aggregates_take_the_staged_layout(name, expr, variant,
                                                        tmp_path):
    """A row_agg and a full_agg over 65,536-wide rows: a cluster of 4,
    one partial a cluster for full_agg (folded by rk::combine)."""
    cp = _wide_cplan(expr)
    assert cp.variant == variant
    src = cuda_src.source_for(cp)
    assert src.layout == "staged" and src.cluster == 4
    assert src.elems == (1 if variant == "full_agg" else 0)
    from test_torch_cell_layout import _parse
    for key, rc, err in _parse([src], tmp_path):
        assert rc == 0, f"{name} {key}:\n{err}"


def test_staged_cluster_size_is_the_smallest_that_fits():
    """One CTA up to 50,304 columns (197 KB), then the smallest cluster
    whose slices fit a third of an SM, then a cluster of 16 up to a CTA's
    227 KB; wider rows stream (the geometry raises)."""
    K = {V: cuda_src.source_for(cp).cluster
         for V in (32_000, 50_304, 64_000, 131_072, 262_144)
         for label, cp in _loss_cplans(V).items() if label == "_lse"}
    assert K == {32_000: 1, 50_304: 1, 64_000: 4, 131_072: 8, 262_144: 16}
    geo = cuda_src.staged_geometry(500_000, 1, 0, 2, 1)
    assert geo.cluster == 16 and geo.smem > cuda_src.STAGED_SLICE_MAX
    with pytest.raises(cuda_src._ClusterTooSmall):
        cuda_src.staged_geometry(1_048_576, 1, 0, 2, 1)
    forced = cuda_src._staged_source(_loss_cplans(32_000)["_lse"],
                                     cluster=4)
    assert (forced.cluster, _consts(forced.text)["NK"]) == (4, 8000)


def test_column_aggregates_and_main_path_tiles_keep_their_layouts():
    """Column aggregates keep the warp layout (or raise past its limit),
    and no main-path CPlan of the six algorithms is staged."""
    case = next(c for c in sweep.cases() if c.name == "row/col_agg_sum")
    cp = sweep.fused_cplan(case, 2_000_003, 100)[0]
    assert cuda_src.source_for(cp).layout == "warp"
    with pytest.raises(NotImplementedError, match="column aggregate"):
        cuda_src._staged_source(cp)
    for path in PATHS:
        for label, cp in _row_cplans(path):
            assert cuda_src.source_for(cp).layout == "tile", label


def test_staged_sources_parse(tmp_path):
    """Every staged source [lm*] and [lm-train] build (the rmsnorm and the
    loss, sound, planted with the chunk fault and, in a cluster, with the
    rank fault) parses against the CUDA stub with the header's
    ``static_assert``s instantiated."""
    from test_torch_cell_layout import _parse
    smoke = chip_smoke()
    srcs = [s for s in smoke.loss_sources() if s.layout == "staged"]
    norms = [cuda_src.source_for(cp) for d in smoke.lm_norm_widths()
             for _l, cp in smoke.lm_norm_cplans(d)]
    srcs += norms + [smoke.planted(s) for s in norms]
    assert any(smoke.PLANT_RANK in s.text for s in srcs)
    assert len({s.key for s in srcs}) == len(srcs)
    for key, rc, err in _parse(srcs, tmp_path):
        assert rc == 0, f"{key}:\n{err}"


def test_staged_header_checks_its_own_shared_memory_sum(tmp_path):
    """The header's sum is live: a source whose SMEM disagrees with it
    fails the parse (and would fail nvcc) at its static_assert."""
    import dataclasses
    from test_torch_cell_layout import _parse
    src = cuda_src.source_for(_loss_cplans(32_000)["_lse"])
    bad = src.text.replace(f"SMEM = {src.smem},", f"SMEM = {src.smem + 16},")
    assert bad != src.text
    (key, rc, err), = _parse([dataclasses.replace(src, text=bad)], tmp_path)
    assert rc != 0 and "cuda_src.py's accounting" in err


def test_warp_floats_max_keeps_the_sweep_warp_programs():
    """The warp layout keeps every sweep program with wide computed values
    at the main path's width (a 256-column product: 28 floats a lane)."""
    for case in sweep.cases():
        if case.template != "row":
            continue
        for shape in ((33, 7), (2_000_003, 100)):
            if shape[1] < case.min_n:
                continue
            src = cuda_src.source_for(sweep.fused_cplan(case, *shape)[0])
            if src.layout == "warp":
                assert src.floats <= cuda_src.WARP_FLOATS_MAX, case.name
