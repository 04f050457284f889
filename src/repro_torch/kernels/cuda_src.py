"""CUDA C++ emitter: one kernel source per CPlan (paper §2.2 code generation).

The reference's Pallas kernels evaluate ``cplan.prog`` at trace time inside
the kernel body, so every CPlan gets its own specialised kernel.  The
Hopper counterpart generates source: the template skeletons are fixed
headers in ``csrc/`` (``cell.cuh``, ``magg.cuh``, ``row.cuh``), and this
module writes, per CPlan, a ``struct Prog`` holding

* the program's ``__device__`` body — one C statement per CNode, using the
  op table of :mod:`repro_torch.kernels.ref` (mirrored in ``common.cuh``),
* the compile-time widths (domain width N, root/closer widths, number of
  aggregate roots K; for Outer the block size, rank and closer width) and
  the variant / aggregation codes,

plus an ``extern "C"`` launcher that instantiates the skeleton
(``repro_launch``, whose launch serves a batch of requests — one request
for a plain call — with per-request bind strides; ``repro_launch_outer``
for Outer, whose kernel also takes the BCSR's block indices and is
generated per block size).  The Row
template has four layouts, chosen per CPlan here (:func:`row_source`):
the tile layout (a thread per row over tiles of rows in shared memory,
every computed value in registers), the warp layout (a warp per row) for
programs with wide computed values that fit its registers without spill,
the staged layout (each row copied once into the shared memory of a CTA
or of a thread-block cluster by TMA bulk copies, every pass over it
reading shared memory) for wider rows up to what a cluster holds, and
the streaming layout (a CTA per row, the row read in column slices once
a pass) for rows wider than that; the layout and its geometry go into
``Prog`` and :class:`KernelSource`.  The Cell template has two walks,
chosen per CPlan here (:func:`cell_source`): the vector walk (four-cell
groups read as float4, several groups in flight per thread) where every
bind is read as a whole group, and the cell-by-cell scalar walk for the
rest; the walk and its geometry go into ``Prog`` and
:class:`KernelSource` too.  The
row count m stays a run-time argument, so one build serves every m.  The
text names values by program position, never by IR node id, so
structurally equal CPlans from different traces give byte-identical
sources (and share one build, keyed by the source hash).

Programs outside what a skeleton can express (an in-program transpose, a
matmul against a computed matrix, …) raise ``NotImplementedError`` here;
the wrappers let that propagate — there is no fallback for a CUDA tensor.
"""

from __future__ import annotations

import functools
import hashlib
import math
from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np

from repro_torch.core.cplan import (CPlan, COL_AGG, COL_T_AGG, FULL_AGG,
                                    NO_AGG, RIGHT_MM, ROW_AGG)
from repro_torch.core.ir import AGG_OPS
from repro_torch.core.templates import TType

#: aggregation codes of common.cuh ("mean" sums, then divides)
AGG_CODE = {"sum": 0, "mean": 0, "min": 1, "max": 2, "sum_sq": 3}

_UNARY_C = {
    "exp": "expf({0})", "log": "logf({0})", "sqrt": "sqrtf({0})",
    "abs": "fabsf({0})", "sign": "rk::f_sign({0})", "round": "rintf({0})",
    "floor": "floorf({0})", "ceil": "ceilf({0})",
    "sigmoid": "rk::f_sigmoid({0})", "tanh": "tanhf({0})",
    "relu": "rk::f_relu({0})", "neg": "(-{0})", "recip": "(1.f / {0})",
    "pow2": "({0} * {0})", "square": "({0} * {0})",
    "neq0": "rk::f_neq0({0})", "sprop": "({0} * (1.f - {0}))",
    "log1p": "log1pf({0})", "softplus": "rk::f_softplus({0})",
    "gelu": "rk::f_gelu({0})", "silu": "rk::f_silu({0})",
    "erf": "erff({0})",
}
_BINARY_C = {
    "add": "({0} + {1})", "sub": "({0} - {1})", "mul": "({0} * {1})",
    "div": "({0} / {1})", "min": "rk::nmin({0}, {1})",
    "max": "rk::nmax({0}, {1})", "pow": "powf({0}, {1})",
    "eq": "rk::f_cmp({0} == {1})", "neq": "rk::f_cmp({0} != {1})",
    "lt": "rk::f_cmp({0} < {1})", "le": "rk::f_cmp({0} <= {1})",
    "gt": "rk::f_cmp({0} > {1})", "ge": "rk::f_cmp({0} >= {1})",
}
_TERNARY_C = {
    "where": "rk::f_where({0}, {1}, {2})",
    "plus_mult": "({0} + {1} * {2})", "minus_mult": "({0} - {1} * {2})",
}
_CELL_C = {**_UNARY_C, **_BINARY_C, **_TERNARY_C}

_CELL_VARIANT = {NO_AGG: 0, ROW_AGG: 1, COL_AGG: 2, FULL_AGG: 3}
_ROW_VARIANT = {NO_AGG: 0, ROW_AGG: 1, COL_AGG: 2, FULL_AGG: 3,
                COL_T_AGG: 4}

#: narrow matmuls with at most this many output columns reduce each column
#: with a warp butterfly; wider ones stage the row in shared memory
_SHUFFLE_MM_MAX = 8
#: static shared memory a Row CTA may use (floats)
_SMEM_FLOATS = 48 * 1024 // 4


@dataclass(frozen=True)
class KernelSource:
    """One generated kernel: its text plus the launch geometry the Python
    wrapper needs (the skeleton reads the same constants from ``Prog``)."""
    template: str          # "cell" | "magg" | "row" | "outer"
    text: str
    domain: tuple          # (rows, cols) the kernel walks (rows: run time)
    elems: int = 0         # reduced elements per partial (0: no partials)
    variant: str = ""      # row, cell: the template variant
    layout: str = ""       # row: "tile", "warp", "staged" or "stream"
    #                        (row_source)
    walk: str = ""         # cell: "vector" or "scalar" (cell_vector_binds)
    group: int = 0         # cell: cells a thread takes per load (4 or 1)
    unroll: int = 0        # cell: groups a thread keeps in flight
    threads: int = 0       # row, cell: threads per CTA
    rows: int = 0          # row: rows a CTA takes per step
    stages: int = 0        # row tile, staged: depth of the ring of rows
    smem: int = 0          # row tile, staged: a CTA's dynamic shared
    #                        memory (bytes)
    ctas: int = 0          # row, cell: CTAs per SM the grid is sized for
    parts_per_cta: int = 0  # row, cell: partials each CTA writes
    floats: int = 0        # row warp: register floats a lane (its arrays)
    passes: int = 0        # row stream, staged: passes over the row
    #                        (folds + write)
    cluster: int = 0       # row staged: CTAs of the cluster a row is split
    #                        over (K)

    @functools.cached_property
    def key(self) -> str:
        return hashlib.sha256(self.text.encode()).hexdigest()[:20]


def _lit(v: float) -> str:
    v = float(np.float32(v))
    if math.isnan(v):
        return "(NAN)"
    if math.isinf(v):
        return "(INFINITY)" if v > 0 else "(-INFINITY)"
    return f"({v!r}f)"


def root_shape(cplan: CPlan, nid: Optional[int] = None) -> tuple[int, int]:
    """Shape of program value ``nid`` (default: the program root)."""
    nid = cplan.prog_root if nid is None else nid
    for (n, _op, _ins, shape, _attrs) in cplan.prog:
        if n == nid:
            return tuple(shape)
    for b in cplan.binds:
        if b.nid == nid:
            return tuple(b.shape)
    return tuple(cplan.main.shape)


def _unsupported(cplan: CPlan, why: str) -> NotImplementedError:
    return NotImplementedError(
        f"{cplan.ttype.name} {cplan.variant} CPlan: {why}; the CUDA "
        f"template cannot run it (no fallback for CUDA tensors)")


def _header(template: str) -> list[str]:
    return [f'#include "{template}.cuh"', ""]


#: the launcher ABI of the Cell, MAgg and Row kernels (``build.launch``):
#: bind pointers, per-request bind strides (floats), the request count,
#: out, out's per-request stride, partials, tickets (Cell), m, the grid per
#: request, aux, stream, device
LAUNCH_SIGNATURE = (
    'extern "C" int repro_launch(void* const* binds, '
    'const long long* strides, int nreq, void* out, long long ostride, '
    'void* part, void* ticket, long long m, int nblocks, double aux, '
    'void* stream, int device)')


def _launcher(fn: str) -> list[str]:
    return [
        LAUNCH_SIGNATURE + " {",
        f"  return {fn}<Prog>(binds, strides, nreq, static_cast<float*>(out), "
        "ostride, static_cast<float*>(part), ticket, m, nblocks, aux, "
        "stream, device);",
        "}", ""]


def _select(values: list[str], default: str) -> str:
    """``k == 0 ? v0 : (k == 1 ? v1 : …)`` over per-root values."""
    expr = default
    for k in reversed(range(len(values))):
        expr = f"(k == {k} ? {values[k]} : {expr})"
    return expr


# --------------------------------------------------------------------------
# Cell and MAgg: the program evaluated at one cell (i, j) of the domain
# --------------------------------------------------------------------------

def _cell_body(cplan: CPlan, roots: list[int], dom: tuple[int, int],
               lane: Optional[int] = None,
               vec: Optional[dict] = None) -> list[str]:
    """The program's lines: at cell (i, j) into ``r[k]`` (``lane`` None),
    or at cell ``lane`` of a vector-walk group into ``r[lane]``, reading
    vector bind ``vec[nid]`` as ``x[k].x/y/z/w`` and a (1,1) bind as the
    ``s<pos>`` the caller loaded."""
    M, N = dom
    pos = {b.nid: k for k, b in enumerate(cplan.binds)}
    shape_of = {b.nid: tuple(b.shape) for b in cplan.binds}
    names: dict[tuple, str] = {}
    lines: list[str] = []
    sfx = "" if lane is None else f"_{lane}"

    def offset(shape, col_lo: int = 0, width: Optional[int] = None):
        r, c = shape
        w = c if width is None else width
        if r not in (1, M) or w not in (1, N):
            raise _unsupported(cplan, f"side of shape {shape} does not "
                                      f"broadcast over the domain {dom}")
        row = r == M and M > 1
        col = w == N and N > 1
        parts = []
        if row:
            parts.append(f"i * {c}")
        if col:
            parts.append("j")
        if col_lo:
            parts.append(str(col_lo))
        return " + ".join(parts) if parts else "0"

    def bind(nid: int) -> str:
        key = ("b", nid)
        if key not in names:
            if lane is not None:
                names[key] = (f"x[{vec[nid]}].{_xyzw(lane)}" if nid in vec
                              else f"s{pos[nid]}")
                return names[key]
            name = f"b{pos[nid]}"
            lines.append(f"const float {name} = __ldg(b.p[{pos[nid]}] + "
                         f"{offset(shape_of[nid])});")
            names[key] = name
        return names[key]

    for idx, (nid, op, ins, shape, attrs) in enumerate(cplan.prog):
        attrs = dict(attrs)
        name = f"v{idx}{sfx}"
        if op == "idx":
            kind, ref = ins[0]
            if kind != "b" or lane is not None:
                raise _unsupported(cplan, "column slice of a computed value")
            lo, hi = int(attrs["lo"]), int(attrs["hi"])
            off = offset(shape_of[ref], lo, hi - lo)
            lines.append(f"const float {name} = __ldg(b.p[{pos[ref]}] + "
                         f"{off});")
        elif op in _CELL_C and "axis" not in attrs:
            args = [names[("n", r)] if k == "n" else
                    bind(r) if k == "b" else _lit(r) for k, r in ins]
            lines.append(f"const float {name} = "
                         f"{_CELL_C[op].format(*args)};")
        else:
            raise _unsupported(cplan, f"op '{op}' inside a cell program")
        names[("n", nid)] = name
    for k, r in enumerate(roots):
        val = names.get(("n", r)) or bind(r)
        lines.append(f"r[{k if lane is None else lane}] = {val};")
    return lines


#: the Cell kernel's geometry: threads per CTA (the fold takes 256), CTAs
#: per SM its __launch_bounds__ keep resident, cells per vector group
CELL_THREADS, CELL_CTAS, CELL_GROUP = 256, 4, 4


def cell_vector_binds(cplan: CPlan, dom: tuple[int, int]
                      ) -> Optional[list[int]]:
    """The binds the vector walk loads as float4, in bind order, or None
    when the CPlan needs the scalar walk: every bind must have the
    domain's shape, be (1,1), or be (1,N) with N % 4 == 0, and the program
    must slice no columns."""
    M, N = dom
    if cplan.variant not in (NO_AGG, FULL_AGG) or any(
            op == "idx" for (_n, op, *_r) in cplan.prog):
        return None
    out = []
    for b in cplan.binds:
        shape = tuple(b.shape)
        if shape == (M, N) or (shape == (1, N) and N % CELL_GROUP == 0):
            out.append(b.nid)
        elif shape != (1, 1):
            return None
    return out


def cell_unroll(nv: int) -> int:
    """Groups a thread keeps in flight before the first program runs: 4
    with one vector bind, else 2, so the loads in flight hold 16 to 24
    registers of the 64 a thread has at CELL_CTAS = 4."""
    return 4 if nv <= 1 else 2


def _cell_vector_fns(cplan: CPlan, roots: list[int], dom, vec: list[int]
                     ) -> list[str]:
    """``vload`` and ``veval`` of the vector walk."""
    N = dom[1]
    pos = {b.nid: k for k, b in enumerate(cplan.binds)}
    shape_of = {b.nid: tuple(b.shape) for b in cplan.binds}
    vix = {nid: k for k, nid in enumerate(vec)}
    side = [nid for nid in vec if shape_of[nid] != tuple(dom)]
    load = [f"const int j = (int)(e % {N});"] if side else []
    for nid in vec:
        at = "j" if nid in side else "e"
        load.append(f"x[{vix[nid]}] = __ldg(reinterpret_cast<const float4*>"
                    f"(b.p[{pos[nid]}] + {at}));")
    scal = [f"const float s{pos[b.nid]} = __ldg(b.p[{pos[b.nid]}]);"
            for b in cplan.binds if b.nid not in vix]
    body = list(scal)
    for u in range(CELL_GROUP):
        body += _cell_body(cplan, roots, dom, lane=u, vec=vix)
    return [
        "  __device__ static __forceinline__ void vload("
        "const rk::Binds<NB>& b, long long e, float4 (&x)[NV]) {",
        *("    " + ln for ln in load),
        "  }",
        "  __device__ static __forceinline__ void veval("
        "const rk::Binds<NB>& b, const float4 (&x)[NV], float (&r)[G]) {",
        *("    " + ln for ln in body),
        "  }"]


def _cell_domain(cplan: CPlan, roots: list[int]) -> tuple[int, int]:
    shapes = {root_shape(cplan, r) for r in roots}
    if len(shapes) != 1:
        raise _unsupported(cplan, f"aggregate roots of different shapes "
                                  f"{sorted(shapes)}")
    return shapes.pop()


def _cell_struct(cplan: CPlan, roots: list[int], aggs: list[str],
                 variant: int, dom, fin: str, consts: tuple = (),
                 fns: tuple = ()) -> list[str]:
    nb = len(cplan.binds)
    body = _cell_body(cplan, roots, dom)
    agg = AGG_CODE[aggs[0]]
    # agg_of(e) indexes the reduced output: roots for MAgg, but columns
    # for the col_agg combine — a single root aggregates every e alike
    agg_of = "AGG" if len(roots) == 1 else \
        _select([str(AGG_CODE[a]) for a in aggs], "0")
    return [
        "struct Prog {",
        f"  static constexpr int NB = {nb}, N = {dom[1]}, K = {len(roots)};",
        f"  static constexpr int VARIANT = {variant}, AGG = {agg}, "
        f"MEAN = {int(aggs[0] == 'mean')};",
        *consts,
        "  __device__ static __forceinline__ int agg_of(int k) {",
        f"    return {agg_of};",
        "  }",
        "  __device__ static __forceinline__ float fin(int k, float a, "
        "double aux) {",
        f"    return {fin};",
        "  }",
        "  __device__ static __forceinline__ void eval("
        "const rk::Binds<NB>& b, long long i, int j, float (&r)[K]) {",
        *("    " + ln for ln in body),
        "  }",
        *fns,
        "};", ""]


def cell_source(cplan: CPlan) -> KernelSource:
    """The Cell template (single-root MAgg included: full_agg, K = 1), in
    the vector walk where :func:`cell_vector_binds` allows it, else the
    scalar walk; the walk and its geometry go into ``Prog`` and
    :class:`KernelSource`."""
    variant = cplan.variant
    if variant not in _CELL_VARIANT or cplan.extra:
        raise _unsupported(cplan, "not a Cell variant")
    roots = [cplan.prog_root]
    dom = cplan.out_shape if variant == NO_AGG else \
        _cell_domain(cplan, roots)
    agg = cplan.agg_op or "sum"
    fin = "a" if agg != "mean" else "a / (float)aux"
    vec = cell_vector_binds(cplan, tuple(dom))
    walk = "scalar" if vec is None else "vector"
    nv = len(vec or [])
    group, unroll = (CELL_GROUP, cell_unroll(nv)) if vec is not None \
        else (1, 1)
    elems = {COL_AGG: dom[1], FULL_AGG: 1}.get(variant, 0)
    consts = (f"  static constexpr int WALK = {int(vec is not None)}, "
              f"G = {group}, U = {unroll}, T = {CELL_THREADS}, "
              f"CTAS = {CELL_CTAS}, NV = {nv}, PARTS = {elems};",)
    fns = tuple(_cell_vector_fns(cplan, roots, dom, vec)) \
        if vec is not None else ()
    text = "\n".join(
        [f"// Cell template, {walk} walk: " + _describe(cplan)]
        + _header("cell")
        + _cell_struct(cplan, roots, [agg], _CELL_VARIANT[variant], dom,
                       fin, consts, fns)
        + _launcher("cell_launch"))
    return KernelSource("cell", text, tuple(dom), elems=elems,
                        variant=variant, walk=walk, threads=CELL_THREADS,
                        ctas=CELL_CTAS, group=group, unroll=unroll,
                        parts_per_cta=int(elems > 0))


def magg_source(cplan: CPlan) -> KernelSource:
    """The MAgg template: k full aggregates in one scan, out (k, 1)."""
    if not cplan.extra:
        raise _unsupported(cplan, "MAgg needs more than one root")
    roots = [cplan.prog_root] + [r for r, _ in cplan.extra]
    aggs = [cplan.agg_op] + [op for _, op in cplan.extra]
    dom = _cell_domain(cplan, roots)
    fin = _select(["a * (float)aux" if a == "mean" else "a" for a in aggs],
                  "a")
    text = "\n".join(
        ["// MAgg template: " + _describe(cplan)] + _header("magg")
        + _cell_struct(cplan, roots, aggs, _CELL_VARIANT[FULL_AGG], dom,
                       fin)
        + _launcher("magg_launch"))
    return KernelSource("magg", text, tuple(dom), elems=len(roots))


# --------------------------------------------------------------------------
# Row: the program evaluated on one row, values lane-distributed
# --------------------------------------------------------------------------

class _RowEmitter:
    """Writes the Row program body.  A value of width w is a ``float``
    when w == 1 (the same bits on every lane of the row group) and a
    register array ``float v[T]``, T = ceil(w / L), when w > 1 (element j
    on lane j % L, slot j / L)."""

    def __init__(self, cplan: CPlan, lanes: int):
        self.cp = cplan
        self.L = lanes
        self.M = cplan.main.shape[0]
        self.pos = {b.nid: k for k, b in enumerate(cplan.binds)}
        self.shape_of = {b.nid: tuple(b.shape) for b in cplan.binds}
        self.vals: dict[tuple, tuple[str, int]] = {}    # key -> (name, w)
        self.lines: list[str] = []
        self.smw = 1
        self.floats = 0

    # -- helpers -------------------------------------------------------------
    def slots(self, w: int) -> int:
        return -(-w // self.L)

    def array(self, name: str, w: int, init: str = "") -> str:
        """Declares the row array ``name`` of width ``w`` and adds its slots
        to :attr:`floats`, what a lane holds in registers (or spills)."""
        self.floats += self.slots(w)
        return f"float {name}[{self.slots(w)}]{init};"

    def emit(self, *lines: str) -> None:
        self.lines.extend(lines)

    def elt(self, key_or_lit) -> tuple[str, int]:
        """(C expression of element t, width) of a value reference."""
        kind, ref = key_or_lit
        if kind == "l":
            return _lit(ref), 1
        if kind == "b":
            name, w = self.bind(ref)
        else:
            name, w = self.vals[("n", ref)]
        return (name if w == 1 else f"{name}[t]"), w

    def base(self, nid: int) -> str:
        """Pointer to row i of an elementwise-read bind."""
        r, c = self.shape_of[nid]
        k = self.pos[nid]
        if r == self.M and self.M > 1:
            return f"b.p[{k}] + i * {c}"
        if r == 1:
            return f"b.p[{k}]"
        raise _unsupported(self.cp, f"side of shape {(r, c)} read "
                                    f"element-wise by a row program over "
                                    f"{self.M} rows")

    def load(self, name: str, base: str, w: int, lo: int = 0) -> None:
        off = f" + {lo}" if lo else ""
        if w == 1:
            self.emit(f"const float {name} = __ldg({base}{off});")
            return
        self.emit(self.array(name, w),
                  "#pragma unroll",
                  f"for (int t = 0; t < {self.slots(w)}; ++t) {{",
                  f"  const int j = t * {self.L} + sub;",
                  f"  {name}[t] = j < {w} ? __ldg({base}{off} + j) : 0.f;",
                  "}")

    def bind(self, nid: int) -> tuple[str, int]:
        key = ("b", nid)
        if key not in self.vals:
            name = f"b{self.pos[nid]}"
            w = self.shape_of[nid][1]
            self.load(name, self.base(nid), w)
            self.vals[key] = (name, w)
        return self.vals[key]

    def stage(self, name: str, w: int) -> None:
        """Write a row value to the warp's shared buffer sm[0:w)."""
        self.smw = max(self.smw, w)
        self.emit("__syncwarp();")
        if w == 1:
            self.emit(f"if (sub == 0) sm[0] = {name};")
        else:
            self.emit("#pragma unroll",
                      f"for (int t = 0; t < {self.slots(w)}; ++t)",
                      f"  if (t * 32 + sub < {w}) sm[t * 32 + sub] = "
                      f"{name}[t];")
        self.emit("__syncwarp();")

    # -- ops -----------------------------------------------------------------
    def cellwise(self, name: str, op: str, ins, width: int) -> None:
        args = [self.elt(r) for r in ins]
        widths = {w for _e, w in args if w > 1}
        if len(widths) > 1 or (widths and widths != {width}):
            raise _unsupported(self.cp, f"'{op}' over row values of widths "
                                        f"{sorted(w for _e, w in args)}")
        expr = _CELL_C[op].format(*(e for e, _w in args))
        if width == 1:
            self.emit(f"const float {name} = {expr};")
        else:
            self.emit(self.array(name, width),
                      "#pragma unroll",
                      f"for (int t = 0; t < {self.slots(width)}; ++t) "
                      f"{name}[t] = {expr};")

    def row_agg(self, name: str, op: str, ref, width: int) -> None:
        x, w = self.elt(ref)
        a = AGG_CODE[op]
        if w == 1:
            expr = {"sum_sq": f"({x} * {x})"}.get(op, x)
            self.emit(f"const float {name} = {expr};")
            return
        # the planted fault (chip_smoke.py's builds only) drops the middle
        # lane's partial (L = 32) or the middle element (L = 1)
        drop = f"sub == {min(w, self.L) // 2}" if self.L > 1 else \
            f"t == {w // 2}"
        self.emit(f"float {name};", "{",
                  f"  float s = rk::agg_init({a});",
                  "#pragma unroll",
                  f"  for (int t = 0; t < {self.slots(w)}; ++t)",
                  f"    if (t * {self.L} + sub < {w} && "
                  f"!(rowtile::kPlanted && {drop})) "
                  f"s = rk::agg_add({a}, s, {x});",
                  f"  {name} = rk::lane_reduce<{self.L}>({a}, s);",
                  "}")
        if op == "mean":
            self.emit(f"{name} = {name} / {float(w)!r}f;")

    def matmul(self, name: str, ins, shape, attrs: dict) -> None:
        if attrs.get("ta", False):
            raise _unsupported(self.cp, "transposed row operand in a "
                                        "row-program matmul")
        (ka, ra), (kb, rb) = ins
        if kb != "b":
            raise _unsupported(self.cp, "matmul against a computed matrix")
        a, k = self.elt((ka, ra))
        a = a.replace("[t]", "")
        c = shape[1]
        tb = bool(attrs.get("tb", False))
        if self.shape_of[rb] != ((c, k) if tb else (k, c)) or k < 2:
            raise _unsupported(self.cp, f"matmul side {self.shape_of[rb]} "
                                        f"for a ({k}) row @ ({c}) columns")
        B = f"b.p[{self.pos[rb]}]"
        at = (lambda q, jc: f"{B} + {jc} * {k} + {q}") if tb else \
            (lambda q, jc: f"{B} + {q} * {c} + {jc}")
        ta = self.slots(k)
        if c <= _SHUFFLE_MM_MAX:
            # one butterfly per output column: every lane gets the sum
            decl = f"float {name} = 0.f;" if c == 1 else \
                self.array(name, c, " = {}")
            store = f"{name} = s;" if c == 1 else \
                f"if (jj % 32 == sub) {name}[jj / 32] = s;"
            self.emit(decl,
                      "#pragma unroll",
                      f"for (int jj = 0; jj < {c}; ++jj) {{",
                      "  float s = 0.f;",
                      "#pragma unroll",
                      f"  for (int t = 0; t < {ta}; ++t) {{",
                      "    const int q = t * 32 + sub;",
                      f"    if (q < {k}) s = fmaf({a}[t], "
                      f"__ldg({at('q', 'jj')}), s);",
                      "  }",
                      "  s = rk::lane_reduce<32>(rk::AGG_SUM, s);",
                      f"  {store}",
                      "}")
            return
        # wide output: the row sits in shared memory, lanes take columns
        self.stage(a, k)
        self.emit(self.array(name, c),
                  "#pragma unroll",
                  f"for (int t = 0; t < {self.slots(c)}; ++t) {{",
                  "  const int jc = t * 32 + sub;",
                  "  float s = 0.f;",
                  f"  if (jc < {c})",
                  f"    for (int q = 0; q < {k}; ++q) "
                  f"s = fmaf(sm[q], __ldg({at('q', 'jc')}), s);",
                  f"  {name}[t] = s;",
                  "}")

    def idx(self, name: str, ref, lo: int, hi: int) -> None:
        w = hi - lo
        kind, r = ref
        if kind == "b":
            self.load(name, self.base(r), w, lo)
            return
        src, sw = self.vals[("n", r)]
        if sw == 1:
            self.emit(f"const float {name} = {src};")
            return
        self.stage(src, sw)
        if w == 1:
            self.emit(f"const float {name} = sm[{lo}];")
        else:
            self.emit(self.array(name, w),
                      "#pragma unroll",
                      f"for (int t = 0; t < {self.slots(w)}; ++t) {{",
                      f"  const int j = t * {self.L} + sub;",
                      f"  {name}[t] = j < {w} ? sm[{lo} + j] : 0.f;",
                      "}")

    # -- program -------------------------------------------------------------
    def program(self) -> None:
        for pos, (nid, op, ins, shape, attrs) in enumerate(self.cp.prog):
            attrs = dict(attrs)
            name = f"v{pos}"
            width = int(shape[1])
            if shape[0] not in (1, self.M):
                raise _unsupported(self.cp, f"program value of shape "
                                            f"{shape} is not a row value")
            if op == "matmul":
                self.matmul(name, ins, shape, attrs)
            elif op in AGG_OPS and "axis" in attrs:
                if attrs["axis"] != "row":
                    raise _unsupported(self.cp, f"{attrs['axis']} "
                                                f"aggregate inside a program")
                self.row_agg(name, op, ins[0], width)
            elif op == "idx":
                self.idx(name, ins[0], int(attrs["lo"]), int(attrs["hi"]))
            elif op in _CELL_C:
                self.cellwise(name, op, ins, width)
            else:
                raise _unsupported(self.cp, f"op '{op}' inside a row "
                                            f"program")
            self.vals[("n", nid)] = (name, width)

    def copy_out(self, dst: str, nid: int) -> int:
        kind = "n" if ("n", nid) in self.vals else "b"
        x, w = self.elt((kind, nid))
        if w == 1:
            self.emit(f"{dst}[0] = {x};")
        else:
            self.emit("#pragma unroll",
                      f"for (int t = 0; t < {self.slots(w)}; ++t) "
                      f"{dst}[t] = {x};")
        return w


# --------------------------------------------------------------------------
# Row, tile layout: a thread per row over tiles of rows in shared memory
# --------------------------------------------------------------------------

#: the widest computed row value the tile layout takes: each is a register
#: array ``float v[w]`` of the thread that owns the row.  Registers are the
#: limit: a thread may have 255, MLogReg's backward keeps about six 5-wide
#: values live at once, and a close keeps KT x C accumulators besides; at 16
#: a dozen live values still fit.  Elementwise values of the tile's own row
#: are exempt (evaluated per element where they are consumed), and so is a
#: wide product that is the root of a no_agg CPlan (written in phase B).
NARROW = 16
#: threads of a tile CTA; a tile of fewer rows gives each row 128 / rows
#: lanes in phase A (a 500-wide row of the autoencoder: 8 lanes)
_TILE_THREADS = 128
#: depth of the ring of row tiles: one tile in flight while one is computed
_TILE_STAGES = 2
#: rows of at least this many floats (the autoencoder's 500 and 784) take
#: tiles of 4 rows, a warp per row in phase A: their per-element work is
#: long, and a large tile of them leaves most SMs idle on a small batch
_WIDE_ROW_FLOATS = 256
_TILE_ROWS_MAX = 8192
#: register accumulators of a thread of the col_t_agg close
_TILE_ACC_MAX = 64
#: shared memory of one SM, the part the SM keeps per CTA, and the most one
#: CTA may have (bytes); the tile is sized so that two CTAs share an SM
_SM_SMEM = 228 * 1024
_CTA_RESERVED = 1024
_CTA_SMEM_MAX = 227 * 1024
_ROW_PHASE_B = {"none": 0, "close": 1, "wide": 2}


class _WarpOnly(Exception):
    """The program needs the warp layout."""


@dataclass
class _Val:
    """A row value of the tile layout: ``s`` a scalar (C expression), ``v``
    a register array ``expr[w]``, ``z`` an element-wise value of the tile
    row (``fn(rd)`` is its C expression at column q, ``rd(kind, k, lo)``
    the reader of tile k (``t``) or side position k (``s``) at q + lo), ``g``
    a wide product left @ side computed in phase B.  ``regs``: depends on a
    phase-A register; ``tile``: the tile index of a bind read as is."""
    kind: str
    w: int
    expr: str = ""
    fn: Optional[Callable] = None
    regs: bool = False
    tile: int = -1
    mm: tuple = ()


def _pad4(x: int) -> int:
    return -(-x // 4) * 4


def _xyzw(u: int) -> str:
    return "xyzw"[u]


class _TileEmitter:
    """Writes the tile layout's phase A (a thread per row, values in
    registers) and the accessors of its phase B; raises :class:`_WarpOnly`
    for a program it cannot express."""

    def __init__(self, cplan: CPlan):
        self.cp = cplan
        self.M = cplan.main.shape[0]
        self.pos = {b.nid: k for k, b in enumerate(cplan.binds)}
        self.shape_of = {b.nid: tuple(b.shape) for b in cplan.binds}
        rhs, used = set(), {cplan.prog_root, cplan.close_nid}
        for (_nid, op, ins, _shape, _attrs) in cplan.prog:
            for j, (kind, r) in enumerate(ins):
                if kind == "b":
                    (rhs if op == "matmul" and j == 1 else used).add(r)
        self.tiles = [cplan.main.nid] + [
            b.nid for b in cplan.binds[1:]
            if b.shape[0] == self.M and self.M > 1 and b.nid in used]
        self.tix = {nid: k for k, nid in enumerate(self.tiles)}
        self.tw = [self.shape_of[nid][1] for nid in self.tiles]
        self.vals: dict[tuple, _Val] = {}
        self.lines: list[str] = []
        self.sides: dict[tuple, int] = {}        # (pos, tb) -> sb offset
        self.side_lines: list[str] = []
        self.sbf = 0

    def emit(self, *lines: str) -> None:
        self.lines.extend(lines)

    # -- values ----------------------------------------------------------------
    def get(self, ref) -> _Val:
        kind, r = ref
        if kind == "l":
            return _Val("s", 1, _lit(r))
        if kind == "b":
            return self.bind(r)
        v = self.vals[("n", r)]
        if v.kind == "g":
            raise _WarpOnly("a wide product used inside the program")
        return v

    def value(self, nid: int) -> _Val:
        v = self.vals.get(("n", nid))
        return v if v is not None else self.bind(nid)

    def bind(self, nid: int) -> _Val:
        key = ("b", nid)
        if key in self.vals:
            return self.vals[key]
        r, c = self.shape_of[nid]
        p = self.pos[nid]
        name = f"b{p}"
        if nid in self.tix:
            k = self.tix[nid]
            if c == 1:
                v = _Val("s", 1, f"t{k}[0]", tile=k)
            elif c <= NARROW:
                self.emit(f"float {name}[{c}];", "#pragma unroll",
                          f"for (int t = 0; t < {c}; ++t) {name}[t] = "
                          f"t{k}[t];")
                v = _Val("v", c, name, regs=True, tile=k)
            else:
                v = _Val("z", c, fn=lambda rd, k=k: rd("t", k, 0), tile=k)
        elif r == 1:
            if c == 1:
                v = _Val("s", 1, f"__ldg(b.p[{p}])")
            elif c <= NARROW:
                self.emit(f"float {name}[{c}];", "#pragma unroll",
                          f"for (int t = 0; t < {c}; ++t) {name}[t] = "
                          f"__ldg(b.p[{p}] + t);")
                v = _Val("v", c, name, regs=True)
            else:
                v = _Val("z", c, fn=lambda rd, p=p: rd("s", p, 0))
        else:
            raise _WarpOnly(f"side of shape {(r, c)} read element-wise")
        self.vals[key] = v
        return v

    def lazy_loop(self, z: _Val, pre, per) -> None:
        """A loop over the columns q of ``z``: ``pre(q, vec)`` lines at the
        top of each step, ``per(expr, q, u)`` lines per element (u the
        float4 lane of a vectorised step, None otherwise).  A step takes
        four columns, each tile read one float4, where every tile read is
        16-byte aligned.  The LT lanes of a row take the steps in turn (the
        caller folds their partials with :meth:`lanes`)."""
        deps = []
        z.fn(lambda kind, k, lo: deps.append((kind, k, lo)) or "0.f")
        tdeps = sorted({(k, lo) for kind, k, lo in deps if kind == "t"})
        vec = z.w % 4 == 0 and all(lo % 4 == 0 and self.tw[k] % 4 == 0
                                   for k, lo in tdeps)
        body = []
        if vec:
            for k, lo in tdeps:
                body.append(f"const float4 x{k}_{lo} = *reinterpret_cast<"
                            f"const float4*>(t{k} + q + {lo});")
            body += pre("q", True)
            for u in range(4):
                e = z.fn(lambda kind, k, lo, u=u:
                         f"x{k}_{lo}.{_xyzw(u)}" if kind == "t"
                         else f"__ldg(b.p[{k}] + q + {lo + u})")
                body += per(e, f"(q + {u})", u)
            head = f"for (int q = 4 * sub; q < {z.w}; q += 4 * LT) {{"
        else:
            body += pre("q", False)
            body += per(z.fn(lambda kind, k, lo:
                             f"t{k}[q + {lo}]" if kind == "t"
                             else f"__ldg(b.p[{k}] + q + {lo})"), "q", None)
            head = f"for (int q = sub; q < {z.w}; q += LT) {{"
        self.emit(head, *("  " + ln for ln in body), "}")

    def lanes(self, code, names: list[str]) -> None:
        """Fold the LT lanes' partials of ``names`` (a butterfly: every
        lane ends with the same bits; a no-op at LT = 1)."""
        self.emit(*(f"{n} = rk::lane_reduce<LT>({code}, {n});"
                    for n in names))

    @staticmethod
    def el(v: _Val) -> str:
        return v.expr if v.kind == "s" else f"{v.expr}[t]"

    # -- ops -------------------------------------------------------------------
    def cellwise(self, name: str, op: str, ins, width: int) -> _Val:
        args = [self.get(r) for r in ins]
        fmt = _CELL_C[op]
        if any(a.kind == "z" for a in args):
            if any(a.kind == "v" or (a.kind == "z" and a.w != width)
                   for a in args):
                raise _WarpOnly(f"'{op}' over values of different widths")
            fns = [a.fn if a.kind == "z" else (lambda rd, e=a.expr: e)
                   for a in args]
            return _Val("z", width, fn=lambda rd: fmt.format(
                *(f(rd) for f in fns)), regs=any(a.regs for a in args))
        if width == 1:
            self.emit(f"const float {name} = "
                      f"{fmt.format(*(a.expr for a in args))};")
            return _Val("s", 1, name, regs=True)
        if width > NARROW or {a.w for a in args if a.kind == "v"} != {width}:
            raise _WarpOnly(f"'{op}' of width {width}")
        self.emit(f"float {name}[{width}];", "#pragma unroll",
                  f"for (int t = 0; t < {width}; ++t) {name}[t] = "
                  f"{fmt.format(*(self.el(a) for a in args))};")
        return _Val("v", width, name, regs=True)

    def reduce(self, name: str, op: str, x: _Val, drop: bool = False) -> None:
        """``float name`` = the aggregate ``op`` of row value x (``mean``
        sums); with ``drop``, the planted fault skips x's middle element."""
        a = AGG_CODE[op]
        skip = (lambda t: f"rowtile::kPlanted && {t} == {x.w // 2}") \
            if drop else None
        if x.kind == "s":
            val = f"rk::agg_add({a}, rk::agg_init({a}), {x.expr})"
            if drop:
                val = f"rowtile::kPlanted ? rk::agg_init({a}) : {val}"
            self.emit(f"const float {name} = {val};")
        elif x.kind == "v":
            cond = f"if (!({skip('t')})) " if drop else ""
            self.emit(f"float {name} = rk::agg_init({a});", "#pragma unroll",
                      f"for (int t = 0; t < {x.w}; ++t) {cond}{name} = "
                      f"rk::agg_add({a}, {name}, {x.expr}[t]);")
        else:
            self.emit(f"float {name} = rk::agg_init({a});")
            self.lazy_loop(x, lambda q, vec: [], lambda e, q, u: [
                (f"if (!({skip(q)})) " if drop else "")
                + f"{name} = rk::agg_add({a}, {name}, {e});"])
            self.lanes(a, [name])

    def row_agg(self, name: str, op: str, ref) -> _Val:
        x = self.get(ref)
        self.reduce(name, op, x)
        if op == "mean" and x.w > 1:
            self.emit(f"const float {name}m = {name} / {float(x.w)!r}f;")
            name += "m"
        return _Val("s", 1, name, regs=True)

    def stage_side(self, p: int, k: int, c: int, tb: bool) -> int:
        """Offset in ``sb`` of side p staged column-major, sb[j KP + q] =
        B(q, j), KP = k padded to 4 (zeros)."""
        key = (p, tb)
        if key not in self.sides:
            kp = _pad4(k)
            off = self.sides[key] = self.sbf
            self.sbf += c * kp
            src = (f"b.p[{p}] + j * {k} + q" if tb
                   else f"b.p[{p}] + q * {c} + j")
            self.side_lines += [
                f"for (int e = tid; e < {c * kp}; e += T) {{",
                f"  const int j = e / {kp}, q = e % {kp};",
                f"  sb[{off} + e] = q < {k} ? __ldg({src}) : 0.f;", "}"]
        return self.sides[key]

    def matmul(self, name: str, ins, shape, attrs: dict) -> _Val:
        (ka, ra), (kb, rb) = ins
        if attrs.get("ta", False) or kb != "b":
            raise _WarpOnly("transposed or computed matmul operand")
        a = self.get((ka, ra))
        k, c = a.w, shape[1]
        tb = bool(attrs.get("tb", False))
        if self.shape_of[rb] != ((c, k) if tb else (k, c)) or k < 2:
            raise _WarpOnly("matmul side does not match")
        p = self.pos[rb]
        if c > NARROW:
            if a.kind != "v":
                raise _WarpOnly(f"a {c}-column product of a wide row")
            return _Val("g", c, mm=(a, p, tb, k))
        acc = (lambda j: name) if c == 1 else (lambda j: f"{name}[{j}]")
        self.emit(f"float {name} = 0.f;" if c == 1
                  else f"float {name}[{c}] = {{}};")
        if a.kind == "z":
            off, kp = self.stage_side(p, k, c, tb), _pad4(k)

            def pre(q, vec):
                return [f"const float4 w{j} = *reinterpret_cast<const "
                        f"float4*>(sb + {off + j * kp} + {q});"
                        for j in range(c)] if vec else []

            def per(e, q, u):
                out = ["{", f"  const float x_ = {e};"]
                for j in range(c):
                    w = f"w{j}.{_xyzw(u)}" if u is not None \
                        else f"sb[{off + j * kp} + {q}]"
                    out.append(f"  {acc(j)} = fmaf(x_, {w}, {acc(j)});")
                return out + ["}"]

            self.lazy_loop(a, pre, per)
            self.lanes("rk::AGG_SUM", [acc(j) for j in range(c)])
        else:
            B = (lambda q, j: f"b.p[{p}] + {j} * {k} + {q}") if tb else \
                (lambda q, j: f"b.p[{p}] + {q} * {c} + {j}")
            for j in range(c):
                self.emit("#pragma unroll",
                          f"for (int q = 0; q < {k}; ++q) {acc(j)} = "
                          f"fmaf({a.expr}[q], __ldg({B('q', j)}), "
                          f"{acc(j)});")
        return _Val("s" if c == 1 else "v", c, name, regs=True)

    def idx(self, name: str, ref, lo: int, hi: int) -> _Val:
        w = hi - lo
        x = self.get(ref)
        if x.kind == "z":
            if w > NARROW:
                return _Val("z", w, fn=lambda rd: x.fn(
                    lambda kind, k, l: rd(kind, k, l + lo)), regs=x.regs)
            cols = [x.fn(lambda kind, k, l, j=j: f"t{k}[{l + lo + j}]"
                         if kind == "t" else f"__ldg(b.p[{k}] + "
                         f"{l + lo + j})") for j in range(w)]
            if w == 1:
                self.emit(f"const float {name} = {cols[0]};")
                return _Val("s", 1, name, regs=True)
            self.emit(f"float {name}[{w}];",
                      *(f"{name}[{j}] = {e};" for j, e in enumerate(cols)))
            return _Val("v", w, name, regs=True)
        if x.kind == "s":
            return x
        if w == 1:
            self.emit(f"const float {name} = {x.expr}[{lo}];")
            return _Val("s", 1, name, regs=True)
        self.emit(f"float {name}[{w}];", "#pragma unroll",
                  f"for (int t = 0; t < {w}; ++t) {name}[t] = "
                  f"{x.expr}[{lo} + t];")
        return _Val("v", w, name, regs=True)

    def program(self) -> None:
        for pos, (nid, op, ins, shape, attrs) in enumerate(self.cp.prog):
            attrs = dict(attrs)
            name = f"v{pos}"
            width = int(shape[1])
            if shape[0] not in (1, self.M):
                raise _WarpOnly(f"program value of shape {shape}")
            if op == "matmul":
                v = self.matmul(name, ins, shape, attrs)
            elif op in AGG_OPS and "axis" in attrs:
                if attrs["axis"] != "row":
                    raise _WarpOnly(f"{attrs['axis']} aggregate")
                v = self.row_agg(name, op, ins[0])
            elif op == "idx":
                v = self.idx(name, ins[0], int(attrs["lo"]), int(attrs["hi"]))
            elif op in _CELL_C:
                v = self.cellwise(name, op, ins, width)
            else:
                raise _WarpOnly(f"op '{op}'")
            self.vals[("n", nid)] = v


@dataclass(frozen=True)
class RowTile:
    """The tile layout of one Row CPlan (``csrc/row.cuh`` sums the shared
    memory again and checks it): ``threads`` per CTA, ``rows`` per tile,
    ``lt`` lanes per row in phase A (1 unless a tile has fewer rows than
    threads), a ring of ``stages`` tiles, ``smem`` bytes of dynamic shared
    memory, ``ctas`` CTAs per SM; ``kt``, ``ng``, ``sl``: the close's
    closer columns per thread, column groups and row slices; ``cw``,
    ``pbr``, ``u``: the wide root's column threads, rows in parallel and
    columns per thread."""
    threads: int
    rows: int
    lt: int
    stages: int
    smem: int
    ctas: int
    kt: int = 1
    ng: int = 1
    sl: int = 1
    cw: int = 1
    pbr: int = 1
    u: int = 1


def _tile_smem(rows: int, stages: int, widths: list[int], gp: int,
               sbf: int, fold: int) -> int:
    stage = sum(_pad4(rows * w) for w in widths)
    return 4 * max(stages * stage + _pad4(rows * gp) + sbf, fold)


def row_tile(widths: list[int], gp: int, sbf: int, variant: str, c: int,
             kc: int, phase_b: str) -> RowTile:
    """The largest tile (at most ``_TILE_ROWS_MAX`` rows) whose ring, gs
    and staged sides fit two CTAs in an SM (one where none does), for tiled
    binds of ``widths``, ``gp`` gs floats per row, ``sbf`` staged side
    floats, root width ``c`` and closer width ``kc``.  Raises
    :class:`_WarpOnly` when a row does not fit."""
    cands = list(range(_TILE_ROWS_MAX, _TILE_THREADS - 1, -_TILE_THREADS))
    cands += [64, 32, 16, 8, 4, 2, 1]
    t, stages = _TILE_THREADS, _TILE_STAGES
    if sum(widths) >= _WIDE_ROW_FLOATS:
        cands = [r for r in cands if r <= t // 32]
    for budget in ((_SM_SMEM // 2) - _CTA_RESERVED, _CTA_SMEM_MAX):
        for rows in cands:
            lt = 1 if rows >= t else min(32, t // rows)
            if rows % (t // lt):
                continue        # under t / 32 rows a pass holds no whole row
            kt = ng = sl = cw = pbr = u = 1
            fold = {FULL_AGG: t, COL_AGG: t * c}.get(variant, 0)
            if phase_b == "close":
                kt = 4
                while -(-kc // kt) > t:
                    kt += 4
                if kt * c > _TILE_ACC_MAX:
                    raise _WarpOnly(f"close of {kc} x {c} accumulators")
                ng = -(-kc // kt)
                sl = t // ng
                fold = sl * kc * c
            elif phase_b == "wide":
                cw = min(c, t)
                pbr, u = t // cw, -(-c // cw)
            smem = _tile_smem(rows, stages, widths, gp, sbf, fold)
            if smem <= budget:
                ctas = max(1, min(_SM_SMEM // (smem + _CTA_RESERVED),
                                  512 // t))
                return RowTile(t, rows, lt, stages, smem, ctas, kt, ng, sl,
                               cw, pbr, u)
    raise _WarpOnly("a row does not fit the shared memory")


def _tile_source(cplan: CPlan) -> KernelSource:
    """The Row template in the tile layout; raises :class:`_WarpOnly`."""
    variant = cplan.variant
    em = _TileEmitter(cplan)
    em.program()
    root = em.value(cplan.prog_root)
    C = root.w
    agg = "sum" if variant == COL_T_AGG else (cplan.agg_op or "sum")
    out_lines, phase_b, KC, to = [], "none", 0, 1
    gs_vals = []                       # (value, gs offset) stored in phase A
    gp = 0

    def gs_width(w):
        return w if w < 4 else _pad4(w)

    if variant in (NO_AGG, COL_AGG):
        if root.kind == "g":
            if variant != NO_AGG:
                raise _WarpOnly("wide product under a column aggregate")
            phase_b = "wide"
            left = root.mm[0]
            gs_vals.append((left, 0))
            gp = gs_width(left.w)
        elif root.kind == "z":
            raise _WarpOnly("wide element-wise root")
        else:
            to = C
            out_lines = [f"o[0] = {root.expr};"] if C == 1 else [
                "#pragma unroll",
                f"for (int t = 0; t < {C}; ++t) o[t] = {root.expr}[t];"]
    elif variant in (ROW_AGG, FULL_AGG):
        if root.kind == "g":
            raise _WarpOnly("wide product under a row aggregate")
        em.reduce("a_", agg, root, drop=variant == ROW_AGG)
        out_lines = ["o[0] = a_;"]
    else:                                          # col_t_agg
        phase_b = "close"
        closer = em.value(cplan.close_nid)
        KC = closer.w
        if root.kind in ("z", "g") or closer.kind == "g" or C > NARROW:
            raise _WarpOnly("wide close operand")
        if closer.kind == "z" and closer.regs:
            raise _WarpOnly("closer depends on phase-A registers")
        if root.tile < 0:
            gs_vals.append((root, 0))
            gp = gs_width(C)
        if closer.tile < 0 and closer.kind != "z":
            gs_vals.append((closer, gp))
            gp += gs_width(KC)
    if gp > 4:
        gp = _pad4(gp)
    for v, off in gs_vals:
        if v.kind == "s":
            out_lines.append(f"if (sub == 0) gs[r * {gp} + {off}] = "
                             f"{v.expr};")
        else:
            out_lines += ["#pragma unroll",
                          f"for (int t = 0; t < {v.w}; ++t) "
                          f"if (sub == 0) gs[r * {gp} + {off} + t] = "
                          f"{v.expr}[t];"]

    widths = em.tw
    lay = row_tile(widths, gp, em.sbf, variant, C, KC, phase_b)
    offs, acc_off = [], 0
    for w in widths:
        offs.append(acc_off)
        acc_off += _pad4(lay.rows * w)
    tile_ptrs = [f"const float* t{k} = buf + {offs[k]} + r * {w};"
                 for k, w in enumerate(widths)]

    def gs_read(dst: str, off: int, w: int) -> list[str]:
        if off % 4 == 0 and gp % 4 == 0 and w >= 4:
            lines = []
            for u in range(_pad4(w) // 4):
                lines.append(f"{{ const float4 y = *reinterpret_cast<const "
                             f"float4*>(gs + r * {gp} + {off + 4 * u});")
                for lane in range(4):
                    if 4 * u + lane < w:
                        lines.append(f"  {dst}[{4 * u + lane}] = "
                                     f"y.{_xyzw(lane)};")
                lines.append("}")
            return lines
        return [f"{dst}[{j}] = gs[r * {gp} + {off + j}];" for j in range(w)]

    def val_read(dst: str, v: _Val, off: int) -> list[str]:
        if v.tile >= 0:
            return [f"{dst}[{j}] = t{v.tile}[{j}];" for j in range(v.w)]
        return gs_read(dst, off, v.w)

    phase_fns = []
    sig = ("const rk::Binds<NB>& b, const float* buf, const float* gs, "
           "int r")
    if phase_b == "close":
        kt = lay.kt
        if closer.tile >= 0:
            k = closer.tile
            if em.tw[k] % 4 == 0 and kt % 4 == 0:
                cbody = []
                for u in range(kt // 4):
                    cbody += [f"if (col0 + {4 * u} < KC) {{",
                              f"  const float4 x = *reinterpret_cast<const "
                              f"float4*>(t{k} + col0 + {4 * u});",
                              *(f"  cv[{4 * u + lane}] = x.{_xyzw(lane)};"
                                for lane in range(4)),
                              "} else {",
                              *(f"  cv[{4 * u + lane}] = 0.f;"
                                for lane in range(4)), "}"]
            else:
                cbody = ["#pragma unroll",
                         "for (int kt = 0; kt < KT; ++kt)",
                         f"  cv[kt] = col0 + kt < KC ? t{k}[col0 + kt] : "
                         f"0.f;"]
        elif closer.kind == "z":
            e = closer.fn(lambda kind, k, lo: f"t{k}[col + {lo}]"
                          if kind == "t" else f"__ldg(b.p[{k}] + col + {lo})")
            cbody = ["#pragma unroll", "for (int kt = 0; kt < KT; ++kt) {",
                     "  const int col = col0 + kt;",
                     f"  cv[kt] = col < KC ? {e} : 0.f;", "}"]
        else:
            off = gs_vals[-1][1]
            cbody = ["#pragma unroll",
                     "for (int kt = 0; kt < KT; ++kt)",
                     f"  cv[kt] = col0 + kt < KC ? gs[r * {gp} + {off} + "
                     f"col0 + kt] : 0.f;"]
        phase_fns += [
            f"__device__ static __forceinline__ void closer_at({sig}, "
            "int col0, float (&cv)[KT]) {",
            *("  " + ln for ln in tile_ptrs + cbody), "}",
            f"__device__ static __forceinline__ void root_at({sig}, "
            "float (&rv)[C]) {",
            *("  " + ln for ln in tile_ptrs + val_read("rv", root, 0)), "}"]
    elif phase_b == "wide":
        left, p, tb, k = root.mm
        B = f"b.p[{p}] + j * {k} + q" if tb else f"b.p[{p}] + q * {C} + j"
        phase_fns += [
            f"__device__ static __forceinline__ void left_at({sig}, "
            "float (&g)[K]) {",
            *("  " + ln for ln in gs_read("g", 0, k)), "}",
            "__device__ static __forceinline__ void bcol("
            "const rk::Binds<NB>& b, int j, float (&w)[K]) {",
            "#pragma unroll",
            f"  for (int q = 0; q < K; ++q) w[q] = __ldg({B});", "}"]

    mean = agg == "mean" and variant in (ROW_AGG, COL_AGG, FULL_AGG)
    elems = {COL_AGG: C, FULL_AGG: 1, COL_T_AGG: KC * C}.get(variant, 0)
    kw = root.mm[3] if phase_b == "wide" else 1
    sel = lambda vals: _select([str(v) for v in vals], "-1")
    lines = [
        "// Row template, tile layout: " + _describe(cplan),
        *_header("row"),
        "struct Prog {",
        f"  static constexpr int NB = {len(cplan.binds)}, LAYOUT = 1, "
        f"T = {lay.threads}, R = {lay.rows}, LT = {lay.lt}, "
        f"STAGES = {lay.stages}, CTAS = {lay.ctas}, SMEM = {lay.smem};",
        f"  static constexpr int NT = {len(widths)}, C = {C}, KC = {KC}, "
        f"TO = {to}, VARIANT = {_ROW_VARIANT[variant]}, "
        f"AGG = {AGG_CODE[agg]}, MEAN = {int(mean)};",
        f"  static constexpr int GP = {gp}, SBF = {em.sbf}, "
        f"PHASE_B = {_ROW_PHASE_B[phase_b]};",
        f"  static constexpr int KT = {lay.kt}, NG = {lay.ng}, "
        f"SL = {lay.sl}, K = {kw}, CW = {lay.cw}, PBR = {lay.pbr}, "
        f"U = {lay.u};",
        "  __host__ __device__ static constexpr int tile_bind(int k) "
        f"{{ return {sel([em.pos[n] for n in em.tiles])}; }}",
        "  __host__ __device__ static constexpr int tile_width(int k) "
        f"{{ return {sel(widths)}; }}",
        "  __host__ __device__ static constexpr int tile_off(int k) "
        f"{{ return {sel(offs)}; }}",
        "  __device__ static __forceinline__ int agg_of(int) "
        "{ return AGG; }",
        "  __device__ static __forceinline__ float fin(int, float a, "
        "double aux) { return MEAN ? a / (float)aux : a; }",
        "  __device__ static __forceinline__ void stage_sides("
        "const rk::Binds<NB>& b, float* sb, int tid) {",
        *("    " + ln for ln in em.side_lines),
        "  }",
        "  __device__ static __forceinline__ void eval("
        "const rk::Binds<NB>& b, const float* buf, const float* sb, "
        "float* gs, int r, int sub, float (&o)[TO]) {",
        *("    " + ln for ln in tile_ptrs + em.lines + out_lines),
        "  }",
        *("  " + ln for ln in phase_fns),
        "};", "",
        *_launcher("row_launch")]
    return KernelSource("row", "\n".join(lines), (cplan.main.shape[0], C),
                        elems=elems, variant=variant, layout="tile",
                        threads=lay.threads, rows=lay.rows,
                        stages=lay.stages,
                        smem=lay.smem, ctas=lay.ctas, parts_per_cta=1)



def _row_lanes(cplan: CPlan) -> int:
    """32 lanes (one warp) per row when any row value is a vector; one
    thread per row when every value is a per-row scalar."""
    if cplan.variant == COL_T_AGG:
        return 32
    for b in cplan.binds:
        if b.shape[1] > 1:
            return 32
    for (_nid, op, _ins, shape, _attrs) in cplan.prog:
        if op in ("matmul", "idx") or shape[1] > 1:
            return 32
    return 1


def row_source(cplan: CPlan) -> KernelSource:
    """The Row template, all five variants: the tile layout where the
    program's computed row values are narrow (:class:`_TileEmitter`), the
    warp layout where its row arrays fit :data:`WARP_FLOATS_MAX` register
    floats a lane, else the staged layout where its row-wide binds fit a
    cluster's shared memory (:func:`staged_geometry`), else the streaming
    layout (``KernelSource.layout`` says which).  A program the staged and
    streaming layouts cannot express (a column aggregate, an in-program
    matmul) keeps the warp layout up to :data:`WARP_FLOATS_LIMIT`, and
    raises ``NotImplementedError`` beyond it."""
    variant = cplan.variant
    if variant not in _ROW_VARIANT:
        raise _unsupported(cplan, "not a Row variant")
    M = cplan.main.shape[0]
    if root_shape(cplan)[0] != M:
        raise _unsupported(cplan, f"root of shape {root_shape(cplan)} is "
                                  f"not a value per row of the {M}-row main")
    try:
        return _tile_source(cplan)
    except _WarpOnly:
        pass
    src = _warp_source(cplan)
    if src.floats <= WARP_FLOATS_MAX:
        return src
    try:
        return _staged_source(cplan)
    except _ClusterTooSmall:
        return _stream_source(cplan)
    except NotImplementedError:
        if src.floats <= WARP_FLOATS_LIMIT:
            return src
        raise


#: the most register floats a lane (the slots of its row arrays, summed)
#: the warp layout takes for a program the staged layout can run: the
#: largest that ptxas compiled without spill on the card.  The fused
#: rmsnorm's warp source holds six arrays of d / 32 slots; its ptxas lines
#: (sm_90a, PERF.md §6) at d = 256 / 512 / 768 / 1,024: 48 / 96 / 144 /
#: 192 floats, 48 / 76 / 146 / 128 registers, no spill; at 1,536 / 2,048 /
#: 3,072 / 4,096: 288 / 384 / 576 / 768 floats, 255 registers and 72 / 32
#: / 288 / 668 bytes of spill.  So every LM rmsnorm width and the fused
#: loss's backward at 2,048 (704 floats) go to the staged layout.
WARP_FLOATS_MAX = 192
#: the most the warp layout takes for a program the staged and streaming
#: layouts cannot express (column aggregates, in-program matmuls): it
#: spills there, and beyond this the card cannot reserve the local memory
#: of its resident threads (the fused loss's backward would hold 11 arrays
#: of V / 32, 11,000 floats at V = 32,000)
WARP_FLOATS_LIMIT = 1024


def _warp_source(cplan: CPlan) -> KernelSource:
    """The Row template in the warp layout."""
    variant = cplan.variant
    M = cplan.main.shape[0]
    lanes = _row_lanes(cplan)
    em = _RowEmitter(cplan, lanes)
    em.program()
    C = em.copy_out("r", cplan.prog_root)
    if variant == NO_AGG and tuple(cplan.out_shape) != (M, C):
        raise _unsupported(cplan, f"output {cplan.out_shape} is not the "
                                  f"root's ({M}, {C})")
    KC = em.copy_out("c", cplan.close_nid) if variant == COL_T_AGG else 0
    if variant == COL_T_AGG:
        em.smw = max(em.smw, KC + C)
    slots = em.slots
    tr, tk = slots(C), max(1, slots(KC))
    te = {COL_AGG: tr, COL_T_AGG: -(-KC * C // 32)}.get(variant, 1)
    wpb = min(8, _SMEM_FLOATS // em.smw)
    if wpb < 1:
        raise _unsupported(cplan, f"row staging of {em.smw} floats exceeds "
                                  f"shared memory")
    agg = "sum" if variant == COL_T_AGG else (cplan.agg_op or "sum")
    mean = agg == "mean" and variant in (ROW_AGG, COL_AGG, FULL_AGG)
    elems = {COL_AGG: C, FULL_AGG: 1, COL_T_AGG: KC * C}.get(variant, 0)
    lines = [
        "// Row template: " + _describe(cplan), *_header("row"),
        "struct Prog {",
        f"  static constexpr int NB = {len(cplan.binds)}, LAYOUT = 0, "
        f"L = {lanes}, "
        f"WPB = {wpb}, SMW = {em.smw};",
        f"  static constexpr int C = {C}, KC = {KC}, TR = {tr}, TK = {tk}, "
        f"TE = {te};",
        f"  static constexpr int VARIANT = {_ROW_VARIANT[variant]}, "
        f"AGG = {AGG_CODE[agg]}, MEAN = {int(mean)};",
        "  __device__ static __forceinline__ int agg_of(int) "
        "{ return AGG; }",
        "  __device__ static __forceinline__ float fin(int, float a, "
        "double aux) { return MEAN ? a / (float)aux : a; }",
        "  __device__ static __forceinline__ void eval("
        "const rk::Binds<NB>& b, long long i, int sub, float* sm, "
        "float (&r)[TR], float (&c)[TK]) {",
        *("    " + ln for ln in em.lines),
        "  }",
        "};", "",
        *_launcher("row_launch")]
    return KernelSource("row", "\n".join(lines),
                        (cplan.main.shape[0], C), elems=elems,
                        variant=variant, layout="warp", threads=wpb * 32,
                        rows=wpb * (32 // lanes), ctas=8, parts_per_cta=wpb,
                        floats=em.floats)


# --------------------------------------------------------------------------
# Row, streaming layout: a CTA per row, the row read in column slices once a
# pass
# --------------------------------------------------------------------------

#: threads of a streaming CTA and CTAs an SM is sized for (64 registers a
#: thread at most)
STREAM_THREADS = 256
STREAM_CTAS = 4
_STREAM_VARIANT = (NO_AGG, ROW_AGG, FULL_AGG)


class _StreamEmitter:
    """Splits a Row program over wide rows into passes and writes its row
    body.  Values are row-wide (``"w"``: evaluated per element inside a
    pass's column walk, never stored) or row scalars (``"s"``).  A row
    aggregate of a wide value is folded in the pass after the last row
    scalar it needs: its ``level`` is that pass + 1, when its value is
    known.  Row scalars live in registers (every thread computes the same
    bits), an aggregate's result reaches them through shared memory."""

    def __init__(self, cplan: CPlan):
        self.cp = cplan
        self.M, self.N = cplan.main.shape
        self.pos = {b.nid: k for k, b in enumerate(cplan.binds)}
        self.kind: dict[tuple, str] = {}
        self.level: dict[tuple, int] = {}
        self.prog: dict[int, tuple] = {}       # nid -> (pos, op, ins, attrs)
        self.aggs: list[tuple] = []            # (pass, slot, code, ref, nid)
        self.staged: Optional[StagedGeometry] = None
        self.recip: set = set()         # row scalars a walk divides by
        for b in cplan.binds:
            r, c = b.shape
            if r not in (1, self.M):
                raise _unsupported(cplan, f"side of shape {(r, c)}")
            if c == self.N:
                self.kind[("b", b.nid)] = "w"
            elif c == 1:
                self.kind[("b", b.nid)] = "s"
            else:
                raise _unsupported(cplan, f"bind of width {c} in a program "
                                          f"over {self.N}-wide rows")
            self.level[("b", b.nid)] = 0
        for pos, (nid, op, ins, shape, attrs) in enumerate(cplan.prog):
            attrs = dict(attrs)
            w = int(shape[1])
            if shape[0] not in (1, self.M) or w not in (1, self.N):
                raise _unsupported(cplan, f"program value of shape {shape}")
            key = ("n", nid)
            self.prog[nid] = (pos, op, tuple(ins), attrs)
            if op in AGG_OPS and "axis" in attrs:
                if attrs["axis"] != "row":
                    raise _unsupported(cplan, f"{attrs['axis']} aggregate "
                                              f"inside a program")
                x = ins[0]
                self.kind[key] = "s"
                if self.kind_of(x) == "w":
                    ps = self.level_of(x)
                    self.aggs.append((ps, len(self.aggs), AGG_CODE[op], x,
                                      nid))
                    self.level[key] = ps + 1
                else:
                    self.level[key] = self.level_of(x)
            elif op in _CELL_C:
                wide = any(self.kind_of(r) == "w" for r in ins)
                if wide != (w == self.N and self.N > 1):
                    raise _unsupported(cplan, f"'{op}' of width {w}")
                self.kind[key] = "w" if wide else "s"
                self.level[key] = max([self.level_of(r) for r in ins] + [0])
            else:
                raise _unsupported(cplan, f"op '{op}' in a streamed row "
                                          f"program")

    def kind_of(self, ref) -> str:
        return "s" if ref[0] == "l" else self.kind[tuple(ref)]

    def level_of(self, ref) -> int:
        return 0 if ref[0] == "l" else self.level[tuple(ref)]

    def ref(self, ref) -> str:
        """C expression of a value inside the body (a wide value: its
        element at the current column)."""
        kind, r = ref
        if kind == "l":
            return _lit(r)
        if kind == "b":
            k = self.pos[r]
            return f"w{k}" if self.kind[("b", r)] == "w" else f"sb{k}"
        pos = self.prog[r][0]
        return f"e{pos}" if self.kind[("n", r)] == "w" else f"s{pos}"

    def wide_closure(self, refs) -> tuple[list[int], list[int]]:
        """(wide program nids in program order, wide bind positions) that
        the element-wise values ``refs`` are computed from."""
        nids, binds, todo = set(), set(), list(refs)
        while todo:
            kind, r = todo.pop()
            if kind == "l" or self.kind[(kind, r)] != "w":
                continue
            if kind == "b":
                binds.add(self.pos[r])
            elif r not in nids:
                nids.add(r)
                todo.extend(self.prog[r][2])
        return sorted(nids, key=lambda n: self.prog[n][0]), sorted(binds)

    def element(self, nids, binds, reader) -> list[str]:
        """One column's element-wise values: bind k read by
        ``reader(k)``."""
        lines = [f"const float w{k} = {reader(k)};" for k in binds]
        for nid in nids:
            pos, op, ins, _a = self.prog[nid]
            if op == "div" and tuple(ins[1]) in self.recip:
                val = f"({self.ref(ins[0])} * rc_{self.ref(ins[1])})"
            else:
                val = _CELL_C[op].format(*(self.ref(r) for r in ins))
            lines.append(f"const float e{pos} = {val};")
        return lines

    def walk(self, refs, fold: Callable, planted: bool,
             group_head: tuple = (), group_tail: tuple = (),
             first: bool = False) -> list[str]:
        """The column walk of one pass, in 4-column groups (float4 loads)
        where every row is 16-byte aligned (``vec``), else column by
        column: ``fold(u)`` gives the statements that consume column u's
        values (u = 0..3 of a group, None in the one-column walk);
        ``group_head`` starts and ``group_tail`` ends each group.  Thread ``tid`` takes groups tid,
        tid + T, ... (columns tid, tid + T, ...), in that order.  The
        planted build drops the middle column slice of a ``planted``
        walk.  Staged (``self.staged``): the walk reads the CTA's slice in
        shared memory, ``first`` (the row's first pass) chunk by chunk,
        each after its barrier; nothing is planted here."""
        nids, binds = self.wide_closure(refs)
        if self.staged is not None:
            return self._staged_walk(nids, binds, fold, group_head,
                                     group_tail, first)
        T, N = STREAM_THREADS, self.N
        mid = -(-N // (4 * T)) // 2
        skip = (f"if (rowtile::kPlanted && j / {4 * T} == {mid}) continue;"
                if planted else "")
        vec = [f"for (long long j = 4 * tid; j < {N}; j += {4 * T}) {{"]
        if skip:
            vec.append("  " + skip)
        vec += [f"  const float4 q{k} = rowstream::ld4(r{k} + j);"
                for k in binds]
        vec += ["  " + ln for ln in group_head]
        for u in range(4):
            c = _xyzw(u)
            vec += ["  {", *("    " + ln for ln in self.element(
                nids, binds, lambda k: f"q{k}.{c}") + fold(u)), "  }"]
        vec += ["  " + ln for ln in group_tail]
        vec.append("}")
        one = [f"for (long long j = tid; j < {N}; j += {T}) {{"]
        if skip:
            one.append("  " + skip)
        one += ["  " + ln for ln in self.element(
            nids, binds, lambda k: f"__ldg(r{k} + j)") + fold(None)]
        one.append("}")
        return ["if (vec) {", *("  " + ln for ln in vec), "} else {",
                *("  " + ln for ln in one), "}"]

    def _staged_walk(self, nids, binds, fold, group_head, group_tail,
                     first) -> list[str]:
        T = self.staged.threads
        inner = [f"const float4 q{k} = rowstaged::lds4(r{k} + j);"
                 for k in binds]
        inner += list(group_head)
        for u in range(4):
            c = _xyzw(u)
            inner += ["{", *("  " + ln for ln in self.element(
                nids, binds, lambda k: f"q{k}.{c}") + fold(u)), "}"]
        inner += list(group_tail)
        if first:
            vec = ["for (int c = 0; c < CH; ++c) {",
                   "  rowstaged::wait(bars + c, par);",
                   "  const int hi = n < (c + 1) * CHW ? n : (c + 1) * CHW;",
                   f"  for (int j = c * CHW + 4 * tid; j < hi; "
                   f"j += {4 * T}) {{",
                   *("    " + ln for ln in inner), "  }", "}"]
        else:
            vec = [f"for (int j = 4 * tid; j < n; j += {4 * T}) {{",
                   *("  " + ln for ln in inner), "}"]
        one = [f"for (int j = tid; j < n; j += {T}) {{",
               *("  " + ln for ln in self.element(
                   nids, binds, lambda k: f"r{k}[j]") + fold(None)), "}"]
        return ["if (vec) {", *("  " + ln for ln in vec), "} else {",
                *("  " + ln for ln in one), "}"]

    def scalars(self, level: int) -> list[str]:
        """The row scalars that become known at ``level`` (element-wise
        over scalars, in program order; a row aggregate's own value is
        read from shared memory after its fold)."""
        out = []
        for nid, (pos, op, ins, attrs) in self.prog.items():
            key = ("n", nid)
            if self.kind[key] != "s" or self.level[key] != level:
                continue
            if op in AGG_OPS and "axis" in attrs:
                if self.kind_of(ins[0]) == "w":
                    continue
                x = self.ref(ins[0])
                out.append(f"const float s{pos} = "
                           f"{f'({x} * {x})' if op == 'sum_sq' else x};")
            else:
                out.append(f"const float s{pos} = "
                           f"{_CELL_C[op].format(*(self.ref(r) for r in ins))};")
            out += self.reciprocal(key)
        return out

    def plan_reciprocals(self) -> None:
        """Where a 0/1 comparison is divided by a row scalar (the loss's
        tie share ``(L == max) / count``), multiply by the scalar's
        reciprocal, computed once a row: x / s and x * (1 / s) round to the
        same float for x in {0, 1} (and give the same NaN, infinity and
        signed zero), so the program's value is unchanged while the column
        walk does one multiply where it did an IEEE division."""
        for nid, (_pos, op, ins, _a) in self.prog.items():
            if op != "div" or self.kind[("n", nid)] != "w":
                continue
            num, den = ins
            if num[0] == "n" and self.prog[num[1]][1] in _ZERO_ONE_OPS \
                    and self.kind_of(den) == "s" and den[0] != "l":
                self.recip.add(tuple(den))

    def reciprocal(self, ref) -> list[str]:
        """The line defining scalar ``ref``'s reciprocal, where a walk
        multiplies by it (:meth:`plan_reciprocals`)."""
        if tuple(ref) not in self.recip:
            return []
        x = self.ref(ref)
        return [f"const float rc_{x} = 1.f / {x};"]


#: program ops whose value is exactly 0 or 1 (``rk::f_cmp``, ``f_neq0``)
_ZERO_ONE_OPS = frozenset({"eq", "neq", "lt", "le", "gt", "ge", "neq0"})


class _RowPasses:
    """A Row program over wide rows split into passes (:class:`_StreamEmitter`)
    and its row body, for the streaming and the staged layouts: the two
    differ in where a pass reads the row (HBM, or the CTA's slice in shared
    memory) and in the fold (a CTA's, or a cluster's)."""

    def __init__(self, cplan: CPlan, layout: str):
        variant = cplan.variant
        if variant not in _STREAM_VARIANT:
            raise _unsupported(cplan, f"a column aggregate over {layout} "
                                      f"rows")
        em = self.em = _StreamEmitter(cplan)
        M, N = em.M, em.N
        root = ("n", cplan.prog_root) if cplan.prog_root in em.prog else \
            ("b", cplan.prog_root)
        self.root, self.wide_root = root, em.kind_of(root) == "w"
        self.agg = cplan.agg_op or "sum"
        aggs = list(em.aggs)
        if variant != NO_AGG and self.wide_root:   # the row's own aggregate
            aggs.append((em.level_of(root), len(aggs), AGG_CODE[self.agg],
                         root, None))
        if variant == NO_AGG and tuple(cplan.out_shape) != (
                M, N if self.wide_root else 1):
            raise _unsupported(cplan, f"output {cplan.out_shape}")
        self.aggs = aggs
        self.npass = max([a[0] + 1 for a in aggs] + [0])
        self.write = variant == NO_AGG and self.wide_root
        self.passes = self.npass + int(self.write)
        self.wide_binds = sorted(em.pos[b.nid] for b in cplan.binds
                                 if em.kind[("b", b.nid)] == "w")
        self.scalar_binds = [
            f"const float sb{k} = __ldg(b.p[{k}]"
            f"{' + i' if cplan.binds[k].shape[0] == M > 1 else ''});"
            for k, bb in enumerate(cplan.binds)
            if em.kind[("b", bb.nid)] == "s"]
        self.mean = self.agg == "mean" and variant in (ROW_AGG, FULL_AGG)

    def body(self, fold_call: Callable) -> list[str]:
        """The passes, the tail and the return; ``fold_call(here)``: the
        statements that fold the pass's accumulators ``a{slot}`` (``here``:
        its aggregates) across the CTA (or the cluster) into ``rs[slot]``."""
        em, cplan = self.em, self.em.cp
        body = em.scalars(0)
        row_value = "0.f"
        for ps in range(self.npass):
            here = [a for a in self.aggs if a[0] == ps]
            body.append(f"// pass {ps}: fold {len(here)} row aggregate(s)")
            body.append("{")
            inner = [f"float a{slot} = rk::agg_init({code});"
                     for _p, slot, code, _r, _n in here]

            def fold(u, here=here):
                return [f"a{slot} = rk::agg_add({code}, a{slot}, "
                        f"{em.ref(r)});" for _p, slot, code, r, _n in here]

            inner += em.walk([a[3] for a in here], fold,
                             planted=ps == self.npass - 1, first=ps == 0)
            inner += fold_call(here)
            body += ["  " + ln for ln in inner]
            body.append("}")
            for _p, slot, code, _r, nid in here:
                if nid is None:
                    row_value = f"rs[{slot}]"
                    continue
                pos, op = em.prog[nid][:2]
                val = f"rs[{slot}]" + (f" / {float(em.N)!r}f" if op == "mean"
                                       else "")
                body.append(f"const float s{pos} = {val};")
                body += em.reciprocal(("n", nid))
            body += em.scalars(ps + 1)
        if self.write:
            x = em.ref(self.root)
            body.append(f"// pass {self.npass}: write the row")
            body += em.walk([self.root], lambda u: [f"o[j] = {x};"]
                            if u is None else [f"o4.{_xyzw(u)} = {x};"],
                            planted=False, group_head=("float4 o4;",),
                            group_tail=("rowstream::st4(o + j, o4);",),
                            first=self.npass == 0)
        elif not self.wide_root:
            x = em.ref(self.root)
            row_value = (x if cplan.variant == NO_AGG else
                         f"rk::agg_add({AGG_CODE[self.agg]}, "
                         f"rk::agg_init({AGG_CODE[self.agg]}), {x})")
        body.append(f"return {row_value};")
        return body

    def prog_lines(self) -> list[str]:
        """``Prog``'s members common to both layouts."""
        cplan = self.em.cp
        return [
            f"  static constexpr int NPASS = {self.npass}, "
            f"WRITE = {int(self.write)}, PASSES = {self.passes}, "
            f"NS = {max(len(self.aggs), 1)};",
            f"  static constexpr long long N = {self.em.N};",
            "  static constexpr int C = 1, KC = 0;   // a partial is one value",
            f"  static constexpr int VARIANT = {_ROW_VARIANT[cplan.variant]}, "
            f"AGG = {AGG_CODE[self.agg]}, MEAN = {int(self.mean)};",
            "  __device__ static __forceinline__ int agg_of(int) "
            "{ return AGG; }",
            "  __device__ static __forceinline__ float fin(int, float a, "
            "double aux) { return MEAN ? a / (float)aux : a; }"]


def _stream_source(cplan: CPlan) -> KernelSource:
    """The Row template in the streaming layout (``no_agg``, ``row_agg``
    and ``full_agg``; raises ``NotImplementedError`` for the rest)."""
    rp = _RowPasses(cplan, "streamed")
    em, M, N = rp.em, rp.em.M, rp.em.N
    body = [f"const float* r{k} = b.p[{k}]"
            f"{f' + i * {N}' if cplan.binds[k].shape[0] == M > 1 else ''};"
            for k in rp.wide_binds]
    body += rp.scalar_binds
    aligned = " && ".join([f"rowstream::aligned(r{k})" for k in rp.wide_binds]
                          + (["rowstream::aligned(o)"] if rp.write else []))
    body.append(f"const bool vec = {'true' if N % 4 == 0 else 'false'}"
                f"{' && ' + aligned if aligned and N % 4 == 0 else ''};")
    body += rp.body(lambda here: [
        f"rowstream::fold<{STREAM_THREADS}>({code}, a{slot}, red, "
        f"rs + {slot});" for _p, slot, code, _r, _n in here])
    lines = [
        "// Row template (streaming layout): " + _describe(cplan),
        *_header("row"),
        "struct Prog {",
        f"  static constexpr int NB = {len(cplan.binds)}, LAYOUT = 2, "
        f"T = {STREAM_THREADS}, CTAS = {STREAM_CTAS};",
        *rp.prog_lines(),
        "  // row i; o: its output row (written by the last pass of a wide "
        "no_agg root); returns the row's value",
        "  __device__ static __forceinline__ float row("
        "const rk::Binds<NB>& b, long long i, int tid, float* rs, "
        "float* red, float* o) {",
        *("    " + ln for ln in body),
        "  }",
        "};", "",
        *_launcher("row_launch")]
    return KernelSource("row", "\n".join(lines),
                        (M, N if rp.wide_root else 1),
                        elems=1 if cplan.variant == FULL_AGG else 0,
                        variant=cplan.variant, layout="stream",
                        threads=STREAM_THREADS, rows=1, ctas=STREAM_CTAS,
                        parts_per_cta=1, passes=rp.passes)


# --------------------------------------------------------------------------
# Row, staged layout: each row copied once into the shared memory of a CTA
# or of a thread-block cluster (row_staged.cuh)
# --------------------------------------------------------------------------

#: dynamic shared memory a CTA may have, and what an SM has for its CTAs
#: (bytes; each resident CTA also takes STAGED_RESERVED of it)
STAGED_SMEM_MAX = 232_448
_SM_SMEM, _STAGED_RESERVED = 233_472, 1024
#: cluster sizes the staged layout takes (above 8: non-portable, opted
#: into at launch)
STAGED_CLUSTERS = (1, 2, 4, 8, 16)
#: a row that fits one CTA stays in one (no cluster fold); a wider row
#: goes to the smallest cluster whose CTAs' slices take at most
#: STAGED_SLICE_MAX, a third of an SM, so that three CTAs share an SM and
#: hide each other's folds (PERF.md §6: at 2,048 x 256,000 the loss took
#: 0.939 / 2.318 ms forward / backward with 16 CTAs of 64 KB, 1.050 /
#: 2.632 with 8 of 128 KB).  A wide row is one stage filled in
#: STAGED_CHUNKS chunks; a narrow row (a stage of at most STAGED_NARROW
#: bytes, the rmsnorm's) a ring of STAGED_RING stages, one copy each.
STAGED_SLICE_MAX = 72 * 1024
STAGED_CHUNKS = 8
STAGED_NARROW = 16 * 1024
STAGED_RING = 4


class _ClusterTooSmall(Exception):
    """The program's row-wide binds exceed a cluster's shared memory."""


@dataclass(frozen=True)
class StagedGeometry:
    cluster: int      # K: CTAs a row is split over
    cols: int         # NK: columns a CTA holds (a multiple of 4)
    threads: int      # T
    stages: int       # S: rows a CTA holds at once
    chunks: int       # CH: bulk copies a bind's slice is filled in
    chunk_cols: int   # CHW: columns a chunk (a multiple of 4 T)
    smem: int         # a CTA's dynamic shared memory (bytes)
    ctas: int         # CTAs an SM holds by shared memory and threads


def staged_threads(cols: int) -> int:
    """Threads of a staged CTA holding ``cols`` columns: 128 for a
    rmsnorm row (2,048-4,096 columns, several CTAs an SM), 256 for a
    cluster's slice (three CTAs an SM), 512 for a vocabulary row that
    holds an SM alone (16 warps)."""
    return 128 if cols <= 4096 else \
        256 if 4 * cols <= STAGED_SLICE_MAX else 512


def staged_smem(threads: int, stages: int, chunks: int, nrow: int,
                nside: int, cols: int, nslots: int, nfold: int) -> int:
    """A staged CTA's dynamic shared memory (bytes), summed as
    ``row_staged.cuh``'s ``rowstaged::Layout`` sums it: the row stages,
    the side slices, the warps' partials of the ``nfold`` aggregates a pass
    folds at most, the row scalars, the cluster partials by row parity
    (each padded to 4 floats), then one mbarrier a chunk a stage and one
    for the sides."""
    pad4 = lambda x: -(-x // 4) * 4
    floats = (stages * nrow * cols + nside * cols
              + pad4(nfold * (threads // 32)) + pad4(nslots) + pad4(2 * nslots))
    return 4 * floats + 8 * (stages * chunks + 1)


def staged_geometry(N: int, nrow: int, nside: int, nslots: int, nfold: int,
                    cluster: Optional[int] = None) -> StagedGeometry:
    """One CTA where it holds the row, else the smallest cluster whose
    CTAs hold their slices of every row-wide bind within STAGED_SLICE_MAX,
    else the largest cluster with up to STAGED_SMEM_MAX a CTA
    (``cluster``: that size, within STAGED_SMEM_MAX): a narrow row in a
    ring of STAGED_RING stages filled by one copy each, a wide one in one
    stage filled in STAGED_CHUNKS chunks; raises :class:`_ClusterTooSmall`
    where no cluster of 16 holds a row."""
    top = STAGED_CLUSTERS[-1]
    tries = [(cluster, STAGED_SMEM_MAX)] if cluster else [
        (K, STAGED_SMEM_MAX if K == 1 else STAGED_SLICE_MAX)
        for K in STAGED_CLUSTERS] + [(top, STAGED_SMEM_MAX)]
    for K, most in tries:
        cols = -(-(-(-N // K)) // 4) * 4
        T = staged_threads(cols)
        step = 4 * T
        narrow = 4 * nrow * cols <= STAGED_NARROW
        stages = STAGED_RING if narrow else 1
        chunks = 1 if narrow else min(STAGED_CHUNKS, -(-cols // step))
        chunk_cols = -(-(-(-cols // chunks)) // step) * step
        chunks = -(-cols // chunk_cols)
        smem = staged_smem(T, stages, chunks, nrow, nside, cols, nslots,
                           nfold)
        if smem <= most:
            ctas = max(1, min(2048 // T,
                              _SM_SMEM // (smem + _STAGED_RESERVED)))
            return StagedGeometry(K, cols, T, stages, chunks, chunk_cols,
                                  smem, ctas)
    raise _ClusterTooSmall(f"{nrow} row-wide bind(s) and {nside} side(s) "
                           f"of {N} columns exceed a cluster of "
                           f"{tries[-1][0]} CTAs")


def _staged_source(cplan: CPlan, cluster: Optional[int] = None
                   ) -> KernelSource:
    """The Row template in the staged layout (``no_agg``, ``row_agg`` and
    ``full_agg``; raises ``NotImplementedError`` for the rest, and
    :class:`_ClusterTooSmall` where a row does not fit a cluster);
    ``cluster``: that cluster size, not the smallest that fits."""
    rp = _RowPasses(cplan, "staged")
    em, M, N = rp.em, rp.em.M, rp.em.N
    if not rp.passes:
        raise _unsupported(cplan, "no pass reads the staged row")
    rows = [k for k in rp.wide_binds if cplan.binds[k].shape[0] == M > 1]
    sides = [k for k in rp.wide_binds if k not in rows]
    nfold = max([sum(a[0] == ps for a in rp.aggs)
                 for ps in range(rp.npass)] + [1])
    geo = staged_geometry(N, len(rows), len(sides), max(len(rp.aggs), 1),
                          nfold, cluster)
    em.staged = geo
    em.plan_reciprocals()
    body = [f"const float* r{k} = st + {q * geo.cols};"
            for q, k in enumerate(rows)]
    body += [f"const float* r{k} = sd + {q * geo.cols};"
             for q, k in enumerate(sides)]
    body += rp.scalar_binds
    for k, bb in enumerate(cplan.binds):
        if em.kind[("b", bb.nid)] == "s":
            body += em.reciprocal(("b", bb.nid))

    def fold(here):
        ops = ", ".join(str(code) for _p, _s, code, _r, _n in here)
        slots = ", ".join(str(slot) for _p, slot, _c, _r, _n in here)
        accs = ", ".join(f"a{slot}" for _p, slot, _c, _r, _n in here)
        k = len(here)
        return [f"const int op[{k}] = {{{ops}}}, sl[{k}] = {{{slots}}};",
                f"float v[{k}] = {{{accs}}};",
                f"rowstaged::fold<T, K, {k}>(op, sl, v, red, cp, rs);"]

    body += rp.body(fold)
    sel = lambda ks: _select([str(k) for k in ks], "-1")
    lines = [
        "// Row template (staged layout): " + _describe(cplan),
        *_header("row"),
        "struct Prog {",
        f"  static constexpr int NB = {len(cplan.binds)}, LAYOUT = 3, "
        f"T = {geo.threads}, K = {geo.cluster}, S = {geo.stages}, "
        f"CH = {geo.chunks}, CHW = {geo.chunk_cols};",
        f"  static constexpr int NR = {len(rows)}, NSD = {len(sides)}, "
        f"NK = {geo.cols}, SMEM = {geo.smem}, VEC = {int(N % 4 == 0)}, "
        f"NA = {nfold};",
        *rp.prog_lines(),
        f"  __host__ __device__ static constexpr int row_bind(int k) "
        f"{{ return {sel(rows)}; }}",
        f"  __host__ __device__ static constexpr int side_bind(int k) "
        f"{{ return {sel(sides)}; }}",
        "  // row i: st / sd: the CTA's slices of its row-staged and side "
        "binds, n of their columns;",
        "  // bars: the stage's chunk barriers (phase parity par), read "
        "by the first pass; cp: this",
        "  // row's cluster partials; o: the CTA's slice of the output row; "
        "returns the row's value",
        "  __device__ static __forceinline__ float row("
        "const rk::Binds<NB>& b, long long i, int tid, const float* st, "
        "const float* sd, int n, bool vec, uint64_t* bars, unsigned par, "
        "float* rs, float* red, float* cp, float* o) {",
        *("    " + ln for ln in body),
        "  }",
        "};", "",
        *_launcher("row_launch")]
    return KernelSource("row", "\n".join(lines),
                        (M, N if rp.wide_root else 1),
                        elems=1 if cplan.variant == FULL_AGG else 0,
                        variant=cplan.variant, layout="staged",
                        threads=geo.threads, rows=1, stages=geo.stages,
                        smem=geo.smem, ctas=geo.ctas, parts_per_cta=1,
                        passes=rp.passes, cluster=geo.cluster)


# --------------------------------------------------------------------------
# Outer: the program evaluated at one cell of one non-zero block
# --------------------------------------------------------------------------

_OUTER_VARIANT = {RIGHT_MM: 0, FULL_AGG: 1}
#: block sizes the Outer skeleton takes (multiples of 16 up to this) and
#: the shared memory a CTA may opt into (bytes)
_OUTER_BS_MAX = 128
_OUTER_SMEM_MAX = 227 * 1024
#: depth of the Outer kernel's cp.async ring of column slices: two slices
#: in flight while one is computed; at bs 128, rank 20 the ring leaves room
#: for two CTAs per SM
_OUTER_STAGES = 3


#: rows of a block each thread of the Outer kernel takes, per variant:
#: every V value it reads from shared memory serves this many cells.
#: right_mm keeps 2K running sums per row in registers besides U's row, so
#: at two rows it spills past the 128 registers two CTAs per SM allow
_OUTER_RPT = {RIGHT_MM: 1, FULL_AGG: 2}


@dataclass(frozen=True)
class OuterLayout:
    """The Outer kernel's CTA (``csrc/outer.cuh`` checks it again):
    ``threads`` = (bs / ``rpt``) × ``stripes``; thread t takes rows
    t % (bs / rpt) + q bs / rpt (q < rpt) of a block and column stripe
    t // (bs / rpt); X is staged in column slices of ``sc`` (each stripe a
    whole number of float4 groups of every slice) through a ring of
    ``stages``; ``smem`` bytes of dynamic shared memory (the ring, reused
    at the end of a piece to add the stripes' sums)."""
    threads: int
    rpt: int
    stripes: int
    sc: int
    stages: int
    smem: int


def outer_layout(bs: int, r: int, k: int, variant: str,
                 close_is_v: bool) -> OuterLayout:
    """The layout at block size ``bs``, rank ``r``, closer width ``k`` (0
    for ``full_agg``); ``close_is_v``: the closer panel is V's, staged
    once.  Raises when it needs more shared memory than a CTA may have."""
    rpt = _OUTER_RPT[variant]
    rb = bs // rpt
    h = next(h for h in (8, 4, 2, 1) if rb * h <= 256 and (bs // 4) % h == 0)
    sc = next(c for c in (32, 16, 8, 4) if bs % c == 0 and c % (4 * h) == 0)
    pad4 = lambda w: -(-w // 4) * 4
    stage = bs * (sc + 4) + sc * pad4(r) + (
        sc * pad4(k) if variant == RIGHT_MM and not close_is_v else 0)
    red = h * bs * k if variant == RIGHT_MM else rb * h
    smem = 4 * max(_OUTER_STAGES * stage, red)
    if smem > _OUTER_SMEM_MAX:
        raise NotImplementedError(
            f"Outer kernel: {smem} bytes of shared memory at bs={bs}, r={r},"
            f" k={k} (a CTA may have {_OUTER_SMEM_MAX})")
    return OuterLayout(rb * h, rpt, h, sc, _OUTER_STAGES, smem)


def _outer_mm_nid(cplan: CPlan) -> int:
    for (nid, op, _ins, _shape, _attrs) in cplan.prog:
        if op == "matmul":
            return nid
    return -1


def _outer_body(cplan: CPlan) -> list[str]:
    """One statement per program node at cell (i, j) of block b: the X
    block value is ``x``, the outer product ``U_b V_bᵀ`` at the cell is
    ``s``, sides are read at the cell's global (gi, gj)."""
    m, n = cplan.main.shape
    pos = {b.nid: k for k, b in enumerate(cplan.binds)}
    shape_of = {b.nid: tuple(b.shape) for b in cplan.binds}
    mm = _outer_mm_nid(cplan)
    names: dict[tuple, str] = {("b", cplan.main.nid): "x", ("n", mm): "s"}
    lines: list[str] = []

    def bind(nid: int) -> str:
        key = ("b", nid)
        if key not in names:
            r, c = shape_of[nid]
            if (r, c) == (1, 1):
                off = "0"
            elif (r, c) == (m, n):
                off = "gi * n + gj"
            elif c == 1 and r == m:
                off = "gi"
            elif r == 1 and c == n:
                off = "gj"
            else:
                raise _unsupported(cplan, f"side of shape {(r, c)} against "
                                          f"the sparse main {(m, n)}")
            name = f"b{pos[nid]}"
            lines.append(f"const float {name} = __ldg(b.p[{pos[nid]}] + "
                         f"{off});")
            names[key] = name
        return names[key]

    for idx, (nid, op, ins, _shape, attrs) in enumerate(cplan.prog):
        if nid == mm:
            continue
        if op not in _CELL_C or "axis" in dict(attrs):
            raise _unsupported(cplan, f"op '{op}' inside an outer program")
        args = [names[("n", r)] if k == "n" else
                bind(r) if k == "b" else _lit(r) for k, r in ins]
        name = f"v{idx}"
        lines.append(f"const float {name} = {_CELL_C[op].format(*args)};")
        names[("n", nid)] = name
    root = cplan.prog_root
    lines.append(f"return {names.get(('n', root)) or bind(root)};")
    return lines


def outer_source(cplan: CPlan, bs: int) -> KernelSource:
    """The Outer template, ``right_mm`` and ``full_agg``, over a BCSR main
    of block size ``bs`` (a multiple of 16, at most 128)."""
    variant = cplan.variant
    if cplan.ttype != TType.OUTER or variant not in _OUTER_VARIANT \
            or cplan.extra:
        raise _unsupported(cplan, "not an Outer right_mm / full_agg")
    if bs % 16 or not 16 <= bs <= _OUTER_BS_MAX:
        raise _unsupported(cplan, f"block size {bs} (the skeleton tiles "
                                  f"multiples of 16 up to {_OUTER_BS_MAX})")
    kinds = [b.kind for b in cplan.binds]
    if "factor_u" not in kinds or "factor_v" not in kinds:
        raise _unsupported(cplan, "no U @ t(V) factor pair")
    ub, vb = kinds.index("factor_u"), kinds.index("factor_v")
    m, n = cplan.main.shape
    r = cplan.binds[ub].shape[1]
    if cplan.binds[ub].shape != (m, r) or cplan.binds[vb].shape != (n, r):
        raise _unsupported(cplan, f"factors {cplan.binds[ub].shape} and "
                                  f"{cplan.binds[vb].shape} are not U (m,r) "
                                  f"and V (n,r)")
    k = 0
    close_is_v = False
    if variant == RIGHT_MM:
        if cplan.close_nid not in {b.nid for b in cplan.binds}:
            raise _unsupported(cplan, "closer computed inside the program")
        k = root_shape(cplan, cplan.close_nid)[0 if cplan.close_tb else 1]
        close_is_v = (cplan.close_nid == cplan.binds[vb].nid
                      and not cplan.close_tb)
        agg = "sum"
    else:
        agg = cplan.agg_op
        if agg not in ("sum", "min", "max"):
            raise _unsupported(cplan, f"full aggregate '{agg}' over blocks")
    try:
        lay = outer_layout(bs, r, k, variant, close_is_v)
    except NotImplementedError as e:
        raise _unsupported(cplan, str(e)) from None
    body = _outer_body(cplan)
    lines = [
        "// Outer template: " + _describe(cplan), *_header("outer"),
        "struct Prog {",
        f"  static constexpr int NB = {len(cplan.binds)}, BS = {bs}, "
        f"R = {r}, K = {k}, UB = {ub}, VB = {vb};",
        f"  static constexpr int VARIANT = {_OUTER_VARIANT[variant]}, "
        f"AGG = {AGG_CODE[agg]};",
        f"  static constexpr int THREADS = {lay.threads}, RPT = {lay.rpt}, "
        f"SC = {lay.sc}, STAGES = {lay.stages}, SMEM = {lay.smem};",
        f"  static constexpr bool CLOSE_IS_V = "
        f"{'true' if close_is_v else 'false'};",
        "  __device__ static __forceinline__ int agg_of(int) "
        "{ return AGG; }",
        "  __device__ static __forceinline__ float fin(int, float a, "
        "double) { return a; }",
        "  __device__ static __forceinline__ float eval("
        "const rk::Binds<NB>& b, float x, float s, long long gi, "
        "long long gj, long long n) {",
        *("    " + ln for ln in body),
        "  }",
        "};", "",
        'extern "C" int repro_launch_outer(void* const* binds, '
        "const void* xdata, const void* cols, const void* rowptr, "
        "const void* pieces, const void* pieceptr, long long npieces, "
        "const void* closer, void* out, void* part, long long m, "
        "long long n, int nblocks, int bs, int r, int k, void* stream, "
        "int device) {",
        "  return outer_launch<Prog>(binds, xdata, cols, rowptr, pieces, "
        "pieceptr, npieces, closer, out, part, m, n, nblocks, bs, r, k, "
        "stream, device);",
        "}", ""]
    return KernelSource("outer", "\n".join(lines), (m, n),
                        elems=1 if variant == FULL_AGG else 0)


# --------------------------------------------------------------------------
# routing (the dense dispatch of kernels/ops.py)
# --------------------------------------------------------------------------

def _describe(cplan: CPlan) -> str:
    # widths only: the row count must not enter the text (one build per m)
    return (f"{cplan.ttype.name} {cplan.variant} agg={cplan.agg_op or '-'} "
            f"bind widths={[b.shape[1] for b in cplan.binds]} "
            f"ops={[op for (_n, op, *_r) in cplan.prog]}")


#: generated sources by CPlan object (the staged plan function hands the
#: same CPlan to every call) and by structural CPlan hash; bounded, and
#: the text is pure in the CPlan, so a hit is always right
_BY_OBJECT: dict[tuple, tuple[CPlan, KernelSource]] = {}
_BY_HASH: dict[tuple, KernelSource] = {}
_MEMO_MAX = 4096


def source_for(cplan: CPlan, bs: Optional[int] = None) -> KernelSource:
    """The kernel source :func:`repro_torch.kernels.ops.execute` would
    launch for this CPlan over CUDA operands (memoized): dense operands, or
    with ``bs``, a BCSR main of that block size."""
    hit = _BY_OBJECT.get((id(cplan), bs))
    if hit is not None and hit[0] is cplan:
        return hit[1]
    key = (cplan.cache_key(), bs)
    src = _BY_HASH.get(key)
    if src is None:
        src = _generate(cplan, bs)
    if len(_BY_OBJECT) >= _MEMO_MAX:
        _BY_OBJECT.clear()
        _BY_HASH.clear()
    _BY_HASH[key] = src
    _BY_OBJECT[(id(cplan), bs)] = (cplan, src)
    return src


def _generate(cplan: CPlan, bs: Optional[int]) -> KernelSource:
    if bs is not None:
        return outer_source(cplan, bs)
    if cplan.extra:
        return magg_source(cplan)
    if cplan.ttype in (TType.CELL, TType.MAGG):
        return cell_source(cplan)
    if cplan.ttype == TType.ROW:
        return row_source(cplan)
    raise _unsupported(cplan, "no CUDA template (Outer over a dense main "
                              "runs the torch oracle)")
