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
template has two layouts, chosen per CPlan here (:func:`row_source`): the
tile layout (a thread per row over tiles of rows in shared memory, every
computed value in registers) and the warp layout (a warp per row) for
programs with wide computed values; the layout and its geometry go into
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
    layout: str = ""       # row: "tile" or "warp" (row_layout)
    walk: str = ""         # cell: "vector" or "scalar" (cell_vector_binds)
    group: int = 0         # cell: cells a thread takes per load (4 or 1)
    unroll: int = 0        # cell: groups a thread keeps in flight
    threads: int = 0       # row, cell: threads per CTA
    rows: int = 0          # row: rows a CTA takes per step
    stages: int = 0        # row tile: depth of the ring of row tiles
    smem: int = 0          # row tile: dynamic shared memory (bytes)
    ctas: int = 0          # row, cell: CTAs per SM the grid is sized for
    parts_per_cta: int = 0  # row, cell: partials each CTA writes

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

    # -- helpers -------------------------------------------------------------
    def slots(self, w: int) -> int:
        return -(-w // self.L)

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
        self.emit(f"float {name}[{self.slots(w)}];",
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
            self.emit(f"float {name}[{self.slots(width)}];",
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
        self.emit(f"float {name};", "{",
                  f"  float s = rk::agg_init({a});",
                  "#pragma unroll",
                  f"  for (int t = 0; t < {self.slots(w)}; ++t)",
                  f"    if (t * {self.L} + sub < {w}) "
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
                f"float {name}[{self.slots(c)}] = {{}};"
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
        self.emit(f"float {name}[{self.slots(c)}];",
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
            self.emit(f"float {name}[{self.slots(w)}];",
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
    warp layout otherwise (``KernelSource.layout`` says which)."""
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
        return _warp_source(cplan)


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
                        rows=wpb * (32 // lanes), ctas=8, parts_per_cta=wpb)


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
