"""Linear-algebra operator IR (the HOP-DAG analogue of SystemML).

The fusion planner (explore/select/codegen) operates on this IR, not on
jaxprs: the paper's templates reason about *linear-algebra semantics*
(cell-wise vs row-wise access, aggregation axes, sparse-safety, outer-product
shapes), which are first-class here and erased in a jaxpr.

Nodes are immutable after construction; a :class:`Graph` snapshots a set of
output nodes into a topologically ordered, id-indexed DAG with consumer
counts — the unit of optimization (one HOP DAG at-a-time, paper §4.1).

Shapes are static 2-D ``(rows, cols)``; column vectors are ``(n, 1)``, row
vectors ``(1, n)``, scalars ``(1, 1)`` literals.  Sparsity is an nnz-fraction
estimate propagated through construction (paper's size/sparsity propagation
via IPA); it drives sparse-safe fusion decisions and the cost model.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import Any, Iterable, Optional

import numpy as np

# --------------------------------------------------------------------------
# Operator taxonomy
# --------------------------------------------------------------------------

#: cell-wise unary ops f(x); SPARSE_SAFE_UNARY ⊆ UNARY_OPS have f(0) == 0.
UNARY_OPS = frozenset({
    "exp", "log", "sqrt", "abs", "sign", "round", "floor", "ceil",
    "sigmoid", "tanh", "relu", "neg", "recip", "pow2", "neq0", "sprop",
    "log1p", "softplus", "gelu", "silu", "square", "erf",
})
SPARSE_SAFE_UNARY = frozenset({
    "sqrt", "abs", "sign", "round", "floor", "ceil", "tanh", "relu", "neg",
    "pow2", "neq0", "sprop", "log1p", "gelu", "silu", "square", "erf",
})

#: cell-wise binary ops g(x, y) with numpy-style broadcasting over
#: (m,n)·(m,1)/(1,n)/(1,1) operands.
BINARY_OPS = frozenset({
    "add", "sub", "mul", "div", "min", "max", "pow",
    "eq", "neq", "lt", "le", "gt", "ge",
})

#: cell-wise ternary ops.
TERNARY_OPS = frozenset({"where", "plus_mult", "minus_mult"})

#: aggregations; axis ∈ {"full", "row", "col"} (rowSums → axis="row",
#: producing an (m,1) vector; colSums → axis="col", producing (1,n)).
AGG_OPS = frozenset({"sum", "min", "max", "mean", "sum_sq"})

CELL_OPS = UNARY_OPS | BINARY_OPS | TERNARY_OPS

# structural / non-cell ops
STRUCT_OPS = frozenset({"input", "lit", "matmul", "t", "idx", "diagv"})

ALL_OPS = CELL_OPS | AGG_OPS | STRUCT_OPS

_counter = itertools.count()


def _fresh_id() -> int:
    return next(_counter)


# --------------------------------------------------------------------------
# Nodes
# --------------------------------------------------------------------------

@dataclass(eq=False)
class Node:
    """One operator in the DAG.  Identity semantics (eq=False) — CSE is the
    caller's job (see :func:`Graph.build` dedup)."""

    op: str
    inputs: tuple["Node", ...]
    shape: tuple[int, int]
    dtype: Any = np.float32
    sparsity: float = 1.0
    name: Optional[str] = None          # for inputs: bind-time key
    attrs: dict = field(default_factory=dict)
    nid: int = field(default_factory=_fresh_id)

    # -- classification helpers used throughout the planner ---------------
    @property
    def is_input(self) -> bool:
        return self.op in ("input", "lit")

    @property
    def is_cellwise(self) -> bool:
        return self.op in CELL_OPS and "axis" not in self.attrs

    @property
    def is_agg(self) -> bool:
        # min/max are also binary cell ops; aggregations carry an axis attr
        return self.op in AGG_OPS and "axis" in self.attrs

    @property
    def agg_axis(self) -> Optional[str]:
        return self.attrs.get("axis") if self.is_agg else None

    @property
    def is_matmul(self) -> bool:
        return self.op == "matmul"

    @property
    def is_scalar(self) -> bool:
        return self.shape == (1, 1)

    @property
    def is_vector(self) -> bool:
        return (self.shape[0] == 1) != (self.shape[1] == 1)

    @property
    def ncells(self) -> int:
        return int(self.shape[0]) * int(self.shape[1])

    @property
    def nnz(self) -> float:
        return self.ncells * self.sparsity

    # matmul structure -----------------------------------------------------
    @property
    def ta(self) -> bool:
        return bool(self.attrs.get("ta", False))

    @property
    def tb(self) -> bool:
        return bool(self.attrs.get("tb", False))

    def mm_dims(self) -> tuple[int, int, int]:
        """(m, k, n) of this matmul after folding transposes."""
        assert self.is_matmul
        a, b = self.inputs
        m, k = (a.shape[1], a.shape[0]) if self.ta else a.shape
        k2, n = (b.shape[1], b.shape[0]) if self.tb else b.shape
        assert k == k2, f"matmul dim mismatch {a.shape}/{b.shape}"
        return m, k, n

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        ins = ",".join(str(i.nid) for i in self.inputs)
        nm = f":{self.name}" if self.name else ""
        return f"%{self.nid}={self.op}{nm}({ins}){self.shape}"


# --------------------------------------------------------------------------
# Shape / sparsity inference
# --------------------------------------------------------------------------

def _broadcast_shape(a: tuple[int, int], b: tuple[int, int]) -> tuple[int, int]:
    r = a[0] if b[0] == 1 else (b[0] if a[0] == 1 else a[0])
    c = a[1] if b[1] == 1 else (b[1] if a[1] == 1 else a[1])
    for (x, y) in ((a[0], r), (b[0], r), (a[1], c), (b[1], c)):
        if x not in (1, y):
            raise ValueError(f"cannot broadcast {a} with {b}")
    return (r, c)


def infer_shape(op: str, in_shapes: list[tuple[int, int]],
                attrs: dict) -> Optional[tuple[int, int]]:
    """Re-derive the output shape of ``op`` bottom-up from its input shapes
    — the single source of the IR's shape semantics, shared by expression
    construction invariants and the plan verifier's metadata cross-check
    (:mod:`repro_torch.core.verify`).  Returns None when the op carries no
    derivable shape (leaves, ops with free output shape); raises
    ``ValueError`` on inconsistent operand shapes (dimension mismatch)."""
    if op in ("input", "lit", "diagv"):
        return None
    if op == "t":
        (r, c), = in_shapes
        return (c, r)
    if op == "idx":
        return (in_shapes[0][0], int(attrs["hi"]) - int(attrs["lo"]))
    if op == "matmul":
        a, b = in_shapes
        m, k = (a[1], a[0]) if attrs.get("ta") else a
        k2, n = (b[1], b[0]) if attrs.get("tb") else b
        if k != k2:
            raise ValueError(f"matmul contraction mismatch {a} @ {b}")
        return (m, n)
    if op in AGG_OPS and "axis" in attrs:
        r, c = in_shapes[0]
        return {"full": (1, 1), "row": (r, 1), "col": (1, c)}[attrs["axis"]]
    if op in UNARY_OPS:
        return in_shapes[0]
    if op in BINARY_OPS or op in TERNARY_OPS:
        out = in_shapes[0]
        for s in in_shapes[1:]:
            out = _broadcast_shape(out, s)
        return out
    return None


def _unary_sparsity(op: str, s: float) -> float:
    return s if op in SPARSE_SAFE_UNARY else 1.0


def _binary_sparsity(op: str, a: Node, b: Node) -> float:
    sa, sb = a.sparsity, b.sparsity
    if op == "mul":
        return min(sa, sb)
    if op == "div":
        return sa                       # 0/x == 0 (x!=0 assumed)
    if op in ("add", "sub", "min", "max"):
        return min(1.0, sa + sb)
    return 1.0


# --------------------------------------------------------------------------
# Expression construction (user-facing; re-exported by core.api)
# --------------------------------------------------------------------------

class Expr:
    """Thin operator-overloading wrapper producing :class:`Node` DAGs."""

    __array_priority__ = 100  # beat numpy scalars

    def __init__(self, node: Node):
        self.node = node

    # constructors ---------------------------------------------------------
    @property
    def shape(self):
        return self.node.shape

    @property
    def T(self) -> "Expr":
        n = self.node
        if n.op == "t":                      # t(t(X)) == X
            return Expr(n.inputs[0])
        return Expr(Node("t", (n,), (n.shape[1], n.shape[0]),
                         n.dtype, n.sparsity))

    # cell-wise ------------------------------------------------------------
    def _bin(self, other, op: str, rev: bool = False) -> "Expr":
        o = as_expr(other, like=self)
        a, b = (o.node, self.node) if rev else (self.node, o.node)
        shape = _broadcast_shape(a.shape, b.shape)
        sp = _binary_sparsity(op, a, b)
        return Expr(Node(op, (a, b), shape, a.dtype, sp))

    def __add__(self, o):  return self._bin(o, "add")
    def __radd__(self, o): return self._bin(o, "add", rev=True)
    def __sub__(self, o):  return self._bin(o, "sub")
    def __rsub__(self, o): return self._bin(o, "sub", rev=True)
    def __mul__(self, o):  return self._bin(o, "mul")
    def __rmul__(self, o): return self._bin(o, "mul", rev=True)
    def __truediv__(self, o):  return self._bin(o, "div")
    def __rtruediv__(self, o): return self._bin(o, "div", rev=True)
    def __pow__(self, o):
        if isinstance(o, (int, float)) and o == 2:
            return self.unary("pow2")
        return self._bin(o, "pow")
    def __neg__(self): return self.unary("neg")
    def __eq__(self, o):  return self._bin(o, "eq")    # type: ignore[override]
    def __ne__(self, o):  return self._bin(o, "neq")   # type: ignore[override]
    def __lt__(self, o):  return self._bin(o, "lt")
    def __le__(self, o):  return self._bin(o, "le")
    def __gt__(self, o):  return self._bin(o, "gt")
    def __ge__(self, o):  return self._bin(o, "ge")
    __hash__ = object.__hash__

    def unary(self, op: str) -> "Expr":
        assert op in UNARY_OPS, op
        n = self.node
        return Expr(Node(op, (n,), n.shape, n.dtype,
                         _unary_sparsity(op, n.sparsity)))

    # matmul (folds adjacent transposes into ta/tb attrs) ------------------
    def __matmul__(self, other) -> "Expr":
        a, b = self.node, as_expr(other, like=self).node
        ta = a.op == "t"
        tb = b.op == "t"
        ai = a.inputs[0] if ta else a
        bi = b.inputs[0] if tb else b
        m = ai.shape[1] if ta else ai.shape[0]
        k = ai.shape[0] if ta else ai.shape[1]
        k2 = bi.shape[1] if tb else bi.shape[0]
        n = bi.shape[0] if tb else bi.shape[1]
        if k != k2:
            raise ValueError(f"matmul mismatch {a.shape} @ {b.shape}")
        # sparsity: P(out nonzero) = 1 - (1 - sa*sb)^k
        sp = float(min(1.0, 1.0 - (1.0 - ai.sparsity * bi.sparsity) ** max(k, 1)))
        return Expr(Node("matmul", (ai, bi), (m, n), ai.dtype, sp,
                         attrs={"ta": ta, "tb": tb}))

    # aggregations ----------------------------------------------------------
    def _agg(self, op: str, axis: str) -> "Expr":
        n = self.node
        shape = {"full": (1, 1), "row": (n.shape[0], 1),
                 "col": (1, n.shape[1])}[axis]
        return Expr(Node(op, (n,), shape, n.dtype, 1.0, attrs={"axis": axis}))

    def sum(self):      return self._agg("sum", "full")
    def rowsums(self):  return self._agg("sum", "row")
    def colsums(self):  return self._agg("sum", "col")
    def rowmaxs(self):  return self._agg("max", "row")
    def max_(self):     return self._agg("max", "full")
    def min_(self):     return self._agg("min", "full")
    def mean(self):     return self._agg("mean", "full")
    def rowmeans(self): return self._agg("mean", "row")
    def colmeans(self): return self._agg("mean", "col")

    # indexing (column range only — the paper's P[, 1:k]) -------------------
    def cols(self, lo: int, hi: int) -> "Expr":
        n = self.node
        assert 0 <= lo < hi <= n.shape[1]
        return Expr(Node("idx", (n,), (n.shape[0], hi - lo), n.dtype,
                         n.sparsity, attrs={"lo": lo, "hi": hi}))


def as_expr(x, like: Optional[Expr] = None) -> Expr:
    if isinstance(x, Expr):
        return x
    if isinstance(x, Node):
        return Expr(x)
    if isinstance(x, (int, float, np.floating, np.integer)):
        dt = like.node.dtype if like is not None else np.float32
        return Expr(Node("lit", (), (1, 1), dt,
                         0.0 if float(x) == 0.0 else 1.0,
                         attrs={"value": float(x)}))
    raise TypeError(f"cannot lift {type(x)} into Expr")


def matrix(name: str, shape: tuple[int, int], *, sparsity: float = 1.0,
           dtype=np.float32) -> Expr:
    """Declare a leaf input matrix."""
    assert len(shape) == 2
    return Expr(Node("input", (), (int(shape[0]), int(shape[1])), dtype,
                     float(sparsity), name=name))


def scalar(name: str, *, dtype=np.float32) -> Expr:
    return matrix(name, (1, 1), dtype=dtype)


# convenience free functions (mirror SystemML builtins)
def exp(x): return as_expr(x).unary("exp")
def log(x): return as_expr(x).unary("log")
def sqrt(x): return as_expr(x).unary("sqrt")
def abs_(x): return as_expr(x).unary("abs")
def sign(x): return as_expr(x).unary("sign")
def sigmoid(x): return as_expr(x).unary("sigmoid")
def tanh(x): return as_expr(x).unary("tanh")
def relu(x): return as_expr(x).unary("relu")
def gelu(x): return as_expr(x).unary("gelu")
def silu(x): return as_expr(x).unary("silu")
def neq0(x): return as_expr(x).unary("neq0")
def erf(x): return as_expr(x).unary("erf")
def minimum(a, b): return as_expr(a)._bin(b, "min")
def maximum(a, b): return as_expr(a)._bin(b, "max")
def where(c, a, b):
    c, a = as_expr(c), as_expr(a, like=as_expr(c))
    b = as_expr(b, like=a)
    shape = _broadcast_shape(_broadcast_shape(c.node.shape, a.node.shape),
                             b.node.shape)
    sp = min(1.0, a.node.sparsity + b.node.sparsity)
    return Expr(Node("where", (c.node, a.node, b.node), shape,
                     a.node.dtype, sp))


# --------------------------------------------------------------------------
# Graph
# --------------------------------------------------------------------------

class Graph:
    """Immutable snapshot of a DAG for a set of outputs.

    Performs structural CSE at build time (SystemML's HOP DAGs share CSEs —
    multiple consumers are exactly what makes plan selection interesting).
    """

    def __init__(self, nodes: list[Node], outputs: list[Node],
                 consumers: dict[int, list[int]]):
        self.nodes = nodes                          # topo order
        self.outputs = outputs
        self.by_id = {n.nid: n for n in nodes}
        self.consumers = consumers                  # nid -> consumer nids
        self.output_ids = {o.nid for o in outputs}

    # -- construction -------------------------------------------------------
    @staticmethod
    def build(outputs: Iterable[Expr | Node]) -> "Graph":
        outs = [o.node if isinstance(o, Expr) else o for o in outputs]
        # structural CSE: key = (op, input ids, shape, frozen attrs, name)
        canon: dict[tuple, Node] = {}
        memo: dict[int, Node] = {}

        def key(n: Node, ins: tuple[Node, ...]) -> tuple:
            return (n.op, tuple(i.nid for i in ins), n.shape, n.name,
                    tuple(sorted(n.attrs.items())))

        order: list[Node] = []

        def visit(n: Node) -> Node:
            if n.nid in memo:
                return memo[n.nid]
            ins = tuple(visit(i) for i in n.inputs)
            k = key(n, ins)
            if k in canon:
                memo[n.nid] = canon[k]
                return canon[k]
            nn = n if ins == n.inputs else Node(
                n.op, ins, n.shape, n.dtype, n.sparsity, n.name, dict(n.attrs))
            canon[k] = nn
            memo[n.nid] = nn
            order.append(nn)
            return nn

        new_outs = [visit(o) for o in outs]
        consumers: dict[int, list[int]] = {n.nid: [] for n in order}
        for n in order:
            for i in n.inputs:
                consumers[i.nid].append(n.nid)
        return Graph(order, new_outs, consumers)

    # -- queries -------------------------------------------------------------
    def n_consumers(self, nid: int) -> int:
        # graph outputs count as an extra (external) consumer
        return len(self.consumers[nid]) + (1 if nid in self.output_ids else 0)

    def multi_consumer_ids(self) -> set[int]:
        return {nid for nid in self.by_id
                if len(self.consumers[nid]) + (1 if nid in self.output_ids else 0) > 1
                and not self.by_id[nid].is_input}

    def inputs(self) -> list[Node]:
        return [n for n in self.nodes if n.op == "input"]

    def __len__(self) -> int:
        return len(self.nodes)

    def __repr__(self) -> str:  # pragma: no cover
        lines = [repr(n) for n in self.nodes]
        lines.append("outputs: " + ", ".join(f"%{o.nid}" for o in self.outputs))
        return "\n".join(lines)


# --------------------------------------------------------------------------
# Sparse-safety analysis (drives Cell sparse-safe binding + Outer validity)
# --------------------------------------------------------------------------

def sparse_safe_wrt(node: Node, driver: Node,
                    _memo: Optional[dict] = None) -> bool:
    """True iff evaluating ``node`` only at the non-zero cells of ``driver``
    is exact — i.e. the value at any cell where driver==0 is itself 0.

    This is the paper's sparse-safety condition for Cell/Outer templates
    ("sparse drivers", §1 Fig. 1(d)); conservative (False on unknown ops).
    """
    if _memo is None:
        _memo = {}
    k = node.nid
    if k in _memo:
        return _memo[k]
    r: bool
    if node.nid == driver.nid:
        r = True
    elif node.op in UNARY_OPS:
        r = node.op in SPARSE_SAFE_UNARY and \
            sparse_safe_wrt(node.inputs[0], driver, _memo)
    elif node.op == "mul":
        r = any(sparse_safe_wrt(i, driver, _memo) for i in node.inputs)
    elif node.op == "div":
        r = sparse_safe_wrt(node.inputs[0], driver, _memo)
    elif node.op in ("add", "sub"):
        r = all(sparse_safe_wrt(i, driver, _memo) for i in node.inputs)
    else:
        r = False
    _memo[k] = r
    return r


def reaches(src: Node, dst: Node) -> bool:
    """DAG reachability src ->* dst (following inputs from dst upward)."""
    seen: set[int] = set()
    stack = [dst]
    while stack:
        n = stack.pop()
        if n.nid == src.nid:
            return True
        if n.nid in seen:
            continue
        seen.add(n.nid)
        stack.extend(n.inputs)
    return False
