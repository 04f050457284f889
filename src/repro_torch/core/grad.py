"""Source-to-source reverse-mode autodiff on the LinOp IR.

``vjp_graph`` takes a built forward :class:`~repro_torch.core.ir.Graph` and
constructs the *gradient DAG*: fresh cotangent input matrices (one per
forward output, named ``__ct{i}``) plus an expression per forward input
computing ``d(Σ_i ct_i · out_i) / d(input)``.

The gradient DAG is an ordinary HOP DAG — it goes through the same
explore → select → codegen pipeline as any forward expression, so the
backward pass of a ``@fused`` region executes through *generated fused
operators* (Cell / Row / MAgg templates), exactly like the forward.
Forward intermediates referenced by gradient rules are re-materialized
inside the gradient DAG (rematerialization), which is what makes the
combined chains fusable in the first place.

Unsupported ops raise :class:`NonDifferentiableError`; callers degrade to
the non-differentiable execution path.
"""

from __future__ import annotations

import math
from typing import Optional

from . import ir
from .ir import Expr, Graph, Node


class NonDifferentiableError(ValueError):
    """The forward graph contains an op with no registered VJP rule."""


#: ops whose gradient w.r.t. every input is identically zero (piecewise-
#: constant outputs): propagating nothing through them is exact a.e.
_ZERO_GRAD = frozenset({
    "sign", "round", "floor", "ceil", "neq0",
    "eq", "neq", "lt", "le", "gt", "ge",
})

_TWO_OVER_SQRT_PI = 2.0 / math.sqrt(math.pi)


def _unbroadcast(e: Expr, shape: tuple[int, int]) -> Expr:
    """Sum a cotangent over the dims the forward op broadcast."""
    if e.shape == shape:
        return e
    if shape[0] == 1 and e.shape[0] != 1:
        e = e.colsums()
    if shape[1] == 1 and e.shape[1] != 1:
        e = e.rowsums()
    return e


def _expand(e: Expr, like: Expr) -> Expr:
    """Broadcast a cotangent up to ``like``'s shape (for reductions).

    Value-safe w.r.t. ``like``: where(c, e, e) == e for any predicate, so
    ±inf/NaN cells in the forward input (e.g. -inf logit masks) cannot
    contaminate the gradient the way ``e + like*0.0`` would (0·inf = NaN).
    """
    if e.shape == like.shape:
        return e
    return ir.where(like == like, e, e)


def _agg_vjp(node: Node, ct: Expr) -> Expr:
    x = Expr(node.inputs[0])
    axis = node.attrs["axis"]
    if node.op == "sum":
        return _expand(ct, x)
    if node.op == "mean":
        n = {"full": x.node.ncells, "row": x.shape[1],
             "col": x.shape[0]}[axis]
        return _expand(ct / float(n), x)
    if node.op == "sum_sq":
        return _expand(ct, x) * x * 2.0
    if node.op in ("min", "max"):
        # subgradient: split the cotangent evenly over the extremal cells
        mask = (x == Expr(node))            # broadcasts the (1|m,1|n) value
        denom = {"full": mask.sum(), "row": mask.rowsums(),
                 "col": mask.colsums()}[axis]
        return (mask / denom) * ct
    raise NonDifferentiableError(f"no VJP for aggregation '{node.op}'")


def _matmul_vjp(node: Node, ct: Expr) -> list[tuple[Node, Expr]]:
    a, b = node.inputs
    A, B = Expr(a), Expr(b)
    ta, tb = node.ta, node.tb
    if not ta and not tb:            # C = A B
        da, db = ct @ B.T, A.T @ ct
    elif ta and not tb:              # C = Aᵀ B
        da, db = B @ ct.T, A @ ct
    elif not ta and tb:              # C = A Bᵀ
        da, db = ct @ B, ct.T @ A
    else:                            # C = Aᵀ Bᵀ
        da, db = B.T @ ct.T, ct.T @ A.T
    return [(a, da), (b, db)]


def _node_vjp(node: Node, ct: Expr) -> list[tuple[Node, Expr]]:
    """Per-op rule: contributions of ``ct`` to each input's adjoint."""
    op = node.op
    if op in _ZERO_GRAD:
        return []
    ins = node.inputs
    out = Expr(node)                     # forward value, rematerialized

    if op == "matmul":
        return _matmul_vjp(node, ct)
    if op == "t":
        return [(ins[0], ct.T)]
    if node.is_agg:
        return [(ins[0], _agg_vjp(node, ct))]

    x = Expr(ins[0]) if ins else None
    if op in ir.UNARY_OPS:
        if op == "neg":
            g = -ct
        elif op in ("pow2", "square"):
            g = ct * x * 2.0
        elif op == "relu":
            g = ct * (x > 0.0)
        elif op == "abs":
            g = ct * ir.sign(x)
        elif op == "exp":
            g = ct * out
        elif op == "log":
            g = ct / x
        elif op == "log1p":
            g = ct / (x + 1.0)
        elif op == "sqrt":
            g = ct * 0.5 / out
        elif op == "recip":
            g = -ct * out * out
        elif op == "sigmoid":
            g = ct * out.unary("sprop")          # s(1-s)
        elif op == "tanh":
            g = ct * (1.0 - out * out)
        elif op == "erf":
            g = ct * _TWO_OVER_SQRT_PI * ir.exp(-(x * x))
        elif op == "softplus":
            g = ct * ir.sigmoid(x)
        elif op == "silu":
            s = ir.sigmoid(x)
            g = ct * (s + x * s.unary("sprop"))
        elif op == "sprop":                      # x(1-x)
            g = ct * (1.0 - 2.0 * x)
        else:
            raise NonDifferentiableError(f"no VJP for unary '{op}'")
        return [(ins[0], g)]

    if op in ir.BINARY_OPS:
        a, b = ins
        A, B = Expr(a), Expr(b)
        if op == "add":
            contrib = [(a, ct), (b, ct)]
        elif op == "sub":
            contrib = [(a, ct), (b, -ct)]
        elif op == "mul":
            contrib = [(a, ct * B), (b, ct * A)]
        elif op == "div":
            contrib = [(a, ct / B), (b, -ct * A / (B * B))]
        elif op in ("min", "max"):
            take_a = (A >= B) if op == "max" else (A <= B)
            contrib = [(a, ct * take_a), (b, ct * (1.0 - take_a))]
        elif op == "pow":
            if b.op != "lit":
                raise NonDifferentiableError(
                    "pow VJP requires a literal exponent")
            p = float(b.attrs["value"])
            contrib = [(a, ct * p * A ** (p - 1.0))]
        else:
            raise NonDifferentiableError(f"no VJP for binary '{op}'")
        return [(n, g) for n, g in contrib if n.op != "lit"]

    if op == "where":
        c, a, b = ins
        mask = ir.neq0(Expr(c))
        return [(n, g) for n, g in
                ((a, ct * mask), (b, ct * (1.0 - mask)))
                if n.op != "lit"]
    if op == "plus_mult":      # a + b*c
        a, b, c = ins
        return [(n, g) for n, g in
                ((a, ct), (b, ct * Expr(c)), (c, ct * Expr(b)))
                if n.op != "lit"]
    if op == "minus_mult":     # a - b*c
        a, b, c = ins
        return [(n, g) for n, g in
                ((a, ct), (b, -ct * Expr(c)), (c, -ct * Expr(b)))
                if n.op != "lit"]
    raise NonDifferentiableError(f"no VJP for op '{op}'")


def vjp_graph(graph: Graph) -> tuple[list[str], dict[str, Expr]]:
    """Gradient DAG of ``graph``.

    Returns ``(ct_names, grads)``: the cotangent input names (``__ct{i}``,
    one per forward output, shaped like it) and an Expr per forward input
    name computing its gradient.  Inputs with no differentiable path get an
    explicit zero of the right shape.
    """
    adjoint: dict[int, Expr] = {}
    cts: list[str] = []
    for i, o in enumerate(graph.outputs):
        name = f"__ct{i}"
        cts.append(name)
        ct = ir.matrix(name, o.shape, dtype=o.dtype)
        adjoint[o.nid] = adjoint[o.nid] + ct if o.nid in adjoint else ct

    for node in reversed(graph.nodes):
        if node.nid not in adjoint or node.is_input:
            continue
        ct = adjoint.pop(node.nid)
        for inp, contrib in _node_vjp(node, ct):
            contrib = _unbroadcast(contrib, inp.shape)
            if inp.nid in adjoint:
                adjoint[inp.nid] = adjoint[inp.nid] + contrib
            else:
                adjoint[inp.nid] = contrib

    grads: dict[str, Expr] = {}
    for inp in graph.inputs():
        g: Optional[Expr] = adjoint.get(inp.nid)
        if g is None:
            g = Expr(inp) * 0.0                       # no path: exact zero
        grads[inp.name] = _unbroadcast(g, inp.shape)  # type: ignore[index]
    return cts, grads
