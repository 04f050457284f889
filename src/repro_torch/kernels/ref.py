"""Torch-eager oracle for CPlan programs and template skeletons.

This module is the single source of truth for fused-operator semantics in
the port, ported from the reference's ``repro/kernels/ref.py``:

* every generated CUDA kernel (``cellwise`` / ``multiagg`` / ``rowwise``)
  is held against these functions, on the CPU in the tests and on the card
  by ``chip_smoke.py``, and
* the ``kernels="never"`` execution path and every fused operator over CPU
  tensors *is* this module — the program is interpreted op by op in torch.

Semantics follow the reference exactly: ``gelu`` is the tanh
approximation (``jax.nn.gelu``'s default), comparisons cast back to the
input dtype, ``where`` tests ``!= 0``, aggregates reshape to (1,1), (m,1)
or (1,n).  :func:`eval_node` also takes values with a leading request
axis (B, r, c) — the batched plan function's basic operators — and
:func:`execute_dense_batched` is the plain version of every request-axis
kernel: the oracle once per request.
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch
import torch.nn.functional as F

from repro_torch.core.cplan import (CPlan, COL_AGG, COL_T_AGG, FULL_AGG,
                                    LEFT_MM, NO_AGG, RIGHT_MM, ROW_AGG)

# --------------------------------------------------------------------------
# basic-operation semantics (shared by program interpretation everywhere)
# --------------------------------------------------------------------------

_UNARY: dict[str, Callable] = {
    "exp": torch.exp, "log": torch.log, "sqrt": torch.sqrt, "abs": torch.abs,
    "sign": torch.sign, "round": torch.round, "floor": torch.floor,
    "ceil": torch.ceil, "sigmoid": torch.sigmoid, "tanh": torch.tanh,
    "relu": torch.relu, "neg": lambda x: -x,
    "recip": lambda x: 1.0 / x, "pow2": lambda x: x * x,
    "square": lambda x: x * x, "neq0": lambda x: (x != 0).to(x.dtype),
    "sprop": lambda x: x * (1 - x), "log1p": torch.log1p,
    # jax.nn.softplus is logaddexp(x, 0) (F.softplus thresholds at 20)
    "softplus": lambda x: torch.logaddexp(x, torch.zeros_like(x)),
    "gelu": lambda x: F.gelu(x, approximate="tanh"), "silu": F.silu,
    "erf": torch.special.erf,
}

_BINARY: dict[str, Callable] = {
    "add": torch.add, "sub": torch.sub, "mul": torch.mul,
    "div": torch.div, "min": torch.minimum, "max": torch.maximum,
    "pow": torch.pow,
    "eq": torch.eq, "neq": torch.ne, "lt": torch.lt, "le": torch.le,
    "gt": torch.gt, "ge": torch.ge,
}

_CMP = {"eq", "neq", "lt", "le", "gt", "ge"}


def _sum_sq(x, dim=None, keepdim=False):
    return torch.sum(x * x) if dim is None else \
        torch.sum(x * x, dim=dim, keepdim=keepdim)


def _full_or(fn):
    return lambda x, dim=None, keepdim=False: (
        fn(x) if dim is None else fn(x, dim=dim, keepdim=keepdim))


_AGG_FN = {"sum": _full_or(torch.sum), "min": _full_or(torch.amin),
           "max": _full_or(torch.amax), "mean": _full_or(torch.mean),
           "sum_sq": _sum_sq}


def _as_tensors(ins: Sequence) -> list:
    """Literals (python floats) become 0-d fp32 tensors on the device of
    the first tensor operand — jnp's weakly-typed scalar semantics."""
    like = next((v for v in ins if isinstance(v, torch.Tensor)), None)
    dev = like.device if like is not None else None
    return [v if isinstance(v, torch.Tensor) else
            torch.tensor(float(v), dtype=torch.float32, device=dev)
            for v in ins]


def _eval_batched(op: str, ins: list, attrs: dict):
    """:func:`eval_node` over (B, r, c) values (2-D values broadcast over
    the requests): aggregates, transposes and slices act on the last two
    axes, matmuls are batched."""
    if op in _AGG_FN and "axis" in attrs:
        dim = {"full": (-2, -1), "row": -1, "col": -2}[attrs["axis"]]
        return _AGG_FN[op](ins[0], dim=dim, keepdim=True)
    if op == "matmul":
        a, b = ins
        a = a.transpose(-2, -1) if attrs.get("ta", False) else a
        b = b.transpose(-2, -1) if attrs.get("tb", False) else b
        return torch.matmul(a, b)
    if op == "t":
        return ins[0].transpose(-2, -1)
    if op == "idx":
        return ins[0][..., attrs["lo"]:attrs["hi"]]
    return None


def eval_node(op: str, ins: Sequence, attrs: dict):
    """Evaluate one IR operation on torch values (used for basic operators
    and inside program interpretation)."""
    ins = _as_tensors(ins)
    if any(v.dim() == 3 for v in ins):
        r = _eval_batched(op, ins, attrs)
        if r is not None:
            return r
    if op in _AGG_FN and "axis" in attrs:     # min/max are also binary ops
        axis = attrs.get("axis", "full")
        ax = {"full": None, "row": 1, "col": 0}[axis]
        r = _AGG_FN[op](ins[0], dim=ax, keepdim=True)
        return r.reshape((1, 1) if ax is None else
                         ((-1, 1) if ax == 1 else (1, -1)))
    if op in _UNARY:
        return _UNARY[op](ins[0])
    if op in _BINARY:
        r = _BINARY[op](ins[0], ins[1])
        if op in _CMP:
            r = r.to(ins[0].dtype)
        return r
    if op == "where":
        return torch.where(ins[0] != 0, ins[1], ins[2])
    if op == "plus_mult":
        return ins[0] + ins[1] * ins[2]
    if op == "minus_mult":
        return ins[0] - ins[1] * ins[2]
    if op == "matmul":
        a, b = ins
        ta, tb = attrs.get("ta", False), attrs.get("tb", False)
        a = a.T if ta else a
        b = b.T if tb else b
        return a @ b
    if op == "t":
        return ins[0].T
    if op == "idx":
        return ins[0][:, attrs["lo"]:attrs["hi"]]
    raise NotImplementedError(op)


# --------------------------------------------------------------------------
# program interpretation
# --------------------------------------------------------------------------

def apply_program(cplan: CPlan, read: Callable[[int], torch.Tensor],
                  roots: Sequence[int]) -> list:
    """Interpret the CNode program; ``read(nid)`` supplies bound inputs.
    Returns the values of the requested program roots."""
    vals: dict[int, torch.Tensor] = {}
    for (nid, op, ins, _shape, attrs) in cplan.prog:
        argv = []
        for kind, ref in ins:
            if kind == "n":
                argv.append(vals[ref])
            elif kind == "b":
                argv.append(read(ref))
            else:                          # literal
                argv.append(ref)
        vals[nid] = eval_node(op, argv, dict(attrs))
    return [vals[r] if r in vals else read(r) for r in roots]


def _agg(val, op: str, axis):
    return _AGG_FN[op](val, dim=axis, keepdim=True)


# --------------------------------------------------------------------------
# dense skeleton references (the oracle per template variant)
# --------------------------------------------------------------------------

def execute_dense(cplan: CPlan, env: dict[int, torch.Tensor]):
    """Reference execution of a fused operator over dense inputs.
    ``env`` maps bound nids to dense tensors.  Returns the contiguous
    output tensor (or a (k,1) stack for multi-aggregates)."""
    return _execute_dense(cplan, env).contiguous()


def execute_dense_batched(cplan: CPlan, env: dict[int, torch.Tensor]):
    """:func:`execute_dense` once per request: every 3-D value of ``env``
    is (B, *shape), a 2-D value is shared; returns the outputs stacked
    (B, ...) — the plain version of the Cell, MAgg and Row kernels'
    request-axis forms."""
    counts = {v.shape[0] for v in env.values() if v.dim() == 3}
    if len(counts) != 1:
        raise ValueError(f"batched operands need one request count, got "
                         f"{sorted(counts)}")
    (nreq,) = counts
    return torch.stack([
        execute_dense(cplan, {nid: (v[q] if v.dim() == 3 else v)
                              for nid, v in env.items()})
        for q in range(nreq)])


def _execute_dense(cplan: CPlan, env: dict[int, torch.Tensor]):
    read = lambda nid: env[nid]

    if cplan.extra:                       # multi-aggregate
        roots = [cplan.prog_root] + [r for r, _ in cplan.extra]
        ops = [cplan.agg_op] + [op for _, op in cplan.extra]
        vals = apply_program(cplan, read, roots)
        outs = [_agg(v, op, None).reshape(1, 1) for v, op in zip(vals, ops)]
        return torch.cat(outs, dim=0)

    roots = [cplan.prog_root]
    if cplan.close_nid is not None:
        roots.append(cplan.close_nid)
    vals = apply_program(cplan, read, roots)
    val = vals[0]
    closer = vals[1] if len(vals) > 1 else None
    v = cplan.variant
    if v == NO_AGG:
        return val
    if v == FULL_AGG:
        return _agg(val, cplan.agg_op, None).reshape(1, 1)
    if v == ROW_AGG:
        return _agg(val, cplan.agg_op, 1).reshape(-1, 1)
    if v == COL_AGG:
        return _agg(val, cplan.agg_op, 0).reshape(1, -1)
    if v == COL_T_AGG:
        return closer.T @ val
    if v == RIGHT_MM:
        return val @ (closer.T if cplan.close_tb else closer)
    if v == LEFT_MM:
        return val.T @ closer
    raise NotImplementedError(v)
