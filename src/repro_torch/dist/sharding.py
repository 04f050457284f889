"""Layout rules for fused-operator operands (the reference's
``repro/dist/sharding.py``, the part the fusion planner reads).

A partition spec is a tuple with one entry per dimension — ``None``
(replicated), an axis name, or a tuple of axis names — the counterpart of
``jax.sharding.PartitionSpec`` (itself a tuple); trailing ``None``
entries are dropped, as ``PartitionSpec`` drops them.  Rows shard over
the data/FSDP axes, columns over the tensor-parallel axis ``model``, and
every entry is divisibility-checked with per-dimension degradation to
replication.
"""

from __future__ import annotations

from typing import Optional

TP_AXIS = "model"


def P(*entries) -> tuple:
    """A partition spec: the tuple of its entries."""
    return tuple(entries)


def tp_axis(mesh) -> Optional[str]:
    """The tensor-parallel axis name, or None if the mesh has none."""
    return TP_AXIS if TP_AXIS in mesh.axis_names else None


def fsdp_axes(mesh) -> tuple[str, ...]:
    """Every mesh axis except the tensor-parallel one, mesh order."""
    return tuple(a for a in mesh.axis_names if a != TP_AXIS)


def axis_size(mesh, axes) -> int:
    """Product of mesh-axis sizes for a None/str/tuple spec entry."""
    if axes is None:
        return 1
    if isinstance(axes, str):
        axes = (axes,)
    out = 1
    for a in axes:
        out *= mesh.shape[a]
    return out


def _fit(mesh, dim: int, axes):
    """Largest suffix of ``axes`` that exists in the mesh and divides
    ``dim`` — the graceful-degradation primitive.  Returns a spec entry
    (None / str / tuple)."""
    if axes is None:
        return None
    if isinstance(axes, str):
        axes = (axes,)
    axes = tuple(a for a in axes if a in mesh.axis_names)
    while axes:
        n = axis_size(mesh, axes)
        if n > 1 and dim % n == 0:
            return axes[0] if len(axes) == 1 else axes
        axes = axes[1:]
    return None


def _spec(mesh, shape: tuple, roles: tuple) -> tuple:
    """A rank-matched partition spec from per-dim axis requests.

    ``roles`` aligns to the *trailing* dims of ``shape``; leading
    (stacked) dims replicate.  Each entry is divisibility-checked
    against its dim and degrades to None via :func:`_fit`."""
    pad = len(shape) - len(roles)
    if pad < 0:
        return P()
    entries = [None] * pad + [_fit(mesh, d, r)
                              for d, r in zip(shape[pad:], roles)]
    while entries and entries[-1] is None:
        entries.pop()
    return P(*entries)


def operand_spec(mesh, shape) -> tuple:
    """Layout rule for one fused-operator operand (``FusionLayout.auto``):
    rows over the FSDP axes, columns over the TP axis, with per-dim
    divisibility degradation — so a (1, n) row vector or a matrix whose
    rows don't divide the data axes simply replicates.  The hybrid
    local/distributed placement reads its row/column shard factors from
    these specs."""
    return _spec(mesh, tuple(shape), (fsdp_axes(mesh), tp_axis(mesh)))
