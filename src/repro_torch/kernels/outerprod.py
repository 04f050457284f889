"""Outer template (the sparsity-exploiting block SDDMM): wrapper of the
generated CUDA kernel, and its plain version.

Replaces ``repro/kernels/outerprod.py::outer_pallas``.  Over the non-zero
(bs × bs) blocks of a row-major BCSR main X, for each block b it forms
``S_b = U[rows[b]] · V[cols[b]]ᵀ``, applies the CPlan's chain to ``S_b``,
the X block and the sides, and

* ``right_mm`` accumulates ``chain @ closer[cols[b]]`` into
  ``out[rows[b]]`` (m, k); block rows without blocks are zero;
* ``full_agg`` aggregates every chain value into a (1, 1) result.

Work is ∝ non-zero blocks, never m × n.  The kernel source is generated
per CPlan and block size (:func:`repro_torch.kernels.cuda_src.
outer_source`) over ``csrc/outer.cuh``; see its header for the design and
what bounds it on the card.  Its grid runs over the BCSR's pieces
(:attr:`~repro_torch.kernels.blocksparse.BCSR.pieces`); the partials of a
row's pieces are folded in order in the same call.  :func:`outer`
launches it for a BCSR on the card and takes :func:`outer_plain` only for
one on the CPU.
"""

from __future__ import annotations

import torch

from repro_torch.core.cplan import CPlan, FULL_AGG, RIGHT_MM
from . import build, cuda_src, ops
from .blocksparse import BCSR

#: launches of the CUDA kernel (one per fused-operator call on the card)
launches = 0


def _check(cplan: CPlan, env: dict) -> BCSR:
    """The BCSR main, after the checks both versions share: an Outer
    ``right_mm`` / ``full_agg`` CPlan and sides of the shapes the
    reference takes ((1,1), (m,n), (m,1), (1,n))."""
    X = env[cplan.main.nid]
    if not isinstance(X, BCSR):
        raise TypeError(f"Outer kernel needs a BCSR main, got "
                        f"{type(X).__name__}")
    if cplan.variant not in (RIGHT_MM, FULL_AGG):
        raise NotImplementedError(f"Outer kernel variant {cplan.variant}")
    m, n = X.shape
    for b in cplan.binds:
        if b.kind in ("side", "scalar"):
            r, c = tuple(env[b.nid].shape)
            if not ((r, c) in ((1, 1), (m, n)) or (c == 1 and r == m)
                    or (r == 1 and c == n)):
                raise NotImplementedError(f"outer side input {(r, c)}")
    return X


def outer_plain(cplan: CPlan, env: dict) -> torch.Tensor:
    """Plain PyTorch version: the torch block loop
    (:func:`repro_torch.kernels.ops._execute_bcsr`) of the template."""
    _check(cplan, env)
    return ops._execute_bcsr(cplan, env)


def _dense_operand(t, device: torch.device, what: str) -> torch.Tensor:
    """``t`` checked (fp32, contiguous, on ``device``); a view that does
    not start on a 16-byte boundary is copied, since the kernel stages its
    operands with 16-byte copies."""
    t = t.todense() if isinstance(t, BCSR) else t
    if not isinstance(t, torch.Tensor) or t.device != device:
        raise ValueError(f"{what} is not a tensor on {device}")
    if t.dtype != torch.float32:
        raise TypeError(f"{what}: {t.dtype}, the kernel takes float32")
    if not t.is_contiguous():
        raise ValueError(f"{what} is not contiguous")
    return t.clone() if t.data_ptr() % 16 else t


def outer(cplan: CPlan, env: dict) -> torch.Tensor:
    """Run an Outer ``right_mm`` / ``full_agg`` CPlan over a BCSR main: the
    CUDA kernel for a BCSR on the card, the plain version for one on the
    CPU; anything else raises."""
    global launches
    X = _check(cplan, env)
    if X.device.type == "cpu":
        return outer_plain(cplan, env)
    if X.device.type != "cuda":
        raise ValueError(f"Outer kernel needs CUDA tensors, got {X.device}")
    dev = X.device
    m, n = X.shape
    src = cuda_src.source_for(cplan, bs=X.bs)
    if src.template != "outer":
        raise ValueError(f"{cplan.ttype.name} CPlan runs the {src.template} "
                         f"kernel, not outer")
    binds = []
    for b in cplan.binds:
        if b.kind == "main":
            t = _dense_operand(X.data, dev, "BCSR data")
        else:
            t = _dense_operand(env[b.nid], dev, f"operand %{b.nid}")
            if tuple(t.shape) != tuple(b.shape):
                raise ValueError(f"operand %{b.nid}: shape "
                                 f"{tuple(t.shape)} != planned "
                                 f"{tuple(b.shape)}")
        binds.append(t)
    kinds = [b.kind for b in cplan.binds]
    r = binds[kinds.index("factor_u")].shape[1]
    pieces = X.pieces
    npieces = pieces.table.shape[0]
    closer, k = None, 0
    if cplan.variant == RIGHT_MM:
        if cplan.close_nid == cplan.binds[kinds.index("factor_v")].nid \
                and not cplan.close_tb:
            closer = binds[kinds.index("factor_v")]     # staged once, as V
        else:
            closer = _dense_operand(env[cplan.close_nid], dev, "closer")
            if cplan.close_tb:
                closer = closer.T.contiguous()
        k = closer.shape[1]
        out = torch.empty((m, k), dtype=torch.float32, device=dev)
        part = torch.empty((npieces, X.bs, k), dtype=torch.float32,
                           device=dev)
    else:
        out = torch.empty((1, 1), dtype=torch.float32, device=dev)
        part = torch.empty(npieces, dtype=torch.float32, device=dev)
    build.launch_outer(src, binds, binds[kinds.index("main")], X.cols,
                       X.rowptr, pieces, closer, out, part, m, n, X.nblocks,
                       X.bs, r, k)
    launches += 1
    return out
