"""Operands carried across packages: the system has no weights, so what
crosses is data and the iterate.  :func:`to_torch` turns numpy arrays (or
arrays produced by another framework and converted to numpy) into
contiguous fp32 tensors on a device; :func:`to_bcsr` carries a block-sparse
matrix across (the reference's ``BCSR`` or anything with its attributes),
and :func:`to_dict_compressed` a CLA-compressed one (the reference's
``DictCompressed`` or anything with its attributes)."""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels.blocksparse import BCSR, DictCompressed


def resolve_device(device) -> torch.device:
    """``device`` as a torch device; raises when the card is asked for and
    there is none (never falls back to the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={str(device)!r} was requested but "
            f"torch.cuda.is_available() is False; pass device='cpu' to run "
            f"on the CPU")
    return dev


def to_torch(values, device="cuda"):
    """Contiguous fp32 tensor(s) on ``device`` from one array-like, or a
    list / tuple of them (same structure back)."""
    device = resolve_device(device)
    if isinstance(values, (list, tuple)):
        return type(values)(to_torch(v, device) for v in values)
    if isinstance(values, torch.Tensor):
        return values.to(device=device, dtype=torch.float32).contiguous()
    return torch.as_tensor(np.ascontiguousarray(values, dtype=np.float32),
                           device=device)


def to_bcsr(x, device="cuda"):
    """The port's :class:`~repro_torch.kernels.blocksparse.BCSR` on
    ``device`` from any object with numpy-convertible ``data`` (nb, bs,
    bs) fp32, ``rows`` / ``cols`` (nb,) block indices sorted row-major,
    and a ``shape`` and ``bs``: the reference's BCSR (duck-typed, nothing
    of its package is imported) or the port's own."""
    device = resolve_device(device)
    if isinstance(x, BCSR):
        return x.to(device)
    idx = lambda a: torch.as_tensor(np.array(a, dtype=np.int32),
                                    device=device)
    return BCSR(to_torch(np.array(x.data, dtype=np.float32), device),
                idx(x.rows), idx(x.cols), tuple(x.shape), int(x.bs))


def to_dict_compressed(x, device="cuda"):
    """The port's :class:`~repro_torch.kernels.blocksparse.DictCompressed`
    on ``device`` from any object with numpy-convertible ``values`` (ncol,
    ndist) fp32, ``codes`` (nrow, ncol) int32 and ``counts`` (ncol, ndist)
    fp32 and a ``shape``: the reference's DictCompressed (duck-typed,
    nothing of its package is imported) or the port's own."""
    device = resolve_device(device)
    if isinstance(x, DictCompressed):
        return x.to(device)
    return DictCompressed(
        to_torch(np.array(x.values, dtype=np.float32), device),
        torch.as_tensor(np.array(x.codes, dtype=np.int32), device=device),
        to_torch(np.array(x.counts, dtype=np.float32), device),
        tuple(x.shape))
