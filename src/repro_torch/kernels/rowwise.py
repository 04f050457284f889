"""Row template: wrapper of the generated CUDA kernel, and its plain
version.

Replaces ``repro/kernels/rowwise.py::row_pallas`` — all five variants
(``no_agg``, ``row_agg``, ``col_agg``, ``full_agg``, ``col_t_agg``), narrow
in-program matmuls and in-program row aggregates.  The kernel source is
generated per CPlan (:func:`repro_torch.kernels.cuda_src.row_source`) over
``csrc/row.cuh``, in its tile, warp or streaming layout
(``csrc/row_stream.cuh``); see those headers for the design and its
bound.  The launch geometry (threads, rows a CTA takes per step,
CTAs per SM, shared memory) comes from the generated source.
:func:`row` launches it for one request and :func:`row_batched` for a
batch of requests stacked on a leading axis — one launch either way, the
batched one the counterpart of a vmapped ``pallas_call``, its persistent
grid shared out over the requests.
"""

from __future__ import annotations

import threading

import torch

from repro_torch.core.cplan import (CPlan, COL_AGG, COL_T_AGG, FULL_AGG,
                                    NO_AGG, ROW_AGG)
from . import build, cuda_src, ref

#: launches of the CUDA kernel for one request (one per fused-operator
#: call on the card) and of its request-axis form (one per batch)
launches = 0
batched_launches = 0
_COUNT_LOCK = threading.Lock()


def row_plain(cplan: CPlan, env: dict) -> torch.Tensor:
    """Plain PyTorch version: the torch-eager oracle of the template."""
    return ref.execute_dense(cplan, env)


def row_batched_plain(cplan: CPlan, env: dict) -> torch.Tensor:
    """Plain version of the request-axis form: the oracle per request."""
    return ref.execute_dense_batched(cplan, env)


def _run(cplan: CPlan, binds, strides, nreq: int,
         dev: torch.device) -> torch.Tensor:
    """One launch over ``nreq`` requests; returns the output, (nreq, ...)
    stacked when ``strides`` is given, else one request's."""
    src = cuda_src.source_for(cplan)
    if src.template != "row":
        raise ValueError(f"{cplan.ttype.name} CPlan runs the {src.template} "
                         f"kernel, not row")
    m = cplan.main.shape[0]
    variant = cplan.variant
    out_shape = {NO_AGG: (m, src.domain[1]), ROW_AGG: (m, 1),
                 COL_AGG: (1, src.domain[1]), FULL_AGG: (1, 1),
                 COL_T_AGG: tuple(cplan.out_shape)}[variant]
    if strides is None:
        out, ostride = torch.empty(out_shape, dtype=torch.float32,
                                   device=dev), 0
    else:
        out = build.batch_empty(nreq, out_shape, dev)
        ostride = build.batch_stride(out_shape)
    # tile layout: a persistent grid of src.ctas CTAs per SM over tiles of
    # src.rows rows; warp layout: a few waves of CTAs over rows; a batch
    # shares either out over its requests
    nblocks = build.grid(m, src.rows, dev, src.ctas, nreq)
    part = None
    if src.elems:
        part = torch.empty(nreq * nblocks * src.parts_per_cta * src.elems,
                           dtype=torch.float32, device=dev)
    rr, rc = cuda_src.root_shape(cplan)
    aux = {ROW_AGG: rc, COL_AGG: rr, FULL_AGG: rr * rc}.get(variant, 1)
    build.launch(src, binds, out, part, m, nblocks, aux, strides, nreq,
                 ostride)
    return out


def row(cplan: CPlan, env: dict) -> torch.Tensor:
    """Run a Row-template CPlan: the CUDA kernel for CUDA tensors, the
    plain version for CPU tensors; anything else raises."""
    global launches
    main = env[cplan.main.nid]
    if main.device.type == "cpu":
        return row_plain(cplan, env)
    binds = build.cuda_operands(cplan, env)
    out = _run(cplan, binds, None, 1, main.device)
    with _COUNT_LOCK:
        launches += 1
    return out


def row_batched(cplan: CPlan, env: dict) -> torch.Tensor:
    """Run a Row-template CPlan over a batch: every 3-D value of ``env``
    is (B, *shape), a 2-D one is shared; one launch of the request-axis
    kernel for CUDA tensors, the plain version for CPU tensors; returns
    the outputs stacked (B, ...)."""
    global batched_launches
    main = env[cplan.main.nid]
    if main.device.type == "cpu":
        return row_batched_plain(cplan, env)
    binds, strides, nreq = build.cuda_batched_operands(cplan, env)
    out = _run(cplan, binds, strides, nreq, main.device)
    with _COUNT_LOCK:
        batched_launches += 1
    return out
