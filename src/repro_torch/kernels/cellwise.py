"""Cell template (and single-root MAgg): wrappers of the generated CUDA
kernel, and their plain versions.

Replaces ``repro/kernels/cellwise.py::cell_pallas``.  The kernel source is
generated per CPlan (:func:`repro_torch.kernels.cuda_src.cell_source`)
over the fixed skeleton ``csrc/cell.cuh``, in its vector or scalar walk;
see its header for the design and what bounds it on the card.
:func:`cell` launches it for one request and :func:`cell_batched` for a
batch of requests stacked on a leading axis — one launch either way, the
batched one the counterpart of a vmapped ``pallas_call``; each takes its
plain version only for tensors on the CPU.  ``full_agg`` and ``col_agg``
fold their partials inside the kernel, through a scratch buffer kept per
(device, stream): one ticket word per request in its head, zeroed once,
when the buffer is made, and reset by the kernel itself, the partials
after it.
"""

from __future__ import annotations

import threading

import torch

from repro_torch.core.cplan import CPlan, COL_AGG, FULL_AGG, NO_AGG, ROW_AGG
from . import build, cuda_src, ref

#: launches of the CUDA kernel for one request (one per fused-operator
#: call on the card) and of its request-axis form (one per batch)
launches = 0
batched_launches = 0
_COUNT_LOCK = threading.Lock()

#: scratch of the reducing variants per (device index, stream): (buffer,
#: ticket words in its head); tickets from float 0, partials from the head
_SCRATCH: dict[tuple[int, int], tuple[torch.Tensor, int]] = {}
_SCRATCH_LOCK = threading.Lock()


def cell_plain(cplan: CPlan, env: dict) -> torch.Tensor:
    """Plain PyTorch version: the torch-eager oracle of the template."""
    return ref.execute_dense(cplan, env)


def cell_batched_plain(cplan: CPlan, env: dict) -> torch.Tensor:
    """Plain version of the request-axis form: the oracle per request."""
    return ref.execute_dense_batched(cplan, env)


def grid(src: cuda_src.KernelSource, m: int, sm_count: int,
         nreq: int = 1) -> int:
    """CTAs of one request's grid: for ``no_agg`` / ``full_agg`` a
    persistent grid of at most ``src.ctas`` CTAs per SM, no more than the
    walk needs (one step of a CTA takes ``group * unroll * threads``
    cells); for ``row_agg`` warps over rows; for ``col_agg`` the row chunks
    R.  A batch of ``nreq`` requests shares the card's grid out over its
    requests (:func:`~repro_torch.kernels.build.share`)."""
    n = src.domain[1]
    if src.variant == ROW_AGG:
        return max(1, min(-(-m // 8), build.share(sm_count * 16, nreq)))
    if src.variant == COL_AGG:
        return max(1, min(-(-m // 64),
                          build.share(sm_count * 8 // -(-n // 32), nreq)))
    step = src.group * src.unroll * src.threads
    return max(1, min(-(-(m * n) // step),
                      build.share(sm_count * src.ctas, nreq)))


def ticket_words(nreq: int) -> int:
    """Ticket words in the scratch head for ``nreq`` requests: one each,
    rounded up to a multiple of 4 (16 bytes), at least 4."""
    return max(4, -(-int(nreq) // 4) * 4)


def scratch_key(device: torch.device) -> tuple[int, int]:
    """The scratch buffer's key: (device index, current stream)."""
    return (device.index, torch.cuda.current_stream(device).cuda_stream)


def scratch(device: torch.device, floats: int, nreq: int = 1,
            key=None) -> tuple[torch.Tensor, int]:
    """The (device, stream) scratch buffer with room for ``nreq`` tickets
    and ``floats`` partials after them, and the float offset of its
    partials; made anew (zeroed) only when it is missing or too small — a
    call never clears it, the kernel resets its tickets.  Creation and
    replacement hold a lock, so two threads on one stream share one
    buffer.  ``key`` defaults to :func:`scratch_key`."""
    key = scratch_key(device) if key is None else key
    with _SCRATCH_LOCK:
        buf, head = _SCRATCH.get(key, (None, 0))
        want = ticket_words(nreq)
        if buf is None or head < want or buf.numel() < head + floats:
            head = max(head, want)
            size = max(head + floats, 1 << 16)
            buf = torch.zeros(size, dtype=torch.float32, device=device)
            _SCRATCH[key] = (buf, head)
    return buf, head


def check_alignment(src: cuda_src.KernelSource, binds,
                    strides=None) -> None:
    """The vector walk reads every bind that is not (1,1) as float4:
    each request's slice must start on a 16-byte boundary; raises on one
    that does not."""
    if src.walk != "vector":
        return
    strides = strides if strides is not None else [0] * len(binds)
    for k, (t, st) in enumerate(zip(binds, strides)):
        per = t[0] if t.dim() == 3 else t
        if per.numel() > 1 and (t.data_ptr() % 16 or st % 4):
            raise ValueError(
                f"cell kernel, vector walk: operand {k} "
                f"{tuple(t.shape)} is not 16-byte aligned for every "
                f"request (address {t.data_ptr():#x}, stride {st} floats)")


def _run(cplan: CPlan, binds, strides, nreq: int,
         dev: torch.device) -> torch.Tensor:
    """One launch over ``nreq`` requests; returns the output, (nreq, ...)
    stacked when ``strides`` is given, else one request's."""
    src = cuda_src.source_for(cplan)
    if src.template != "cell":
        raise ValueError(f"{cplan.ttype.name} CPlan runs the {src.template} "
                         f"kernel, not cell")
    check_alignment(src, binds, strides)
    m, n = src.domain
    variant = cplan.variant
    nblocks = grid(src, m, build.sm_count(dev), nreq)
    out_shape = {NO_AGG: (m, n), ROW_AGG: (m, 1), COL_AGG: (1, n),
                 FULL_AGG: (1, 1)}[variant]
    if strides is None:
        out, ostride = torch.empty(out_shape, dtype=torch.float32,
                                   device=dev), 0
    else:
        out = build.batch_empty(nreq, out_shape, dev)
        ostride = build.batch_stride(out_shape)
    part = ticket = None
    if src.elems:
        buf, head = scratch(dev, nreq * nblocks * src.elems, nreq)
        part, ticket = buf[head:], buf.data_ptr()
    aux = {ROW_AGG: n, COL_AGG: m, FULL_AGG: m * n}.get(variant, 1.0)
    build.launch(src, binds, out, part, m, nblocks, aux, strides, nreq,
                 ostride, ticket)
    return out


def cell(cplan: CPlan, env: dict) -> torch.Tensor:
    """Run a Cell-template CPlan: the CUDA kernel for CUDA tensors, the
    plain version for CPU tensors; anything else raises."""
    global launches
    main = env[cplan.main.nid]
    if main.device.type == "cpu":
        return cell_plain(cplan, env)
    binds = build.cuda_operands(cplan, env)
    out = _run(cplan, binds, None, 1, main.device)
    with _COUNT_LOCK:
        launches += 1
    return out


def cell_batched(cplan: CPlan, env: dict) -> torch.Tensor:
    """Run a Cell-template CPlan over a batch: every 3-D value of ``env``
    is (B, *shape), a 2-D one is shared; one launch of the request-axis
    kernel for CUDA tensors, the plain version for CPU tensors; returns
    the outputs stacked (B, ...)."""
    global batched_launches
    main = env[cplan.main.nid]
    if main.device.type == "cpu":
        return cell_batched_plain(cplan, env)
    binds, strides, nreq = build.cuda_batched_operands(cplan, env)
    out = _run(cplan, binds, strides, nreq, main.device)
    with _COUNT_LOCK:
        batched_launches += 1
    return out
