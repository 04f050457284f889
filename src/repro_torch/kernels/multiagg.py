"""MAgg template: wrapper of the generated CUDA kernel, and its plain
version.

Replaces ``repro/kernels/multiagg.py::multiagg_pallas``: k full aggregates
of k program roots in one scan, out (k, 1); mean roots are scaled by
1/(m·n) after the combine, as the Pallas kernel does.  The kernel source is
generated per CPlan (:func:`repro_torch.kernels.cuda_src.magg_source`) over
``csrc/magg.cuh``; see its header for the design and its bound.
:func:`multiagg` launches it for one request and :func:`multiagg_batched`
for a batch of requests stacked on a leading axis, out (B, k, 1).
"""

from __future__ import annotations

import threading

import torch

from repro_torch.core.cplan import CPlan
from . import build, cuda_src, ref

#: launches of the CUDA kernel for one request (one per fused-operator
#: call on the card) and of its request-axis form (one per batch)
launches = 0
batched_launches = 0
_COUNT_LOCK = threading.Lock()


def multiagg_plain(cplan: CPlan, env: dict) -> torch.Tensor:
    """Plain PyTorch version: the torch-eager oracle of the template."""
    return ref.execute_dense(cplan, env)


def multiagg_batched_plain(cplan: CPlan, env: dict) -> torch.Tensor:
    """Plain version of the request-axis form: the oracle per request."""
    return ref.execute_dense_batched(cplan, env)


def _run(cplan: CPlan, binds, strides, nreq: int,
         dev: torch.device) -> torch.Tensor:
    src = cuda_src.source_for(cplan)
    if src.template != "magg":
        raise ValueError(f"{cplan.ttype.name} CPlan runs the {src.template} "
                         f"kernel, not magg")
    m, n = src.domain
    if strides is None:
        out, ostride = torch.empty((src.elems, 1), dtype=torch.float32,
                                   device=dev), 0
    else:
        out = build.batch_empty(nreq, (src.elems, 1), dev)
        ostride = build.batch_stride((src.elems, 1))
    nblocks = build.grid(m * n, 256, dev, 8, nreq)
    part = torch.empty(nreq * nblocks * src.elems, dtype=torch.float32,
                       device=dev)
    build.launch(src, binds, out, part, m, nblocks, 1.0 / (m * n), strides,
                 nreq, ostride)
    return out


def multiagg(cplan: CPlan, env: dict) -> torch.Tensor:
    """Run a multi-root MAgg CPlan: the CUDA kernel for CUDA tensors, the
    plain version for CPU tensors; anything else raises."""
    global launches
    main = env[cplan.main.nid]
    if main.device.type == "cpu":
        return multiagg_plain(cplan, env)
    binds = build.cuda_operands(cplan, env)
    out = _run(cplan, binds, None, 1, main.device)
    with _COUNT_LOCK:
        launches += 1
    return out


def multiagg_batched(cplan: CPlan, env: dict) -> torch.Tensor:
    """Run a multi-root MAgg CPlan over a batch: every 3-D value of
    ``env`` is (B, *shape), a 2-D one is shared; one launch of the
    request-axis kernel for CUDA tensors, the plain version for CPU
    tensors; returns (B, k, 1)."""
    global batched_launches
    main = env[cplan.main.nid]
    if main.device.type == "cpu":
        return multiagg_batched_plain(cplan, env)
    binds, strides, nreq = build.cuda_batched_operands(cplan, env)
    out = _run(cplan, binds, strides, nreq, main.device)
    with _COUNT_LOCK:
        batched_launches += 1
    return out
