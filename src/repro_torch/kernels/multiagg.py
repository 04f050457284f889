"""MAgg template: wrapper of the generated CUDA kernel, and its plain
version.

Replaces ``repro/kernels/multiagg.py::multiagg_pallas``: k full aggregates
of k program roots in one scan, out (k, 1); mean roots are scaled by
1/(m·n) after the combine, as the Pallas kernel does.  The kernel source is
generated per CPlan (:func:`repro_torch.kernels.cuda_src.magg_source`) over
``csrc/magg.cuh``; see its header for the design and its bound.
"""

from __future__ import annotations

import torch

from repro_torch.core.cplan import CPlan
from . import build, cuda_src, ref

#: launches of the CUDA kernel (one per fused-operator call on the card)
launches = 0


def multiagg_plain(cplan: CPlan, env: dict) -> torch.Tensor:
    """Plain PyTorch version: the torch-eager oracle of the template."""
    return ref.execute_dense(cplan, env)


def multiagg(cplan: CPlan, env: dict) -> torch.Tensor:
    """Run a multi-root MAgg CPlan: the CUDA kernel for CUDA tensors, the
    plain version for CPU tensors; anything else raises."""
    global launches
    main = env[cplan.main.nid]
    if main.device.type == "cpu":
        return multiagg_plain(cplan, env)
    binds = build.cuda_operands(cplan, env)
    src = cuda_src.source_for(cplan)
    if src.template != "magg":
        raise ValueError(f"{cplan.ttype.name} CPlan runs the {src.template} "
                         f"kernel, not magg")
    m, n = src.domain
    dev = main.device
    out = torch.empty((src.elems, 1), dtype=torch.float32, device=dev)
    nblocks = build.grid(m * n, 256, dev, 8)
    part = torch.empty(nblocks * src.elems, dtype=torch.float32, device=dev)
    build.launch(src, binds, out, part, m, nblocks, 1.0 / (m * n))
    launches += 1
    return out
