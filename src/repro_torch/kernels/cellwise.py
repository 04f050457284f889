"""Cell template (and single-root MAgg): wrapper of the generated CUDA
kernel, and its plain version.

Replaces ``repro/kernels/cellwise.py::cell_pallas``.  The kernel source is
generated per CPlan (:func:`repro_torch.kernels.cuda_src.cell_source`)
over the fixed skeleton ``csrc/cell.cuh``; see its header for the design
and what bounds it on the card.  :func:`cell` launches it for CUDA tensors
and takes :func:`cell_plain` only for tensors on the CPU.
"""

from __future__ import annotations

import torch

from repro_torch.core.cplan import CPlan, COL_AGG, FULL_AGG, NO_AGG, ROW_AGG
from . import build, cuda_src, ref

#: launches of the CUDA kernel (one per fused-operator call on the card)
launches = 0


def cell_plain(cplan: CPlan, env: dict) -> torch.Tensor:
    """Plain PyTorch version: the torch-eager oracle of the template."""
    return ref.execute_dense(cplan, env)


def cell(cplan: CPlan, env: dict) -> torch.Tensor:
    """Run a Cell-template CPlan: the CUDA kernel for CUDA tensors, the
    plain version for CPU tensors; anything else raises."""
    global launches
    main = env[cplan.main.nid]
    if main.device.type == "cpu":
        return cell_plain(cplan, env)
    binds = build.cuda_operands(cplan, env)
    src = cuda_src.source_for(cplan)
    if src.template != "cell":
        raise ValueError(f"{cplan.ttype.name} CPlan runs the {src.template} "
                         f"kernel, not cell")
    m, n = src.domain
    dev = main.device
    variant = cplan.variant
    part = None
    if variant == NO_AGG:
        out = torch.empty((m, n), dtype=torch.float32, device=dev)
        nblocks, aux = build.grid(m * n, 256, dev, 16), 1.0
    elif variant == ROW_AGG:
        out = torch.empty((m, 1), dtype=torch.float32, device=dev)
        nblocks, aux = build.grid(m, 8, dev, 16), n
    elif variant == COL_AGG:
        out = torch.empty((1, n), dtype=torch.float32, device=dev)
        col_blocks = -(-n // 32)
        nblocks = max(1, min(-(-m // 64),
                             build.sm_count(dev) * 8 // col_blocks))
        part = torch.empty(nblocks * n, dtype=torch.float32, device=dev)
        aux = m
    else:
        assert variant == FULL_AGG, variant
        out = torch.empty((1, 1), dtype=torch.float32, device=dev)
        nblocks, aux = build.grid(m * n, 256, dev, 8), m * n
        part = torch.empty(nblocks, dtype=torch.float32, device=dev)
    build.launch(src, binds, out, part, m, nblocks, aux)
    launches += 1
    return out
