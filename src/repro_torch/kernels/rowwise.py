"""Row template: wrapper of the generated CUDA kernel, and its plain
version.

Replaces ``repro/kernels/rowwise.py::row_pallas`` — all five variants
(``no_agg``, ``row_agg``, ``col_agg``, ``full_agg``, ``col_t_agg``), narrow
in-program matmuls and in-program row aggregates.  The kernel source is
generated per CPlan (:func:`repro_torch.kernels.cuda_src.row_source`) over
``csrc/row.cuh``, in its tile or warp layout; see its header for the design
and its bound.  The launch geometry (threads, rows a CTA takes per step,
CTAs per SM, shared memory) comes from the generated source.
"""

from __future__ import annotations

import torch

from repro_torch.core.cplan import (CPlan, COL_AGG, COL_T_AGG, FULL_AGG,
                                    NO_AGG, ROW_AGG)
from . import build, cuda_src, ref

#: launches of the CUDA kernel (one per fused-operator call on the card)
launches = 0


def row_plain(cplan: CPlan, env: dict) -> torch.Tensor:
    """Plain PyTorch version: the torch-eager oracle of the template."""
    return ref.execute_dense(cplan, env)


def row(cplan: CPlan, env: dict) -> torch.Tensor:
    """Run a Row-template CPlan: the CUDA kernel for CUDA tensors, the
    plain version for CPU tensors; anything else raises."""
    global launches
    main = env[cplan.main.nid]
    if main.device.type == "cpu":
        return row_plain(cplan, env)
    binds = build.cuda_operands(cplan, env)
    src = cuda_src.source_for(cplan)
    if src.template != "row":
        raise ValueError(f"{cplan.ttype.name} CPlan runs the {src.template} "
                         f"kernel, not row")
    m = cplan.main.shape[0]
    dev = main.device
    variant = cplan.variant
    out_shape = {NO_AGG: (m, src.domain[1]), ROW_AGG: (m, 1),
                 COL_AGG: (1, src.domain[1]), FULL_AGG: (1, 1),
                 COL_T_AGG: tuple(cplan.out_shape)}[variant]
    out = torch.empty(out_shape, dtype=torch.float32, device=dev)
    # tile layout: a persistent grid of src.ctas CTAs per SM over tiles of
    # src.rows rows; warp layout: a few waves of CTAs over rows
    nblocks = build.grid(m, src.rows, dev, src.ctas)
    part = None
    if src.elems:
        part = torch.empty(nblocks * src.parts_per_cta * src.elems,
                           dtype=torch.float32, device=dev)
    rr, rc = cuda_src.root_shape(cplan)
    aux = {ROW_AGG: rc, COL_AGG: rr, FULL_AGG: rr * rc}.get(variant, 1)
    build.launch(src, binds, out, part, m, nblocks, aux)
    launches += 1
    return out
