"""Cell template (and single-root MAgg): wrapper of the generated CUDA
kernel, and its plain version.

Replaces ``repro/kernels/cellwise.py::cell_pallas``.  The kernel source is
generated per CPlan (:func:`repro_torch.kernels.cuda_src.cell_source`)
over the fixed skeleton ``csrc/cell.cuh``, in its vector or scalar walk;
see its header for the design and what bounds it on the card.
:func:`cell` launches it for CUDA tensors and takes :func:`cell_plain`
only for tensors on the CPU.  Every call is one launch: ``full_agg`` and
``col_agg`` fold their partials inside the kernel, through a scratch
buffer kept per (device, stream) whose ticket word is zeroed once, when
the buffer is made, and reset by the kernel itself.
"""

from __future__ import annotations

import torch

from repro_torch.core.cplan import CPlan, COL_AGG, FULL_AGG, NO_AGG, ROW_AGG
from . import build, cuda_src, ref

#: launches of the CUDA kernel (one per fused-operator call on the card)
launches = 0

#: scratch of the reducing variants per (device index, stream): the
#: ticket in its first word, partials from float 4 (16 bytes in)
_SCRATCH: dict[tuple[int, int], torch.Tensor] = {}
_SCRATCH_HEAD = 4


def cell_plain(cplan: CPlan, env: dict) -> torch.Tensor:
    """Plain PyTorch version: the torch-eager oracle of the template."""
    return ref.execute_dense(cplan, env)


def grid(src: cuda_src.KernelSource, m: int, sm_count: int) -> int:
    """CTAs of one launch: for ``no_agg`` / ``full_agg`` a persistent grid
    of at most ``src.ctas`` CTAs per SM, no more than the walk needs (one
    step of a CTA takes ``group * unroll * threads`` cells); for
    ``row_agg`` warps over rows; for ``col_agg`` the row chunks R."""
    n = src.domain[1]
    if src.variant == ROW_AGG:
        return max(1, min(-(-m // 8), sm_count * 16))
    if src.variant == COL_AGG:
        return max(1, min(-(-m // 64), sm_count * 8 // -(-n // 32)))
    step = src.group * src.unroll * src.threads
    return max(1, min(-(-(m * n) // step), sm_count * src.ctas))


def scratch(device: torch.device, floats: int) -> torch.Tensor:
    """The (device, stream) scratch buffer with room for ``floats``
    partials after its head, made anew (zeroed) only when it is missing or
    too small: a call never clears it, the kernel resets its ticket."""
    stream = torch.cuda.current_stream(device).cuda_stream
    key = (device.index, stream)
    buf = _SCRATCH.get(key)
    if buf is None or buf.numel() < _SCRATCH_HEAD + floats:
        size = max(_SCRATCH_HEAD + floats, 1 << 16)
        buf = torch.zeros(size, dtype=torch.float32, device=device)
        _SCRATCH[key] = buf
    return buf


def check_alignment(src: cuda_src.KernelSource, binds) -> None:
    """The vector walk reads every bind that is not (1,1) as float4:
    each must start on a 16-byte boundary; raises on one that does not."""
    if src.walk != "vector":
        return
    for k, t in enumerate(binds):
        if t.numel() > 1 and t.data_ptr() % 16:
            raise ValueError(
                f"cell kernel, vector walk: operand {k} "
                f"{tuple(t.shape)} is not 16-byte aligned "
                f"(address {t.data_ptr():#x})")


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
    check_alignment(src, binds)
    m, n = src.domain
    dev = main.device
    variant = cplan.variant
    nblocks = grid(src, m, build.sm_count(dev))
    out_shape = {NO_AGG: (m, n), ROW_AGG: (m, 1), COL_AGG: (1, n),
                 FULL_AGG: (1, 1)}[variant]
    out = torch.empty(out_shape, dtype=torch.float32, device=dev)
    part = scratch(dev, nblocks * src.elems) if src.elems else None
    aux = {ROW_AGG: n, COL_AGG: m, FULL_AGG: m * n}.get(variant, 1.0)
    build.launch(src, binds, out, part, m, nblocks, aux)
    launches += 1
    return out
