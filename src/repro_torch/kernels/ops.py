"""Dispatch layer for generated fused operators (dense, one device).

Given a CPlan and bound tensors, pick an execution path — the dense
routing of the reference's ``repro/kernels/ops.py``, kept exactly:

* ``kernels="never"`` — interpret the program op by op in torch
  (:func:`repro_torch.kernels.ref.execute_dense`);
* ``kernels="cuda"`` — a multi-root CPlan (``cplan.extra``) runs the MAgg
  kernel, CELL or single-root MAGG the Cell kernel, ROW the Row kernel;
  an Outer CPlan over a dense main runs the torch oracle.  Each kernel
  wrapper takes its plain version for CPU tensors only.

Sparse (BCSR) and compressed (CLA) operands, and the Outer kernel, wait for
the sparse slice (ROADMAP.md queue A item 8).
"""

from __future__ import annotations

import torch

from repro_torch.core.cplan import CPlan
from repro_torch.core.templates import TType
from . import cellwise, multiagg, ref, rowwise


def execute(cplan: CPlan, env: dict, *, kernels: str = "never"
            ) -> torch.Tensor:
    """Run one fused operator.  ``kernels`` ∈ {"never", "cuda"}."""
    for v in env.values():
        if not isinstance(v, torch.Tensor):
            raise NotImplementedError(
                f"operand of type {type(v).__name__}: sparse and compressed "
                f"formats wait for the sparse slice (ROADMAP.md queue A "
                f"item 8)")
    if kernels != "never":
        if cplan.extra:
            return multiagg.multiagg(cplan, env)
        if cplan.ttype in (TType.CELL, TType.MAGG):
            return cellwise.cell(cplan, env)
        if cplan.ttype == TType.ROW:
            return rowwise.row(cplan, env)
        # Outer over a dense main: the torch oracle, as the reference
        # falls through to XLA
    return ref.execute_dense(cplan, env)
