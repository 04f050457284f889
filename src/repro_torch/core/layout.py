"""Layout-aware fused execution: the distributed layout rules on
fused-operator inputs and outputs (the reference's ``core/layout.py``).

A :class:`FusionLayout` maps fused-region input/output names to
rank-matched, divisibility-checked partition specs built with the fitting
primitives of :mod:`repro_torch.dist.sharding`: matrix rows shard over the
data/FSDP axes, columns over the tensor-parallel axis, vectors and scalars
degrade to replication.

Two consumers, one entry point (the paper's hybrid local/distributed
plans):

* **planning** — :func:`layout_cost_params` turns the layout into cost
  geometry for candidate selection: reads of column-sharded side inputs
  are re-priced at the interconnect's all-gather bandwidth for the local
  arm, and a :class:`~repro_torch.core.cost.DistParams` describing the
  row-shard group enables the *distributed* cost arm, so selection
  enumerates ``local × distributed`` per fused operator.  Any mesh
  exposing ``.shape``/``.axis_names`` is accepted, the abstract
  :class:`~repro_torch.dist.LogicalMesh` included.  The interconnect is
  priced at the reference's TPU figure (``TPU_V5E.ici_bw``, 50 GB/s), so
  the port selects the reference's plans.
* **execution** — on a :class:`~repro_torch.dist.Mesh` every rank holds
  whole operands (:meth:`FusionLayout.apply` places each on the mesh's
  device, whole); operators the plan placed *distributed* run their
  generated kernels on the rank's row panels and join them with the
  template's collective (:mod:`repro_torch.kernels.distributed`).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Mapping, Optional

from repro_torch import hw as _hw
from .cost import CostParams, DistParams
from .ir import Graph


def _mesh_sig(mesh) -> tuple:
    return tuple((a, int(mesh.shape[a])) for a in mesh.axis_names)


def _mesh_token(mesh):
    """Identity of an executable mesh (None for an abstract one): plans
    cached under a :class:`LogicalMesh` must not serve a real
    :class:`~repro_torch.dist.Mesh` of the same shape, which executes
    them."""
    from repro_torch.dist import Mesh
    return id(mesh) if isinstance(mesh, Mesh) else None


def layout_signature(layout) -> Optional[tuple]:
    """Hashable identity of a layout: a :class:`FusionLayout`, a bare mesh
    (``.shape``/``.axis_names``), or None."""
    if layout is None:
        return None
    if isinstance(layout, FusionLayout):
        return layout.key() + (_mesh_token(layout.mesh),)
    if hasattr(layout, "axis_names"):
        return _mesh_sig(layout) + (_mesh_token(layout),)
    raise TypeError(f"a layout is a FusionLayout, a mesh or None, not "
                    f"{type(layout).__name__}")


@dataclass(frozen=True)
class FusionLayout:
    """Mesh + per-name partition specs for a fused region's inputs and
    outputs.

    Built either explicitly (``FusionLayout(mesh, {"X": ("data",)})``) or
    via :meth:`auto`, which fits the sharding rules to the region's
    operand shapes.  Passing a bare mesh to ``Traced.plan(layout=)`` or
    scoping one through ``FusionContext(layout=mesh)`` auto-fits it the
    same way."""

    mesh: Any
    specs: Any            # Mapping[str, tuple]

    @staticmethod
    def auto(mesh, shapes: Mapping[str, tuple[int, int]]) -> "FusionLayout":
        """Fit the sharding rules to a dict of 2-D operand shapes: rows
        over the FSDP axes, columns over the TP axis, each entry
        divisibility-checked with per-dim degradation to replication."""
        from repro_torch.dist import sharding as sh
        specs = {name: sh.operand_spec(mesh, shape)
                 for name, shape in shapes.items()}
        return FusionLayout(mesh, specs)

    def key(self) -> tuple:
        return (_mesh_sig(self.mesh),
                tuple(sorted((n, tuple(s)) for n, s in self.specs.items())))

    def spec_for(self, name: str):
        return self.specs.get(name)

    def shard_factors(self, name: str) -> tuple[int, int]:
        """(row, col) shard degrees of one named operand (1 ≡ replicated)."""
        from repro_torch.dist import sharding as sh
        spec = self.specs.get(name)
        if spec is None:
            return (1, 1)
        entries = tuple(spec)
        r = sh.axis_size(self.mesh, entries[0]) if len(entries) >= 1 else 1
        c = sh.axis_size(self.mesh, entries[1]) if len(entries) >= 2 else 1
        return (r, c)

    def row_axes(self) -> tuple[str, ...]:
        """The row-shard group: every non-tensor-parallel mesh axis."""
        from repro_torch.dist import sharding as sh
        return sh.fsdp_axes(self.mesh)

    def row_devices(self) -> int:
        """Total row-shard degree (Π row-axis sizes; 1 on a 1-D TP mesh)."""
        from repro_torch.dist import sharding as sh
        return sh.axis_size(self.mesh, self.row_axes())

    def apply(self, name: str, value):
        """Place one dense operand for execution under this layout
        (identity when the name has no spec, the value is sparse — BCSR or
        DictCompressed — or the mesh is abstract).  On a
        :class:`~repro_torch.dist.Mesh` every rank holds whole operands:
        the value stays the whole logical operand, moved to the mesh's
        device, and the compiled plan cuts each rank's row panel itself
        (``compile_plan(layout=)``)."""
        import numpy as np
        import torch
        from repro_torch.dist import Mesh
        spec = self.specs.get(name)
        if spec is None or hasattr(value, "todense") \
                or not isinstance(self.mesh, Mesh):
            return value
        if isinstance(value, torch.Tensor):
            return value.to(self.mesh.device)
        return torch.as_tensor(np.asarray(value), device=self.mesh.device)


def ensure_layout(layout, graph: Graph,
                  extra_shapes: Optional[Mapping] = None) -> FusionLayout:
    """Coerce a layout-ish object into a :class:`FusionLayout` for this
    graph: bare meshes are auto-fitted to the graph's input and output
    shapes (``extra_shapes`` may add operand-name → shape entries)."""
    if isinstance(layout, FusionLayout):
        return layout
    shapes = {n.name: n.shape for n in graph.inputs() if n.name}
    shapes.update({f"__out{i}": o.shape
                   for i, o in enumerate(graph.outputs)})
    if extra_shapes:
        shapes.update(extra_shapes)
    return FusionLayout.auto(layout, shapes)


def layout_cost_params(layout: Optional[FusionLayout], graph: Graph,
                       params: CostParams) -> CostParams:
    """Cost parameters carrying the layout's distributed geometry.

    Two effects (both no-ops without a layout):

    * inputs whose layout shards the column (contraction-side) dimension
      must be all-gathered across the model axis before a row-local fused
      operator can consume them — the local arm prices their reads at
      interconnect bandwidth instead of memory bandwidth (the paper's
      "different read bandwidths for inputs of resulting distributed
      operations");
    * a :class:`~repro_torch.core.cost.DistParams` describing the
      row-shard group and per-input shard factors enables the distributed
      cost arm, so selection can choose mesh-wide execution per fused
      operator.
    """
    if layout is None:
        return params
    if not isinstance(layout, FusionLayout):
        layout = ensure_layout(layout, graph)
    overrides = dict(params.input_read_bw)
    row_factor: dict[int, int] = {}
    col_factor: dict[int, int] = {}
    for node in graph.inputs():
        if not node.name:
            continue
        r, c = layout.shard_factors(node.name)
        if r > 1:
            row_factor[node.nid] = r
        if c > 1:
            col_factor[node.nid] = c
            overrides[node.nid] = _hw.TPU_V5E.ici_bw
    axes = layout.row_axes()
    n = layout.row_devices()
    dist = DistParams(axes=tuple(axes), n=n, ici_bw=_hw.TPU_V5E.ici_bw,
                      row_factor=row_factor, col_factor=col_factor) \
        if n > 1 else None
    if not overrides and dist is None:
        return params
    return CostParams(read_bw=params.read_bw, write_bw=params.write_bw,
                      compute_bw=params.compute_bw,
                      dtype_bytes=params.dtype_bytes,
                      sparse_idx_bytes=params.sparse_idx_bytes,
                      input_read_bw=overrides,
                      max_fused_inputs=params.max_fused_inputs,
                      dist=dist)
