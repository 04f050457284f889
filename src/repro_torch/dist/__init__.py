"""Meshes and layout rules for hybrid local/distributed fused-operator
plans.

:class:`LogicalMesh` (abstract, cost-only) and :class:`Mesh` (ranks of an
initialised ``torch.distributed`` process group) are the meshes
``Traced.plan(layout=...)`` accepts; :mod:`.sharding` holds the operand
layout rules, :mod:`.launch` starts and watches rank processes.
"""

from .mesh import LogicalMesh, Mesh, signature_of  # noqa: F401
