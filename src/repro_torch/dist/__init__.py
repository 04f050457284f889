"""Meshes and layout rules for hybrid local/distributed fused-operator
plans.

:class:`LogicalMesh` (abstract, cost-only) and :class:`Mesh` (ranks of an
initialised ``torch.distributed`` process group) are the meshes
``Traced.plan(layout=...)`` accepts; :class:`RecordingMesh` runs a rank's
program without processes and records its collectives (the dry-run);
:mod:`.sharding` holds the operand, LM and activation layout rules,
:mod:`.launch` starts and watches rank processes.
"""

from .mesh import (CollectiveLog, LogicalMesh, Mesh,  # noqa: F401
                   RecordingMesh, signature_of)
