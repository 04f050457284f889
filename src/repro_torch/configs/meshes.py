"""Named production mesh shapes (axis name → size, ordered).

Pure data — no devices, no process group — so the layout planner and the
sharding rules agree with the reference on what "pod16x16" means without a
real :class:`~repro_torch.dist.Mesh` (the rules only ever read
``.shape``/``.axis_names``).  ``pod16x16`` / ``multipod2x16x16`` are the
reference's planning shapes (TPU pods), kept under its names for the
parity tests; ``h100x256`` / ``h100x2x256`` are their H100 counterparts
for the dry-run: 32 nodes of 8 cards, tensor parallelism inside a node's
NVLink domain of 8, and two such clusters (two row axes).
"""

from __future__ import annotations

#: production mesh shapes: one v5e pod (16×16 = 256 chips) and the
#: two-pod DCN-linked variant used by the multipod dry-run cells.
MESH_SHAPES: dict[str, dict[str, int]] = {
    "pod16x16": {"data": 16, "model": 16},
    "multipod2x16x16": {"pod": 2, "data": 16, "model": 16},
    "h100x256": {"data": 32, "model": 8},
    "h100x2x256": {"pod": 2, "data": 32, "model": 8},
}


def mesh_devices(name: str) -> int:
    out = 1
    for v in MESH_SHAPES[name].values():
        out *= v
    return out
