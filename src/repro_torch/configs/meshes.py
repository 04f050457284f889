"""Named production mesh shapes (axis name → size, ordered).

Pure data — no devices, no process group — so the layout planner and the
sharding rules agree with the reference on what "pod16x16" means without a
real :class:`~repro_torch.dist.Mesh` (the rules only ever read
``.shape``/``.axis_names``).  These are planning shapes (TPU pods), kept
under the reference's names.
"""

from __future__ import annotations

#: production mesh shapes: one v5e pod (16×16 = 256 chips) and the
#: two-pod DCN-linked variant used by the multipod dry-run cells.
MESH_SHAPES: dict[str, dict[str, int]] = {
    "pod16x16": {"data": 16, "model": 16},
    "multipod2x16x16": {"pod": 2, "data": 16, "model": 16},
}


def mesh_devices(name: str) -> int:
    out = 1
    for v in MESH_SHAPES[name].values():
        out *= v
    return out
