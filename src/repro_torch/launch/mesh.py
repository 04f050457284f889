"""Meshes for the launch stack (the reference's ``repro.launch.mesh``).

:func:`make_host_mesh` is the :class:`~repro_torch.dist.Mesh` over an
initialised process group (training and serving over ranks);
:func:`make_production_mesh` is a :class:`~repro_torch.dist.RecordingMesh`
of a production shape (the dry-run: no processes, no devices).  Functions,
not module-level constants: importing this module touches no process
group.
"""

from __future__ import annotations

from repro_torch.configs.meshes import MESH_SHAPES
from repro_torch.dist import sharding


def make_production_mesh(*, multi_pod: bool = False, kind: str = "h100",
                         coords=None):
    """The production mesh as a :class:`~repro_torch.dist.RecordingMesh`
    (rank 0's coordinates by default): ``kind="h100"`` the H100 shapes
    (``h100x256``: 32 nodes of 8, tensor parallelism inside a node's
    NVLink domain; ``h100x2x256``: two of them), ``"tpu"`` the reference's
    pod shapes (``pod16x16`` / ``multipod2x16x16``)."""
    from repro_torch.dist import RecordingMesh
    name = production_mesh_name(multi_pod=multi_pod, kind=kind)
    return RecordingMesh(MESH_SHAPES[name], coords)


def production_mesh_name(*, multi_pod: bool = False,
                         kind: str = "h100") -> str:
    names = {("h100", False): "h100x256", ("h100", True): "h100x2x256",
             ("tpu", False): "pod16x16", ("tpu", True): "multipod2x16x16"}
    if (kind, multi_pod) not in names:
        raise ValueError(f"no {kind!r} production mesh: 'h100' or 'tpu'")
    return names[(kind, multi_pod)]


def make_host_mesh(model: int = 1, device=None):
    """The mesh over the initialised process group: ``{"data": world //
    model, "model": model}`` on ``device`` (default: the current CUDA
    device)."""
    import torch.distributed as dist
    from repro_torch.dist import Mesh
    world = dist.get_world_size()
    if world % model:
        raise ValueError(f"a model axis of {model} does not divide "
                         f"{world} ranks")
    return Mesh({"data": world // model, "model": model}, device=device)


def fsdp_axes(mesh) -> tuple[str, ...]:
    """Axes used for fully-sharded parameter storage (everything except
    the tensor-parallel axis)."""
    return sharding.fsdp_axes(mesh)


def dp_size(mesh) -> int:
    out = 1
    for a in fsdp_axes(mesh):
        out *= mesh.shape[a]
    return out
