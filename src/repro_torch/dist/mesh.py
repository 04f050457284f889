"""Meshes for hybrid local/distributed fused-operator plans.

:class:`LogicalMesh` is the abstract mesh (``.shape``/``.axis_names``
only): planning under it costs the local × distributed placement of every
fused operator and reports it in ``explain()``, and execution stays local
with a recorded reason — the reference's cost-only layout
(``repro/dist/planner.py``).

:class:`Mesh` is the executable one, the counterpart of
``jax.sharding.Mesh``: a grid of ``torch.distributed`` ranks, laid out
row-major over its axes.  The caller initialises the process group (its
backend, address, world size and rank), as a JAX caller builds its device
mesh; the mesh picks no backend.  Every rank holds whole operands on its
own device; a distributed segment reads the rank's row panel of each
row-sharded operand and joins the panels with the collectives below, over
the group of ranks that share every coordinate but the row axes'.  The
sharded LM (``serve.Engine(mesh=...)``) also reduces and gathers over the
model group, the ranks that share every coordinate but ``model``.
"""

from __future__ import annotations

import threading
import time
import torch

from .sharding import TP_AXIS, axis_size, fsdp_axes, mesh_coords


class LogicalMesh:
    """Abstract mesh (``.shape``/``.axis_names`` only) accepted by the
    sharding rules and by ``Traced.plan(layout=...)``: the local ×
    distributed placement is costed and reported, and execution stays
    local until the same plan is made under a :class:`Mesh`."""

    def __init__(self, shape: dict[str, int]):
        self.shape = dict(shape)
        self.axis_names = tuple(self.shape)

    def __repr__(self) -> str:
        return f"LogicalMesh({self.shape})"


def signature_of(mesh) -> tuple[tuple[str, int], ...]:
    """Hashable (axis, size) signature of any mesh-like object
    (:class:`Mesh`, :class:`LogicalMesh`, or a plain dict)."""
    if isinstance(mesh, dict):
        return tuple((a, int(n)) for a, n in mesh.items())
    return tuple((a, int(mesh.shape[a])) for a in mesh.axis_names)


_REDUCE_OPS = {"psum": "SUM", "pmin": "MIN", "pmax": "MAX"}


class Mesh:
    """A mesh of ``torch.distributed`` ranks.

    ``shape`` maps axis names to sizes whose product is the world size;
    ranks are laid out row-major over the axes (the last axis fastest);
    :attr:`coords` are this rank's coordinates.  The row group — the
    ranks that differ only in the row (non-``model``) axes — is the group
    a distributed segment's collectives run over; :attr:`part` is this
    rank's index in it, the row panel it computes.  The model group — the
    ranks that differ only in ``model`` — is the one a tensor-parallel
    layer reduces and gathers over; :attr:`tp` is its size.
    ``device`` is where this rank's operands and kernels live (default:
    the current CUDA device).

    ``torch.distributed.init_process_group`` must have been called: the
    mesh spans its default group, and every rank must build its meshes in
    the same order (a mesh with a ``model`` axis creates its row groups
    with ``new_group``; one with ``model`` and row axes also its model
    groups).  Under gloo a CUDA
    tensor goes through host memory: the mesh copies it there and back
    itself, as gloo's own CUDA path does, so every collective of every
    backend takes device tensors.  :attr:`collectives` and
    :attr:`collective_s` count the collectives and their host-clock
    seconds (a device-to-host copy ends in a synchronise, so under gloo
    the reading includes the wait for the panel's kernels)."""

    def __init__(self, shape: dict[str, int], device=None):
        import torch.distributed as dist
        if not dist.is_available() or not dist.is_initialized():
            raise RuntimeError(
                "repro_torch.dist.Mesh needs an initialised process group: "
                "call torch.distributed.init_process_group(backend, "
                "init_method=..., world_size=..., rank=...) first")
        self.shape = {a: int(n) for a, n in shape.items()}
        self.axis_names = tuple(self.shape)
        world = dist.get_world_size()
        if axis_size(self, self.axis_names) != world:
            raise ValueError(f"mesh {self.shape} has "
                             f"{axis_size(self, self.axis_names)} ranks, the "
                             f"process group {world}")
        self.rank = dist.get_rank()
        self.device = torch.device(device if device is not None else
                                   f"cuda:{torch.cuda.current_device()}")
        self.backend = dist.get_backend()
        self.row_axes = fsdp_axes(self)
        self.n = axis_size(self, self.row_axes)
        coords = mesh_coords(self, self.rank)
        self.coords = coords
        self.part = 0
        for a in self.row_axes:
            self.part = self.part * self.shape[a] + coords[a]
        tp = self.shape.get(TP_AXIS, 1)
        self.tp = tp
        # every rank creates every group in the same order (new_group is
        # collective); a group of the whole world is the default group
        self.group = self.model_group = None
        if tp > 1:
            for t in range(tp):         # row groups: one per model coord
                g = dist.new_group([q for q in range(world)
                                    if mesh_coords(self, q)[TP_AXIS] == t])
                if t == coords[TP_AXIS]:
                    self.group = g
        if tp > 1 and self.n > 1:
            for part in range(self.n):  # model groups: one per row part
                ranks = [q for q in range(world)
                         if self._part_of(q) == part]
                g = dist.new_group(ranks)
                if part == self.part:
                    self.model_group = g
        self.collectives = 0
        self.collective_s = 0.0
        self._lock = threading.Lock()

    def _part_of(self, rank: int) -> int:
        c, part = mesh_coords(self, rank), 0
        for a in self.row_axes:
            part = part * self.shape[a] + c[a]
        return part

    def _group(self, over: str):
        """(process group, size) of the row (``"row"``) or model
        (``"model"``) group, or of every rank (``"all"``)."""
        if over == "row":
            return self.group, self.n
        if over == "model":
            return self.model_group, self.tp
        if over == "all":
            return None, self.n * self.tp
        raise ValueError(f"no {over!r} group: 'row', 'model' or 'all'")

    def __repr__(self) -> str:
        return (f"Mesh({self.shape}, rank {self.rank}, part {self.part}/"
                f"{self.n}, {self.device}, {self.backend})")

    # -- panels -------------------------------------------------------------
    def panel(self, t: torch.Tensor) -> torch.Tensor:
        """This rank's row panel of a whole (m, c) tensor: a view of rows
        ``part·m/n : (part+1)·m/n`` (no copy)."""
        m = t.shape[0]
        if m % self.n:
            raise ValueError(f"{m} rows do not split into {self.n} panels")
        k = m // self.n
        return t[self.part * k:(self.part + 1) * k]

    # -- collectives --------------------------------------------------------
    def _staged(self, t: torch.Tensor) -> bool:
        return self.backend == "gloo" and t.device.type != "cpu"

    def _count(self, t0: float) -> None:
        with self._lock:
            self.collectives += 1
            self.collective_s += time.perf_counter() - t0

    def all_reduce(self, t: torch.Tensor, epilogue: str = "psum",
                   over: str = "row") -> torch.Tensor:
        """``epilogue`` (``"psum"`` / ``"pmin"`` / ``"pmax"``) of ``t``
        over the row group (``over="row"``), the model group
        (``"model"``) or every rank (``"all"``): the all-reduce SUM / MIN
        / MAX, into a new tensor on ``t``'s device (``t`` itself over a
        group of one rank)."""
        import torch.distributed as dist
        group, n = self._group(over)
        if n == 1:
            return t
        op = getattr(dist.ReduceOp, _REDUCE_OPS[epilogue])
        t0 = time.perf_counter()
        buf = t.detach().to("cpu", copy=True) if self._staged(t) \
            else t.detach().clone()
        dist.all_reduce(buf, op=op, group=group)
        out = buf.to(t.device)
        self._count(t0)
        return out

    def all_gather(self, t: torch.Tensor, dim: int = 0,
                   over: str = "row") -> torch.Tensor:
        """Every rank's ``t`` of the row or model group joined along
        ``dim`` in group order (ascending rank), on ``t``'s device
        (``t`` itself over a group of one rank): over the row group along
        dim 0, the whole (n·k, c) tensor from every rank's (k, c) row
        panel."""
        import torch.distributed as dist
        group, n = self._group(over)
        if n == 1:
            return t
        gather = getattr(dist, "all_gather_single", None) \
            or dist.all_gather_into_tensor      # torch before 2.13
        t0 = time.perf_counter()
        src = t.detach().contiguous()
        if self._staged(src):
            src = src.cpu()
        buf = torch.empty((n * src.shape[0],) + tuple(src.shape[1:]),
                          dtype=src.dtype, device=src.device)
        gather(buf, src, group=group)
        if dim != 0:
            buf = torch.cat(buf.view((n,) + tuple(src.shape)).unbind(0),
                            dim=dim)
        out = buf.to(t.device)
        self._count(t0)
        return out
