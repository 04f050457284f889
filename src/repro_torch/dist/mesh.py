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
the group of ranks that share every coordinate but the row axes'.
"""

from __future__ import annotations

import threading
import time
import torch

from .sharding import TP_AXIS, axis_size, fsdp_axes


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
    ranks are laid out row-major over the axes (the last axis fastest).
    The row group — the ranks that differ only in the row (non-``model``)
    axes — is the group a distributed segment's collectives run over;
    :attr:`part` is this rank's index in it, the row panel it computes.
    ``device`` is where this rank's operands and kernels live (default:
    the current CUDA device).

    ``torch.distributed.init_process_group`` must have been called: the
    mesh spans its default group, and every rank must build its meshes in
    the same order (a mesh with a ``model`` axis creates its row groups
    with ``new_group``).  Under gloo a CUDA
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
        coords, r = {}, self.rank
        for a in reversed(self.axis_names):
            coords[a] = r % self.shape[a]
            r //= self.shape[a]
        self.part = 0
        for a in self.row_axes:
            self.part = self.part * self.shape[a] + coords[a]
        tp = self.shape.get(TP_AXIS, 1)
        if tp == 1:
            self.group = None           # the default group: every rank
        else:
            # one row group per model coordinate, every rank creating all
            # of them in the same order (new_group is collective)
            stride = 1
            for a in reversed(self.axis_names):
                if a == TP_AXIS:
                    break
                stride *= self.shape[a]
            self.group = None
            for t in range(tp):
                ranks = [q for q in range(world)
                         if (q // stride) % tp == t]
                g = dist.new_group(ranks)
                if t == coords[TP_AXIS]:
                    self.group = g
        self.collectives = 0
        self.collective_s = 0.0
        self._lock = threading.Lock()

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

    def all_reduce(self, t: torch.Tensor, epilogue: str) -> torch.Tensor:
        """``epilogue`` (``"psum"`` / ``"pmin"`` / ``"pmax"``) of ``t``
        over the row group: the all-reduce SUM / MIN / MAX, into a new
        tensor on ``t``'s device."""
        import torch.distributed as dist
        op = getattr(dist.ReduceOp, _REDUCE_OPS[epilogue])
        t0 = time.perf_counter()
        buf = t.detach().to("cpu", copy=True) if self._staged(t) \
            else t.detach().clone()
        dist.all_reduce(buf, op=op, group=self.group)
        out = buf.to(t.device)
        self._count(t0)
        return out

    def all_gather_rows(self, panel: torch.Tensor) -> torch.Tensor:
        """The whole (n·k, c) tensor from every rank's (k, c) row panel,
        in row-group order, on ``panel``'s device."""
        import torch.distributed as dist
        gather = getattr(dist, "all_gather_single", None) \
            or dist.all_gather_into_tensor      # torch before 2.13
        t0 = time.perf_counter()
        src = panel.detach().contiguous()
        if self._staged(src):
            src = src.cpu()
        out = torch.empty((self.n * src.shape[0],) + tuple(src.shape[1:]),
                          dtype=src.dtype, device=src.device)
        gather(out, src, group=self.group)
        out = out.to(panel.device)
        self._count(t0)
        return out
