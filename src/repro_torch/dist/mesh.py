"""Meshes for hybrid local/distributed fused-operator plans and the
sharded LM.

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
sharded LM (``serve.Engine(mesh=...)``, ``launch.train.make_train_step(
mesh=...)``) also reduces and gathers over the model group, the ranks that
share every coordinate but ``model``, and gathers a leaf over any subset
of the row axes its spec names.

:class:`RecordingMesh` has the same interface and no process group: each
collective returns a tensor of the right shape and dtype (on ``meta``,
where the dry-run runs a rank's program) and is only recorded.  Both
meshes keep a :class:`CollectiveLog` of what they ran — kind, group, group
size and the bytes a device moves under the ring formulas of
:mod:`repro_torch.hw` — so that a recorded program can be held to the
live one collective for collective.

The ``*_fn`` functions at the end are the collectives the sharded LM's
layers call, each a ``torch.autograd.Function`` whose forward is the
plain collective (so serving under ``torch.no_grad`` has the same bits)
and whose backward is its adjoint.
"""

from __future__ import annotations

import itertools
import threading
import time
from typing import Optional, Union

import torch

from repro_torch import hw
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

#: the collective kinds, in the reference's record order
#: (``repro/launch/dryrun_lib.collective_bytes``)
KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
         "collective-permute")

#: a group: ``"row"``, ``"model"``, ``"all"``, or a tuple of row axes
Over = Union[str, tuple]


class CollectiveLog:
    """What a mesh's collectives moved: per kind the bytes a device sends
    (ring formulas, :mod:`repro_torch.hw`) and the count, and the count per
    group (``"model/8"``, ``"row/32"``, ``"row:data/32"``, ``"all/256"``).
    :meth:`record` gives the reference's ``collective_bytes`` schema (each
    kind's bytes, ``total``, ``counts``) plus ``groups`` and
    ``group_bytes``."""

    def __init__(self):
        self.reset()

    def reset(self) -> None:
        self.bytes = {k: 0.0 for k in KINDS}
        self.counts = {k: 0 for k in KINDS}
        self.groups: dict[str, int] = {}
        self.group_bytes: dict[str, float] = {}

    def add(self, kind: str, group: str, n: int, nbytes: float) -> None:
        self.bytes[kind] += nbytes
        self.counts[kind] += 1
        g = f"{group}/{n}"
        self.groups[g] = self.groups.get(g, 0) + 1
        self.group_bytes[g] = self.group_bytes.get(g, 0.0) + nbytes

    def record(self) -> dict:
        out = dict(self.bytes)
        out["total"] = sum(self.bytes.values())
        out["counts"] = dict(self.counts)
        out["groups"] = dict(sorted(self.groups.items()))
        out["group_bytes"] = dict(sorted(self.group_bytes.items()))
        return out


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class _Axes:
    """The coordinates of one rank on a named grid of ranks (row-major,
    the last axis fastest), and the collectives' shape logic shared by
    :class:`Mesh` and :class:`RecordingMesh`."""

    def _init_axes(self, shape: dict, rank: int) -> None:
        self.shape = {a: int(n) for a, n in shape.items()}
        self.axis_names = tuple(self.shape)
        self.rank = rank
        self.row_axes = fsdp_axes(self)
        self.n = axis_size(self, self.row_axes)
        self.coords = mesh_coords(self, rank)
        self.part = self._part_of(rank)
        self.tp = self.shape.get(TP_AXIS, 1)
        self.world = axis_size(self, self.axis_names)
        self.log = CollectiveLog()
        self.collectives = 0
        self.collective_s = 0.0
        self._lock = threading.Lock()

    def _part_of(self, rank: int) -> int:
        c, part = mesh_coords(self, rank), 0
        for a in self.row_axes:
            part = part * self.shape[a] + c[a]
        return part

    def group_axes(self, over: Over) -> tuple:
        """The axes (mesh order) of group ``over``: ``"row"`` the row
        axes, ``"model"`` the tensor-parallel one, ``"all"`` every axis, a
        tuple those row axes."""
        if over == "row":
            return self.row_axes
        if over == "model":
            return (TP_AXIS,) if TP_AXIS in self.shape else ()
        if over == "all":
            return self.axis_names
        if isinstance(over, tuple):
            bad = [a for a in over if a not in self.row_axes]
            if bad:
                raise ValueError(f"{bad} are not row axes of {self.shape}")
            return tuple(a for a in self.axis_names if a in over)
        raise ValueError(f"no {over!r} group: 'row', 'model', 'all' or a "
                         f"tuple of row axes")

    def group_size(self, over: Over) -> int:
        return axis_size(self, self.group_axes(over))

    @staticmethod
    def _label(over: Over) -> str:
        return over if isinstance(over, str) else "row:" + ",".join(over)

    def _note(self, kind: str, over: Over, n: int, nbytes: float,
              t0: float) -> None:
        with self._lock:
            self.log.add(kind, self._label(over), n, nbytes)
            self.collectives += 1
            self.collective_s += time.perf_counter() - t0

    def panel(self, t: torch.Tensor) -> torch.Tensor:
        """This rank's row panel of a whole (m, c) tensor: a view of rows
        ``part·m/n : (part+1)·m/n`` (no copy)."""
        m = t.shape[0]
        if m % self.n:
            raise ValueError(f"{m} rows do not split into {self.n} panels")
        k = m // self.n
        return t[self.part * k:(self.part + 1) * k]

    # -- the collectives (shapes, counts, bytes; _run_* do the work) -------
    def all_reduce(self, t: torch.Tensor, epilogue: str = "psum",
                   over: Over = "row") -> torch.Tensor:
        """``epilogue`` (``"psum"`` / ``"pmin"`` / ``"pmax"``) of ``t``
        over the group ``over`` (:meth:`group_axes`): the all-reduce SUM /
        MIN / MAX, into a new tensor on ``t``'s device (``t`` itself over
        a group of one rank)."""
        n = self.group_size(over)
        if n == 1:
            return t
        t0 = time.perf_counter()
        out = self._run_all_reduce(t, epilogue, over)
        self._note("all-reduce", over, n, hw.all_reduce_bytes(_nbytes(t), n),
                   t0)
        return out

    def all_gather(self, t: torch.Tensor, dim: int = 0,
                   over: Over = "row") -> torch.Tensor:
        """Every rank's ``t`` of the group ``over`` joined along ``dim``
        in group order (ascending rank: row-major over the group's axes in
        mesh order), on ``t``'s device (``t`` itself over a group of one
        rank): over the row group along dim 0, the whole (n·k, c) tensor
        from every rank's (k, c) row panel."""
        n = self.group_size(over)
        if n == 1:
            return t
        t0 = time.perf_counter()
        out = self._run_all_gather(t, dim % t.dim(), over, n)
        self._note("all-gather", over, n, hw.all_gather_bytes(_nbytes(out),
                                                              n), t0)
        return out

    def reduce_scatter(self, t: torch.Tensor, dim: int = 0,
                       over: Over = "row") -> torch.Tensor:
        """The sum of every group rank's ``t``, cut along ``dim`` into
        ``n`` equal blocks, of which this rank keeps its own (its index in
        the group): the adjoint of :meth:`all_gather`."""
        n = self.group_size(over)
        if n == 1:
            return t
        dim = dim % t.dim()
        if t.shape[dim] % n:
            raise ValueError(f"dim {dim} of {tuple(t.shape)} does not split "
                             f"into {n} blocks")
        t0 = time.perf_counter()
        out = self._run_reduce_scatter(t, dim, over, n)
        self._note("reduce-scatter", over, n,
                   hw.reduce_scatter_bytes(_nbytes(t), n), t0)
        return out

    def all_to_all(self, t: torch.Tensor, split_dim: int, concat_dim: int,
                   over: Over = "model") -> torch.Tensor:
        """``t`` cut along ``split_dim`` into ``n`` equal chunks, chunk
        ``j`` sent to the group's rank ``j``; the chunks received joined
        along ``concat_dim`` in group order (``jax.lax.all_to_all`` with
        ``tiled=True``)."""
        n = self.group_size(over)
        if n == 1:
            return t
        split_dim, concat_dim = split_dim % t.dim(), concat_dim % t.dim()
        if t.shape[split_dim] % n:
            raise ValueError(f"dim {split_dim} of {tuple(t.shape)} does not "
                             f"split into {n} chunks")
        t0 = time.perf_counter()
        out = self._run_all_to_all(t, split_dim, concat_dim, over, n)
        self._note("all-to-all", over, n, hw.all_to_all_bytes(_nbytes(t), n),
                   t0)
        return out

    def index_in(self, over: Over) -> int:
        """This rank's index in group ``over`` (row-major over its axes)."""
        i = 0
        for a in self.group_axes(over):
            i = i * self.shape[a] + self.coords[a]
        return i


class Mesh(_Axes):
    """A mesh of ``torch.distributed`` ranks.

    ``shape`` maps axis names to sizes whose product is the world size;
    ranks are laid out row-major over the axes (the last axis fastest);
    :attr:`coords` are this rank's coordinates.  The row group — the
    ranks that differ only in the row (non-``model``) axes — is the group
    a distributed segment's collectives run over; :attr:`part` is this
    rank's index in it, the row panel it computes.  The model group — the
    ranks that differ only in ``model`` — is the one a tensor-parallel
    layer reduces and gathers over; :attr:`tp` is its size.  With more
    than one row axis, every subset of them has its group too (a leaf
    whose spec keeps only some of the row axes gathers over those).
    ``device`` is where this rank's operands and kernels live (default:
    the current CUDA device).

    ``torch.distributed.init_process_group`` must have been called: the
    mesh spans its default group, and every rank must build its meshes in
    the same order (``new_group`` is collective: every rank creates every
    group, in the same order).  Under gloo a CUDA
    tensor goes through host memory: the mesh copies it there and back
    itself, as gloo's own CUDA path does (a gathered tensor is joined on
    the device), so every collective of every
    backend takes device tensors.  :attr:`collectives` and
    :attr:`collective_s` count the collectives and their host-clock
    seconds (a device-to-host copy ends in a synchronise, so under gloo
    the reading includes the wait for the panel's kernels); :attr:`log`
    has them by kind and group."""

    def __init__(self, shape: dict[str, int], device=None):
        import torch.distributed as dist
        if not dist.is_available() or not dist.is_initialized():
            raise RuntimeError(
                "repro_torch.dist.Mesh needs an initialised process group: "
                "call torch.distributed.init_process_group(backend, "
                "init_method=..., world_size=..., rank=...) first")
        shape = {a: int(n) for a, n in shape.items()}
        world = dist.get_world_size()
        if axis_size(LogicalMesh(shape), tuple(shape)) != world:
            raise ValueError(f"mesh {shape} has "
                             f"{axis_size(LogicalMesh(shape), tuple(shape))} "
                             f"ranks, the process group {world}")
        self._init_axes(shape, dist.get_rank())
        self.device = torch.device(device if device is not None else
                                   f"cuda:{torch.cuda.current_device()}")
        self.backend = dist.get_backend()
        self._groups: dict[tuple, object] = {}
        for axes in self._group_order():
            rest = [a for a in self.axis_names if a not in axes]
            classes: dict[tuple, list] = {}
            for q in range(world):
                c = mesh_coords(self, q)
                classes.setdefault(tuple(c[a] for a in rest), []).append(q)
            mine = tuple(self.coords[a] for a in rest)
            for key in sorted(classes):
                g = dist.new_group(classes[key])
                if key == mine:
                    self._groups[axes] = g
        # the old names, for callers that reach the groups themselves
        self.group = self._groups.get(self.row_axes)
        self.model_group = self._groups.get((TP_AXIS,))

    def _group_order(self) -> list:
        """The groups a rank builds, in the order every rank builds them:
        the whole row group (with a model axis), the model group (with row
        axes), then each proper subset of two or more row axes' values
        (with more than one row axis; a subset of one axis of size one is
        no group)."""
        out = []
        if self.tp > 1:
            out.append(self.row_axes)
        if self.tp > 1 and self.n > 1:
            out.append((TP_AXIS,))
        rows = self.row_axes
        for k in range(1, len(rows)):
            for sub in itertools.combinations(rows, k):
                if axis_size(self, sub) > 1:
                    out.append(sub)
        return out

    def _pg(self, over: Over):
        """The process group of ``over`` (None: the default group)."""
        axes = self.group_axes(over)
        if self.group_size(over) == self.world:
            return None
        if axes not in self._groups:
            raise ValueError(f"no process group for {axes} on {self.shape}")
        return self._groups[axes]

    def __repr__(self) -> str:
        return (f"Mesh({self.shape}, rank {self.rank}, part {self.part}/"
                f"{self.n}, {self.device}, {self.backend})")

    def _staged(self, t: torch.Tensor) -> bool:
        return self.backend == "gloo" and t.device.type != "cpu"

    def _src(self, t: torch.Tensor) -> torch.Tensor:
        src = t.detach().contiguous()
        return src.cpu() if self._staged(src) else src

    def _run_all_reduce(self, t, epilogue, over):
        import torch.distributed as dist
        op = getattr(dist.ReduceOp, _REDUCE_OPS[epilogue])
        buf = t.detach().to("cpu", copy=True) if self._staged(t) \
            else t.detach().clone()
        dist.all_reduce(buf, op=op, group=self._pg(over))
        return buf.to(t.device)

    def _run_all_gather(self, t, dim, over, n):
        import torch.distributed as dist
        gather = getattr(dist, "all_gather_single", None) \
            or dist.all_gather_into_tensor      # torch before 2.13
        src = self._src(t)
        buf = torch.empty((n * src.shape[0],) + tuple(src.shape[1:]),
                          dtype=src.dtype, device=src.device)
        gather(buf, src, group=self._pg(over))
        buf = buf.to(t.device)          # joined on the device
        if dim != 0:
            buf = torch.cat(buf.view((n,) + tuple(src.shape)).unbind(0),
                            dim=dim)
        return buf

    def _run_reduce_scatter(self, t, dim, over, n):
        import torch.distributed as dist
        src = self._src(t.movedim(dim, 0))
        out = torch.empty((src.shape[0] // n,) + tuple(src.shape[1:]),
                          dtype=src.dtype, device=src.device)
        scatter = getattr(dist, "reduce_scatter_single", None) \
            or dist.reduce_scatter_tensor       # torch before 2.13
        scatter(out, src, group=self._pg(over))
        return out.to(t.device).movedim(0, dim)

    def _run_all_to_all(self, t, split_dim, concat_dim, over, n):
        import torch.distributed as dist
        src = self._src(torch.stack(t.chunk(n, split_dim)))
        out = torch.empty_like(src)
        dist.all_to_all_single(out, src, group=self._pg(over))
        return torch.cat(out.to(t.device).unbind(0), dim=concat_dim)


class RecordingMesh(_Axes):
    """:class:`Mesh`'s interface for one rank, ``coords`` (default: rank
    0's), without a process group: every collective returns a new tensor
    of the right shape and dtype on its input's device (``meta`` in the
    dry-run) and is recorded in :attr:`log` as :class:`Mesh` records it.
    A rank's program run under it issues the collectives the live mesh
    would, in the same order."""

    def __init__(self, shape: dict[str, int],
                 coords: Optional[dict] = None, device="meta"):
        shape = {a: int(n) for a, n in shape.items()}
        rank = 0
        if coords is not None:
            for a, n in shape.items():
                rank = rank * n + int(coords.get(a, 0))
        self._init_axes(shape, rank)
        self.device = torch.device(device)
        self.backend = "recording"

    def __repr__(self) -> str:
        return f"RecordingMesh({self.shape}, coords {self.coords})"

    @staticmethod
    def _new(t: torch.Tensor, shape) -> torch.Tensor:
        return torch.empty(tuple(shape), dtype=t.dtype, device=t.device)

    def _run_all_reduce(self, t, epilogue, over):
        return self._new(t, t.shape)

    def _run_all_gather(self, t, dim, over, n):
        shape = list(t.shape)
        shape[dim] *= n
        return self._new(t, shape)

    def _run_reduce_scatter(self, t, dim, over, n):
        shape = list(t.shape)
        shape[dim] //= n
        return self._new(t, shape)

    def _run_all_to_all(self, t, split_dim, concat_dim, over, n):
        shape = list(t.shape)
        shape[split_dim] //= n
        shape[concat_dim] *= n
        return self._new(t, shape)


# ---------------------------------------------------------------------------
# the collectives under autograd
# ---------------------------------------------------------------------------

class _Gather(torch.autograd.Function):
    """FSDP: a leaf's blocks all-gathered over row axes; the gradient of
    the whole leaf, one per data block, reduce-scattered back."""

    @staticmethod
    def forward(ctx, t, mesh, dim, over):
        ctx.mesh, ctx.dim, ctx.over = mesh, dim, over
        return mesh.all_gather(t, dim=dim, over=over)

    @staticmethod
    def backward(ctx, g):
        return (ctx.mesh.reduce_scatter(g.contiguous(), ctx.dim, ctx.over),
                None, None, None)


class _Reduce(torch.autograd.Function):
    """The model group's partial sums all-reduced; the sum is replicated
    over the group, so its gradient passes through as it is."""

    @staticmethod
    def forward(ctx, t, mesh):
        return mesh.all_reduce(t, "psum", over="model")

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Enter(torch.autograd.Function):
    """A replicated tensor entering rank-specific work (a column-parallel
    product, a rank's heads or channels): the identity, whose gradient —
    one partial sum a rank — is all-reduced over the model group
    (Megatron's *f*)."""

    @staticmethod
    def forward(ctx, t, mesh):
        ctx.mesh = mesh
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.all_reduce(g.contiguous(), "psum", over="model"), \
            None


class _GatherBlocks(torch.autograd.Function):
    """Column blocks gathered over the model group; the whole tensor is
    replicated, so a rank's gradient is its block of the gradient."""

    @staticmethod
    def forward(ctx, t, mesh, dim):
        ctx.mesh, ctx.dim, ctx.k = mesh, dim, t.shape[dim]
        return mesh.all_gather(t, dim=dim, over="model")

    @staticmethod
    def backward(ctx, g):
        r = ctx.mesh.index_in("model")
        return g.narrow(ctx.dim, r * ctx.k, ctx.k), None, None


class _AllToAll(torch.autograd.Function):
    """An all-to-all over a group; its gradient takes the inverse one."""

    @staticmethod
    def forward(ctx, t, mesh, split_dim, concat_dim, over):
        ctx.args = (mesh, split_dim, concat_dim, over)
        return mesh.all_to_all(t, split_dim, concat_dim, over)

    @staticmethod
    def backward(ctx, g):
        mesh, split_dim, concat_dim, over = ctx.args
        return (mesh.all_to_all(g.contiguous(), concat_dim, split_dim, over),
                None, None, None, None)


class _ScatterSeq(torch.autograd.Function):
    """The model group's partial sums of a (B, S, ...) activation
    reduce-scattered along the sequence (dim 1); each rank's block of the
    sum carries its block's whole gradient, so the gradient of the
    partial sums is those blocks all-gathered."""

    @staticmethod
    def forward(ctx, t, mesh):
        ctx.mesh = mesh
        return mesh.reduce_scatter(t, 1, over="model")

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.all_gather(g.contiguous(), dim=1, over="model"), None


class _RowMean(torch.autograd.Function):
    """The mean over the row group of a per-data-block value that the
    block's loss then uses: each block's loss is its own part of the
    global one, so the gradient passes through to the block's value."""

    @staticmethod
    def forward(ctx, t, mesh):
        return mesh.all_reduce(t, "psum", over="row") / mesh.n

    @staticmethod
    def backward(ctx, g):
        return g, None


def gather_fn(mesh, t, dim: int, over: Over):
    """:meth:`Mesh.all_gather` over row axes; its gradient is
    reduce-scattered."""
    return _Gather.apply(t, mesh, dim % t.dim(), over)


def reduce_fn(mesh, t):
    """The model group's all-reduce; the gradient passes through."""
    return _Reduce.apply(t, mesh)


def enter_fn(mesh, t):
    """The identity; with more than one rank in the model group, its
    gradient is all-reduced over the group."""
    return _Enter.apply(t, mesh) if mesh.tp > 1 else t


def gather_blocks_fn(mesh, t, dim: int):
    """Column blocks gathered over the model group; a rank's gradient is
    its block."""
    return _GatherBlocks.apply(t, mesh, dim % t.dim())


def all_to_all_fn(mesh, t, split_dim: int, concat_dim: int,
                  over: Over = "model"):
    """:meth:`Mesh.all_to_all`; its gradient runs the inverse one."""
    return _AllToAll.apply(t, mesh, split_dim % t.dim(), concat_dim % t.dim(),
                           over)


def scatter_seq_fn(mesh, t):
    """The model group's partial sums reduce-scattered along dim 1 (the
    sequence-parallel residual)."""
    return _ScatterSeq.apply(t, mesh)


def row_mean_fn(mesh, t):
    """The mean of ``t`` over the row group; the gradient passes
    through."""
    return _RowMean.apply(t, mesh)
