"""The LM on local shards: what each layer runs when its parameters are the
rank's blocks of a layout (:func:`repro_torch.dist.sharding.param_specs`).

The reference places whole arrays with ``NamedSharding`` and lets the
compiler insert the collectives; here every rank holds only its blocks
(:func:`repro_torch.dist.sharding.local_shard`) and each leaf's actual
spec, after ``_fit``'s degradation, decides what runs:

* a product whose weight is column-sharded over ``model`` computes the
  rank's block of output columns; where the next step cannot take a
  block (heads the block does not align with, Mamba's and mLSTM's
  ``[u | z]`` split), the blocks are all-gathered over the model group;
* a product whose weight is row-sharded over ``model`` takes the rank's
  block of its input and all-reduces the partial sums over the model
  group;
* a leaf sharded over the data (FSDP) axes is all-gathered over the row
  axes its spec names (the whole row group, or some of its axes) before
  use, a layer's leaves at once, in key order;
* a leaf that ``_fit`` left replicated runs whole.

:func:`place` puts a rank's blocks on its device
(:func:`repro_torch.dist.sharding.block_slices`).

Where autograd records, each of these collectives is its differentiable
form, and a replicated activation entering a rank's own work (a
column-parallel product, its heads or channels) passes :meth:`Scope.enter`,
whose gradient is all-reduced over the model group: so the sharded train
step's gradients are the unsharded model's (:mod:`repro_torch.launch.
train`).  Under ``activation_rules(mesh, "sp")`` the residual stream holds
the rank's sequence block over ``model``: each layer all-gathers its input
along the sequence and reduce-scatters its output (:attr:`Scope.sp`), or
``dist.sharding.constrain`` cuts a whole output to the block.

Without a mesh none of this runs: the layers take ``sh=None`` and their
code path and bits are those of the unsharded model.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from repro_torch.dist.mesh import (enter_fn, gather_blocks_fn, gather_fn,
                                   reduce_fn, scatter_seq_fn)
from repro_torch.dist.sharding import (TP_AXIS, block_slices, entry_axes,
                                       seq_parallel)


class Sharded:
    """An LM's layout on a mesh: ``specs`` maps every state-dict key to
    its spec (one entry per dim, padded with ``None``)."""

    def __init__(self, mesh, specs: dict):
        self.mesh = mesh
        self.specs = {k: tuple(s) for k, s in specs.items()}
        self.tp = mesh.tp
        self.r = mesh.coords.get(TP_AXIS, 0)
        #: whether any leaf is sharded over the data (FSDP) axes
        self.fsdp = any(a != TP_AXIS for s in self.specs.values()
                        for e in s for a in entry_axes(e))
        #: whether the rank's batch is its block over the row axes (the
        #: batch's spec splits it; ``moe_a2a`` dispatches only then)
        self.batch_split = True

    def scope(self, prefix: str) -> "Scope":
        return Scope(self, prefix)


class Scope:
    """The layout of one parameter group (keys under ``prefix``), and the
    collectives its layer runs.

    Each collective is differentiable (:mod:`repro_torch.dist.mesh`): an
    FSDP gather's gradient is reduce-scattered, a model-group sum's passes
    through, a gathered block's gradient is the rank's block, and a
    replicated tensor entering rank-specific work (:meth:`enter`) has its
    gradient's partial sums all-reduced over the model group.  Its forward
    is the plain collective, so serving under ``torch.no_grad`` has the
    same bits."""

    def __init__(self, sh: Sharded, prefix: str):
        self.sh, self.prefix = sh, prefix
        self.mesh, self.tp, self.r = sh.mesh, sh.tp, sh.r

    def sub(self, name: str) -> "Scope":
        return Scope(self.sh, f"{self.prefix}{name}.")

    def spec(self, name: str) -> tuple:
        return self.sh.specs[self.prefix + name]

    def tp_dim(self, name: str) -> Optional[int]:
        """The dim of leaf ``name`` sharded over ``model``, or None."""
        for d, e in enumerate(self.spec(name)):
            if TP_AXIS in entry_axes(e):
                return d
        return None

    # -- parameters ---------------------------------------------------------
    def weights(self, p) -> dict:
        """The group's leaves with every FSDP-sharded dim all-gathered over
        exactly the row axes its spec entry names (``_fit`` names them in
        mesh order, whose row-major order the group's ranks follow; the
        ``model`` blocks stay local), in key order, so that
        every rank of a row group gathers the same leaves in the same
        order whichever path (prefill or decode) it runs."""
        out = {}
        for k in sorted(p.keys()):
            t = p[k]
            for d, e in enumerate(self.spec(k)):
                axes = entry_axes(e)
                if not axes or axes == (TP_AXIS,):
                    continue
                if TP_AXIS in axes or axes != tuple(
                        a for a in self.mesh.axis_names if a in axes):
                    raise ValueError(f"{self.prefix}{k}: spec entry {e!r} "
                                     f"is not row axes in mesh order")
                # the group's ranks in order: row-major over ``axes``
                t = gather_fn(self.mesh, t, d, axes)
            out[k] = t
        return out

    # -- activations --------------------------------------------------------
    @property
    def sp(self) -> bool:
        """Whether the residual stream holds the rank's sequence block over
        ``model`` (:func:`repro_torch.dist.sharding.seq_parallel`)."""
        return seq_parallel(self.mesh)

    def reduce(self, y: torch.Tensor) -> torch.Tensor:
        """The sum of every model-group rank's partial ``y``."""
        return reduce_fn(self.mesh, y)

    def reduce_seq(self, y: torch.Tensor) -> torch.Tensor:
        """:meth:`reduce` of a (B, S, ...) output onto the residual
        stream; under ``"sp"`` (:attr:`sp`) the rank's block of the sum
        along the sequence, a reduce-scatter."""
        if self.sp and y.shape[1] % self.tp == 0:
            return scatter_seq_fn(self.mesh, y)
        return self.reduce(y)

    def gather(self, y: torch.Tensor, dim: int = -1) -> torch.Tensor:
        """Every model-group rank's block of ``y`` joined along ``dim``."""
        return gather_blocks_fn(self.mesh, y, dim % y.dim())

    def enter(self, x: torch.Tensor) -> torch.Tensor:
        """``x``, replicated over the model group, entering rank-specific
        work: the identity, whose gradient is all-reduced over the model
        group."""
        return enter_fn(self.mesh, x)

    def seq_params(self, p) -> dict:
        """Replicated parameters applied to the residual's sequence block
        (the norms) under ``"sp"``: each rank's gradient covers its block
        of positions, so they enter (:meth:`enter`); else ``p``."""
        if not self.sp:
            return p
        return {k: self.enter(v) for k, v in p.items()}

    def seq_gather(self, h: torch.Tensor, S: int) -> torch.Tensor:
        """A layer's input: under ``"sp"`` the rank's sequence block of a
        (B, S, d) activation, all-gathered along the sequence; else ``h``
        itself."""
        if h.shape[1] != S:
            return self.gather(h, 1)
        return h

    def full(self, y: torch.Tensor, w: str) -> torch.Tensor:
        """``y = x @ p[w]`` with every output column: its blocks gathered
        where ``w`` is column-sharded."""
        return self.gather(y) if self.tp_dim(w) == 1 else y

    def heads(self, y: torch.Tensor, w: str, n: int) -> tuple:
        """(``y``, first head): the heads of ``y = x @ p[w]`` (columns
        n·hd) this rank computes on — its block where ``w`` is
        column-sharded and the block holds whole heads, else all ``n``
        (gathered where ``w`` is sharded)."""
        if self.tp_dim(w) != 1:
            return y, 0
        if n % self.tp == 0:
            return y, self.r * (n // self.tp)
        return self.gather(y), 0

    def channels(self, n: int, w: str) -> tuple[int, int]:
        """(first, count) of the rank's block of ``n`` channels where
        ``w``'s leading dim is sharded over ``model``, else (0, n)."""
        if self.tp_dim(w) == 0:
            k = n // self.tp
            return self.r * k, k
        return 0, n

    def proj(self, x: torch.Tensor, xe: torch.Tensor, p, w: str):
        """``x @ p[w]``: from ``xe`` (``x`` entered, :meth:`enter`) where
        ``w`` is column-sharded, so that the rank's partial gradient of
        ``x`` is summed over the model group."""
        return (xe if self.tp_dim(w) == 1 else x) @ p[w]

    def row(self, x: torch.Tensor, w: torch.Tensor, name: str,
            seq: bool = False):
        """``x @ w`` for a weight ``name`` whose rows may be sharded: the
        rank's block of ``x``'s columns (``x`` may hold every column or
        the block already) times its rows, all-reduced; an unsharded
        weight takes every column (a block ``x`` is gathered).  ``seq``:
        the product is a layer's output onto the residual stream, under
        ``"sp"`` a sharded product's sum reduce-scattered to the rank's
        sequence block (a whole output is cut to it by ``constrain``)."""
        if self.tp_dim(name) == 0:
            k = w.shape[0]
            if x.shape[-1] != k:
                x = self.enter(x)[..., self.r * k:(self.r + 1) * k]
            return self.reduce_seq(x @ w) if seq else self.reduce(x @ w)
        if x.shape[-1] != w.shape[0]:
            x = self.gather(x)
        return x @ w


def weights(p, sh: Optional[Scope]):
    """``p`` itself without a mesh, else its FSDP leaves gathered."""
    return p if sh is None or not sh.sh.fsdp else sh.weights(p)


def row(x: torch.Tensor, p, name: str, sh: Optional[Scope],
        seq: bool = False):
    """``x @ p[name]``, row-parallel under a mesh (:meth:`Scope.row`;
    ``seq``: a layer's output onto the residual stream)."""
    return x @ p[name] if sh is None else sh.row(x, p[name], name, seq)


def enter(x: torch.Tensor, sh: Optional[Scope]) -> torch.Tensor:
    """``x`` entering a layer's rank-specific products (:meth:`Scope.
    enter`); ``x`` itself without a mesh."""
    return x if sh is None else sh.enter(x)


def proj(x: torch.Tensor, xe: torch.Tensor, p, w: str,
         sh: Optional[Scope]) -> torch.Tensor:
    """``x @ p[w]`` (:meth:`Scope.proj`)."""
    return x @ p[w] if sh is None else sh.proj(x, xe, p, w)


def local_shape(mesh, spec: tuple, shape) -> tuple:
    """The shape of a rank's block of a ``shape`` tensor under ``spec``."""
    out = list(shape)
    for d, e in enumerate(spec):
        n = 1
        for a in entry_axes(e):
            n *= mesh.shape[a]
        out[d] //= n
    return tuple(out)


def place(model: nn.Module, mesh, specs: dict, weights=None) -> None:
    """Replace every parameter of ``model`` by the rank's block of it on
    ``mesh.device``, in the model's dtype, one parameter at a time.
    ``weights(key, index)`` gives the block of parameter ``key`` at
    ``index`` (a slice a dim into the whole tensor): a loader or a seeded
    draw that produces only the block, so that no process holds a whole
    model; the default cuts the model's own parameters (on any
    device)."""
    for key, spec in specs.items():
        owner, name = _owner(model, key)
        cur = owner[name] if isinstance(owner, nn.ParameterDict) \
            else getattr(owner, name)
        index = block_slices(mesh, spec, cur.shape)
        block = cur.detach()[index] if weights is None \
            else weights(key, index)
        want = local_shape(mesh, spec, cur.shape)
        if tuple(block.shape) != want:
            raise ValueError(f"{key}: block {tuple(block.shape)}, the "
                             f"layout's {want}")
        # a copy, never a view that would keep the whole leaf alive
        param = nn.Parameter(block.to(device=mesh.device, dtype=cur.dtype,
                                      copy=True).contiguous(),
                             requires_grad=False)
        if isinstance(owner, nn.ParameterDict):
            owner[name] = param
        else:
            setattr(owner, name, param)
        del block


def _owner(model: nn.Module, key: str):
    """(the module holding parameter ``key``, its last name)."""
    *path, name = key.split(".")
    mod = model
    for part in path:
        mod = mod[int(part)] if isinstance(mod, nn.ModuleList) else \
            (mod[part] if isinstance(mod, (nn.ModuleDict, nn.ParameterDict))
             else getattr(mod, part))
    return mod, name
