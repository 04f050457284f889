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
  group before use, a layer's leaves at once, in key order;
* a leaf that ``_fit`` left replicated runs whole.

:func:`place` puts a rank's blocks on its device
(:func:`repro_torch.dist.sharding.block_slices`).

Without a mesh none of this runs: the layers take ``sh=None`` and their
code path and bits are those of the unsharded model.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from repro_torch.dist.sharding import TP_AXIS, block_slices, entry_axes


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

    def scope(self, prefix: str) -> "Scope":
        return Scope(self, prefix)


class Scope:
    """The layout of one parameter group (keys under ``prefix``), and the
    collectives its layer runs."""

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
        the row group (the ``model`` blocks stay local), in key order, so
        that every rank of a row group gathers the same leaves in the same
        order whichever path (prefill or decode) it runs."""
        out = {}
        for k in sorted(p.keys()):
            t = p[k]
            for d, e in enumerate(self.spec(k)):
                axes = entry_axes(e)
                if not axes or axes == (TP_AXIS,):
                    continue
                if TP_AXIS in axes or axes != self.mesh.row_axes:
                    raise NotImplementedError(
                        f"{self.prefix}{k}: spec entry {e!r} is not the row "
                        f"axes {self.mesh.row_axes}; only the whole row "
                        f"group gathers")
                t = self.mesh.all_gather(t, dim=d, over="row")
            out[k] = t
        return out

    # -- activations --------------------------------------------------------
    def reduce(self, y: torch.Tensor) -> torch.Tensor:
        """The sum of every model-group rank's partial ``y``."""
        return self.mesh.all_reduce(y, "psum", over="model")

    def gather(self, y: torch.Tensor, dim: int = -1) -> torch.Tensor:
        """Every model-group rank's block of ``y`` joined along ``dim``."""
        return self.mesh.all_gather(y, dim=dim % y.dim(), over="model")

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

    def row(self, x: torch.Tensor, w: torch.Tensor, name: str):
        """``x @ w`` for a weight ``name`` whose rows may be sharded: the
        rank's block of ``x``'s columns (``x`` may hold every column or
        the block already) times its rows, all-reduced; an unsharded
        weight takes every column (a block ``x`` is gathered)."""
        if self.tp_dim(name) == 0:
            k = w.shape[0]
            if x.shape[-1] != k:
                x = x[..., self.r * k:(self.r + 1) * k]
            return self.reduce(x @ w)
        if x.shape[-1] != w.shape[0]:
            x = self.gather(x)
        return x @ w


def weights(p, sh: Optional[Scope]):
    """``p`` itself without a mesh, else its FSDP leaves gathered."""
    return p if sh is None or not sh.sh.fsdp else sh.weights(p)


def row(x: torch.Tensor, p, name: str, sh: Optional[Scope]):
    """``x @ p[name]``, row-parallel under a mesh (:meth:`Scope.row`)."""
    return x @ p[name] if sh is None else sh.row(x, p[name], name)


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
