"""Layout rules (the reference's ``repro/dist/sharding.py``): the
fused-operator operands' and the LM's parameters and decode caches.

A partition spec is a tuple with one entry per dimension — ``None``
(replicated), an axis name, or a tuple of axis names — the counterpart of
``jax.sharding.PartitionSpec`` (itself a tuple); trailing ``None``
entries are dropped, as ``PartitionSpec`` drops them.  Rows shard over
the data/FSDP axes, columns over the tensor-parallel axis ``model``, and
every entry is divisibility-checked with per-dimension degradation to
replication (:func:`_fit`): a rule never fails, a dimension the axes do
not divide replicates.

The LM rules are the reference's megatron-style TP × FSDP layout:
projections into head / ff space (``wq``/``wk``/``wv``, dense ``w1``/``w3``,
``up``, ``in_proj``) shard their output dim over TP and their input dim
over FSDP, projections out of it (``wo``, dense ``w2``, ``down``,
``out_proj``) the transpose; the embedding shards the vocabulary over TP;
MoE experts shard the expert dim over TP where the expert count divides it
(expert parallelism), else each expert's ff dim (:func:`moe_expert_parallel`);
``serve=True`` drops the FSDP axes.  The port's parameter tree is the flat
state dict of :class:`~repro_torch.models.LM` (the keys
:func:`repro_torch.interop.lm_params_from_jax` produces): no leaf is
stacked, so each port spec is the reference's stacked-leaf spec without
its leading ``None``.  :func:`local_shard` cuts a rank's block of a whole
tensor by its mesh coordinates, :func:`join_shards` puts the blocks back.

:func:`activation_rules` / :func:`current_rules` / :func:`activation_spec` /
:func:`constrain` are the reference's activation-sharding rules: the
specs entry for entry, and a context that the sharded layers read.
"""

from __future__ import annotations

import threading
from contextlib import contextmanager
from typing import Optional

TP_AXIS = "model"


def P(*entries) -> tuple:
    """A partition spec: the tuple of its entries."""
    return tuple(entries)


def tp_axis(mesh) -> Optional[str]:
    """The tensor-parallel axis name, or None if the mesh has none."""
    return TP_AXIS if TP_AXIS in mesh.axis_names else None


def fsdp_axes(mesh) -> tuple[str, ...]:
    """Every mesh axis except the tensor-parallel one, mesh order."""
    return tuple(a for a in mesh.axis_names if a != TP_AXIS)


def axis_size(mesh, axes) -> int:
    """Product of mesh-axis sizes for a None/str/tuple spec entry."""
    if axes is None:
        return 1
    if isinstance(axes, str):
        axes = (axes,)
    out = 1
    for a in axes:
        out *= mesh.shape[a]
    return out


def _fit(mesh, dim: int, axes):
    """Largest suffix of ``axes`` that exists in the mesh and divides
    ``dim`` — the graceful-degradation primitive.  Returns a spec entry
    (None / str / tuple)."""
    if axes is None:
        return None
    if isinstance(axes, str):
        axes = (axes,)
    axes = tuple(a for a in axes if a in mesh.axis_names)
    while axes:
        n = axis_size(mesh, axes)
        if n > 1 and dim % n == 0:
            return axes[0] if len(axes) == 1 else axes
        axes = axes[1:]
    return None


def _spec(mesh, shape: tuple, roles: tuple) -> tuple:
    """A rank-matched partition spec from per-dim axis requests.

    ``roles`` aligns to the *trailing* dims of ``shape``; leading
    (stacked) dims replicate.  Each entry is divisibility-checked
    against its dim and degrades to None via :func:`_fit`."""
    pad = len(shape) - len(roles)
    if pad < 0:
        return P()
    entries = [None] * pad + [_fit(mesh, d, r)
                              for d, r in zip(shape[pad:], roles)]
    while entries and entries[-1] is None:
        entries.pop()
    return P(*entries)


def operand_spec(mesh, shape) -> tuple:
    """Layout rule for one fused-operator operand (``FusionLayout.auto``):
    rows over the FSDP axes, columns over the TP axis, with per-dim
    divisibility degradation — so a (1, n) row vector or a matrix whose
    rows don't divide the data axes simply replicates.  The hybrid
    local/distributed placement reads its row/column shard factors from
    these specs."""
    return _spec(mesh, tuple(shape), (fsdp_axes(mesh), tp_axis(mesh)))


# ---------------------------------------------------------------------------
# the LM: parameters, caches, batches
# ---------------------------------------------------------------------------

def moe_expert_parallel(mesh, cfg) -> bool:
    """True when expert weights shard over the TP axis (EP): the expert
    count must be a positive multiple of the axis size.  olmoe (64e) on a
    16-way axis → EP; grok (8e) → ff-TP fallback."""
    tp = tp_axis(mesh)
    return (tp is not None and cfg.n_experts > 0
            and cfg.n_experts % mesh.shape[tp] == 0)


def _param_roles(name, base_rank: int, F, tp, ep: bool):
    """Trailing-dim axis requests for one named parameter leaf.

    ``F`` is the FSDP axis group (or None for the serving layout); ``tp``
    the TP axis (or None).  Unknown leaves (norm scales, gate biases,
    SSM vectors) replicate."""
    if name == "embed":                       # (V, d) / (nc, V, d)
        return (tp, F)
    if name == "head":                        # (d, V) / (d, nc·V)
        return (F, tp)
    if name in ("wq", "wk", "wv", "up", "in_proj"):
        return (F, tp)                        # (d_in, heads/ff·…)
    if name in ("wo", "out_proj", "down"):
        return (tp, F)                        # (heads/ff·…, d_out)
    if name in ("w1", "w3"):
        if base_rank == 3:                    # MoE (e, d, f)
            return (tp, F, None) if ep else (None, F, tp)
        return (F, tp)                        # dense (d, f)
    if name == "w2":
        if base_rank == 3:                    # MoE (e, f, d)
            return (tp, None, F) if ep else (None, tp, F)
        return (tp, F)                        # dense (f, d)
    if name == "router":                      # (d, e) — e is tiny
        return (F, None)
    if name == "x_proj":                      # (di, 2N+1)
        return (tp, None)
    if name == "A_log":                       # (di, N)
        return (tp, None)
    if name == "conv_w":                      # (K, di)
        return (None, tp)
    if name == "wif":                         # (di, 2H)
        return (F, None)
    return ()


def param_specs(mesh, cfg, params, *, serve: bool = False,
                moe: Optional[str] = None) -> dict:
    """The spec of every leaf of ``params`` (a flat ``{key: tensor}`` state
    dict of the LM; meta tensors will do), under the same keys.

    Every spec is rank-matched and divisibility-checked against its leaf;
    ``serve=True`` drops the FSDP axes (TP only).  ``moe`` forces the
    expert-weight role (``"ep"`` / ``"fftp"``) instead of the
    :func:`moe_expert_parallel` predicate; ``None`` keeps the fixed
    rule."""
    F = None if serve else (fsdp_axes(mesh) or None)
    tp = tp_axis(mesh)
    ep = moe_expert_parallel(mesh, cfg) if moe is None else (moe == "ep")
    out = {}
    for key, leaf in params.items():
        shape = tuple(leaf.shape)
        name = key.rsplit(".", 1)[-1]
        out[key] = _spec(mesh, shape, _param_roles(name, len(shape), F, tp,
                                                   ep))
    return out


#: trailing-dim axis requests per cache leaf name (the leading group dim
#: of block leaves replicates).  "F"/"tp" placeholders resolved per mesh.
_CACHE_ROLES = {
    "k":    ("F", None, "tp", None),    # (B, S, KV, hd) — heads over TP
    "v":    ("F", None, "tp", None),
    "h":    ("F", "tp", None),          # mamba (B, di, N)
    "conv": ("F", None, "tp"),          # mamba (B, K-1, di)
    "C":    ("F", "tp", None, None),    # mlstm (B, H, hd, hd)
    "n":    ("F", "tp", None),          # mlstm (B, H, hd)
    "m":    ("F", "tp"),                # mlstm (B, H)
}


def cache_specs(mesh, cfg, shape, cache) -> dict:
    """The spec tree of the decode cache (:meth:`LM.init_cache`'s
    ``{"blocks": [...], "rest": [...]}``, each layer a dict of leaves):
    batch over the FSDP axes, head / state dims over TP, with per-dim
    divisibility fallback (e.g. 8 KV heads on a 16-way axis replicate)."""
    del cfg, shape  # the layout depends only on leaf shapes (API parity)
    F = fsdp_axes(mesh) or None
    tp = tp_axis(mesh)
    resolve = {"F": F, "tp": tp, None: None}

    def layer(c: dict) -> dict:
        return {k: _spec(mesh, tuple(v.shape),
                         tuple(resolve[r] for r in _CACHE_ROLES.get(k, ())))
                for k, v in c.items()}
    return {part: [layer(c) for c in cache[part]] for part in cache}


def batch_spec(mesh, cfg, batch: int, n_rest: int = 0) -> tuple:
    """Input-batch layout: dim 0 over the FSDP axes (when divisible),
    ``n_rest`` trailing dims replicated."""
    del cfg
    return _spec(mesh, (batch,) + (1,) * n_rest,
                 (fsdp_axes(mesh) or None,) + (None,) * n_rest)


def entry_axes(entry) -> tuple[str, ...]:
    """The axis names of one spec entry (None / str / tuple)."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def block_index(mesh, entry, coords: dict) -> tuple[int, int]:
    """(this rank's block, number of blocks) along a dim with spec
    ``entry``: the rank's coordinates on the entry's axes, row-major."""
    idx, n = 0, 1
    for a in entry_axes(entry):
        idx = idx * mesh.shape[a] + coords[a]
        n *= mesh.shape[a]
    return idx, n


def block_slices(mesh, spec: tuple, shape,
                 coords: Optional[dict] = None) -> tuple:
    """The rank's block of a ``shape`` tensor under ``spec``, as a slice
    per dim: along each sharded dim, block ``i`` of ``n`` equal blocks,
    ``i`` the coordinates of the rank at ``coords`` (default:
    ``mesh.coords``, this rank's) on the entry's axes, row-major."""
    coords = mesh.coords if coords is None else coords
    out = []
    for dim, size in enumerate(shape):
        entry = spec[dim] if dim < len(spec) else None
        i, n = block_index(mesh, entry, coords)
        k = size // n
        out.append(slice(i * k, (i + 1) * k))
    return tuple(out)


def local_shard(mesh, spec: tuple, t, coords: Optional[dict] = None):
    """The block of the whole tensor ``t`` that the rank at ``coords``
    (default: this rank) holds under ``spec`` (:func:`block_slices`).  A
    view (no copy)."""
    return t[block_slices(mesh, spec, t.shape, coords)]


def join_shards(mesh, spec: tuple, blocks: dict):
    """The whole tensor from ``blocks`` (the :func:`local_shard` of every
    rank, keyed by rank), the inverse of :func:`local_shard`: ranks that
    hold the same block must hold the same values."""
    import torch
    coords = {r: mesh_coords(mesh, r) for r in blocks}
    dims = [d for d, e in enumerate(spec) if entry_axes(e)]

    def build(level: int, fixed: dict):
        if level == len(dims):
            for r, c in coords.items():
                if all(block_index(mesh, spec[d], c)[0] == i
                       for d, i in fixed.items()):
                    return blocks[r]
            raise ValueError(f"no rank holds block {fixed}")
        d = dims[level]
        n = block_index(mesh, spec[d], coords[next(iter(coords))])[1]
        return torch.cat([build(level + 1, {**fixed, d: i})
                          for i in range(n)], dim=d)
    return build(0, {})


def mesh_coords(mesh, rank: int) -> dict:
    """The coordinates of ``rank`` on ``mesh``: ranks row-major over the
    axes, the last fastest."""
    coords = {}
    for a in reversed(mesh.axis_names):
        coords[a] = rank % mesh.shape[a]
        rank //= mesh.shape[a]
    return {a: coords[a] for a in mesh.axis_names}


# ---------------------------------------------------------------------------
# activation-sharding rules
# ---------------------------------------------------------------------------

_ACT = threading.local()


def current_rules():
    """The (mesh, mode) pair of the innermost active
    :func:`activation_rules` context, or None."""
    return getattr(_ACT, "rules", None)


@contextmanager
def activation_rules(mesh, mode: str = "dp"):
    """Enable the activation-sharding rules inside the context (this
    thread).  ``mode``: ``"dp"`` (batch over FSDP, TP on head/ff/vocab
    dims) or ``"sp"`` (additionally sequence-parallel residuals).  Inside
    it, ``models.moe.moe_a2a`` runs its expert-parallel all-to-all, and
    under ``"sp"`` a sharded model's residual stream holds the rank's
    sequence block over ``model`` (:mod:`repro_torch.models.sharded`)."""
    if mode not in ("dp", "sp"):
        raise ValueError(f"activation mode {mode!r}: 'dp' or 'sp'")
    prev = current_rules()
    _ACT.rules = (mesh, mode)
    try:
        yield
    finally:
        _ACT.rules = prev


def activation_spec(mesh, layout: str, shape: tuple,
                    mode: str = "dp") -> Optional[tuple]:
    """The partition spec of an activation of the given layout string
    (``"btd"``, ``"bthd"``, ``"btf"``, ``"btv"``) and global ``shape``, or
    None for an unknown layout / rank mismatch."""
    F = fsdp_axes(mesh) or None
    tp = tp_axis(mesh)
    roles = {
        "btd": (F, tp if mode == "sp" else None, None),
        "bthd": (F, None, tp, None),
        "btf": (F, None, tp),
        "btv": (F, None, tp),
    }.get(layout)
    if roles is None or len(roles) != len(shape):
        return None
    return _spec(mesh, shape, roles)


def seq_parallel(mesh) -> bool:
    """Whether the residual stream of a model sharded on ``mesh`` holds
    the rank's sequence block over ``model``: ``activation_rules(m, "sp")``
    on a mesh ``m`` of ``mesh``'s shape with more than one model rank."""
    rules = current_rules()
    return (rules is not None and rules[1] == "sp"
            and axis_size(mesh, TP_AXIS) > 1
            and dict(rules[0].shape) == dict(mesh.shape))


def constrain(x, layout: str, seq: Optional[int] = None):
    """The activation-sharding rule at the reference's places: ``x``
    brought to the rank's block of ``layout`` (:func:`activation_spec`).
    The identity outside :func:`activation_rules`.

    The port's sharded layers compute on the rank's blocks already: the
    batch block, and their heads / ff / vocabulary blocks, which is the
    ``"dp"`` rule and the ``"bthd"`` / ``"btf"`` / ``"btv"`` entries of
    ``"sp"``; so there this checks ``x``'s rank and passes it through.
    Under ``"sp"`` a ``"btd"`` residual holds the rank's sequence block
    over ``model``: given ``seq``, the global sequence length, a tensor
    that holds all ``seq`` positions (replicated over the model group) is
    cut to the rank's block, whose gradient is summed over the group
    where autograd records; a block passes through.  (A row-parallel
    product's partial sums reach the block by a reduce-scatter instead,
    ``models.sharded.Scope.reduce_seq``.)"""
    rules = current_rules()
    if rules is None:
        return x
    want = {"btd": 3, "bthd": 4, "btf": 3, "btv": 3}.get(layout)
    if want is not None and x.dim() not in (want, want + 1):
        # musicgen's logits carry a codebook dim: (B, S, nc, V)
        raise ValueError(f"constrain: a {layout!r} activation of rank "
                         f"{x.dim()}")
    mesh = rules[0]
    tp = axis_size(mesh, TP_AXIS)
    if (layout != "btd" or seq is None or not seq_parallel(mesh)
            or seq % tp or x.shape[1] != seq):
        return x
    from .mesh import enter_fn
    k = seq // tp
    return enter_fn(mesh, x).narrow(1, mesh.coords[TP_AXIS] * k, k)
