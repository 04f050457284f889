"""Distributed execution of generated fused operators over a
:class:`~repro_torch.dist.Mesh` of ``torch.distributed`` ranks.

The distributed variant of a template runs the *same* generated operator
as the local one — :func:`repro_torch.kernels.ops.execute`, the CUDA
kernel of the CPlan on the card — over one rank's row panel of its
iteration domain.  Every rank holds whole operands; what differs per
template is only the wiring the plan's
:class:`~repro_torch.core.cost.Placement` prescribes:

* **panels** — operands the placement marked ``sharded`` (row-aligned
  with the iteration domain) are read as the rank's row panel: a view of
  rows ``part·m/n : (part+1)·m/n`` of a dense operand, the rank's block
  rows of a BCSR main (:func:`~repro_torch.kernels.blocksparse.
  block_row_panel`, a view) or its part of a
  :class:`~repro_torch.kernels.blocksparse.ShardedBCSR`.  Everything else
  (side-input row vectors, scalars, the narrow matmul operands of Row and
  Outer closures) is read whole.
* **epilogue** — ``"none"`` variants write their own output panel;
  ``"psum"``/``"pmin"``/``"pmax"`` variants produce per-rank partials
  completed by an all-reduce SUM / MIN / MAX over the mesh's row group
  (multi-aggregates ride one all-reduce of the stacked (k, 1) output).

**Multi-operator segments**: a plan :class:`~repro_torch.core.select.
Segment` — a maximal run of adjacent distributed-placed operators — runs
as *one* step: every member's generated kernel in order over the local
panels.  A row-partitioned intermediate (``"none"`` epilogue) consumed
inside the segment stays a panel: no gather at the operator boundary.
Reduced intermediates complete their all-reduce and flow whole.  Only
segment *outputs* leave the step, whole: reduced values as they are,
``"none"`` values after an all-gather of the panels — so the plan's
local operators and basic ops run unchanged on every rank.

Lowering is split into two stages so every downgrade is an explicit,
observable decision:

* :func:`plan_segment` validates the placement against the mesh at
  compile time (realizable axes, divisible rows) and returns a
  :class:`SegmentPlan`, or a :class:`SegmentFallback` carrying the reason
  the members must run locally (an abstract ``LogicalMesh``, an axis
  mismatch, indivisible rows, …).
* :func:`lower_segment` builds the rank's callable from the bound values'
  formats, or returns a :class:`SegmentFallback` when a format cannot be
  split into panels (block rows that do not divide the ranks, a
  CLA-compressed operand).

Callers record every ``SegmentFallback`` in the compiled plan's fallback
log (``explain()['execution']['fallbacks']``, checked by EXE005); local
execution computes the same values, since every rank holds whole
operands.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Callable

from repro_torch import faults
from repro_torch.core.cplan import CPlan, NO_AGG
from repro_torch.core.partitions import PlanInvariantError
from repro_torch.dist import Mesh
from repro_torch.dist.sharding import axis_size
from . import ops as kops
from .blocksparse import BCSR, DictCompressed, ShardedBCSR, block_row_panel

faults.register_site(
    "dist.segment",
    "distributed segment planning (plan_segment): compile-time validation "
    "of a segment's placement against the mesh",
    kinds=("error", "latency"),
    handler="an injected error degrades to SegmentFallback — the caller "
            "records it via CompiledPlan.record_fallback (EXE005) and the "
            "members run as local fused steps on whole operands")

#: structural cache of lowered single-operator callables (the per-operator
#: dispatch path): keyed by (structural CPlan hash, mesh, epilogue, axes,
#: per-bind shard mask, kernel policy, operand formats) — the mesh and the
#: formats are part of the key, so a plan re-targeted at another mesh (or
#: fed a BCSR where a dense operand was lowered) never reuses a stale one;
#: bounded LRU
_FN_CACHE: "OrderedDict[tuple, Callable]" = OrderedDict()
_FN_CACHE_MAX = 256
_FN_LOCK = threading.Lock()


@dataclass(frozen=True)
class SegmentItem:
    """One operator of a distributed segment."""
    cplan: CPlan
    placement: object              # repro_torch.core.cost.Placement
    roots: tuple[int, ...]         # output nids (>1: combined multi-agg)
    export: bool                   # value leaves the segment?


@dataclass(frozen=True)
class SegmentFallback:
    """An explicit 'this segment runs locally' decision with its reason:
    callers record the reason in the compiled plan's fallback log, so
    ``explain()`` and EXE005 can show that no downgrade went
    unexplained."""
    reason: str


@dataclass
class SegmentPlan:
    """Mesh-validated segment metadata, ready to lower."""
    items: tuple                     # tuple[SegmentItem]
    axes: tuple                      # realized mesh axis names
    n: int                           # shard count
    ext: tuple                       # external bind nids, in order
    ext_shard: dict                  # nid -> row-sharded?
    epilogues: tuple                 # exported items' epilogues
    #: per-item main-row count of one rank's panel
    shard_rows: tuple = ()
    cache_token: tuple = field(default=(), repr=False)


def _realizable_axes(mesh, placement):
    """(axes, ok): the placement's row-shard axes on this mesh, or ok=False
    when the runtime cannot realize the plan's shard group."""
    axes = tuple(a for a in placement.axes if a in mesh.axis_names)
    if not axes or axis_size(mesh, axes) != placement.n:
        return (), False
    return axes, True


def plan_segment(items: list[SegmentItem], mesh):
    """Validate one plan segment (≥1 distributed operators in dependency
    order) against the mesh → :class:`SegmentPlan`, or a
    :class:`SegmentFallback` naming why the members must run locally.

    Raises :class:`~repro_torch.core.partitions.PlanInvariantError` when
    the segment itself is malformed (an operand both sharded and
    broadcast across members), which ``annotate_segments`` never emits."""
    try:
        faults.fault_point("dist.segment")
    except faults.FaultInjected as e:
        return SegmentFallback(f"injected fault: {e}")
    if not items:
        return SegmentFallback("empty segment")
    if not isinstance(mesh, Mesh):
        return SegmentFallback(
            "abstract mesh (cost-only layout): distributed placement is "
            "costed and reported but the body runs locally")
    axes, ok = _realizable_axes(mesh, items[0].placement)
    if not ok or items[0].placement.n != mesh.n:
        return SegmentFallback(
            f"mesh cannot realize shard axes {items[0].placement.axes!r} "
            f"x {items[0].placement.n} shards")
    n = items[0].placement.n

    produced: set[int] = set()
    ext: list[int] = []
    ext_shard: dict[int, bool] = {}
    for it in items:
        ax_it, ok = _realizable_axes(mesh, it.placement)
        if not ok or ax_it != axes:
            return SegmentFallback(
                f"member shard axes {it.placement.axes!r} diverge from "
                f"segment axes {axes!r}")
        for b in it.cplan.binds:
            if b.nid in produced:
                continue                           # intra-segment edge
            sh = b.nid in it.placement.sharded
            if b.nid in ext_shard:
                if ext_shard[b.nid] != sh:
                    # annotate_segments only groups members with one
                    # consistent view of each external operand: the plan
                    # was corrupted after selection — fail loudly
                    raise PlanInvariantError(
                        f"segment operand %{b.nid} is row-sharded for "
                        f"one member and broadcast for another — "
                        f"inconsistent shard view inside one region")
                continue
            if sh and b.shape[0] % n:
                return SegmentFallback(            # defensive: plan drift
                    f"sharded operand %{b.nid} rows {b.shape[0]} not "
                    f"divisible across {n} shards")
            ext.append(b.nid)
            ext_shard[b.nid] = sh
        produced.update(it.roots)

    if not any(it.export for it in items):
        return SegmentFallback("segment exports no value")
    epilogues = tuple(it.placement.epilogue for it in items if it.export)
    shard_rows = tuple(
        it.cplan.main.shape[0] // n
        if it.cplan.main.nid in it.placement.sharded
        else it.cplan.main.shape[0]
        for it in items)
    token = (tuple(it.cplan.cache_key() for it in items), mesh, axes,
             tuple(ext), tuple(sorted(ext_shard.items())),
             tuple((it.placement.epilogue, it.export, it.roots)
                   for it in items))
    return SegmentPlan(tuple(items), axes, n, tuple(ext), ext_shard,
                       epilogues, shard_rows, token)


def lower_segment(sp: SegmentPlan, mesh: Mesh, values=None, *,
                  kernels: str = "never"):
    """The rank's callable for a validated segment, given the bound value
    formats (``values`` None = all dense): it takes the whole external
    values in ``sp.ext`` order and returns the exported outputs whole, in
    item order.  Returns a :class:`SegmentFallback` when a value format
    cannot be split into panels (the caller records the reason and runs
    the members locally)."""
    if values is None:
        values = [None] * len(sp.ext)
    _values, fb = prepare_segment_values(sp, values)
    if fb is not None:
        return fb
    for nid, v in zip(sp.ext, values):
        if not sp.ext_shard[nid]:
            if isinstance(v, ShardedBCSR):
                return SegmentFallback(
                    f"replicated operand %{nid} arrived pre-partitioned")
            continue
        if isinstance(v, ShardedBCSR):
            if v.nparts != sp.n:
                return SegmentFallback(
                    f"sparse operand %{nid} partitioned into {v.nparts} "
                    f"shards but the mesh has {sp.n}")
        elif isinstance(v, DictCompressed):
            return SegmentFallback(
                f"row-sharded operand %{nid} is CLA-compressed: no "
                f"distributed decompression path")

    # a sparse-main no_agg export would have to re-assemble a global BCSR
    # from every rank's blocks — not a panel all-gather
    for it in sp.items:
        if not it.export or it.cplan.variant != NO_AGG:
            continue
        mv = values[sp.ext.index(it.cplan.main.nid)] \
            if it.cplan.main.nid in sp.ext else None
        if isinstance(mv, (BCSR, ShardedBCSR)) and it.cplan.main.exploit:
            return SegmentFallback(
                f"sparse no_agg output of %{it.roots[0]} cannot cross the "
                f"segment boundary")

    part = mesh.part
    steps = [(it.cplan, [b.nid for b in it.cplan.binds],
              it.placement.epilogue, it.roots, it.export, m_loc)
             for it, m_loc in zip(sp.items, sp.shard_rows)]

    def panel(nid, v):
        if not sp.ext_shard[nid]:
            return v
        if isinstance(v, ShardedBCSR):
            return v.local_bcsr(part)
        if isinstance(v, BCSR):
            return block_row_panel(v, sp.n, part)
        return mesh.panel(v)

    def body(*arrs):
        # each member's generated kernel on the rank's panels; "none"
        # outputs stay panels inside the segment and leave it gathered
        env = {nid: panel(nid, v) for nid, v in zip(sp.ext, arrs)}
        outs = []
        for cplan, nids, epilogue, roots, export, m_loc in steps:
            out = kops.execute(cplan, {nid: env[nid] for nid in nids},
                               kernels=kernels, shard_rows=m_loc)
            if epilogue != "none":
                out = mesh.all_reduce(out, epilogue)
            if len(roots) > 1:                     # combined multi-agg
                for k, r in enumerate(roots):
                    env[r] = out[k].reshape(1, 1)
            else:
                env[roots[0]] = out
            if export:
                outs.append(mesh.all_gather_rows(out)
                            if epilogue == "none" else out)
        return tuple(outs)

    return body


def prepare_segment_values(sp: SegmentPlan, values):
    """Check that every row-sharded BCSR operand splits into the mesh's
    panels (its block rows divide the shard count).  Returns ``(values,
    fallback)``; ``fallback`` is a :class:`SegmentFallback` naming the
    first operand that does not, and the values then run locally."""
    for nid, v in zip(sp.ext, values):
        if sp.ext_shard[nid] and isinstance(v, BCSR) \
                and (v.shape[0] // v.bs) % sp.n:
            return list(values), SegmentFallback(
                f"sparse operand %{nid}: {v.shape[0] // v.bs} block rows "
                f"not partitionable across {sp.n} shards")
    return list(values), None


def run_segment_local(sp: SegmentPlan, values, *, kernels: str = "never"):
    """Execute the segment's members on whole values (the recorded-fallback
    path): the same programs, no collectives.  Returns exported outputs in
    item order."""
    env = {nid: (v.unshard() if isinstance(v, ShardedBCSR) else v)
           for nid, v in zip(sp.ext, values)}
    outs = []
    for it in sp.items:
        out = kops.execute(
            it.cplan, {b.nid: env[b.nid] for b in it.cplan.binds},
            kernels=kernels)
        if len(it.roots) > 1:
            for k, r in enumerate(it.roots):
                env[r] = out[k].reshape(1, 1)
        else:
            env[it.roots[0]] = out
        if it.export:
            outs.append(out)
    return tuple(outs)


def build_dist_fn(cplan: CPlan, mesh, placement, *, kernels: str = "never",
                  values=None):
    """One distributed fused operator for the per-operator dispatch path.
    Returns ``((fn, prepared), None)`` — ``fn`` takes the prepared values
    in ``cplan.binds`` order and returns the output whole — or ``(None,
    SegmentFallback)`` naming why the placement cannot execute distributed
    here (the caller records the reason and runs the local operator)."""
    roots = getattr(cplan, "roots", None) or (cplan.prog_root,)
    sp = plan_segment(
        [SegmentItem(cplan, placement, tuple(roots), True)], mesh)
    if isinstance(sp, SegmentFallback):
        return None, sp
    if values is None:
        values = [None] * len(sp.ext)
    prepared, fb = prepare_segment_values(sp, values)
    if fb is not None:
        return None, fb

    # structural hit: binding is positional, as for GeneratedOp
    shard_mask = tuple(b.nid in placement.sharded for b in cplan.binds)
    fmt = tuple(type(v).__name__ for v in prepared)
    key = (cplan.cache_key(), mesh, placement.epilogue, sp.axes,
           shard_mask, kernels, fmt)
    with _FN_LOCK:
        hit = _FN_CACHE.get(key)
        if hit is not None:
            _FN_CACHE.move_to_end(key)
            return (hit, prepared), None

    seg_fn = lower_segment(sp, mesh, prepared, kernels=kernels)
    if isinstance(seg_fn, SegmentFallback):
        return None, seg_fn
    if sp.ext != tuple(b.nid for b in cplan.binds):
        raise PlanInvariantError("distributed operator binds out of order")

    def fn(*vals):
        return seg_fn(*vals)[0]

    with _FN_LOCK:
        _FN_CACHE[key] = fn
        while len(_FN_CACHE) > _FN_CACHE_MAX:
            _FN_CACHE.popitem(last=False)
    return (fn, prepared), None
