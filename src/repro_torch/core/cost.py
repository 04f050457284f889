"""Analytical cost model and plan resolution (paper §4.3, Eq. 4).

``C(P_i|q) = Σ_p ( T̂w_p + max(T̂r_p, T̂c_p) )`` over the basic/fused
operators p that assignment q induces: write time + overlapped read/compute
time, bandwidth-normalized.  Sparsity-exploiting operators scale compute by
the sparsity of the main (driver) input; sparse inputs are read at
nnz·(value+index) bytes; shared reads and CSEs are deduplicated via cost
vectors; operators reachable over multiple paths with materialized output
cost zero the second time, while *overlapping* fused operators pay their
redundant compute (fuse-all semantics).

The same walker that costs a plan also **extracts** it (`resolve_partition`
returns :class:`FusedOpSpec` lists), so the executed plan is by construction
the costed plan.

Cost constants default to the TPU v5e roofline (819 GB/s HBM, 197 TFLOP/s
bf16); the distributed variant prices reads of sharded side inputs at ICI
all-gather bandwidth — the paper's "different read bandwidths for inputs of
resulting distributed operations" (§4.4) mapped onto the mesh.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Optional

from repro_torch import hw as _hw
from .ir import Graph, Node, sparse_safe_wrt
from .memo import MemoEntry, MemoTable
from .partitions import Partition, Point
from .templates import TType

# -- hardware constants (shared substrate: repro_torch.hw; the reference's
# TPU v5e constants, kept as the planning default for plan parity) -------------

@dataclass(frozen=True)
class DistParams:
    """Row-partitioned execution geometry for the distributed cost arm.

    Derived from a ``FusionLayout`` by
    :func:`repro_torch.core.layout.layout_cost_params`: the mesh's
    data/FSDP axes become the row-shard group, and per graph-input shard
    factors are read off the layout's partition specs (``row_factor``:
    dim-0, ``col_factor``: dim-1).  With this set, :func:`spec_cost` prices every
    fused operator as ``min(local arm, distributed arm)`` — the
    local × distributed template dimension of candidate selection.
    """

    axes: tuple[str, ...]          # row-shard mesh axes, mesh order
    n: int                         # total row-shard degree (Π axis sizes)
    ici_bw: float = _hw.TPU_V5E.ici_bw
    row_factor: dict = field(default_factory=dict)   # input nid → dim-0 shards
    col_factor: dict = field(default_factory=dict)   # input nid → dim-1 shards
    #: per-spec memo of :func:`_dist_arm` (one planning call shares one
    #: DistParams, so the cache dies with the plan)
    cache: dict = field(default_factory=dict, repr=False, compare=False)

    def signature(self) -> tuple:
        """Hashable identity (plan-cache / context keys)."""
        return (self.axes, self.n, self.ici_bw,
                tuple(sorted(self.row_factor.items())),
                tuple(sorted(self.col_factor.items())))


@dataclass(frozen=True)
class Placement:
    """The local-vs-distributed decision for one fused operator.

    ``arm`` is the selected execution arm; both arms' modeled costs are
    kept for ``explain()``.  For the distributed arm, ``epilogue`` names
    the collective that completes the template
    (:func:`repro_torch.core.templates.dist_epilogue`), ``collective_bytes`` is
    the total per-device ring volume (epilogue all-reduce + side-input
    all-gathers), and ``sharded`` lists the bound input nids each device
    reads as a row shard."""

    arm: str                       # "local" | "distributed"
    cost: float                    # cost of the selected arm
    local_cost: float
    dist_cost: float               # inf when no distributed variant applies
    epilogue: Optional[str] = None  # none | psum | pmin | pmax
    axes: tuple = ()
    n: int = 1
    collective_bytes: float = 0.0
    gather_bytes: float = 0.0      # side-input all-gather share of the above
    sharded: frozenset = frozenset()


@dataclass
class CostParams:
    read_bw: float = _hw.TPU_V5E.hbm_bw      # HBM read, B/s
    write_bw: float = _hw.TPU_V5E.hbm_bw     # HBM write, B/s
    compute_bw: float = _hw.TPU_V5E.peak_flops   # peak FLOP/s (bf16 MXU)
    dtype_bytes: int = 4
    sparse_idx_bytes: int = 4
    #: per-input read-bandwidth override (nid -> B/s): distributed side
    #: inputs crossing shards are read at collective bandwidth.
    input_read_bw: dict[int, float] = field(default_factory=dict)
    #: hard constraint checker: (spec) -> bool valid; invalid => inf cost.
    max_fused_inputs: int = 12      # VMEM-budget style constraint
    #: row-shard geometry enabling the distributed cost arm (None: local
    #: only — the pre-layout behavior).
    dist: Optional[DistParams] = None

    def in_bw(self, nid: int) -> float:
        return self.input_read_bw.get(nid, self.read_bw)


#: the reference's TPU v5e cost constants — the port plans under them so it
#: selects exactly the reference's plans; they are not H100 figures
TPU_V5E = CostParams()

#: flop weight per output cell for cell-wise ops (transcendentals are
#: many-flop on the VPU; same spirit as SystemML's per-op costs).
_EXPENSIVE = {"exp": 16, "log": 16, "sigmoid": 20, "tanh": 20, "gelu": 24,
              "silu": 20, "softplus": 20, "pow": 16, "sqrt": 4, "div": 4,
              "recip": 4, "log1p": 16}


def node_flops(node: Node) -> float:
    if node.is_input or node.op in ("t", "idx"):
        return 0.0
    if node.is_matmul:
        m, k, n = node.mm_dims()
        return 2.0 * m * k * n
    if node.is_agg:
        return float(node.inputs[0].ncells)
    w = _EXPENSIVE.get(node.op, 1)
    return float(node.ncells) * w


def node_bytes(node: Node, params: CostParams) -> float:
    """Storage footprint (sparse-aware)."""
    if node.sparsity < 1.0:
        return node.ncells * node.sparsity * (params.dtype_bytes
                                              + params.sparse_idx_bytes)
    return float(node.ncells) * params.dtype_bytes


# -- plan specs ---------------------------------------------------------------

@dataclass
class FusedOpSpec:
    """One operator of the induced runtime plan: a fused operator (ttype
    set) or a basic operator (ttype None).  ``cover`` maps covered node id →
    chosen memo entry (root first)."""
    root: int
    ttype: Optional[TType]
    cover: dict[int, Optional[MemoEntry]]
    inputs: list[int]                     # distinct, order of discovery
    driver: Optional[int] = None          # sparse-exploitation driver input
    #: local/distributed decision (set by selection when planning under a
    #: mesh layout; None ≡ local).
    placement: Optional["Placement"] = None

    @property
    def fused(self) -> bool:
        return self.ttype is not None and len(self.cover) > 1


def _spec_flops(graph: Graph, spec: FusedOpSpec) -> float:
    """Covered-node FLOPs, sparse-driver scaled (shared by both arms)."""
    flops = 0.0
    for nid in spec.cover:
        n = graph.by_id[nid]
        f = node_flops(n)
        if n.is_matmul and spec.ttype is None:
            # basic matmul exploits sparse left input (SystemML dispatches
            # to sparse kernels)
            f *= max(graph.by_id[n.inputs[0].nid].sparsity, 1e-12)
        flops += f
    if spec.driver is not None:
        flops *= max(graph.by_id[spec.driver].sparsity, 1e-12)
    return flops


def _boundary_gather(graph: Graph, spec: FusedOpSpec, params: CostParams,
                     interior: Optional[dict]) -> float:
    """Ring all-gather volume (bytes) a *segment boundary* costs: every
    input that an upstream operator produces row-partitioned
    (``interior[nid]`` — a distributed operator with a ``"none"``
    epilogue) must be gathered across the row group before a consumer
    that does not read it as a row shard can run.  Intra-segment edges —
    a distributed consumer reading the value sharded — never pay this;
    that asymmetry is what makes selection prefer longer distributed
    chains."""
    if not interior or params.dist is None:
        return 0.0
    n = params.dist.n
    return sum(_hw.all_gather_bytes(node_bytes(graph.by_id[i], params), n)
               for i in spec.inputs if interior.get(i))


def _local_spec_cost(graph: Graph, spec: FusedOpSpec, params: CostParams,
                     interior: Optional[dict] = None) -> float:
    """The paper's Eq. 4 single-device operator cost (the local arm).

    ``interior`` maps node id → "produced row-partitioned by an upstream
    distributed operator"; reading such an intermediate locally first
    re-assembles it (ring all-gather at ICI bandwidth) — the re-scatter
    side of a distributed-segment boundary."""
    if len(spec.inputs) > params.max_fused_inputs and spec.fused:
        return math.inf                    # constraint violation (paper Z)
    root = graph.by_id[spec.root]
    t_r = 0.0
    for i in spec.inputs:
        n = graph.by_id[i]
        t_r += node_bytes(n, params) / params.in_bw(i)
    t_w = node_bytes(root, params) / params.write_bw
    t_c = _spec_flops(graph, spec) / params.compute_bw
    cost = t_w + max(t_r, t_c)
    gather = _boundary_gather(graph, spec, params, interior)
    if gather:
        cost += gather / params.dist.ici_bw
    return cost


def spec_cost(graph: Graph, spec: FusedOpSpec, params: CostParams,
              interior: Optional[dict] = None) -> float:
    """Operator cost under ``params``.

    Without distributed geometry this is the local Eq. 4 cost.  When
    ``params.dist`` is set (planning under a mesh layout), every fused
    operator is priced on *both* execution arms and the cheaper one wins —
    candidate selection thereby enumerates ``local × distributed`` as an
    extra per-partition template dimension, and the induced plan is hybrid
    whenever that is what the cost model prefers.

    ``interior`` (nid → upstream operator produces the value
    row-partitioned) makes the pricing *chain-aware*: a distributed
    consumer reads such intermediates as free-flowing row shards (and is
    anchored by them), while a local consumer pays the boundary
    all-gather — so the model stops charging the epilogue gather +
    re-scatter on intra-segment edges and selection extends distributed
    runs instead of bouncing back to local after every operator."""
    local = _local_spec_cost(graph, spec, params, interior)
    if params.dist is None or not getattr(spec, "fused", False) \
            or not math.isfinite(local):
        return local
    arm = _dist_arm(graph, spec, params, interior)
    return local if arm is None else min(local, arm[0])


def spec_placement(graph: Graph, spec: FusedOpSpec, params: CostParams,
                   interior: Optional[dict] = None) -> Placement:
    """Resolve the local/distributed decision for one fused operator (the
    argmin :func:`spec_cost` takes, with both arms' evidence retained)."""
    local = _local_spec_cost(graph, spec, params, interior)
    arm = _dist_arm(graph, spec, params, interior) \
        if math.isfinite(local) else None
    if arm is None:
        return Placement("local", local, local, math.inf)
    cost, epil, coll, gather, sharded, axes, n = arm
    if cost < local:
        return Placement("distributed", cost, local, cost, epil, axes, n,
                         coll, gather, sharded)
    return Placement("local", local, local, cost, epil, axes, n)


def _iter_rows(graph: Graph, spec: FusedOpSpec, variant: str,
               prog_root: int) -> int:
    """Rows of the template's iteration domain — the dimension the
    distributed variant shards.  Aggregating variants (including the
    closing-matmul ones, whose contraction runs over the chain rows)
    iterate the chain at ``prog_root``; no_agg/right_mm iterate the
    output rows."""
    if variant in ("full_agg", "row_agg", "col_agg", "col_t_agg",
                   "left_mm"):
        return graph.by_id[prog_root].shape[0]
    return graph.by_id[spec.root].shape[0]


def _shardable(graph: Graph, spec: FusedOpSpec, i: int, rows: int) -> bool:
    """May input ``i`` arrive as a row shard of the iteration domain?

    Shape equality with the iteration rows is necessary but *not*
    sufficient — the template must also bind the input per-row.  A
    covered matmul consuming ``i`` as its **right** operand contracts
    (or, transposed, emits) over ``i``'s rows, so the full operand is
    needed regardless of its shape (a square main would otherwise
    misclassify, e.g. ``w`` in ``(X @ w)`` with m == n).  A **left**
    operand is row-bound — except a transposed interior read, which only
    the reduce epilogue of a closing ``t(X) @ chain`` / ``left_mm`` root
    makes exact."""
    node = graph.by_id[i]
    if node.is_scalar or node.shape[0] != rows:
        return False
    for nid in spec.cover:
        c = graph.by_id[nid]
        if not c.is_matmul:
            continue
        a, b = c.inputs
        if b.nid == i:
            return False
        if a.nid == i and c.ta and nid != spec.root:
            return False
    return True


_MISS = object()


def _dist_arm(graph: Graph, spec: FusedOpSpec, params: CostParams,
              interior: Optional[dict] = None):
    """Cost the distributed variant of ``spec``, or None when no such
    variant exists (template/variant not in the registry, rows don't
    divide the shard group, or no operand actually arrives row-sharded).

    Returns (cost, epilogue, collective_bytes, gather_bytes, sharded
    nids, axes, n).  Reads and compute scale 1/n over the row shards;
    broadcast side inputs are read in full, and layout-sharded ones add
    ring all-gather volume; a "reduce" epilogue adds the ring all-reduce
    of the (partial) output — all at ICI bandwidth (``repro_torch.hw``).

    ``interior`` marks inputs an upstream distributed operator already
    produces row-partitioned: they anchor the operator (no layout shard
    factor needed) and flow shard-to-shard for free, while consuming one
    as a *broadcast* side input costs the boundary all-gather.

    Memoized per (spec identity, interior inputs) on ``params.dist``
    (one planning call shares one DistParams): MPSkipEnum re-costs the
    same induced operators exponentially often, and the variant
    derivation walks the cover — pure arithmetic must stay pure
    arithmetic in that loop."""
    dp = params.dist
    if dp is None or dp.n <= 1 or spec.ttype is None:
        return None
    interior = interior or {}
    key = (id(graph), spec.root, spec.ttype, frozenset(spec.cover),
           tuple(spec.inputs), spec.driver,
           tuple(sorted(i for i in spec.inputs if interior.get(i))))
    hit = dp.cache.get(key, _MISS)
    if hit is not _MISS:
        return hit
    dp.cache[key] = out = _dist_arm_uncached(graph, spec, params, dp,
                                             interior)
    return out


def _dist_arm_uncached(graph: Graph, spec: FusedOpSpec, params: CostParams,
                       dp: DistParams, interior: dict):
    from .templates import dist_epilogue
    from .cplan import _variant_of     # runtime import: cplan imports us

    root = graph.by_id[spec.root]
    variant, agg_op, prog_root, _close = _variant_of(
        graph, spec.ttype, root, set(spec.cover))
    epil = dist_epilogue(spec.ttype, variant, agg_op)
    if epil is None:
        return None
    rows = _iter_rows(graph, spec, variant, prog_root)
    n = dp.n
    if rows < n or rows % n:
        return None

    sharded: set[int] = set()
    anchored = False            # ≥1 operand is layout-sharded over rows
    t_r = 0.0
    gather = 0.0
    for i in spec.inputs:
        node = graph.by_id[i]
        b = node_bytes(node, params)
        r = dp.row_factor.get(i, 1)
        c = dp.col_factor.get(i, 1)
        if _shardable(graph, spec, i, rows):
            # row-bound: each device reads only its row slice — either a
            # layout shard or an upstream operator's row-partitioned
            # output flowing shard-to-shard (no collective on that edge)
            sharded.add(i)
            anchored = anchored or r == n or bool(interior.get(i))
            t_r += b / n / params.read_bw
            if c > 1:           # column shards gathered within the row group
                gather += _hw.all_gather_bytes(b / n, c)
        else:
            # broadcast side input: full read, all-gathered if sharded
            t_r += b / params.read_bw
            if r * c > 1:
                gather += _hw.all_gather_bytes(b, r * c)
            elif interior.get(i):
                # upstream row-partitioned intermediate consumed whole:
                # the segment boundary's re-assembly gather
                gather += _hw.all_gather_bytes(b, n)
    if not anchored:
        return None
    t_c = _spec_flops(graph, spec) / n / params.compute_bw
    out_b = node_bytes(root, params)
    coll = gather
    if epil == "none":
        t_w = out_b / n / params.write_bw      # row-partitioned write
    else:
        t_w = out_b / params.write_bw          # replicated reduced output
        coll += _hw.all_reduce_bytes(out_b, n)
    cost = t_w + max(t_r, t_c) + coll / dp.ici_bw
    return cost, epil, coll, gather, frozenset(sharded), dp.axes, n


# -- sparse driver detection ---------------------------------------------------

SPARSE_EXPLOIT_MAX = 0.7   # exploit sparsity in costs below this density


def find_driver(graph: Graph, root: Node, cover: dict[int, object],
                inputs: list[int], ttype: Optional[TType]) -> Optional[int]:
    """Main-input sparse driver of a fused operator, if any: an input matrix
    w.r.t. which the fused chain is sparse-safe (evaluating only at its
    non-zeros is exact)."""
    if ttype is None or ttype == TType.ROW:
        # Row binds whole (possibly sparse) rows; it gets no per-cell
        # asymptotic win — this is exactly why an overlapping Row plan
        # "destroys" a sparse-safe Outer plan (paper §5.4 ALS-CG).
        return None
    # expression whose per-cell values must vanish where the driver is 0
    expr = root
    if root.is_agg:
        if root.op not in ("sum", "sum_sq"):
            return None
        expr = root.inputs[0]
    elif root.is_matmul:
        a, b = root.inputs
        expr = b if root.ta else a

    best: Optional[int] = None
    best_sp = SPARSE_EXPLOIT_MAX if ttype != TType.OUTER else 1.0 + 1e-9
    for i in inputs:
        n = graph.by_id[i]
        if n.is_scalar or n.is_vector:
            continue
        if ttype == TType.OUTER and n.shape != expr.shape:
            continue
        if n.sparsity < best_sp and sparse_safe_wrt(expr, n):
            best, best_sp = i, n.sparsity
    return best


# -- plan resolution (the GETPLANCOST walker, also used for extraction) --------

#: cost-tie preference between template types at a plan root: multi-
#: aggregates enable cross-operator sharing, Outer enables sparsity.
_TIE_PREF = {TType.MAGG: 0, TType.OUTER: 1, TType.CELL: 2, TType.ROW: 3}


def _build_spec(graph: Graph, memo: MemoTable, nid: int,
                entry: Optional[MemoEntry],
                banned: set[Point]) -> FusedOpSpec:
    """Expand a root memo entry into the fused-operator spec it induces
    (interior continuations picked by max fusion references, the paper's
    "best plan regarding template type and fusion references")."""
    node = graph.by_id[nid]
    if entry is None or entry.n_refs == 0:
        return FusedOpSpec(nid, None, {nid: None},
                           [i.nid for i in node.inputs])
    cover: dict[int, Optional[MemoEntry]] = {}
    inputs: list[int] = []
    in_seen: set[int] = set()

    def walk(wid: int, e: MemoEntry) -> None:
        if wid in cover:
            return
        cover[wid] = e
        wnode = graph.by_id[wid]
        for j, inp in enumerate(wnode.inputs):
            fused = e.refs[j] >= 0 and (wid, inp.nid) not in banned
            e_in = None
            if fused:
                e_in = memo.best_compatible(inp.nid, entry.ttype, banned)
                fused = e_in is not None
            if fused:
                walk(inp.nid, e_in)              # type: ignore[arg-type]
            elif inp.nid not in in_seen:
                in_seen.add(inp.nid)
                inputs.append(inp.nid)

    walk(nid, entry)
    drv = find_driver(graph, node, cover, inputs, entry.ttype)
    return FusedOpSpec(nid, entry.ttype, cover, inputs, drv)


def resolve_partition(graph: Graph, memo: MemoTable, part: Partition,
                      banned: set[Point], params: CostParams = TPU_V5E,
                      probe: str = "cost") -> list[FusedOpSpec]:
    """Induce the runtime plan of partition ``part`` under assignment
    ``banned``.

    ``probe="cost"`` (Gen): per materialized node the root plan is chosen
    by a memoized cost DP over candidate memo entries (fused alternatives
    plus the basic operator), including the cost of the materialized
    subgraphs each alternative leaves behind.

    ``probe="greedy"`` (the fuse-all / fuse-no-redundancy heuristics):
    always take the maximal-fusion entry — this is what lets an
    overlapping Row plan destroy a sparse-safe Outer plan (paper §5.4).

    Under distributed geometry the DP is *chain-aware*: materialized
    inputs are resolved bottom-up first, and a child whose chosen plan is
    a distributed operator with a row-partitioned output marks its node
    ``interior`` — the parent's cost then sees the value as a free
    shard-to-shard edge on the distributed arm and as a boundary
    all-gather on the local arm (see :func:`spec_cost`).

    Returns one spec per materialized operator in dependency order."""
    choice: dict[int, FusedOpSpec] = {}
    subcost: dict[int, float] = {}
    interior: dict[int, bool] = {}

    def best(nid: int) -> float:
        """Memoized cost of materializing nid (and everything below it)."""
        if nid in subcost:
            return subcost[nid]
        node = graph.by_id[nid]
        if node.is_input:
            subcost[nid] = 0.0
            return 0.0
        subcost[nid] = 0.0          # cycle guard (DAG: unreachable)
        cands: list[Optional[MemoEntry]]
        if nid not in part.nodes:
            cands = [None]
        elif probe == "greedy":
            cands = [memo.best_compatible(nid, None, banned)]
        else:
            cands = [None] + [
                e for e in memo.entries(nid) if e.can_root
                and not any((nid, r) in banned for r in e.ref_ids())]
        best_c, best_s = math.inf, None
        for e in cands:
            spec = _build_spec(graph, memo, nid, e, banned)
            child = sum(best(i) for i in spec.inputs)
            c = spec_cost(graph, spec, params, interior) + child
            pref = _TIE_PREF.get(spec.ttype, 9) if spec.ttype else 9
            if c < best_c * (1 - 1e-12) or (
                    best_s is not None and abs(c - best_c) <= best_c * 1e-9
                    and pref < (_TIE_PREF.get(best_s.ttype, 9)
                                if best_s.ttype else 9)):
                best_c, best_s = c, spec
        choice[nid] = best_s            # type: ignore[assignment]
        subcost[nid] = best_c
        if params.dist is not None and best_s is not None \
                and getattr(best_s, "fused", False):
            interior[nid] = row_partitioned(
                spec_placement(graph, best_s, params, interior))
        return best_c

    # commit: walk the chosen DAG from roots/exits, emit specs once each
    specs: list[FusedOpSpec] = []
    emitted: set[int] = set()

    def emit(nid: int) -> None:
        node = graph.by_id[nid]
        if nid in emitted or node.is_input:
            return
        emitted.add(nid)
        if nid not in part.nodes:
            return                       # planned elsewhere (other partition
                                         # or basic fill-in by select())
        best(nid)
        spec = choice[nid]
        for i in spec.inputs:
            emit(i)
        specs.append(spec)

    for r in sorted(set(part.roots) | part.exits):
        emit(r)
    return specs


def row_partitioned(pl: Optional[Placement]) -> bool:
    """Does this placement produce its output as row shards (the value an
    intra-segment consumer may read shard-to-shard)?  The single source
    of the rule for the selection DP, :func:`update_interior`, and the
    post-selection placement walk."""
    return pl is not None and pl.arm == "distributed" \
        and pl.epilogue == "none"


def update_interior(graph: Graph, spec, params: CostParams,
                    interior: dict) -> None:
    """Record whether ``spec``'s output is produced row-partitioned
    (distributed arm, ``"none"`` epilogue) — the walker state both the
    selection DP and the post-selection placement pass thread through
    :func:`spec_cost` in dependency order."""
    if params.dist is None or not getattr(spec, "fused", False):
        return
    pl = spec_placement(graph, spec, params, interior)
    interior[spec.root] = row_partitioned(pl)


def partition_cost(graph: Graph, memo: MemoTable, part: Partition,
                   banned: set[Point], params: CostParams,
                   ub: float = math.inf) -> float:
    """GETPLANCOST with early abort once the partial cost exceeds ub.
    Walks the induced specs in dependency order so chain-aware
    distributed pricing sees the same interior-producer state the DP in
    :func:`resolve_partition` used."""
    total = 0.0
    interior: dict[int, bool] = {}
    for spec in resolve_partition(graph, memo, part, banned, params):
        total += spec_cost(graph, spec, params, interior)
        update_interior(graph, spec, params, interior)
        if total >= ub:
            return math.inf
    return total


# -- lower bounds for cost-based pruning (paper §4.4) ---------------------------

def static_lower_bound(graph: Graph, memo: MemoTable, part: Partition,
                       params: CostParams) -> float:
    """C̲_{P_i}: read partition inputs once + minimal (sparsity-exploited)
    compute + write partition roots/exits — a true lower bound of any plan.

    Under distributed geometry every operator may run row-partitioned —
    reads, compute, and writes all scale 1/n — so the bound divides by
    the shard degree to stay a *valid* lower bound of the distributed
    arm (otherwise cost-based pruning would discard exactly the
    materialization assignments that enable long distributed chains)."""
    t_r = sum(node_bytes(graph.by_id[i], params) / params.in_bw(i)
              for i in part.inputs)
    sp_min = min((graph.by_id[i].sparsity for i in part.inputs
                  if not graph.by_id[i].is_scalar), default=1.0)
    t_c = sum(node_flops(graph.by_id[n]) for n in part.nodes) \
        * max(sp_min, 1e-12) / params.compute_bw
    t_w = sum(node_bytes(graph.by_id[r], params) / params.write_bw
              for r in set(part.roots) | part.exits)
    bound = max(t_r, t_c) + t_w
    if params.dist is not None and params.dist.n > 1:
        bound /= params.dist.n
    return bound


def mp_cost(graph: Graph, banned: set[Point], params: CostParams,
            written_anyway: frozenset[int] = frozenset()) -> float:
    """GETMPCOST: each distinct materialization target forced by q costs at
    least one write plus one read.  Targets in ``written_anyway`` (partition
    roots/exits, whose write is already in the static bound) only add the
    read — otherwise the bound would overestimate and mis-prune.  Like
    :func:`static_lower_bound`, the distributed arm may write and re-read
    a materialization target row-partitioned (1/n per device), so the
    bound scales by the shard degree."""
    targets = {t for (_, t) in banned}
    total = 0.0
    for t in targets:
        b = node_bytes(graph.by_id[t], params)
        total += b / params.read_bw
        if t not in written_anyway:
            total += b / params.write_bw
    if params.dist is not None and params.dist.n > 1:
        total /= params.dist.n
    return total
