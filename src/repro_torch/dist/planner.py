"""Cost-based layout search over the mesh (explore → cost → select), the
reference's ``repro/dist/planner.py``.

The fixed layout rules of :mod:`.sharding` (TP on the ``"model"`` axis,
FSDP everywhere else, EP-vs-ffTP by a divisibility predicate, serving
layouts opt-in) become candidates that are enumerated, costed with an
analytical model and selected by argmin, as the fusion planner does for
fusion plans (paper §4).

A **candidate** (:class:`Layout`) is one axis-role assignment for a
``(config, shape, mesh)`` cell:

* ``tp``        — tensor-parallel degree (the logical ``"model"`` axis
                  size; the remaining per-pod factor becomes FSDP/data),
* ``moe``       — expert weights over TP (``"ep"``) vs per-expert ff-TP
                  (``"fftp"``) for MoE configs,
* ``act``       — activation residuals data-parallel (``"dp"``) or
                  additionally sequence-parallel (``"sp"``),
* ``serve_params`` — replicate parameters over the FSDP axes (decode
                  reads weights every token; all-gathering them each
                  step is the wrong side of the roofline).

Candidates are validated abstractly: the sharding rules map the layout's
logical mesh onto rank-matched, divisibility-checked spec trees over the
LM's parameters and caches built on the ``meta`` device (no allocation),
and per-leaf shard factors read off those trees drive exact
parameter / optimizer / KV-cache memory accounting.  Infeasible candidates
(> usable HBM) are pruned.  Costs are the reference's roofline with
ring-collective volumes from :mod:`repro_torch.hw`, at its TPU v5e
constants (``hw.TPU_V5E``), so the port selects exactly the reference's
layouts; they are not figures for the GPU.  Selection is the argmin of
modeled step time with deterministic tie-breaking (candidate key order),
memoized per cell.

Usage::

    from repro_torch.configs import SHAPES, get_config, MESH_SHAPES
    from repro_torch.dist import planner

    cfg = get_config("yi-34b")
    result = planner.search(cfg, SHAPES["decode_32k"],
                            planner.signature_of(MESH_SHAPES["pod16x16"]))
    result.winner.layout        # Layout(tp=16, serve_params=True, ...)
    layout = planner.plan_layout(mesh, cfg, SHAPES["decode_32k"])

Reports (one JSON per cell: every candidate, its terms, the winner) go to
``experiments/layouts_torch/`` unless ``--out`` names another directory::

    PYTHONPATH=src python -m repro_torch.dist.planner [--mesh pod16x16] [--out DIR]
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from pathlib import Path
from typing import Optional

from repro_torch import hw as _hw
from repro_torch.configs.base import ModelConfig, ShapeConfig
from .mesh import LogicalMesh, signature_of

#: where :func:`write_report` writes without ``out_dir`` (not committed)
REPORT_DIR = (Path(__file__).resolve().parents[3] / "experiments"
              / "layouts_torch")

ACT_BYTES = 2          # bf16 activations / collective payloads


# ---------------------------------------------------------------------------
# layouts
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class Layout:
    """One candidate axis-role assignment (see module docstring)."""
    tp: int
    dp: int
    pods: int = 1
    moe: str = "dense"           # dense | ep | fftp
    act: str = "dp"              # dp | sp
    serve_params: bool = False

    @property
    def devices(self) -> int:
        return self.tp * self.dp * self.pods

    def key(self) -> tuple:
        """Deterministic tie-break order (after cost)."""
        return (self.tp, self.moe, self.act, self.serve_params)

    def mesh(self) -> LogicalMesh:
        axes: dict[str, int] = {}
        if self.pods > 1:
            axes["pod"] = self.pods
        axes["data"] = self.dp
        axes["model"] = self.tp
        return LogicalMesh(axes)

    def to_dict(self) -> dict:
        return {"tp": self.tp, "dp": self.dp, "pods": self.pods,
                "moe": self.moe, "act": self.act,
                "serve_params": self.serve_params}


@dataclass
class LayoutCost:
    layout: Layout
    terms: dict[str, float]            # compute/memory/collective seconds
    collective_bytes: dict[str, float]  # per-device bytes by kind
    mem_bytes: dict[str, float]        # per-device resident bytes by kind
    feasible: bool
    step_time: float                   # seconds; inf when infeasible

    def to_dict(self) -> dict:
        return {"layout": self.layout.to_dict(), "terms": self.terms,
                "collective_bytes": self.collective_bytes,
                "mem_bytes": self.mem_bytes, "feasible": self.feasible,
                # None (not Infinity) for strict-JSON artifact tooling
                "step_time": self.step_time if self.feasible else None}


@dataclass
class PlanResult:
    cfg: ModelConfig
    shape: ShapeConfig
    mesh_sig: tuple
    winner: LayoutCost
    fixed: LayoutCost
    candidates: list[LayoutCost] = field(default_factory=list)

    @property
    def speedup(self) -> float:
        """Modeled fixed/auto step-time ratio (≥ 1 by construction).
        Cells where no layout fits HBM (e.g. grok training on a single
        pod) are ∞/∞ ties → 1.0."""
        import math
        if not math.isfinite(self.winner.step_time):
            return 1.0
        if self.winner.step_time <= 0:
            return 1.0
        return self.fixed.step_time / self.winner.step_time

    def to_dict(self) -> dict:
        import math
        speedup = self.speedup
        return {
            "arch": self.cfg.name, "shape": self.shape.name,
            "mesh": dict(self.mesh_sig),
            "devices": self.winner.layout.devices,
            "winner": self.winner.to_dict(),
            "fixed": self.fixed.to_dict(),
            # None when fixed fits no HBM at all (auto-only cell) — keeps
            # the artifact strict JSON
            "speedup": speedup if math.isfinite(speedup) else None,
            "n_candidates": len(self.candidates),
            "candidates": [c.to_dict() for c in self.candidates],
        }


# ---------------------------------------------------------------------------
# shard-factor accounting from the rule trees
# ---------------------------------------------------------------------------

def _eff(dim: int, n: int) -> int:
    """Effective shard factor of ``dim`` over one ``n``-way axis.
    Delegates to ``sharding._fit`` — the planner's compute-side factors
    are *by construction* the per-dim graceful degradation the rules
    apply, so a rule change cannot silently diverge the costs."""
    from . import sharding as sh
    mesh = LogicalMesh({"model": n})
    return sh.axis_size(mesh, sh._fit(mesh, dim, "model"))


def _group_eff(dim: int, sizes: list[int]) -> int:
    """Suffix-fit of a dim over an ordered axis group — ``_fit`` over
    multiple axes: largest trailing sub-product that divides."""
    from . import sharding as sh
    mesh = LogicalMesh({f"ax{i}": s for i, s in enumerate(sizes)})
    return sh.axis_size(mesh, sh._fit(mesh, dim, tuple(mesh.axis_names)))


_ABS_CACHE: dict = {}


def _abstract_state(cfg: ModelConfig, shape: Optional[ShapeConfig] = None):
    """(params, cache) of the LM on the ``meta`` device, memoized per
    config/shape: the flat parameter state dict and, for a serving
    shape, :meth:`LM.init_cache`'s tree — shapes and dtypes, no
    allocation.  Keyed on the full (frozen) ShapeConfig: two shapes
    sharing a name (e.g. per-engine ``engine_decode`` cells) must not
    collide."""
    key = (cfg, shape)
    if key in _ABS_CACHE:
        return _ABS_CACHE[key]
    from repro_torch.models import LM
    model = LM(cfg, device="meta")
    params = dict(model.state_dict())
    cache = None
    if shape is not None and shape.kind != "train":
        cache = model.init_cache(shape.global_batch, shape.seq_len)
    _ABS_CACHE[key] = (params, cache)
    return params, cache


def _shard_factors(mesh: LogicalMesh, spec) -> tuple[int, int]:
    """(tp factor, fsdp factor) of one spec on ``mesh``."""
    f_tp = f_F = 1
    for entry in tuple(spec):
        if entry is None:
            continue
        axes = (entry,) if isinstance(entry, str) else tuple(entry)
        for a in axes:
            if a == "model":
                f_tp *= mesh.shape[a]
            else:
                f_F *= mesh.shape[a]
    return f_tp, f_F


def _tree_accounting(mesh: LogicalMesh, specs, abstract) -> dict[str, float]:
    """Per-device stored bytes + FSDP gather/scatter volumes for a spec
    tree against its abstract leaves (exact, per leaf)."""
    stored = gather = scatter = 0.0
    for spec, leaf in _paired(specs, abstract):
        ncells = 1
        for d in leaf.shape:
            ncells *= d
        nbytes = float(ncells) * leaf.element_size()
        f_tp, f_F = _shard_factors(mesh, spec)
        stored += nbytes / (f_tp * f_F)
        # all-gather assembles the per-TP-shard tensor across the FSDP
        # group; reduce-scatter is the f32-gradient mirror image.
        gather += _hw.all_gather_bytes(nbytes / f_tp, f_F)
        scatter += _hw.reduce_scatter_bytes(
            nbytes / f_tp * 4 / leaf.element_size(), f_F)
    return {"stored": stored, "gather": gather, "scatter": scatter}


def _paired(specs, tree) -> list:
    """[(spec, leaf)] of a spec tree (dicts and lists of spec tuples) and
    the tree of leaves it mirrors; raises ValueError where the two
    structures differ."""
    if isinstance(specs, dict) or isinstance(tree, dict):
        if not (isinstance(specs, dict) and isinstance(tree, dict)
                and specs.keys() == tree.keys()):
            raise ValueError("spec tree and leaves differ in their keys")
        return [p for k in specs for p in _paired(specs[k], tree[k])]
    if isinstance(specs, list) or isinstance(tree, list):
        if not (isinstance(specs, list) and isinstance(tree, list)
                and len(specs) == len(tree)):
            raise ValueError("spec tree and leaves differ in their lists")
        return [p for s, t in zip(specs, tree) for p in _paired(s, t)]
    return [(specs, tree)]


def validate_layout(cfg: ModelConfig, shape: ShapeConfig,
                    layout: Layout) -> bool:
    """Every sharded dim of every param/cache leaf divides its mesh-axis
    product — the property the regression harness locks down."""
    from . import sharding as sh
    mesh = layout.mesh()
    params, cache = _abstract_state(cfg, shape)
    moe = None if layout.moe == "dense" else layout.moe
    trees = [(sh.param_specs(mesh, cfg, params, serve=layout.serve_params,
                             moe=moe), params)]
    if cache is not None:
        trees.append((sh.cache_specs(mesh, cfg, shape, cache), cache))
    for specs, abstract in trees:
        try:
            pairs = _paired(specs, abstract)
        except ValueError:
            return False
        for spec, leaf in pairs:
            if len(tuple(spec)) > len(leaf.shape):
                return False
            for dim, entry in zip(leaf.shape, tuple(spec)):
                if entry is None:
                    continue
                axes = (entry,) if isinstance(entry, str) else tuple(entry)
                n = 1
                for a in axes:
                    n *= mesh.shape[a]
                if dim % n != 0:
                    return False
    return True


# ---------------------------------------------------------------------------
# candidate enumeration
# ---------------------------------------------------------------------------

def _tp_options(per_pod: int) -> list[int]:
    out = []
    t = 1
    while t <= per_pod:
        if per_pod % t == 0:
            out.append(t)
        t *= 2
    return out


def enumerate_layouts(cfg: ModelConfig, shape: ShapeConfig,
                      mesh_sig: tuple) -> list[Layout]:
    """All candidate axis-role assignments for the cell, deterministic
    order.  The pod (DCN) axis is never re-sliced — only the within-pod
    ICI factor splits into TP × FSDP."""
    axes = dict(mesh_sig)
    pods = axes.pop("pod", 1)
    per_pod = 1
    for n in axes.values():
        per_pod *= n

    is_serve = shape.kind != "train"
    out: list[Layout] = []
    for tp in _tp_options(per_pod):
        dp = per_pod // tp
        if cfg.n_experts > 0:
            moes = ["fftp"]
            if tp > 1 and cfg.n_experts % tp == 0:
                moes.append("ep")
        else:
            moes = ["dense"]
        acts = ("dp", "sp") if shape.kind in ("train", "prefill") else ("dp",)
        serves = (False, True) if is_serve else (False,)
        for moe in moes:
            for act in acts:
                for serve_params in serves:
                    out.append(Layout(tp=tp, dp=dp, pods=pods, moe=moe,
                                      act=act, serve_params=serve_params))
    out.sort(key=Layout.key)
    return out


def fixed_layout(cfg: ModelConfig, shape: ShapeConfig,
                 mesh_sig: tuple) -> Layout:
    """The fixed-rule layout as a candidate: TP = the mesh's
    ``"model"`` axis, FSDP everywhere else, EP by predicate, dp
    activations, no serve-time replication."""
    axes = dict(mesh_sig)
    pods = axes.pop("pod", 1)
    tp = axes.get("model", 1)
    dp = 1
    for a, n in axes.items():
        if a != "model":
            dp *= n
    if cfg.n_experts > 0:
        moe = "ep" if (tp > 1 and cfg.n_experts % tp == 0) else "fftp"
    else:
        moe = "dense"
    return Layout(tp=tp, dp=dp, pods=pods, moe=moe, act="dp",
                  serve_params=False)


# ---------------------------------------------------------------------------
# the analytical cost model
# ---------------------------------------------------------------------------

def cost_layout(cfg: ModelConfig, shape: ShapeConfig, layout: Layout,
                hw: _hw.HardwareSpec = _hw.TPU_V5E) -> LayoutCost:
    """Modeled per-step roofline of one candidate: per-layer matmul
    compute, HBM traffic, ring-collective volumes, and exact (spec-tree)
    memory feasibility."""
    from repro_torch.models.lm import build_pattern
    from . import sharding as sh

    mesh = layout.mesh()
    tp, pods = layout.tp, layout.pods
    train = shape.kind == "train"
    decode = shape.is_decode
    bwd = 3.0 if train else 1.0
    B, S = shape.global_batch, shape.seq_len

    # tokens per device: batch shards over the FSDP group (pod, data)
    beff = _group_eff(B, [pods, layout.dp])
    t = (B / beff) * (S if not decode else 1)
    s_ctx = float(S)                   # attended context length

    d, f, V = cfg.d_model, cfg.d_ff, cfg.vocab
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    eff_h = _eff(H, tp)
    eff_kv = _eff(KV, tp)
    eff_f = _eff(f, tp) if f else 1
    eff_v = _eff(V, tp)

    pattern = build_pattern(cfg)
    L = cfg.n_layers
    reps = L / len(pattern)

    flops = 0.0
    coll = {"all-gather": 0.0, "all-reduce": 0.0, "reduce-scatter": 0.0,
            "all-to-all": 0.0, "dcn": 0.0}
    ar_payload = t * d * ACT_BYTES     # one residual-stream tensor

    n_mats = 3 if cfg.mlp_type in ("swiglu", "geglu") else 2
    for spec in pattern:
        if spec.kind == "attn":
            flops += reps * 2 * t * d * H * hd / eff_h * 2      # wq + wo
            flops += reps * 2 * t * d * KV * hd * 2 / eff_kv    # wk + wv
            w = float(min(spec.window or S, S))
            dens = 1.0 if decode else 0.5                       # causal
            flops += reps * 4 * t * min(w, s_ctx) * H * hd / eff_h * dens
            if eff_h > 1:
                coll["all-reduce"] += reps * _hw.all_reduce_bytes(
                    ar_payload, eff_h)
        else:                                    # mamba | mlstm
            di = cfg.ssm_expand * d
            eff_di = _eff(di, tp)
            if spec.kind == "mamba":
                body = 2 * t * d * di * 3 + 26 * t * di * cfg.ssm_state
            else:                                # mlstm
                hdi = di // max(H, 1)
                body = 8 * t * d * di + 5.5 * t * di * hdi
            flops += reps * body / eff_di
            if eff_di > 1:
                coll["all-reduce"] += reps * _hw.all_reduce_bytes(
                    ar_payload, eff_di)

        if spec.kind == "attn" or cfg.block_type != "xlstm":
            if cfg.n_experts > 0 and spec.use_moe:
                flops += reps * 2 * t * d * cfg.n_experts       # router
                e_div = tp if layout.moe == "ep" else eff_f
                flops += reps * n_mats * 2 * t * d * f * cfg.top_k / e_div
                if layout.moe == "ep" and tp > 1:
                    # tokens split across the EP group before dispatch,
                    # so each device re-buckets t/tp of the routed payload
                    payload = t * cfg.top_k * d * ACT_BYTES / tp
                    coll["all-to-all"] += reps * 2 * _hw.all_to_all_bytes(
                        payload, tp)
                elif eff_f > 1:
                    coll["all-reduce"] += reps * _hw.all_reduce_bytes(
                        ar_payload, eff_f)
            elif f:
                flops += reps * n_mats * 2 * t * d * f / eff_f
                if eff_f > 1:
                    coll["all-reduce"] += reps * _hw.all_reduce_bytes(
                        ar_payload, eff_f)

    # vocab-parallel head: logits matmul + (serve) logit assembly
    flops += 2 * t * d * V / eff_v
    if eff_v > 1 and not train:
        coll["all-gather"] += _hw.all_gather_bytes(t * V * ACT_BYTES, eff_v)
    flops *= bwd
    for k in ("all-reduce", "all-to-all"):
        coll[k] *= bwd

    # ---- exact per-leaf parameter / optimizer / cache accounting ----------
    params_abs, cache_abs = _abstract_state(cfg, shape)
    moe_role = None if layout.moe == "dense" else layout.moe
    pspecs = sh.param_specs(mesh, cfg, params_abs,
                            serve=layout.serve_params, moe=moe_role)
    pacc = _tree_accounting(mesh, pspecs, params_abs)

    # sequence-parallel residuals shard the checkpoint/working set over TP
    act_shard = _eff(S, tp) if layout.act == "sp" else 1

    mem = {"params": pacc["stored"]}
    if train:
        from repro_torch.launch.train import default_microbatches
        facc = pacc        # train layouts never replicate (serve) params
        mem["optimizer"] = facc["stored"] * 4       # m + v in f32
        mem["grads"] = facc["stored"] * 2           # f32 accumulators
        # accumulation depth adapts to the activation budget: start at the
        # throughput-picked default and deepen (power of two, ≥ 1 sequence
        # per microbatch) until the remat checkpoints fit
        n_mb = default_microbatches(cfg, shape, max(beff, 1))
        budget = hw.hbm_bytes * hw.hbm_usable - (
            mem["params"] + mem["optimizer"] + mem["grads"])

        def act_of(n: int) -> float:
            return 2 * (t / n) * d * L * ACT_BYTES / act_shard

        max_mb = max(1, int(B // max(beff, 1)))
        while act_of(n_mb) > max(budget, 0.0) and n_mb * 2 <= max_mb:
            n_mb *= 2
        mem["activations"] = act_of(n_mb)
        # re-gather params per microbatch (scan body), scatter grads once
        coll["all-gather"] += facc["gather"] * n_mb
        coll["reduce-scatter"] += facc["scatter"]
        if pods > 1:
            grad_dev = facc["stored"] * 2
            coll["dcn"] += _hw.all_reduce_bytes(grad_dev, pods)
    else:
        if not layout.serve_params:
            # fixed rules keep FSDP at serve time: re-gather every step
            coll["all-gather"] += pacc["gather"]
        cacc = _tree_accounting(mesh, sh.cache_specs(
            mesh, cfg, shape, cache_abs), cache_abs)
        mem["cache"] = cacc["stored"]
        mem["activations"] = 4 * t * d * ACT_BYTES / act_shard

    # ---- HBM traffic term --------------------------------------------------
    hbm = mem["params"] * (2.0 if train else 1.0)      # weights read/updated
    if train:
        hbm += mem["optimizer"] + mem["grads"]
        hbm += mem["activations"] * 4                  # remat re-reads
    else:
        hbm += mem.get("cache", 0.0) * (1.0 if decode else 0.5)
        hbm += mem["activations"] * 4

    mem["total"] = sum(mem.values())
    feasible = mem["total"] <= hw.hbm_bytes * hw.hbm_usable

    ici_bytes = sum(coll[k] for k in ("all-gather", "all-reduce",
                                      "reduce-scatter", "all-to-all"))
    terms = {
        "compute": _hw.compute_time(flops, hw),
        "memory": _hw.memory_time(hbm, hw),
        "collective": (_hw.collective_time(ici_bytes, hw)
                       + _hw.collective_time(coll["dcn"], hw, dcn=True)),
    }
    step = _hw.step_time(**{f"{k}_s": v for k, v in terms.items()}) \
        if feasible else float("inf")
    coll["total"] = ici_bytes + coll["dcn"]
    return LayoutCost(layout, terms, coll, mem, feasible, step)


# ---------------------------------------------------------------------------
# search (memoized, deterministic)
# ---------------------------------------------------------------------------

_MEMO: dict = {}


def clear_memo() -> None:
    _MEMO.clear()
    _ABS_CACHE.clear()


def search(cfg: ModelConfig, shape: ShapeConfig, mesh_sig: tuple,
           hw: _hw.HardwareSpec = _hw.TPU_V5E) -> PlanResult:
    """Enumerate → cost → select for one cell.  The fixed-rule layout is
    always in the candidate set, so the winner beats or ties it on
    modeled step time by construction; ties break on :meth:`Layout.key`.
    Results are memoized per (config, shape, mesh, hw)."""
    key = (cfg, shape, mesh_sig, hw)
    if key in _MEMO:
        return _MEMO[key]

    fixed = fixed_layout(cfg, shape, mesh_sig)
    layouts = enumerate_layouts(cfg, shape, mesh_sig)
    if fixed not in layouts:
        layouts.append(fixed)
    costs = [cost_layout(cfg, shape, lay, hw) for lay in layouts]
    by_layout = {c.layout: c for c in costs}
    fixed_cost = by_layout[fixed]

    feasible = [c for c in costs if c.feasible]
    pool = feasible if feasible else [fixed_cost]
    winner = min(pool, key=lambda c: (c.step_time, c.layout.key()))

    result = PlanResult(cfg, shape, mesh_sig, winner, fixed_cost,
                        sorted(costs, key=lambda c: (c.step_time,
                                                     c.layout.key())))
    _MEMO[key] = result
    return result


def plan_layout(mesh, cfg: ModelConfig, shape: ShapeConfig,
                fallback: Optional[Layout] = None) -> Layout:
    """Consumer entry point: the best *realizable* searched layout for a
    real mesh.  A real mesh's axis sizes are fixed and the runtime MoE
    layout follows the EP predicate, so the
    applied candidate must match the mesh's physical TP degree and the
    predicate's expert role — the search report's overall winner may
    additionally recommend re-slicing TP or re-sharding experts, which
    stays advisory until the mesh/model is rebuilt.  When no realizable
    candidate is feasible (or the planner fails), returns ``fallback``
    (default: the fixed-rule layout) — the contract ``layout="auto"``
    relies on.  A planner failure warns (``RuntimeWarning``) and returns
    ``fallback``."""
    sig = signature_of(mesh)
    fixed = fixed_layout(cfg, shape, sig)
    if fallback is None:
        fallback = fixed
    try:
        res = search(cfg, shape, sig)
        for c in res.candidates:           # sorted (step_time, key)
            if (c.feasible and c.layout.tp == fixed.tp
                    and c.layout.moe == fixed.moe):
                return c.layout
        return fallback
    except Exception as e:                 # noqa: BLE001 - reported, and
        import warnings                    # consumers stay alive
        warnings.warn(f"layout planner failed for {cfg.name} × "
                      f"{shape.name} ({type(e).__name__}: {e}); "
                      "using the fixed-rule fallback", RuntimeWarning)
        return fallback


#: plan_layout fallback sentinel: lets auto_variant tell "planner chose
#: the fixed layout" apart from "planner failed / nothing realizable"
_NO_PLAN = object()


def auto_variant(mesh, cfg: ModelConfig, shape: ShapeConfig,
                 variant: Optional[dict] = None) -> dict:
    """Merge the searched layout into a dry-run variant dict without
    overriding explicit keys (explicit hillclimb arms win).  On planner
    failure or no realizable candidate the variant is returned
    *unchanged* — the lowered cell is then exactly the fixed-rule
    baseline, not a half-applied layout."""
    out = dict(variant or {})
    lay = plan_layout(mesh, cfg, shape, fallback=_NO_PLAN)
    if lay is _NO_PLAN:
        return out
    out.setdefault("act", lay.act)
    if lay.serve_params:
        out.setdefault("serve_params", True)
    return out


# ---------------------------------------------------------------------------
# reports
# ---------------------------------------------------------------------------

def write_report(result: PlanResult, *, name: str, mesh_name: str,
                 out_dir: Optional[Path] = None) -> Path:
    out_dir = Path(out_dir) if out_dir else REPORT_DIR
    out_dir.mkdir(parents=True, exist_ok=True)
    path = out_dir / f"{name}__{result.shape.name}__{mesh_name}.json"
    path.write_text(json.dumps(result.to_dict(), indent=1))
    return path


def main() -> None:
    import argparse
    from repro_torch.configs import MESH_SHAPES, SHAPES, all_configs, applicable

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--mesh", default=None,
                    choices=[None, *MESH_SHAPES], help="limit to one mesh")
    ap.add_argument("--out", default=None,
                    help=f"report directory (default {REPORT_DIR})")
    args = ap.parse_args()

    meshes = {args.mesh: MESH_SHAPES[args.mesh]} if args.mesh \
        else MESH_SHAPES
    rows = ["| arch | shape | mesh | fixed ms | auto ms | speedup | "
            "winner |", "|---|---|---|---|---|---|---|"]
    for arch, cfg in all_configs().items():
        for shape in SHAPES.values():
            if not applicable(cfg, shape):
                continue
            for mesh_name, mesh_shape in meshes.items():
                res = search(cfg, shape, signature_of(mesh_shape))
                write_report(res, name=arch, mesh_name=mesh_name,
                             out_dir=args.out)
                w = res.winner.layout
                rows.append(
                    f"| {arch} | {shape.name} | {mesh_name} "
                    f"| {res.fixed.step_time * 1e3:.2f} "
                    f"| {res.winner.step_time * 1e3:.2f} "
                    f"| {res.speedup:.2f}x "
                    f"| tp={w.tp} moe={w.moe} act={w.act} "
                    f"serve_params={w.serve_params} |")
    print("\n".join(rows))


if __name__ == "__main__":
    main()
