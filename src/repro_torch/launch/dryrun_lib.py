"""Dry-run machinery (the reference's ``repro.launch.dryrun_lib``): run
one rank's step of every (arch × shape × mesh) cell on the ``meta``
device under a :class:`~repro_torch.dist.RecordingMesh` and extract its
memory, FLOP and collective statistics for the roofline analysis.

The reference lowers the global SPMD program through XLA and reads the
compiled per-device module's cost and memory analyses and its HLO.  The
port has no compiler in between: the program a rank really runs — the
model placed on the rank's blocks (``LM.shard_``), the sharded train step
(``launch.train.make_train_step(mesh=)``) or the prefill / decode step —
is run once on ``meta`` tensors (shapes and dtypes, no allocation), and:

* ``flops_per_device``: ``torch.utils.flop_counter.FlopCounterMode``;
* ``bytes_per_device``: the bytes in and out of every aten op that is not
  a view, an unfused count (:class:`OpBytes`);
* ``collective_bytes_per_device``: the recording mesh's
  :class:`~repro_torch.dist.CollectiveLog` (ring formulas); the
  ``_trip_corrected`` record is the same — an eager run issues every
  iteration's collectives, so there is no loop trip to correct;
* ``memory``: ``argument_bytes`` the rank's parameters, optimizer state,
  cache and batch block; ``output_bytes`` the step's new outputs;
  ``alias_bytes`` the outputs written into the arguments (the updated
  parameters, moments, cache); ``temp_bytes`` the peak of live ``meta``
  bytes the step allocated beyond its arguments.

Like the reference's scanned programs, the Mamba and mLSTM recurrences
count their loop body once on ``meta`` (:func:`_scans_once`;
``launch.costing`` adds the rest in closed form).  A train step of M > 3
microbatches is counted from runs of two and three
(:func:`measure_train_cell`: its counts are affine in M).
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import time
import weakref
from pathlib import Path
from typing import Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from repro_torch.configs import SHAPES, get_config
from repro_torch.core import fusion_mode
from repro_torch.dist import sharding as sh
from repro_torch.launch import serve as serve_lib
from repro_torch.launch import train as train_lib
from repro_torch.launch.mesh import dp_size
from repro_torch.models import LM
from repro_torch.models import mamba as mamba_mod
from repro_torch.models import xlstm as xlstm_mod
from repro_torch.models.sharded import local_shape
from repro_torch.optim import adamw

RESULTS_DIR = Path(__file__).resolve().parents[3] / "experiments" \
    / "dryrun_torch"


class OpBytes(TorchDispatchMode):
    """Counts, over the aten ops dispatched inside it, the bytes each op
    reads and writes (its tensor inputs and outputs; views move nothing)
    and the live bytes of the tensors the ops allocate (an output that
    aliases no input, freed when its tensor is): :attr:`bytes`,
    :attr:`peak`."""

    def __init__(self):
        super().__init__()
        self.bytes = 0
        self.live = 0
        self.peak = 0

    @staticmethod
    def _n(t: torch.Tensor) -> int:
        return t.numel() * t.element_size()

    def _free(self, n: int) -> None:
        self.live -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        schema = func._schema
        if getattr(func, "is_view", False):
            return out
        ins = [t for t in tree_leaves((args, kwargs))
               if isinstance(t, torch.Tensor)]
        outs = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
        self.bytes += sum(self._n(t) for t in ins) + \
            sum(self._n(t) for t in outs)
        rets = schema.returns
        for i, t in enumerate(outs):
            aliased = i < len(rets) and rets[i].alias_info is not None
            if aliased:
                continue
            n = self._n(t)
            self.live += n
            weakref.finalize(t, self._free, n)
        self.peak = max(self.peak, self.live)
        return out


def _nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree)
               if isinstance(t, torch.Tensor))


def abstract_params(model: LM) -> dict:
    """The model's flat parameter state dict (``meta`` tensors where the
    model was built on ``meta``)."""
    return dict(model.state_dict())


def input_specs(arch: str, shape_name: str) -> dict:
    """``meta`` stand-ins for every model input of the cell."""
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    if shape.kind == "train":
        return train_lib.train_batch_specs(cfg, shape)
    if shape.kind == "prefill":
        return serve_lib.prefill_specs(cfg, shape)
    return serve_lib.decode_specs(cfg, shape)


def apply_variant(cfg, variant: Optional[dict]):
    """Apply §Perf variant config overrides (act/fusion keys are handled
    by the step wrapper, the rest are ModelConfig fields)."""
    if not variant:
        return cfg
    fields = {k: v for k, v in variant.items()
              if k not in ("act", "fusion", "serve_params", "n_mb")}
    return dataclasses.replace(cfg, **fields) if fields else cfg


def resolve_layout(arch: str, shape_name: str, mesh,
                   variant: Optional[dict], layout: str) -> Optional[dict]:
    """``layout="auto"``: merge the searched layout (``dist/planner``)
    into the variant dict — explicit variant keys win, and any planner
    failure falls back to the fixed rules (variant unchanged)."""
    if layout != "auto":
        return variant
    from repro_torch.dist import planner
    cfg = apply_variant(get_config(arch), variant)
    return planner.auto_variant(mesh, cfg, SHAPES[shape_name], variant)


def _real(t: torch.Tensor, device, gen=None) -> torch.Tensor:
    """A tensor of ``t``'s shape and dtype on ``device``: ``t`` itself on
    ``meta``; elsewhere zeros (integers) or N(0, 0.02²) draws from
    ``gen`` (the live runs that the recording is held to)."""
    device = torch.device(device)
    if device.type == "meta":
        return t if t.device.type == "meta" else \
            torch.empty(t.shape, dtype=t.dtype, device="meta")
    if not t.dtype.is_floating_point:
        return torch.zeros(t.shape, dtype=t.dtype, device=device)
    return (torch.randn(t.shape, generator=gen) * 0.02).to(device=device,
                                                             dtype=t.dtype)


def _local_cache(mesh, cfg, shape, model: LM) -> dict:
    whole = serve_lib.cache_specs_abstract(model, shape)
    cspecs = sh.cache_specs(mesh, cfg, shape, whole)
    return {part: [{k: _real(torch.empty(local_shape(mesh, spec[k],
                                                     v.shape),
                                         dtype=v.dtype, device="meta"),
                             mesh.device).zero_()
                    for k, v in layer.items()}
                   for layer, spec in zip(whole[part], cspecs[part])]
            for part in whole}


def _local_batch(mesh, cfg, batch: dict) -> dict:
    return {k: sh.local_shard(mesh, sh.batch_spec(mesh, cfg, v.shape[0],
                                                  v.dim() - 1), v)
            for k, v in batch.items()}


def build_cell(arch: str, shape_name: str, mesh, *, fusion: str = "off",
               variant: Optional[dict] = None, cfg=None,
               shape=None) -> tuple:
    """(run, arguments, model): one rank's step of the cell on ``mesh``
    (``mesh.coords``' rank), on ``mesh.device`` (``meta`` for a
    :class:`~repro_torch.dist.RecordingMesh`; a live mesh's runs have
    drawn weights and zero inputs); ``run()`` runs it once and returns its
    outputs; ``arguments`` is the tree of its inputs (the rank's
    parameters, optimizer state, cache and batch block).  ``cfg`` and
    ``shape`` replace the architecture's configuration and the named
    shape (the cost probes', the tests')."""
    cfg = apply_variant(get_config(arch) if cfg is None else cfg, variant)
    shape = SHAPES[shape_name] if shape is None else shape
    dev = mesh.device
    gen = torch.Generator().manual_seed(0)
    model = LM(cfg, device="meta").requires_grad_(False)
    serve = bool(variant and variant.get("serve_params"))
    pspecs = sh.param_specs(mesh, cfg, abstract_params(model), serve=serve)
    model.shard_(mesh, pspecs,
                 weights=lambda key, index: _real(torch.empty(
                     tuple(s.stop - s.start for s in index), device="meta"),
                     dev, gen))

    def real(tree: dict) -> dict:
        return {k: _real(v, dev, gen) for k, v in tree.items()}

    if shape.kind == "train":
        dp = dp_size(mesh)
        n_mb = (variant or {}).get(
            "n_mb", train_lib.default_microbatches(cfg, shape, dp))
        tc = train_lib.TrainConfig(n_microbatches=n_mb, fusion=fusion)
        step = train_lib.make_train_step(model, cfg, tc, mesh=mesh)
        params = dict(model.named_parameters())
        opt = adamw.init(params, tc.opt)
        batch = real(train_lib.train_batch_specs(cfg, shape))
        local = train_lib.batch_block(mesh, cfg, batch, model)
        args = {"params": params, "opt": opt, "batch": local}
        return (lambda: step(params, opt, batch)), args, model

    cache = _local_cache(mesh, cfg, shape, model)
    if shape.kind == "prefill":
        pre = serve_lib.make_prefill_step(model)
        batch = _local_batch(mesh, cfg,
                             real(serve_lib.prefill_specs(cfg, shape)))
        args = {"params": dict(model.named_parameters()), "cache": cache,
                "batch": batch}
        return (lambda: pre(batch["tokens"], cache,
                            prefix_emb=batch.get("patches"))), args, model

    step = serve_lib.make_serve_step(model)
    dspecs = serve_lib.decode_specs(cfg, shape)
    token = _local_batch(mesh, cfg, real({"token": dspecs["token"]}))["token"]
    args = {"params": dict(model.named_parameters()), "cache": cache,
            "batch": {"token": token, "pos": dspecs["pos"]}}
    pos = shape.seq_len - 1          # the step that reads the whole cache
    return (lambda: step(cache, token, pos)), args, model


def _scan_once(u, dt, B_, C_, A, h0):
    """``mamba._selective_scan`` with its loop's body run once: the
    step's ops, and outputs of the whole sequence's shape."""
    dA = torch.exp(dt[..., None] * A)
    hs = dt[..., None] * B_[:, :, None, :] * u[..., None]
    h = torch.addcmul(hs[:, 0], h0, dA[:, 0])
    y = torch.einsum("bldn,bln->bld", h[:, None].expand(hs.shape), C_)
    return y, h


def _mlstm_scan_once(st, q, k, v, ipre, logf):
    """``xlstm._mlstm_scan`` with its loop's body run once."""
    st, h = xlstm_mod._cell_step(st, (q[:, 0], k[:, 0], v[:, 0],
                                      ipre[:, 0], logf[:, 0]))
    return st, h[:, None].expand(q.shape)


@contextlib.contextmanager
def _scans_once():
    """The Mamba and mLSTM recurrences counted as the reference's compiled
    scans are, which XLA's cost analysis counts a ``while`` body once:
    inside the context each runs its loop's body once (``launch.costing``
    adds the other steps in closed form, ``_seq_scan_flops``).  Run step by
    step, a 32,768-token prefill would issue millions of ops on ``meta``.
    The models' code is untouched: the two scan functions are swapped in
    their modules for the run and restored after it."""
    saved = mamba_mod._selective_scan, xlstm_mod._mlstm_scan
    mamba_mod._selective_scan = _scan_once
    xlstm_mod._mlstm_scan = _mlstm_scan_once
    try:
        yield
    finally:
        mamba_mod._selective_scan, xlstm_mod._mlstm_scan = saved


def measure_cell(arch: str, shape_name: str, mesh, *, fusion: str = "off",
                 variant: Optional[dict] = None, cfg=None,
                 shape=None) -> dict:
    """One rank's step of the cell run once on ``meta``: its FLOPs, op
    bytes, collectives and memory (see the module doc), and the seconds
    the run took on the host."""
    from torch.utils.flop_counter import FlopCounterMode
    t0 = time.perf_counter()
    run, args, _model = build_cell(arch, shape_name, mesh, fusion=fusion,
                                   variant=variant, cfg=cfg, shape=shape)
    t_build = time.perf_counter() - t0
    ctx = contextlib.nullcontext()
    if variant and variant.get("act"):
        ctx = sh.activation_rules(mesh, variant["act"])
    # on meta a fused operator runs its plain version's ops (shapes only),
    # and a recurrence its loop's body once
    policy = contextlib.ExitStack()
    if torch.device(mesh.device).type == "meta":
        policy.enter_context(fusion_mode(kernels="never"))
        policy.enter_context(_scans_once())
    mesh.log.reset()
    counter = OpBytes()
    flops = FlopCounterMode(display=False)
    arg_ids = {id(t) for t in tree_leaves(args)
               if isinstance(t, torch.Tensor)}
    t0 = time.perf_counter()
    with ctx, policy, flops, counter:
        out = run()
    t_run = time.perf_counter() - t0
    outs = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
    alias = sum(t.numel() * t.element_size() for t in outs
                if id(t) in arg_ids)
    new = sum(t.numel() * t.element_size() for t in outs
              if id(t) not in arg_ids)
    coll = mesh.log.record()
    return {
        "flops_per_device": float(flops.get_total_flops()),
        "bytes_per_device": float(counter.bytes),
        "collective_bytes_per_device": coll,
        "collective_bytes_per_device_trip_corrected": coll,
        "memory": {"argument_bytes": _nbytes(args),
                   "output_bytes": new,
                   "temp_bytes": counter.peak,
                   "alias_bytes": alias},
        "time_lower_s": round(t_build, 2),
        "time_compile_s": round(t_run, 2),
    }


def measure_train_cell(arch: str, shape_name: str, mesh, *,
                       fusion: str = "off", variant: Optional[dict] = None,
                       cfg=None, shape=None) -> dict:
    """:func:`measure_cell` of a train cell whose step accumulates M > 3
    microbatches, from two runs of two and of three microbatches of the
    same size: from two on, a step's counts are affine in M (every
    microbatch runs the same forward, backward, accumulation and
    collectives; the gradient reductions and the update run once), so
    f(M) = f(2) + (M - 2)·(f(3) - f(2)) exactly, for the FLOPs, op bytes,
    every collective count and byte, and the arguments' bytes; the
    temporaries' peak is the three-microbatch run's (the accumulators and
    one microbatch's live tensors)."""
    cfg0 = apply_variant(get_config(arch) if cfg is None else cfg, variant)
    shape = SHAPES[shape_name] if shape is None else shape
    M = (variant or {}).get(
        "n_mb", train_lib.default_microbatches(cfg0, shape, dp_size(mesh)))
    if M <= 3:
        return measure_cell(arch, shape_name, mesh, fusion=fusion,
                            variant=variant, cfg=cfg, shape=shape)
    mb = shape.global_batch // M
    recs = [measure_cell(arch, shape_name, mesh, fusion=fusion,
                         variant=dict(variant or {}, n_mb=k), cfg=cfg,
                         shape=dataclasses.replace(shape,
                                                   global_batch=k * mb))
            for k in (2, 3)]

    def ext(a, b):
        if isinstance(a, dict):
            return {k: ext(a[k], b[k]) for k in a}
        if isinstance(a, (int, float)) and not isinstance(a, bool):
            v = a + (M - 2) * (b - a)
            return type(a)(v) if isinstance(a, int) else v
        return a
    out = ext(recs[0], recs[1])
    out["memory"]["temp_bytes"] = recs[1]["memory"]["temp_bytes"]
    out["time_lower_s"] = round(recs[0]["time_lower_s"]
                                + recs[1]["time_lower_s"], 2)
    out["time_compile_s"] = round(recs[0]["time_compile_s"]
                                  + recs[1]["time_compile_s"], 2)
    out["microbatches"] = {"M": M, "extrapolated_from": [2, 3]}
    return out


def run_cell(arch: str, shape_name: str, mesh, mesh_name: str, *,
             fusion: str = "off", save: bool = True,
             force: bool = False, variant: Optional[dict] = None,
             variant_tag: str = "", layout: str = "fixed") -> dict:
    """Run one cell's rank step on ``meta`` under ``mesh`` (a
    :class:`~repro_torch.dist.RecordingMesh`); return (and persist under
    ``experiments/dryrun_torch/``) its statistics in the reference's
    record keys.  ``layout="auto"`` runs under the planner-searched
    layout.  ``time_lower_s`` / ``time_compile_s`` are the host seconds
    of building the rank's step and of running it."""
    tag = f"{arch}__{shape_name}__{mesh_name}" + (
        f"__fusion-{fusion}" if fusion != "off" else "") + (
        f"__{variant_tag}" if variant_tag else "") + (
        f"__layout-{layout}" if layout != "fixed" else "")
    out_path = RESULTS_DIR / f"{tag}.json"
    if save and out_path.exists() and not force:
        return json.loads(out_path.read_text())

    resolved = resolve_layout(arch, shape_name, mesh, variant, layout)
    # "auto" that fell back (or added nothing) runs the fixed baseline:
    # recorded, so auto-vs-fixed comparisons cannot read it as searched
    layout_applied = layout == "auto" and resolved != dict(variant or {})
    measure = measure_train_cell if SHAPES[shape_name].kind == "train" \
        else measure_cell
    stats = measure(arch, shape_name, mesh, fusion=fusion, variant=resolved)
    n_dev = 1
    for v in mesh.shape.values():
        n_dev *= v
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
           "mesh_shape": dict(mesh.shape), "devices": n_dev,
           "fusion": fusion, "layout": layout,
           "layout_applied": layout_applied,
           "variant": variant_tag or "baseline", **stats}
    if save:
        RESULTS_DIR.mkdir(parents=True, exist_ok=True)
        out_path.write_text(json.dumps(rec, indent=1))
    return rec
