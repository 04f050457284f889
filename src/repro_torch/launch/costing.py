"""Whole-cell FLOP and byte accounting (the reference's
``repro.launch.costing``).

The dry-run (:mod:`.dryrun_lib`) counts the Mamba and mLSTM recurrences'
loop body once, as XLA's ``cost_analysis`` counts a ``while`` body once in
the reference.  So, as the reference does, the totals come from probes:
miniature variants of the cell (G ∈ {1, 2} layer groups, M ∈ {1, 2}
microbatches, dense attention) run on ``meta`` under a small recording
mesh, solving the affine model f(G, M) = o₀ + o₁·G + M·(b + c·G) for the
per-group (c), per-microbatch (b) and optimizer (o₁, o₀) parts, evaluated
at the production (G, M); the FLOPs that live inside sequence loops
(Mamba / mLSTM cells, chunked-attention recompute) are added in closed
form (:func:`_seq_scan_flops`, the reference's).

The reference's trip-corrected collective accounting (``parse_hlo``,
``trip_count``, ``corrected_collectives``) has no counterpart: the
recording mesh counts every collective as an eager run issues it.
"""

from __future__ import annotations

import json
from dataclasses import replace
from pathlib import Path

from repro_torch.configs import SHAPES, get_config
from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.models.lm import build_pattern

RESULTS_DIR = Path(__file__).resolve().parents[3] / "experiments" \
    / "costing_torch"

#: the probes' mesh (the reference's (4, 2) host mesh)
PROBE_MESH = {"data": 4, "model": 2}

#: the data-parallel size whose default microbatch count the totals are
#: evaluated at (``h100x256``'s data axis)
PROBE_DP = 32


def _probe_cfg(cfg: ModelConfig, n_groups: int) -> ModelConfig:
    P = len(build_pattern(cfg))
    return replace(cfg, n_layers=n_groups * P, scan_layers=False,
                   attn_chunk=0)


def _measure(arch: str, cfg, shape_name: str, mesh,
             n_mb: int) -> tuple[float, float]:
    """(total flops, total bytes) of one probe variant: its rank's counts
    times the mesh's devices."""
    from repro_torch.launch.dryrun_lib import measure_cell
    variant = {"n_mb": n_mb} if SHAPES[shape_name].kind == "train" else None
    rec = measure_cell(arch, shape_name, mesh, variant=variant, cfg=cfg)
    n_dev = 1
    for v in mesh.shape.values():
        n_dev *= v
    return (rec["flops_per_device"] * n_dev, rec["bytes_per_device"] * n_dev)


def _seq_scan_flops(cfg: ModelConfig, shape: ShapeConfig) -> float:
    """Analytic FLOPs living inside sequence scans (counted once by the
    probes): Mamba/mLSTM cell steps and chunked-attention recompute."""
    pattern = build_pattern(cfg)
    L = cfg.n_layers
    per = len(pattern)
    if shape.kind == "train":
        B, S = shape.global_batch, shape.seq_len
        bwd_mult = 3.0       # fwd + ~2x bwd (scan body differentiated)
    elif shape.kind == "prefill":
        B, S = shape.global_batch, shape.seq_len
        bwd_mult = 1.0
    else:
        return 0.0           # decode: single step, fully counted

    total = 0.0
    n_mamba = sum(s.kind == "mamba" for s in pattern) * (L // per)
    n_mlstm = sum(s.kind == "mlstm" for s in pattern) * (L // per)
    n_attn = sum(s.kind == "attn" for s in pattern) * (L // per)
    if n_mamba:
        di, N = cfg.ssm_expand * cfg.d_model, cfg.ssm_state
        total += n_mamba * B * S * di * N * 26.0 * bwd_mult
    if n_mlstm:
        di = cfg.ssm_expand * cfg.d_model
        hd = di // cfg.n_heads
        total += n_mlstm * B * S * cfg.n_heads * hd * hd * 5.5 * bwd_mult
    if shape.kind == "train" and cfg.attn_chunk and n_attn:
        # chunk-body remat: one extra attention forward in the backward
        # (0.5 ≈ causal-mask effective score density)
        for s in pattern:
            if s.kind != "attn":
                continue
            s_eff = min(s.window or S, S)
            total += (L // per) * 4.0 * B * S * s_eff \
                * cfg.n_heads * cfg.hd * 0.5
    return total


def probe_cell(arch: str, shape_name: str, probe_mesh, *,
               save: bool = True, force: bool = False,
               variant: dict | None = None, variant_tag: str = "",
               dp: int = PROBE_DP) -> dict:
    """Extrapolated total (flops, bytes) for the production cell, under
    ``experiments/costing_torch/``."""
    tag = f"{arch}__{shape_name}" + (f"__{variant_tag}" if variant_tag
                                     else "")
    out_path = RESULTS_DIR / f"{tag}.json"
    if save and out_path.exists() and not force:
        return json.loads(out_path.read_text())

    cfg = get_config(arch)
    if variant:
        from repro_torch.launch.dryrun_lib import apply_variant
        cfg = apply_variant(cfg, variant)
    shape = SHAPES[shape_name]
    P = len(build_pattern(cfg))
    G_full = cfg.n_layers / P

    if shape.kind == "train":
        from repro_torch.launch import train as train_lib
        f, b = {}, {}
        for (g, m) in ((1, 1), (2, 1), (1, 2), (2, 2)):
            f[(g, m)], b[(g, m)] = _measure(arch, _probe_cfg(cfg, g),
                                            shape_name, probe_mesh, m)

        def extrap(v):
            c = v[(2, 2)] - v[(2, 1)] - v[(1, 2)] + v[(1, 1)]
            bb = v[(1, 2)] - v[(1, 1)] - c
            o1 = v[(2, 1)] - v[(1, 1)] - c
            o0 = v[(1, 1)] - o1 - bb - c
            M = train_lib.default_microbatches(cfg, shape, dp)
            return o0 + o1 * G_full + M * (bb + c * G_full)

        flops, bytes_ = extrap(f), extrap(b)
    else:
        f1, b1 = _measure(arch, _probe_cfg(cfg, 1), shape_name, probe_mesh,
                          1)
        f2, b2 = _measure(arch, _probe_cfg(cfg, 2), shape_name, probe_mesh,
                          1)
        cf, cb = f2 - f1, b2 - b1
        flops = (f1 - cf) + cf * G_full
        bytes_ = (b1 - cb) + cb * G_full

    flops += _seq_scan_flops(cfg, shape)
    rec = {"arch": arch, "shape": shape_name,
           "total_flops": flops, "total_bytes": bytes_}
    if save:
        RESULTS_DIR.mkdir(parents=True, exist_ok=True)
        out_path.write_text(json.dumps(rec, indent=1))
    return rec


def main(argv=None) -> int:
    """Probe every live cell (``--arch`` / ``--shape`` to pick some)."""
    import argparse
    ap = argparse.ArgumentParser()
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    args = ap.parse_args(argv)
    from repro_torch.configs import all_configs, cells
    from repro_torch.dist import RecordingMesh
    failures = 0
    for arch, shape in cells(all_configs()):
        if args.arch not in (None, arch) or args.shape not in (None, shape):
            continue
        try:
            rec = probe_cell(arch, shape, RecordingMesh(PROBE_MESH),
                             force=args.force)
            print(f"OK   {arch:18s} {shape:12s} "
                  f"flops={rec['total_flops']:.3e} "
                  f"bytes={rec['total_bytes']:.3e}", flush=True)
        except Exception as e:
            failures += 1
            print(f"FAIL {arch} {shape}: {type(e).__name__}: {e}",
                  flush=True)
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())
