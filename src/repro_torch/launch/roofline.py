"""Roofline analysis from the dry-run's records (the reference's
``repro.launch.roofline``).

Three terms per (arch × shape × mesh), all seconds per step, per device
(the dry-run records one rank's program, so its FLOPs, bytes and
collective bytes are per device):

  compute    = flops_per_device / hw.peak_flops
  memory     = bytes_per_device / hw.hbm_bw
  collective = collective bytes / link rate

plus MODEL_FLOPS (6·N_active·tokens for training, 2·N_active·tokens for
prefill and decode) and the usefulness ratio MODEL/counted.  ``hw``
defaults to :data:`repro_torch.hw.H100_SXM` (datasheet figures, not
measured); the collective term times the model group's bytes over
NVLink (``ici_bw``) and a group's bytes that span nodes (the row group on
the H100 meshes, whose model axis fills a node of 8) over the inter-node
link (``dcn_bw``).  A record without per-group bytes (the reference's)
times its total over ``ici_bw``, as the reference does.  Every figure is
model output, not a measurement.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.roofline [--mesh h100x256]
"""

from __future__ import annotations

import json
import warnings
from pathlib import Path

from repro_torch.configs import SHAPES, all_configs
from repro_torch.hw import H100_SXM, HardwareSpec

RESULTS_DIR = Path(__file__).resolve().parents[3] / "experiments" \
    / "dryrun_torch"
PROBE_DIR = Path(__file__).resolve().parents[3] / "experiments" \
    / "costing_torch"

#: the cards of a node that one NVLink domain joins
NODE = 8


def model_flops_per_device(arch: str, shape_name: str, devices: int,
                           n_microbatches_hint: int = 1) -> float:
    cfg = all_configs()[arch]
    shape = SHAPES[shape_name]
    n_act = cfg.active_params
    if shape.kind == "train":
        tokens = shape.seq_len * shape.global_batch
        return 6.0 * n_act * tokens / devices
    if shape.kind == "prefill":
        tokens = shape.seq_len * shape.global_batch
        return 2.0 * n_act * tokens / devices
    tokens = shape.global_batch            # one new token per sequence
    return 2.0 * n_act * tokens / devices


def model_bytes_per_device(arch: str, shape_name: str,
                           devices: int) -> float:
    """Analytic HBM-traffic floor (bytes per step per device), bf16:
    training reads the weights forward and backward and writes gradients
    (3× weight bytes) and round-trips activations; prefill streams the
    weights once and writes the KV cache; decode streams the weights and
    reads the whole KV cache per token.  A floor, not a count."""
    cfg = all_configs()[arch]
    shape = SHAPES[shape_name]
    bpe = 2.0                               # bf16
    wbytes = bpe * cfg.total_params / devices
    d, hd = cfg.d_model, cfg.hd
    if shape.kind == "train":
        tokens = shape.seq_len * shape.global_batch / devices
        act = bpe * tokens * d * cfg.n_layers
        return 3.0 * wbytes + 2.0 * act
    if shape.kind == "prefill":
        tokens = shape.seq_len * shape.global_batch / devices
        act = bpe * tokens * d * cfg.n_layers
        kv = 2.0 * bpe * tokens * cfg.n_kv_heads * hd * cfg.n_layers
        return wbytes + act + kv
    seqs = shape.global_batch / devices     # decode: one token per sequence
    kv = (2.0 * bpe * seqs * shape.seq_len * cfg.n_kv_heads * hd
          * cfg.n_layers)
    return wbytes + kv


def _probe(arch: str, shape: str):
    p = PROBE_DIR / f"{arch}__{shape}.json"
    return json.loads(p.read_text()) if p.exists() else None


def spans_nodes(mesh_shape: dict, group: str, node: int = NODE) -> bool:
    """Whether a group of the record's ``groups`` labels (``"model/8"``,
    ``"row/32"``, ``"row:data/32"``, ``"all/256"``) joins ranks of more
    than one node of ``node`` ranks (ranks row-major over the mesh, rank
    0's group)."""
    from repro_torch.dist.sharding import mesh_coords
    label = group.rsplit("/", 1)[0]
    names = tuple(mesh_shape)
    if label == "model":
        axes = ("model",)
    elif label == "all":
        axes = names
    elif label == "row":
        axes = tuple(a for a in names if a != "model")
    else:
        axes = tuple(label.split(":", 1)[1].split(","))

    class _M:
        shape, axis_names = mesh_shape, names
    world = 1
    for v in mesh_shape.values():
        world *= v
    nodes = {q // node for q in range(world)
             if all(mesh_coords(_M, q)[a] == 0 for a in names
                    if a not in axes)}
    return len(nodes) > 1


def collective_seconds(rec: dict, hw: HardwareSpec) -> float:
    """The collective term: per-group bytes over NVLink within a node and
    over the inter-node link across nodes; a record without per-group
    bytes, its total over ``ici_bw``."""
    coll = rec.get("collective_bytes_per_device_trip_corrected",
                   rec["collective_bytes_per_device"])
    groups = coll.get("group_bytes")
    shape = rec.get("mesh_shape")
    if not groups or not shape:
        return coll["total"] / hw.ici_bw
    return sum(b / (hw.dcn_bw if spans_nodes(shape, g) else hw.ici_bw)
               for g, b in groups.items())


def analyze(rec: dict, hw: HardwareSpec = H100_SXM) -> dict:
    """Three-term roofline.  FLOPs/bytes come from the probe
    extrapolation (:mod:`.costing`) where it has run, else the analytic
    model (with a warning); collectives from the recording; everything
    per device per step."""
    devices = rec["devices"]
    probe = _probe(rec["arch"], rec["shape"])
    if probe is not None:
        flops_dev = probe["total_flops"] / devices
        bytes_dev = probe["total_bytes"] / devices
        source = "probe"
    else:
        flops_dev = model_flops_per_device(rec["arch"], rec["shape"],
                                           devices)
        bytes_dev = model_bytes_per_device(rec["arch"], rec["shape"],
                                           devices)
        source = "analytic"
        warnings.warn(
            f"no probe record for {rec['arch']}×{rec['shape']}: "
            "FLOPs/bytes normalized to the analytic model "
            "(cost_source='analytic'); run repro_torch.launch.costing to "
            "make the probes", RuntimeWarning, stacklevel=2)
    t_comp = flops_dev / hw.peak_flops
    t_mem = bytes_dev / hw.hbm_bw
    t_coll = collective_seconds(rec, hw)
    mf = model_flops_per_device(rec["arch"], rec["shape"], devices)
    terms = {"compute": t_comp, "memory": t_mem, "collective": t_coll}
    dom = max(terms, key=terms.get)
    bound = max(terms.values())
    useful = mf / max(flops_dev, 1.0)
    # roofline fraction: useful-model-compute time over the bound
    frac = (mf / hw.peak_flops) / bound if bound > 0 else 0.0
    return dict(rec, terms=terms, dominant=dom, model_flops=mf,
                useful_ratio=useful, roofline_fraction=frac,
                flops_per_device_corrected=flops_dev,
                bytes_per_device_corrected=bytes_dev,
                cost_source=source, hw=hw.name)


SUGGEST = {
    "compute": "cut overcompute (MoE dense→ragged dispatch) or raise "
               "arithmetic intensity",
    "memory": "fuse bandwidth-bound chains / reuse KV reads "
              "(larger per-step batch, bf16 states)",
    "collective": "re-shard to cut all-gather volume (smaller TP span, "
                  "FSDP prefetch overlap, gradient compression)",
}


def load_all(mesh: str | None = None, fusion: str | None = None,
             variant: str = "baseline", layout: str = "fixed",
             hw: HardwareSpec = H100_SXM):
    recs = []
    for p in sorted(RESULTS_DIR.glob("*.json")):
        rec = json.loads(p.read_text())
        if mesh and rec["mesh"] != mesh:
            continue
        if (fusion or "off") != rec.get("fusion", "off"):
            continue
        if rec.get("variant", "baseline") != variant:
            continue
        if rec.get("layout", "fixed") != layout:
            continue
        recs.append(analyze(rec, hw=hw))
    return recs


def table(recs: list[dict]) -> str:
    hdr = ("| arch | shape | mesh | compute s | memory s | collective s | "
           "dominant | MODEL/counted | roofline frac |\n"
           "|---|---|---|---|---|---|---|---|---|")
    rows = [hdr]
    for r in sorted(recs, key=lambda r: (r["arch"], r["shape"], r["mesh"])):
        t = r["terms"]
        rows.append(
            f"| {r['arch']} | {r['shape']} | {r['mesh']} "
            f"| {t['compute']:.3e} | {t['memory']:.3e} "
            f"| {t['collective']:.3e} | **{r['dominant']}** "
            f"| {r['useful_ratio']:.2f} | {r['roofline_fraction']:.2f} |")
    return "\n".join(rows)


def main(argv=None) -> None:
    import argparse
    ap = argparse.ArgumentParser()
    ap.add_argument("--mesh", default=None)
    ap.add_argument("--fusion", default="off")
    args = ap.parse_args(argv)
    recs = load_all(args.mesh, args.fusion)
    if not recs:
        print("no dry-run records found — run repro_torch.launch.dryrun "
              "first")
        return
    print(table(recs))
    print()
    worst = sorted((r for r in recs if r["mesh"] == "h100x256"),
                   key=lambda r: r["roofline_fraction"])
    if worst:
        print("worst roofline fractions (h100x256):")
        for r in worst[:5]:
            print(f"  {r['arch']} × {r['shape']}: "
                  f"{r['roofline_fraction']:.3f} ({r['dominant']}-bound"
                  f" → {SUGGEST[r['dominant']]})")


if __name__ == "__main__":
    main()
