"""§Perf hillclimb (the reference's ``repro.launch.hillclimb``):
run the chosen cells under each optimization variant on an H100
production mesh (the dry-run's ``meta`` run under a recording mesh,
:mod:`.dryrun_lib`), recording variant-tagged statistics; the variants
whose FLOPs and bytes change need cost probes (:data:`PROBE_VARIANTS`,
``costing.probe_cell``), run separately.

``--layout auto`` re-runs the arms under the planner-searched layout
(``repro_torch.dist.planner``) instead of the fixed sharding rules;
explicit variant keys (``act``, ``serve_params``) still win over the
planner's choices, so each arm measures exactly what it names.

The ``fusion: "gen"`` arm routes the CE loss through the staged fusion
pipeline (``launch/train._fused_lse``); its backward is the planned
gradient DAG, so the arm runs generated fused operators in both
directions of the train step.

  PYTHONPATH=src python -m repro_torch.launch.hillclimb [--mesh h100]
"""

from __future__ import annotations

import traceback

CELLS = {
    # (arch, shape): [(variant_tag, variant_dict), ...]
    ("yi-34b", "prefill_32k"): [
        ("actdp", {"act": "dp"}),
        ("actsp", {"act": "sp"}),
        ("actdp-servep", {"act": "dp", "serve_params": True}),
    ],
    ("grok-1-314b", "train_4k"): [
        ("actdp", {"act": "dp"}),
        ("actdp-capmoe", {"act": "dp", "moe_impl": "capacity"}),
    ],
    ("olmoe-1b-7b", "train_4k"): [
        ("actdp", {"act": "dp"}),
        ("actdp-capmoe", {"act": "dp", "moe_impl": "capacity"}),
        ("actdp-fusedloss", {"act": "dp", "fusion": "gen"}),
    ],
    # bonus: decode memory/collective lever
    ("yi-34b", "decode_32k"): [
        ("servep", {"serve_params": True}),
        ("servep-gqagrp", {"serve_params": True, "gqa_grouped": True}),
    ],
}

#: variants whose FLOPs/bytes change (need probes): (arch, shape, tag,
#: variant)
PROBE_VARIANTS = [
    ("grok-1-314b", "train_4k", "capmoe", {"moe_impl": "capacity"}),
    ("olmoe-1b-7b", "train_4k", "capmoe", {"moe_impl": "capacity"}),
    ("yi-34b", "decode_32k", "gqagrp", {"gqa_grouped": True}),
]


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--layout", default="fixed", choices=("fixed", "auto"))
    ap.add_argument("--mesh", default="h100",
                    choices=("h100", "h100x2", "both"))
    args = ap.parse_args(argv)

    from repro_torch.launch.dryrun_lib import run_cell
    from repro_torch.launch.mesh import (make_production_mesh,
                                         production_mesh_name)

    failures = 0
    for multi, arm in ((False, "h100"), (True, "h100x2")):
        if args.mesh not in (arm, "both"):
            continue
        mesh = make_production_mesh(multi_pod=multi)
        name = production_mesh_name(multi_pod=multi)
        for (arch, shape), variants in CELLS.items():
            for tag, variant in variants:
                try:
                    fusion = variant.get("fusion", "off")
                    rec = run_cell(arch, shape, mesh, name, fusion=fusion,
                                   variant=variant, variant_tag=tag,
                                   layout=args.layout)
                    coll = rec["collective_bytes_per_device_trip_corrected"]
                    print(f"OK   {arch} × {shape} × {name} [{tag}]: "
                          f"coll/dev={coll['total']:.3e} "
                          f"rawflops={rec['flops_per_device']:.3e} "
                          f"rawbytes={rec['bytes_per_device']:.3e}",
                          flush=True)
                except Exception as e:
                    failures += 1
                    print(f"FAIL {arch} × {shape} × {name} [{tag}]: "
                          f"{type(e).__name__}: {e}", flush=True)
                    traceback.print_exc()
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())
