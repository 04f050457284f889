"""Dry-run: run one rank's step of every (architecture × input shape) cell
on the H100 production meshes — ``h100x256`` (32 nodes of 8) and
``h100x2x256`` (two such clusters, two row axes) — on the ``meta``
device under a recording mesh, printing memory, FLOP and collective
statistics (the roofline inputs; :mod:`.dryrun_lib`).  No card, no
process group: it runs on the CPU.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch xlstm-1.3b \\
      --shape decode_32k --mesh h100 [--layout auto] [--optimized]
"""

import argparse
import sys
import traceback


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="both",
                    choices=("h100", "h100x2", "both"))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--fusion", default="off")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--optimized", action="store_true",
                    help="apply the §Perf-winning variants: act=dp for "
                         "train/prefill, TP-only params + grouped GQA "
                         "for decode")
    ap.add_argument("--layout", default="fixed", choices=("fixed", "auto"),
                    help="auto: run under the planner-searched layout "
                         "(repro_torch.dist.planner) instead of the fixed "
                         "rules")
    ap.add_argument("--jobs", type=int, default=1,
                    help="cells run at once, each in a process of its own")
    args = ap.parse_args(argv)

    from repro_torch.configs import SHAPES, all_configs, cells

    if args.all:
        todo = cells(all_configs())
    else:
        if not (args.arch and args.shape):
            ap.error("--arch and --shape, or --all")
        todo = [(args.arch, args.shape)]

    meshes = [multi for multi, arm in ((False, "h100"), (True, "h100x2"))
              if args.mesh in (arm, "both")]
    jobs = []
    for arch, shape in todo:
        variant, vtag = None, ""
        if args.optimized:
            if SHAPES[shape].kind in ("train", "prefill"):
                variant, vtag = {"act": "dp"}, "opt"
            else:
                variant = {"serve_params": True, "gqa_grouped": True}
                vtag = "opt"
        for multi in meshes:
            jobs.append((arch, shape, multi, variant, vtag, args.fusion,
                         args.force, args.layout))
    if args.jobs > 1:
        import concurrent.futures
        import multiprocessing
        ctx = multiprocessing.get_context("spawn")
        with concurrent.futures.ProcessPoolExecutor(args.jobs,
                                                    mp_context=ctx) as ex:
            results = ex.map(_cell, jobs)
            failures = sum(_report(job, res) for job, res
                           in zip(jobs, results))
    else:
        failures = sum(_report(job, _cell(job)) for job in jobs)
    return 1 if failures else 0


def _cell(job) -> tuple:
    """Run one (arch, shape, mesh) job: (record, None) or (None, the
    error and its traceback)."""
    arch, shape, multi, variant, vtag, fusion, force, layout = job
    from repro_torch.launch.dryrun_lib import run_cell
    from repro_torch.launch.mesh import (make_production_mesh,
                                         production_mesh_name)
    try:
        rec = run_cell(arch, shape, make_production_mesh(multi_pod=multi),
                       production_mesh_name(multi_pod=multi), fusion=fusion,
                       force=force, variant=variant, variant_tag=vtag,
                       layout=layout)
        return rec, None
    except Exception as e:
        return None, f"{type(e).__name__}: {e}\n{traceback.format_exc()}"


def _report(job, res) -> int:
    """Print a job's OK or FAIL line; 1 for a failure."""
    from repro_torch.launch.mesh import production_mesh_name
    arch, shape, multi = job[:3]
    tag = f"{arch} × {shape} × {production_mesh_name(multi_pod=multi)}"
    rec, err = res
    if rec is None:
        head, _, tb = err.partition("\n")
        print(f"FAIL {tag}: {head}", flush=True)
        print(tb, file=sys.stderr, flush=True)
        return 1
    mem = rec["memory"]
    coll = rec["collective_bytes_per_device"]
    print(f"OK   {tag}: "
          f"flops/dev={rec['flops_per_device']:.3e} "
          f"bytes/dev={rec['bytes_per_device']:.3e} "
          f"coll/dev={coll['total']:.3e} "
          f"({sum(coll['counts'].values())} collectives) "
          f"args={_gb(mem['argument_bytes'])} "
          f"temp={_gb(mem['temp_bytes'])} "
          f"(build {rec['time_lower_s']}s, "
          f"run {rec['time_compile_s']}s)", flush=True)
    return 0


def _gb(x):
    return f"{x / 1e9:.2f}GB" if x is not None else "n/a"


if __name__ == "__main__":
    sys.exit(main())
