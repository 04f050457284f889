"""The readings the comparison's limits are set from, for one cell at its
own size on the card:

    python3 portbench/calibrate.py --workload <cell> --seeds 1 2 3 ... \
        [--control-seeds 1 2 3] [--fault-seeds 1 2 3]

For each seed (the operands drawn from it as a run draws them, the fit's
input the first of the window's), the port's fit against the fp32
reference: the lower readings.  For each control seed, the reference
computed in TF32 (every product's operands rounded to TF32) against the
fp32 reference: the control's readings, which have to come out over a
limit.  For each fault seed, the reference with half of the rows left out
of every product that sums over them (:func:`half_rows_mm`) against the
fp32 reference: a fault's readings.  One JSON line a seed and fit, then a
summary line: the largest program reading and the smallest control and
fault reading of each number.
"""

import time

T_START = time.perf_counter()

import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402


def half_rows_mm(rows: int):
    """A planted fault, for the reference put in the port's place: every
    product that contracts over the ``rows`` rows of X (Aᵀ X, Xᵀ v) sums
    the first half of them, doubled: half of the batch left out, the mean
    taken over the rest."""
    import torch
    h = rows // 2

    def mm(a, b):
        if a.shape[-1] == rows and b.shape[-2] == rows:
            return 2.0 * torch.matmul(a[..., :h], b[..., :h, :])
        return torch.matmul(a, b)
    return mm


def readings(cell, seeds, control_seeds, fault_seeds=(), device="cuda",
             fit=None, fits: int = 1) -> list[dict]:
    """One dict a seed and fit (the first ``fits`` fit inputs of each
    seed's window): ``program``, ``control`` and ``fault``, each the
    compared numbers or None where that seed does not read it."""
    import numpy as np
    import torch
    from portbench import compare, precision
    cfg, script, ref = cell.cfg, cell.script, cell.reference
    fit = fit or script.port_fit
    precision.fp32_only()
    last = cell.mix.get("objective") == "last"
    others = {"control": (set(control_seeds), precision.tf32_mm),
              "fault": (set(fault_seeds), half_rows_mm(cfg["rows"]))}
    out = []
    for seed in sorted(set(seeds) | set(control_seeds) | set(fault_seeds)):
        t0 = time.perf_counter()
        ops = script.draw(cfg, seed % (2 ** 63), device)
        port_ops = script.prepare(ops, cfg)
        rng = np.random.default_rng([seed % (2 ** 63), 1])
        for j in range(fits):
            fin = script.fit_input(ops, cfg, rng)
            row = {"seed": seed, "fit": j, "program": None, "control": None,
                   "fault": None}
            with torch.no_grad():
                rp, robjs = ref.fit(ops, fin, cfg, precision.fp32_mm)
            if seed in seeds:
                params, objs = fit(port_ops, fin, cfg)
                row["program"] = {
                    "obj_gap": compare.obj_gap(objs, robjs, last),
                    "param_gap": compare.param_gap(params, rp)}
                del params
            for name, (chosen, mm) in others.items():
                if seed in chosen:
                    with torch.no_grad():
                        cp, cobjs = ref.fit(ops, fin, cfg, mm)
                    row[name] = {
                        "obj_gap": compare.obj_gap(cobjs, robjs, last),
                        "param_gap": compare.param_gap(cp, rp)}
            row["seconds"] = time.perf_counter() - t0
            out.append(row)
            t0 = time.perf_counter()
        del ops, port_ops, rp
        if device == "cuda":
            torch.cuda.empty_cache()
    return out


def main() -> int:
    import argparse
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="*", default=[])
    p.add_argument("--control-seeds", type=int, nargs="*", default=[])
    p.add_argument("--fault-seeds", type=int, nargs="*", default=[])
    p.add_argument("--fits", type=int, default=1,
                   help="fits a seed: the first of its window's inputs")
    a = p.parse_args()
    import torch
    from portbench import compare, harness
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    print(harness.card_line(), file=sys.stderr, flush=True)
    cell = harness.Cell(a.workload)
    # warm the plans and kernels once, as a run's set-up does
    _ms, cplans = harness.plan_regions(cell.script, cell.cfg)
    harness.build_kernels(cplans)
    rows = readings(cell, a.seeds, a.control_seeds, a.fault_seeds,
                    fits=a.fits)
    summary = {"workload": a.workload, "lower": {}, "control": {},
               "fault": {}}
    for row in rows:
        print(json.dumps(dict(row, workload=a.workload)), flush=True)
    for key, col, pick in (("lower", "program", max),
                           ("control", "control", min),
                           ("fault", "fault", min)):
        for n in compare.NUMBERS:
            vals = [r[col][n] for r in rows if r[col] is not None]
            summary[key][n] = pick(vals) if vals else None
    summary["seconds"] = time.perf_counter() - T_START
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    _root = Path(__file__).resolve().parent.parent
    sys.path[0:1] = [str(_root), str(_root / "src")]
    sys.exit(main())
