#!/usr/bin/env python
"""fusionlint_torch — static plan verification over the paper algorithms,
through the PyTorch port (``repro_torch``).

Plans every registered fused region of the requested algorithms under
every requested fusion mode, locally and under an abstract 4-way
row-sharded mesh (``repro_torch.dist.LogicalMesh({"data": 4})``, so
distributed placements and segments are exercised too), runs the port's
plan verifier (:mod:`repro_torch.core.verify`) over each resulting
ExecPlan, and prints the diagnostics.  Exits nonzero iff any
error-severity diagnostic is found.  It only plans: nothing runs on the
device, which ``--device`` names (``cuda`` by default, ``cpu`` on a
machine without a card; asking for the card without one raises).

Usage (from the repo root):

    PYTHONPATH=src python tools/fusionlint_torch.py \\
        --algo l2svm,mlogreg,kmeans,glm,autoencoder,als_cg \\
        --mode all --strict [--device cpu]

``--strict`` runs the full pass (CPlan construction, placement/segment
replay, whole-plan-key completeness) instead of the default O(plan)
cheap mode, and additionally enforces **no-silent-fallback** (every
execution-time downgrade the compiled plan would take must carry a
nonempty recorded reason) and sweeps every region's **rewrite variants**
(:mod:`repro_torch.core.rewrite`): each must pass the rewrite verifier
strict-clean.  ``--serving`` additionally warms a
:class:`repro_torch.serve.FusionServer` (``workers=0``: plans and
compiles, runs nothing) with the reference serving harness's cases and
verifies every plan its cache holds.  ``--faults`` audits the port's
fault-injection sites: each must have a documented handler.
``--verbose`` prints every clean plan and every explained fallback.

The regions, shapes, modes, meshes and counts are those of the
reference's ``tools/fusionlint.py``, so the two tools' summaries can be
compared line for line; this one imports nothing of ``repro``.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import torch  # noqa: E402

from repro_torch.core import Fused, fused, fusion_mode, ir  # noqa: E402
from repro_torch.core.codegen import plan_fallbacks  # noqa: E402
from repro_torch.core.select import MODES  # noqa: E402
from repro_torch.core.verify import verify_plan  # noqa: E402
from repro_torch.interop import resolve_device  # noqa: E402

#: the reference serving harness's configuration
#: (benchmarks/serving.py: BUCKET_ROWS, N_FEATURES, N_CLASSES, PAD_TO,
#: MAX_BATCH)
SERVE_ROWS, SERVE_FEATURES, SERVE_CLASSES = (115, 240, 490), 64, 5
SERVE_PAD_TO, SERVE_MAX_BATCH = 128, 8


def _arr(*shape):
    """A shape-only operand: planning reads shapes, never values."""
    return torch.empty(shape, device="meta")


@fused
def _nll_obj(X, B, Y):
    """−Σ Y⊙log P: the reference's unregularized ``mlogreg._nll_obj``
    region, which the port's MLogReg does not keep (it differentiates the
    regularized ``_nll_obj_reg``)."""
    Z = X @ B
    m = Z.rowmaxs()
    E = ir.exp(Z - m)
    P = E / E.rowsums()
    return 0.0 - (Y * ir.log(P + 1e-30)).sum()


def _cases(algo: str) -> list[tuple[str, object, dict]]:
    """(region name, Fused wrapper, shaped args) for one algorithm —
    paper-scale (m >> n) shapes, rows divisible by the probe mesh."""
    if algo == "l2svm":
        from repro_torch.algos import l2svm
        X, w = _arr(10_000, 100), _arr(100, 1)
        y, out, lam = _arr(10_000, 1), _arr(10_000, 1), _arr(1, 1)
        return [
            ("hinge", l2svm._hinge, dict(X=X, w=w, y=y)),
            ("objective_full", l2svm._objective_full,
             dict(X=X, w=w, y=y, lam=lam)),
            ("grad", l2svm._grad, dict(X=X, out=out, y=y, w=w, lam=lam)),
            ("search_terms", l2svm._search_terms,
             dict(out=out, yXs=_arr(10_000, 1))),
            ("objective", l2svm._objective, dict(out=out, w=w)),
        ]
    if algo == "mlogreg":
        from repro_torch.algos import mlogreg
        X, B = _arr(10_000, 100), _arr(100, 5)
        P, Y, v, lam = _arr(10_000, 5), _arr(10_000, 5), _arr(100, 5), \
            _arr(1, 1)
        return [
            ("probs", mlogreg._probs, dict(X=X, B=B)),
            ("nll_obj", _nll_obj, dict(X=X, B=B, Y=Y)),
            ("nll_obj_reg", mlogreg._nll_obj_reg,
             dict(X=X, B=B, Y=Y, lam=lam)),
            ("hvp", mlogreg._hvp, dict(X=X, v=v, P=P)),
            ("grad", mlogreg._grad, dict(X=X, P=P, Y=Y)),
            ("nll_terms", mlogreg._nll_terms, dict(P=P, Y=Y)),
            ("fit_terms", mlogreg._fit_terms, dict(X=X, B=B, Y=Y)),
        ]
    if algo == "kmeans":
        from repro_torch.algos import kmeans
        return [
            ("sq_rowsums", kmeans._sq_rowsums, dict(X=_arr(10_000, 50))),
            ("min_dist", kmeans._min_dist,
             dict(XC=_arr(10_000, 5), xsq=_arr(10_000, 1),
                  csq=_arr(1, 5))),
        ]
    if algo == "glm":
        from repro_torch.algos import glm
        X = _arr(10_000, 100)
        col = _arr(10_000, 1)
        return [
            ("link_chain", glm._link_chain, dict(eta=col, y=col)),
            ("wxv", glm._wxv, dict(X=X, w=col, v=_arr(100, 1))),
            ("wz", glm._wz, dict(X=X, w=col, r=col)),
            ("deviance", glm._deviance, dict(y=col, eta=col)),
        ]
    if algo == "autoencoder":
        from repro_torch.algos import autoencoder
        return [
            ("recon_loss", autoencoder._recon_loss,
             dict(Xb=_arr(256, 100),
                  W1=_arr(100, 64), b1=_arr(1, 64),
                  W2=_arr(64, 2), b2=_arr(1, 2),
                  W3=_arr(2, 64), b3=_arr(1, 64),
                  W4=_arr(64, 100), b4=_arr(1, 100))),
        ]
    if algo == "als_cg":
        from repro_torch.algos import als_cg
        # re-wrap with a planning-time sparsity hint for the ratings
        # matrix so the sparsity-exploiting Outer template qualifies
        # (the algo passes a real BCSR whose density the trace reads)
        wsq = Fused(als_cg._wsq_mm.fn, sparsity={"X": 0.05})
        loss = Fused(als_cg._loss_terms.fn, sparsity={"X": 0.05})
        X, U, V = _arr(2_000, 500), _arr(2_000, 20), _arr(500, 20)
        return [
            ("wsq_mm", wsq, dict(X=X, U=U, V=V)),
            ("loss_terms", loss, dict(X=X, U=U, V=V)),
        ]
    raise SystemExit(f"fusionlint_torch: unknown algo '{algo}'")


def _mesh():
    from repro_torch.dist import LogicalMesh
    return LogicalMesh({"data": 4})


def _check_fallbacks(eplan, layout, label: str,
                     verbose: bool) -> tuple[int, int]:
    """no-silent-fallback: every downgrade the compiled plan would take
    must carry a nonempty recorded reason.  Returns (total, silent)."""
    entries = plan_fallbacks(eplan, layout=layout)
    silent = 0
    for fb in entries:
        site = fb.get("site", "?")
        reason = str(fb.get("reason", "") or "").strip()
        if not reason:
            silent += 1
            print(f"{label}: SILENT fallback at site={site!r} — "
                  "no reason recorded")
        elif verbose:
            print(f"{label}: fallback[{site}] {reason}")
    return len(entries), silent


def _check_rewrites(graph, label: str, verbose: bool) -> tuple[int, int]:
    """all-variants-verify-clean: every algebraic variant the rewrite
    rule set generates for this region must pass the rewrite verifier
    strict-clean.  Returns (variants, failing variants)."""
    from repro_torch.core.rewrite import rewrite_variants
    from repro_torch.core.verify import verify_variant

    bad = 0
    variants = rewrite_variants(graph)
    for v in variants:
        report = verify_variant(graph, v.graph, level="strict")
        if not report.ok:
            bad += 1
            print(f"{label}: rewrite variant {'+'.join(v.rules)} "
                  f"failed verification: {report.pretty()}")
        elif verbose:
            print(f"{label}: rewrite {'+'.join(v.rules)} clean")
    return len(variants), bad


def serving_cases() -> list[tuple[str, object, dict]]:
    """The reference serving harness's cases (``benchmarks/serving.py``
    ``harness_regions``) as shapes: the l2svm hinge and mlogreg softmax
    scoring regions at every row bucket."""
    from repro_torch.algos.l2svm import _hinge
    from repro_torch.algos.mlogreg import _probs
    n, k = SERVE_FEATURES, SERVE_CLASSES
    cases = []
    for m in SERVE_ROWS:
        cases.append((f"l2svm_hinge_m{m}", _hinge,
                      {"X": _arr(m, n), "w": _arr(n, 1), "y": _arr(m, 1)}))
        cases.append((f"mlogreg_probs_m{m}", _probs,
                      {"X": _arr(m, n), "B": _arr(n, k)}))
    return cases


def lint_serving(level: str, verbose: bool,
                 device: str = "cuda") -> tuple[int, list[str]]:
    """Verify the plans the serving harness compiles, reusing the warmed
    entry cache (``workers=0`` server: warm() plans and compiles without
    executing anything).  Returns (plans verified, failing labels)."""
    from repro_torch.core import FusionContext
    from repro_torch.serve import FusionServer

    server = FusionServer(workers=0, max_batch=SERVE_MAX_BATCH,
                          pad_to=SERVE_PAD_TO, autostart=False,
                          context=FusionContext(device=device))
    server.warm([(region, ops) for _l, region, ops in serving_cases()],
                execute=False)
    failed: list[str] = []
    n = 0
    for label, planned in server.warmed_plans():
        full = f"serving/{label}"
        report = verify_plan(planned.eplan, level=level, layout=None)
        n += 1
        if report.errors:
            failed.append(full)
        if report.diagnostics or verbose:
            print(f"{full}: {report.pretty()}")
        if level == "strict":
            _total, silent = _check_fallbacks(planned.eplan, None, full,
                                              verbose)
            if silent:
                failed.append(f"{full} [no-silent-fallback]")
    return n, failed


def lint_faults(verbose: bool) -> int:
    """``--faults``: audit the port's fault-injection site registry.
    Imports every module that declares a site (``faults.
    ensure_registered``) and fails if no sites exist or any site lacks a
    documented handler."""
    from repro_torch import faults

    sites = faults.ensure_registered()
    bad = 0
    for site in sorted(sites, key=lambda s: s.name):
        ok = bool(site.handler.strip())
        if not ok:
            bad += 1
        if verbose or not ok:
            status = "OK" if ok else "MISSING HANDLER"
            print(f"{site.name}: kinds={','.join(site.kinds)} [{status}]")
            if ok:
                print(f"  handler: {site.handler}")
    print(f"fusionlint: {len(sites)} fault site(s) registered, "
          f"{bad} without a handler")
    if not sites:
        print("fusionlint: no fault sites registered — the injection "
              "harness is disconnected from the stack")
        return 1
    return 1 if bad else 0


def lint(algos: list[str], modes: list[str], level: str,
         verbose: bool, serving: bool = False, device: str = "cuda") -> int:
    device = str(resolve_device(device))
    n_plans = n_errors = n_warnings = n_fallbacks = n_silent = 0
    n_rewrites = n_rewrite_bad = 0
    failed: list[str] = []
    layouts = [("local", None), ("mesh[data=4]", _mesh())]
    for algo in algos:
        for region, wrapper, args in _cases(algo):
            if level == "strict":
                # once per region: every rewrite variant verify-clean
                rlabel = f"{algo}/{region} [rewrite]"
                total, bad = _check_rewrites(wrapper.trace(**args).graph,
                                             rlabel, verbose)
                n_rewrites += total
                n_rewrite_bad += bad
                if bad:
                    n_errors += bad
                    failed.append(rlabel)
            for mode in modes:
                for lname, layout in layouts:
                    label = f"{algo}/{region} mode={mode} {lname}"
                    with fusion_mode(mode, layout=layout, verify="off",
                                     device=device):
                        eplan = wrapper.plan_for(**args)
                    report = verify_plan(eplan, level=level, layout=layout)
                    n_plans += 1
                    n_errors += len(report.errors)
                    n_warnings += len(report.warnings)
                    if report.errors:
                        failed.append(label)
                    if report.diagnostics or verbose:
                        print(f"{label}: {report.pretty()}")
                    if level == "strict":
                        total, silent = _check_fallbacks(
                            eplan, layout, label, verbose)
                        n_fallbacks += total
                        n_silent += silent
                        if silent:
                            n_errors += silent
                            failed.append(f"{label} [no-silent-fallback]")
    if serving:
        n, sfailed = lint_serving(level, verbose, device)
        n_plans += n
        n_errors += len(sfailed)
        failed.extend(sfailed)
    print(f"fusionlint: {n_plans} plans verified [{level}] — "
          f"{n_errors} error(s), {n_warnings} warning(s)"
          + (f", {n_fallbacks} fallback(s) ({n_silent} silent), "
             f"{n_rewrites} rewrite variant(s) ({n_rewrite_bad} unclean)"
             if level == "strict" else ""))
    if failed:
        print("failing plans:")
        for label in failed:
            print(f"  {label}")
        return 1
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="fusionlint_torch",
        description="statically verify every selectable fusion plan "
                    "of the paper algorithms through the PyTorch port")
    ap.add_argument("--algo", default="l2svm,mlogreg,kmeans,glm,"
                    "autoencoder,als_cg",
                    help="comma-separated algorithm list (default: all)")
    ap.add_argument("--mode", default="all",
                    help="fusion mode(s), comma-separated or 'all' "
                         f"(choices: {', '.join(MODES)})")
    ap.add_argument("--strict", action="store_true",
                    help="full pass: build CPlans, replay placements/"
                         "segments, check the whole-plan key")
    ap.add_argument("--serving", action="store_true",
                    help="also verify the plans the serving harness "
                         "compiles (warmed FusionServer cache)")
    ap.add_argument("--faults", action="store_true",
                    help="audit the fault-injection site registry: list "
                         "every site and fail on any without a "
                         "documented handler")
    ap.add_argument("--device", default="cuda",
                    help="the device plans are made for: cuda (default) "
                         "or cpu")
    ap.add_argument("--verbose", action="store_true",
                    help="print every verified plan, including clean "
                         "ones")
    args = ap.parse_args(argv)

    if args.faults:
        return lint_faults(args.verbose)
    algos = [a.strip() for a in args.algo.split(",") if a.strip()]
    modes = list(MODES) if args.mode == "all" else \
        [m.strip() for m in args.mode.split(",") if m.strip()]
    for m in modes:
        if m not in MODES:
            ap.error(f"unknown mode '{m}' (choices: {', '.join(MODES)})")
    return lint(algos, modes, "strict" if args.strict else "cheap",
                args.verbose, serving=args.serving, device=args.device)


if __name__ == "__main__":
    raise SystemExit(main())
