"""One run of one cell: set-up, the measured window, the comparison with
the plain reference, and the result line.

- Set-up: the cell's operands drawn on the device from the seed, the
  cell's fused regions planned from an empty plan cache (``plan_ms``), its
  kernels built (served from the checkout's build directory after the first
  run), warm-up fits; with ``--trace 1`` one more fit under
  :mod:`portbench.launches`.
- The window: the port's public entry called back to back, one fit after
  the other, until ``seconds`` have passed; each fit ends in a
  synchronise.  With ``--trace 1`` it runs under ``torch.profiler``.
- The comparison, once the window has closed and the peak is read: a
  sample of the window's fits, drawn from the seed, against the reference
  run on the same operands (:mod:`portbench.compare`).
"""

from __future__ import annotations

import gc
import json
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import torch

from portbench import compare, launches, precision, registry, work
from portbench import tracing

#: top-level module names the process may not hold once the window closes
#: (the JAX package is ``repro``; the port, ``repro_torch``, is another name)
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
GIB = 2.0 ** 30


def forbidden_modules() -> list[str]:
    return sorted({n.split(".")[0] for n in list(sys.modules)
                   if n.split(".")[0] in FORBIDDEN})


def meta(*shape):
    return torch.empty(shape, device="meta")


def card_line() -> str:
    """The card's name, count and power limit, for the log."""
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, timeout=60)
        power = r.stdout.strip().splitlines()[0] if r.stdout.strip() else \
            "power.limit unread"
    except (OSError, subprocess.SubprocessError):
        power = "power.limit unread"
    return (f"device {torch.cuda.get_device_name(0)} x "
            f"{torch.cuda.device_count()}; nvidia-smi: {power}")


def log(msg: str) -> None:
    print(f"[portbench] {msg}", file=sys.stderr, flush=True)


class Cell:
    """A cell's entries and parts, found by name."""

    def __init__(self, name: str, root: Path = registry.ROOT,
                 base: Path = registry.HERE):
        self.bench = registry.benchmark(root)
        self.entry = registry.cell(self.bench, name)
        self.name = name
        self.cfg = registry.config(self.bench, self.entry["config"], root)
        self.mix = registry.mix(self.entry["traffic"], base)
        script = self.mix.get("script", self.entry["traffic"])
        self.script = registry.module("scripts", script, base)
        self.reference = registry.module("reference", script, base)
        self.end_to_end = registry.end_to_end(self.bench, name)
        self.readers = registry.readers(self.bench, name, base)


class Reservoir:
    """A uniform sample of ``k`` of a stream of unknown length, drawn with
    ``rng``."""

    def __init__(self, k: int, rng):
        self.k, self.rng, self.seen, self.items = k, rng, 0, {}

    def offer(self, i: int, item) -> None:
        if len(self.items) < self.k:
            self.items[i] = item
        else:
            j = int(self.rng.integers(0, self.seen + 1))
            if j < self.k:
                del self.items[sorted(self.items)[j]]
                self.items[i] = item
        self.seen += 1


def plan_regions(script, cfg: dict) -> tuple[float, list]:
    """Plan the cell's fused regions, with their backward, from the
    process's empty plan cache; returns (host ms, [(CPlan, BCSR block size
    or None)])."""
    from repro_torch.core import FusionContext
    from repro_torch.core.codegen import compile_plan
    from repro_torch.core.cplan import TType
    regions = script.regions(cfg, meta)      # imports the algorithm
    t0 = time.perf_counter()
    out = []
    with FusionContext():
        for region, args, backward in regions:
            bs = next((a.bs for a in args if hasattr(a, "nblocks")), None)
            planned = region.trace(*args).plan()
            eplans = [planned.eplan] + ([planned.backward().eplan]
                                        if backward else [])
            for ep in eplans:
                for cp in compile_plan(ep).cplans():
                    if bs is None or cp.ttype == TType.OUTER:
                        out.append((cp, bs))
    return (time.perf_counter() - t0) * 1e3, out


def build_kernels(cplans: list) -> int:
    """Build the generated kernels of these CPlans (all at once; a library
    already in the build directory is kept)."""
    from repro_torch.kernels import build, cuda_src
    srcs = {}
    for cp, bs in cplans:
        try:
            src = cuda_src.source_for(cp, bs)
        except NotImplementedError:
            continue                # no CUDA template: the torch path runs
        srcs[src.key] = src
    build.build_all(srcs.values())
    return len(srcs)


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def run_cell(name: str, seed: int, seconds: float, trace: bool, *,
             t_start: float, root: Path = registry.ROOT,
             base: Path = registry.HERE, device: str = "cuda",
             entry=None) -> tuple[dict, list[str]]:
    """One run; returns (the result object, the check lines).  ``device``
    and ``entry`` (the call that stands for the port's fit) are for the CPU
    tests; the benchmark passes neither."""
    cell = Cell(name, root, base)
    cfg, mix, script = cell.cfg, cell.mix, cell.script
    fit = entry or script.port_fit
    cuda = torch.device(device).type == "cuda"
    precision.fp32_only()
    seed = int(seed) % (2 ** 63)

    # -- set-up --------------------------------------------------------------
    ops = script.draw(cfg, seed, device)
    port_ops = script.prepare(ops, cfg)
    _sync(device)
    log(f"{name}: operands drawn, {time.perf_counter() - t_start:.2f} s "
        f"from start")
    plan_ms, cplans = plan_regions(script, cfg)
    if cuda:
        nsrc = build_kernels(cplans)
        log(f"{name}: planned {len(cplans)} CPlans in {plan_ms:.1f} ms; "
            f"{nsrc} kernels built or found, "
            f"{time.perf_counter() - t_start:.2f} s from start")
    warm = np.random.default_rng([seed, 0])
    for _ in range(mix.get("warmup_fits", 1)):
        fit(port_ops, script.fit_input(ops, cfg, warm), cfg)
        _sync(device)
    seq = []
    if trace and cuda:
        fin = script.fit_input(ops, cfg, warm)
        _out, seq = launches.record(lambda: fit(port_ops, fin, cfg))
        _sync(device)
    setup_s = time.perf_counter() - t_start
    log(f"{name}: set-up {setup_s:.2f} s")

    # -- the window ----------------------------------------------------------
    rng = np.random.default_rng([seed, 1])
    sample = Reservoir(mix["check_fits"], np.random.default_rng([seed, 2]))
    fits, spans, traces = [], [], {}
    if cuda:
        peak_setup = torch.cuda.max_memory_allocated()
        torch.cuda.reset_peak_memory_stats()

    def window():
        t_open = time.perf_counter()
        deadline = t_open + seconds
        i = 0
        while True:
            fin = script.fit_input(ops, cfg, rng)
            t0 = time.perf_counter()
            params, objs = fit(port_ops, fin, cfg)
            _sync(device)
            t1 = time.perf_counter()
            fits.append((t1 - t0, len(objs)))
            spans.append((t0, t1))
            traces.setdefault(compare.fit_key(fin), []).append(
                (i, list(objs)))
            sample.offer(i, (i, fin, params))
            del params
            i += 1
            if t1 >= deadline:
                return t_open, t1

    events = None
    if trace and cuda:
        clock = tracing.to_trace_clock()
        (t_open, t_close), events = tracing.profiled(window)
    else:
        t_open, t_close = window()
    window_s = t_close - t_open
    peak_window = torch.cuda.max_memory_allocated() if cuda else 0
    steps = sum(s for _t, s in fits)
    times_ms = [t * 1e3 for t, _s in fits]
    log(f"{name}: {len(fits)} fits, {steps} steps in {window_s:.3f} s")

    # -- the per-layer readings (read before the reference runs) ------------
    metrics = {}
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
           "count": 1,
           "memory_peak_bytes": int(max(peak_setup, peak_window))
           if cuda else 0}
    breakdown = None
    if trace:
        tr = None
        if events is not None:
            tr = tracing.reduce_events(
                events, (clock(t_open), clock(t_close)),
                [(clock(a), clock(b)) for a, b in spans])
            del events
            log(f"{name}: {tracing.outside_fits(tr)} of "
                f"{sum(o.kernel for o in tr.ops)} kernels launched outside "
                f"the fit spans (the next fit's input, drawn between fits)")
        ctx = SimpleNamespace(
            trace=tr, fits=fits, steps=steps, window_s=window_s,
            plan_ms=plan_ms, launch_seq=seq, cfg=cfg, mix=mix,
            fit_least_ms=work.least_ms(*script.fit_work(cfg, ops)))
        for entry_, reader in cell.readers:
            v = reader.read(ctx)
            if v is not None:
                metrics[entry_["name"]] = {"value": v, "unit": entry_["unit"]}
        if tr is not None:
            dev["busy_s"] = tr.busy_s
            dev["window_s"] = tr.window_s
            breakdown = tracing.breakdown(tr)
    else:
        values = {"setup_s": setup_s, "step_ms": window_s * 1e3 / steps,
                  "fit_p95_ms": float(np.percentile(times_ms, 95)),
                  "peak_mem_gib": peak_window / GIB}
        for e in cell.end_to_end:
            metrics[e["name"]] = {"value": values[e["name"]],
                                  "unit": e["unit"]}

    # -- the comparison ------------------------------------------------------
    del port_ops
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    verdict = compare.judge(sample.items.values(), traces, ops, cfg, mix,
                            cell.reference)
    log(f"{name}: {len(sample.items)} sampled fits compared in "
        f"{time.perf_counter() - t_ref:.2f} s")
    result = {"correct": verdict.correct, "attempted": len(fits),
              "failed": verdict.failed, "metrics": metrics, "device": dev}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = verdict.checks
    return result, verdict.lines


def main(argv=None, t_start: float | None = None) -> int:
    import argparse
    t_start = time.perf_counter() if t_start is None else t_start
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = p.parse_args(argv)
    chips = registry.cell(registry.benchmark(), a.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        log(f"no CUDA card for {a.workload}: is_available "
            f"{torch.cuda.is_available()}, {torch.cuda.device_count()} of "
            f"{chips} cards; the benchmark measures the port on the card "
            f"only")
        return 2
    log(f"torch imported, {time.perf_counter() - t_start:.2f} s from start")
    torch.cuda.init()
    log(f"CUDA initialised, {time.perf_counter() - t_start:.2f} s from start")
    log(card_line())
    result, lines = run_cell(a.workload, a.seed, a.seconds, bool(a.trace),
                             t_start=t_start)
    bad = forbidden_modules()
    if bad:
        log(f"modules loaded that the port may not load: {bad}")
        return 3
    for line in lines:
        print(line, file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0

