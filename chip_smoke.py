#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

Run from the repository root on a machine with an NVIDIA H100 and the CUDA
toolkit:

    python3 chip_smoke.py            # X of 10,000,000 x 100 on the main path

Phases, each reported on its own lines:

1. environment: torch / CUDA versions, the card's name and power limit,
   TF32 switched off for matmuls and cuDNN;
2. build: every kernel this run launches is generated from its CPlan and
   compiled with nvcc, all builds started together;
3. kernels vs plain: every variant of the Cell, MAgg and Row kernels
   (CPlans from the port's planner, ``repro_torch.kernels.sweep``) at a
   ragged shape, at an (m,1) main and at the main path's width, each held
   against its plain PyTorch version on the same CUDA tensors; then a
   fault planted in the kernels' ordered combine (the middle partial is
   dropped) must fail the same check at 2,000,003 rows;
4. the main path's own CPlans at the main path's shapes, against plain;
5. the main path: ``repro_torch.algos.l2svm.run`` for 5 iterations on
   X (m,100) fp32 with ``kernels="cuda"``, launch counters set to 0 just
   before it and read just after; the same run with ``kernels="never"``
   and the hand-written torch baseline must give the same objective trace,
   and a run with the planted fault must not; one more run under
   ``torch.profiler`` splits the device time by kernel;
6. timing: per main-path CPlan, the kernel's and its plain version's
   median time with CUDA events, beside the bound (bytes over 3.35 TB/s or
   fp32 flops over 67 TFLOP/s, the larger);
7. one JSON line with every kernel, the card line, and the final
   ``{"ok": true, ...}`` line.

Any failed check raises; the script then prints the traceback and exits 1
without a result line.  It imports nothing of JAX or of ``repro``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import statistics
import subprocess
import sys
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

N_MAIN = 100                 # the repo's L2SVM width (docs/architecture.md)
M_MAIN = 10_000_000          # rows: X is 4.0 GB fp32
M_SWEEP = 2_000_003          # sweep rows at the main path's width (ragged)
ITERS = 5
HBM_BW = 3.35e12             # H100 SXM HBM3, B/s (datasheet)
FP32_PEAK = 67e12            # H100 SXM fp32 outside the tensor cores, FLOP/s
EPS32 = 2.0 ** -23            # fp32 machine epsilon
#: kernel vs plain, per output element: |got - plain| <= KERNEL_ULPS *
#: EPS32 * scale, where scale is a first-order bound of the plain
#: computation's rounding (error_scale).  Both sides are fp32 and sum in
#: different orders; a sum of non-negative terms that lost one of its P
#: partials is off by about its value / P (P is in the thousands at the
#: sweep's 2,000,003 rows), far above the limit
KERNEL_ULPS = 16
#: objective traces (kernels / torch-eager / hand torch): relative; the
#: line search carries reduction-order differences over 5 iterations
TRACE_RTOL = 1e-5
#: sweep cases at M_SWEEP rows whose planted fault (one partial dropped)
#: must fail the kernel check: sums of non-negative terms, one per kernel
PLANTED = ("cell/full_agg_abs_sum", "magg/k3_min_mean_sum", "row/full_agg")
PLANT = "#define RK_PLANTED_FAULT 1\n"

KERNELS = {   # name -> (skeleton source, the TPU kernel it replaces)
    "cell": ("src/repro_torch/kernels/csrc/cell.cuh",
             "src/repro/kernels/cellwise.py:55"),
    "magg": ("src/repro_torch/kernels/csrc/magg.cuh",
             "src/repro/kernels/multiagg.py:20"),
    "row": ("src/repro_torch/kernels/csrc/row.cuh",
            "src/repro/kernels/rowwise.py:25"),
}


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60, check=True)
    return r.stdout.strip().splitlines()[0]


# --------------------------------------------------------------------------
# helpers
# --------------------------------------------------------------------------

def main_path_cplans(m: int, n: int):
    """CPlans of one L2SVM iteration, in order: hinge, search terms, the
    objective forward and its planned backward (planning needs shapes
    only: meta tensors)."""
    import torch
    from repro_torch.algos import l2svm
    from repro_torch.core import FusionContext
    from repro_torch.core.codegen import compile_plan

    meta = lambda *s: torch.empty(s, device="meta")
    X, w, y, col, lam = meta(m, n), meta(n, 1), meta(m, 1), meta(m, 1), \
        meta(1, 1)
    out = []
    with FusionContext():
        for region, args, bwd in ((l2svm._hinge, (X, w, y), False),
                                  (l2svm._search_terms, (col, col), False),
                                  (l2svm._objective_full, (X, w, y, lam),
                                   True)):
            planned = region.trace(*args).plan()
            out += [(region.fn.__name__, cp)
                    for cp in compile_plan(planned.eplan).cplans()]
            if bwd:
                out += [(region.fn.__name__ + ":vjp", cp) for cp in
                        compile_plan(planned.backward().eplan).cplans()]
    return out


def kernel_name(cplan) -> str:
    from repro_torch.kernels import cuda_src
    return cuda_src.source_for(cplan).template


def random_env(cplan, gen, shared=None):
    """Random fp32 operands on the card for every bind (scaled so exp and
    friends stay finite); ``shared`` maps a shape to a tensor to reuse."""
    import torch
    env = {}
    for b in cplan.binds:
        shape = tuple(b.shape)
        if shared is not None and shape in shared:
            env[b.nid] = shared[shape]
        else:
            env[b.nid] = 0.3 * torch.randn(shape, generator=gen,
                                           device="cuda")
    return env


#: piecewise-constant ops: their outputs count as exact under rounding
STEP_OPS = {"sign", "round", "floor", "ceil", "neq0", "eq", "neq", "lt", "le",
            "gt", "ge"}


def error_scale(cplan, env):
    """Per output element, the size its fp32 rounding is held against: a
    first-order running error bound of the plain computation in units of
    fp32 eps.  Every program value v carries s(v) with |error(v)| <~ eps *
    s(v): inputs and literals are exact (s = 0); each op adds its own
    rounding |v| and carries its inputs' bounds through its partial
    derivatives (|b| s(a) + |a| s(b) for a*b, |A||B| + s(A)|B| + |A|s(B)
    for a matmul, sum |t| + sum s(t) for a sum, |f'(x)| s(x) for a smooth
    f); piecewise-constant ops count as exact.  The template's own
    reduction closes the bound."""
    import torch
    from repro_torch.core.cplan import (COL_AGG, COL_T_AGG, FULL_AGG,
                                        NO_AGG, ROW_AGG)
    from repro_torch.kernels import ref

    is_t = lambda x: isinstance(x, torch.Tensor)
    mag = lambda x: x.abs() if is_t(x) else abs(x)

    def reduce(op, v, s, axis):
        s = s if is_t(s) else torch.zeros_like(v)
        if op in ("min", "max"):
            return (ref.eval_node(op, [v], {"axis": axis}).abs()
                    + ref.eval_node("max", [s], {"axis": axis}))
        if op == "sum_sq":
            return ref.eval_node("sum", [v * v + 2 * v.abs() * s],
                                 {"axis": axis})
        return ref.eval_node(op, [v.abs() + s], {"axis": axis})

    def matmul(a, sa, b, sb):
        out = a.abs() @ b.abs()
        if is_t(sa):
            out = out + sa @ b.abs()
        if is_t(sb):
            out = out + a.abs() @ sb
        return out

    def smooth(op, xs, ss, val, attrs):
        leaves = [x.detach().expand(val.shape).clone().requires_grad_(True)
                  if is_t(x) and is_t(s) else x for x, s in zip(xs, ss)]
        want = [x for x in leaves if is_t(x) and x.requires_grad]
        out = val.abs()
        if want:
            with torch.enable_grad():
                grads = torch.autograd.grad(
                    ref.eval_node(op, leaves, attrs).sum(), want)
            carried = iter(s for x, s in zip(leaves, ss)
                           if is_t(x) and x.requires_grad)
            for g in grads:
                out = out + torch.nan_to_num(g.abs() * next(carried))
        return out

    def bound(op, xs, ss, val, attrs):
        if op in ref._AGG_FN and "axis" in attrs:
            return reduce(op, xs[0], ss[0], attrs["axis"])
        if op == "matmul":
            a, b = xs
            sa, sb = ss
            if attrs.get("ta"):
                a, sa = a.T, (sa.T if is_t(sa) else sa)
            if attrs.get("tb"):
                b, sb = b.T, (sb.T if is_t(sb) else sb)
            return matmul(a, sa, b, sb)
        if op == "t":
            return ss[0].T if is_t(ss[0]) else ss[0]
        if op == "idx":
            return ss[0][:, attrs["lo"]:attrs["hi"]] if is_t(ss[0]) \
                else ss[0]
        if op in STEP_OPS:
            return val.abs()
        if op in ("relu", "abs", "neg"):
            return val.abs() + ss[0]
        if op in ("add", "sub", "min", "max"):
            return val.abs() + ss[0] + ss[1]
        if op == "mul":
            return val.abs() + mag(xs[1]) * ss[0] + mag(xs[0]) * ss[1]
        if op == "div":
            return val.abs() + (ss[0] + val.abs() * ss[1]) / mag(xs[1])
        if op in ("plus_mult", "minus_mult"):
            return (val.abs() + ss[0] + mag(xs[2]) * ss[1]
                    + mag(xs[1]) * ss[2])
        if op == "where":
            return val.abs() + ref.eval_node("where", [xs[0], *ss[1:]], {})
        return smooth(op, xs, ss, val, attrs)

    vals, scales = {}, {}

    def get(kind, r):
        if kind == "n":
            return vals[r], scales[r]
        return (env[r] if kind == "b" else r), 0.0

    for (nid, op, ins, _shape, attrs) in cplan.prog:
        xs, ss = zip(*[get(k, r) for k, r in ins])
        attrs = dict(attrs)
        vals[nid] = ref.eval_node(op, list(xs), attrs)
        scales[nid] = bound(op, list(xs), list(ss), vals[nid], attrs)
    root = lambda nid: get("n" if nid in vals else "b", nid)

    if cplan.extra:
        roots = [(cplan.prog_root, cplan.agg_op)] + list(cplan.extra)
        return torch.cat([reduce(op, *root(r), "full").reshape(1, 1)
                          for r, op in roots])
    v, s = root(cplan.prog_root)
    if cplan.variant == NO_AGG:
        return s if is_t(s) else torch.zeros_like(v)
    if cplan.variant == COL_T_AGG:
        c, sc = root(cplan.close_nid)
        return matmul(c.T, sc.T if is_t(sc) else sc, v, s)
    axis = {FULL_AGG: "full", ROW_AGG: "row", COL_AGG: "col"}[cplan.variant]
    return reduce(cplan.agg_op, v, s, axis)


def measure(cplan, env, got, label: str) -> tuple[float, float]:
    """(max |got - plain|, its largest share of the per-element limit);
    raises on a shape or non-finite mismatch."""
    import torch
    from repro_torch.kernels import ref
    exp = ref.execute_dense(cplan, env)
    torch.cuda.synchronize()
    if tuple(got.shape) != tuple(exp.shape):
        raise AssertionError(f"{label}: shape {tuple(got.shape)} != "
                             f"plain {tuple(exp.shape)}")
    fin = torch.isfinite(exp)
    if not bool(torch.equal(torch.isfinite(got), fin)):
        raise AssertionError(f"{label}: non-finite values differ")
    if not bool(fin.any()):
        return 0.0, 0.0
    diff = (got[fin] - exp[fin]).abs()
    scale = error_scale(cplan, env)
    if tuple(scale.shape) != tuple(exp.shape):
        raise AssertionError(f"{label}: error scale {tuple(scale.shape)}")
    limit = KERNEL_ULPS * EPS32 * scale[fin].clamp_min(
        torch.finfo(torch.float32).tiny)
    return float(diff.max()), float((diff / limit).max())


def compare(cplan, env, label: str) -> tuple[float, float]:
    """Kernel vs plain on the same CUDA tensors: (max |error|, its share of
    the limit); raises when any element is over its limit."""
    from repro_torch.kernels import ops
    got = ops.execute(cplan, env, kernels="cuda")
    err, share = measure(cplan, env, got, label)
    if not share <= 1.0:
        raise AssertionError(f"{label}: max |kernel - plain| = {err:.3e}, "
                             f"{share:.3g} x its limit")
    return err, share


def planted(src):
    """``src`` built with the fault planted in ``rk::combine`` (it drops
    the middle partial); a source without partials is returned as is."""
    return dataclasses.replace(src, text=PLANT + src.text) if src.elems \
        else src


@contextlib.contextmanager
def planted_fault():
    """Every reducing kernel launched inside runs its planted build."""
    from repro_torch.kernels import cuda_src
    orig = cuda_src.source_for
    cuda_src.source_for = lambda cp: planted(orig(cp))
    try:
        yield
    finally:
        cuda_src.source_for = orig


def trace_rel(objs, ref_objs) -> float:
    """Largest relative difference of two objective traces; infinite when
    their lengths differ or a value is not finite."""
    if len(objs) != len(ref_objs) or not all(
            math.isfinite(v) for v in list(objs) + list(ref_objs)):
        return math.inf
    return max(abs(a - b) / max(abs(b), 1e-30)
               for a, b in zip(objs, ref_objs))


def time_ms(fn, reps: int = 10, rounds: int = 5) -> float:
    """Median over ``rounds`` of the CUDA-event time of ``reps``
    back-to-back calls, per call."""
    import torch
    fn()
    torch.cuda.synchronize()
    per = []
    for _ in range(rounds):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        b.synchronize()
        per.append(a.elapsed_time(b) / reps)
    return statistics.median(per)


def device_ms(fn, reps: int = 10):
    """Device time per call from a ``torch.profiler`` trace: the self
    device time of every kernel the calls launched, summed, over ``reps``;
    None when the trace holds no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total_us = sum(e.self_device_time_total for e in prof.key_averages())
    return total_us / 1e3 / reps if total_us > 0 else None


def bound_ms(cplan, env, out) -> tuple[float, str]:
    """Least time for the same work: each distinct input read once and the
    output written once over HBM bandwidth, or the program's fp32 flops
    over the fp32 peak — the larger, and which one it is."""
    seen, nbytes = set(), out.numel() * 4
    for t in env.values():
        if t.data_ptr() not in seen:
            seen.add(t.data_ptr())
            nbytes += t.numel() * 4
    rows = cplan.main.shape[0]
    flops = 0
    for (_nid, op, ins, shape, attrs) in cplan.prog:
        cells = shape[0] * shape[1]
        if op == "matmul":
            side = next(b.shape for b in cplan.binds
                        if ("b", b.nid) == ins[1])
            inner = side[1] if dict(attrs).get("tb") else side[0]
            flops += 2 * cells * inner
        else:
            flops += cells
    if cplan.variant == "col_t_agg":
        flops += 2 * rows * out.numel()
    t_bytes, t_flops = nbytes / HBM_BW * 1e3, flops / FP32_PEAK * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_flops else \
        (t_flops, "operations")


def profile_main_path(l2svm, X, y) -> None:
    """Where the time goes: one more ``kernels="cuda"`` run (plans already
    cached) under ``torch.profiler``; device busy time per kernel name and
    the idle share of the host-clock wall time (profiler on)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]):   # tracer start-up
        torch.zeros(1, device="cuda").add_(1)
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        l2svm.run(X, y, max_iter=ITERS, kernels="cuda")
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    events = sorted(prof.key_averages(),
                    key=lambda e: -e.self_device_time_total)
    busy_ms = sum(e.self_device_time_total for e in events) / 1e3
    log(f"[profile] l2svm.run kernels=cuda, {ITERS} iterations: wall "
        f"{wall_ms:.2f} ms, device busy {busy_ms:.2f} ms, idle share "
        f"{1 - busy_ms / wall_ms:.3f}")
    for e in events[:12]:
        log(f"[profile]   {e.self_device_time_total / 1e3:9.3f} ms "
            f"x{e.count:<4d} {e.key[:90]}")


# --------------------------------------------------------------------------
# phases
# --------------------------------------------------------------------------

def run() -> None:
    import torch
    m_main = M_MAIN

    # 1. environment ---------------------------------------------------------
    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is False: this smoke "
                           "run needs the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import repro_torch
    from repro_torch.algos import l2svm
    from repro_torch.kernels import (build, cellwise, cuda_src, multiagg,
                                     ops, ref, rowwise, sweep)
    counters = {"cell": cellwise, "magg": multiagg, "row": rowwise}
    wrappers = {"cell": cellwise.cell, "magg": multiagg.multiagg,
                "row": rowwise.row}
    card = card_line()
    log(f"[env] python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda} repro_torch {repro_torch.__version__}")
    log(f"[env] device {torch.cuda.get_device_name(0)} x "
        f"{torch.cuda.device_count()}; nvidia-smi: {card}")
    log(f"[env] allow_tf32 matmul={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn={torch.backends.cudnn.allow_tf32}")

    # 2. build ---------------------------------------------------------------
    t0 = time.perf_counter()
    sweep_runs = []        # (case, m, n)
    for c in sweep.cases():
        for (m, n) in ((33, 7), (33, 1), (M_SWEEP, N_MAIN)):
            if n >= c.min_n:
                sweep_runs.append((c, m, n))
    planned = [(c, m, n, *sweep.fused_cplan(c, m, n))
               for c, m, n in sweep_runs]
    main_cps = main_path_cplans(m_main, N_MAIN)
    sources = {}
    for cp in [p[3] for p in planned] + [cp for _r, cp in main_cps]:
        src = cuda_src.source_for(cp)
        sources[src.key] = src
    # the planted-fault builds: the planted sweep cases and the main path
    for cp in [p[3] for p in planned if p[0].name in PLANTED
               and p[1] == M_SWEEP] + [cp for _r, cp in main_cps]:
        src = planted(cuda_src.source_for(cp))
        sources[src.key] = src
    t_plan = time.perf_counter() - t0
    build.build_all(sources.values())
    t_build = time.perf_counter() - t0 - t_plan
    log(f"[build] {len(sources)} kernel sources (planning {t_plan:.1f} s), "
        f"nvcc {t_build:.1f} s in parallel, set-up "
        f"{time.perf_counter() - t0:.1f} s")

    # 3. kernels vs plain: the sweep ---------------------------------------
    gen = torch.Generator(device="cuda").manual_seed(1234)
    worst = {k: 0.0 for k in KERNELS}
    for c, m, n, cp, _names in planned:
        kname = kernel_name(cp)
        if kname != c.template:
            raise AssertionError(f"{c.name}: routed to {kname}")
        err, share = compare(cp, random_env(cp, gen), f"{c.name} at {m}x{n}")
        worst[kname] = max(worst[kname], share)
        log(f"[check] {c.name:30s} {m:>9d}x{n:<3d} {cp.ttype.name:4s} "
            f"{cp.variant:9s} max|kernel-plain| {err:.3e} = {share:.3g} "
            f"x limit")
    log(f"[check] sweep passed: {len(planned)} CPlans, limit {KERNEL_ULPS} "
        f"x eps32 x error scale; largest share of the limit per kernel "
        + json.dumps(worst))
    for c, m, n, cp, _names in planned:
        if c.name not in PLANTED or m != M_SWEEP:
            continue
        env = random_env(cp, gen)
        with planted_fault():
            got = ops.execute(cp, env, kernels="cuda")
        err, share = measure(cp, env, got, f"planted {c.name}")
        log(f"[check] planted fault (one partial dropped) {c.name} at "
            f"{m}x{n}: max|kernel-plain| {err:.3e} = {share:.3g} x limit")
        if not share > 1.0:
            raise AssertionError(f"planted fault in {c.name} passed the "
                                 f"kernel check")

    # 4. the main path's CPlans at the main path's shapes -------------------
    big = {(m_main, N_MAIN): 0.3 * torch.randn((m_main, N_MAIN),
                                               generator=gen, device="cuda")}
    main_err = {k: 0.0 for k in KERNELS}
    envs = []
    for region, cp in main_cps:
        env = random_env(cp, gen, big)
        kname = kernel_name(cp)
        err, share = compare(cp, env, f"main-path {region} "
                                      f"{cp.ttype.name} {cp.variant}")
        main_err[kname] = max(main_err[kname], err)
        envs.append(env)
        log(f"[check] main path {region:22s} {kname:4s} {cp.variant:9s} "
            f"binds {[tuple(b.shape) for b in cp.binds]} "
            f"max|kernel-plain| {err:.3e} = {share:.3g} x limit")

    # 5. the main path -------------------------------------------------------
    g = torch.Generator(device="cuda").manual_seed(0)
    X = torch.randn((m_main, N_MAIN), generator=g, device="cuda")
    w_true = torch.randn((N_MAIN, 1), generator=g, device="cuda")
    noise = torch.randn((m_main, 1), generator=g, device="cuda")
    y = torch.where(X @ w_true + 0.5 * noise >= 0, 1.0, -1.0)
    del noise
    torch.cuda.synchronize()
    for mod in counters.values():
        mod.launches = 0
    t0 = time.perf_counter()
    w, objs = l2svm.run(X, y, max_iter=ITERS, kernels="cuda")
    torch.cuda.synchronize()
    t_cuda = time.perf_counter() - t0
    launches = {k: mod.launches for k, mod in counters.items()}
    log(f"[main] l2svm.run X {m_main}x{N_MAIN} fp32, {len(objs)} "
        f"iterations, kernels=cuda: {t_cuda:.2f} s host clock (planning "
        f"included); launches {json.dumps(launches)}")
    log(f"[main] objective trace (kernels=cuda): {objs}")
    missing = [k for k, v in launches.items() if v == 0]
    if missing:
        raise AssertionError(f"main path never launched: {missing}")
    if tuple(w.shape) != (N_MAIN, 1) or not bool(torch.isfinite(w).all()):
        raise AssertionError("main path: w is not a finite (n,1) vector")
    t0 = time.perf_counter()
    _w2, objs_plain = l2svm.run(X, y, max_iter=ITERS, kernels="never")
    torch.cuda.synchronize()
    t_plain = time.perf_counter() - t0
    _w3, objs_hand = l2svm.run(X, y, max_iter=ITERS, mode="hand")
    log(f"[main] kernels=never: {t_plain:.2f} s; trace {objs_plain}")
    log(f"[main] hand torch baseline trace {objs_hand}")
    rel, rel_hand = trace_rel(objs, objs_plain), trace_rel(objs_hand,
                                                           objs_plain)
    log(f"[main] max relative trace difference: kernels vs never "
        f"{rel:.3e}, hand vs never {rel_hand:.3e} (tolerance "
        f"{TRACE_RTOL:g})")
    if not (len(objs_plain) == ITERS and rel <= TRACE_RTOL
            and rel_hand <= TRACE_RTOL):
        raise AssertionError("main path: objective traces disagree")
    with planted_fault():
        _w4, objs_fault = l2svm.run(X, y, max_iter=ITERS, kernels="cuda")
    rel_fault = trace_rel(objs_fault, objs_plain)
    log(f"[main] planted fault (one partial dropped in every reducing "
        f"kernel): trace {objs_fault}, max relative difference vs never "
        f"{rel_fault:.3e}")
    if not rel_fault > TRACE_RTOL:
        raise AssertionError("planted fault passed the trace check")
    profile_main_path(l2svm, X, y)
    del X, y, w, _w2, _w3, _w4

    # 6. timing at the main path's shapes ----------------------------------
    per_kernel = {k: {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
                      "bound_by": {}, "parts": []} for k in KERNELS}
    for (region, cp), env in zip(main_cps, envs):
        kname = kernel_name(cp)
        out = ref.execute_dense(cp, env)
        kernel = lambda: wrappers[kname](cp, env)
        plain = lambda: ref.execute_dense(cp, env)
        ms, plain_ms = time_ms(kernel), time_ms(plain)
        dev_ms, dev_plain_ms = device_ms(kernel), device_ms(plain)
        b_ms, b_by = bound_ms(cp, env, out)
        agg = per_kernel[kname]
        agg["ms"] += ms
        agg["plain_ms"] += plain_ms
        agg["bound_ms"] += b_ms
        agg["bound_by"][b_by] = agg["bound_by"].get(b_by, 0) + 1
        agg["parts"].append({"region": region, "variant": cp.variant,
                             "binds": [list(b.shape) for b in cp.binds],
                             "ms": ms, "plain_ms": plain_ms,
                             "device_ms": dev_ms,
                             "plain_device_ms": dev_plain_ms,
                             "bound_ms": b_ms, "bound_by": b_by})
        log(f"[time] {region:22s} {kname:4s} {cp.variant:9s} kernel "
            f"{ms:.4f} ms (device {dev_ms}) plain {plain_ms:.4f} ms "
            f"(device {dev_plain_ms}) bound {b_ms:.4f} ms ({b_by})")

    # 7. result lines --------------------------------------------------------
    rows = []
    for k, (src, replaces) in KERNELS.items():
        agg = per_kernel[k]
        rows.append({
            "name": k, "route": "cuda", "source": src, "replaces": replaces,
            "launches": launches[k], "max_abs_err": main_err[k],
            "ms": agg["ms"], "plain_ms": agg["plain_ms"],
            "bound_ms": agg["bound_ms"],
            "bound_by": max(agg["bound_by"], key=agg["bound_by"].get),
            "library_ms": None,
            "per": "one L2SVM iteration (sum over its CPlans)",
            "parts": agg["parts"]})
    log(json.dumps({"kernels": rows}))
    log(card_line())
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


def main() -> int:
    try:
        run()
    except Exception:                 # noqa: BLE001 - report, exit non-zero
        traceback.print_exc()
        print("chip_smoke: FAILED", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
