"""The harness on the CPU: its parts found by name, the trace reduced and
read, the forbidden imports, and a run refused without a card."""

import json
import math
import os
import shutil
import subprocess
import sys
import time
from types import SimpleNamespace

import pytest

from conftest import ROOT
from portbench import harness, registry, rooflines, tracing

CELLS = [w["name"] for w in registry.benchmark()["workloads"]]


@pytest.mark.parametrize("cell", CELLS)
def test_every_cell_finds_its_parts_by_name(cell):
    c = harness.Cell(cell)
    assert c.cfg["name"] == c.entry["config"]
    for part in ("draw", "fit_input", "prepare", "port_fit", "regions",
                 "fit_work"):
        assert callable(getattr(c.script, part))
    assert callable(c.reference.fit)
    names = [e["name"] for e, _m in c.readers]
    assert "step_mfu" in names and "idle_share" in names
    assert all(callable(m.read) for _e, m in c.readers)
    assert {e["name"] for e in c.end_to_end} >= {"setup_s", "step_ms",
                                                  "peak_mem_gib"}
    for n in ("obj_gap", "param_gap"):
        assert c.mix["limits"][n] > 0


def test_benchmark_json_keeps_to_its_shape():
    bench = registry.benchmark()
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    files = [c["file"] for c in bench["configs"]]
    assert len(set(files)) == len(files)
    for c in bench["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert sorted(cfg["reduced"]) == sorted(c["reduced"])
    for w in bench["workloads"]:
        assert w["chips"] == 1 and w["name"] == f"{w['config']}.{w['traffic']}"
        assert (ROOT / "portbench" / "traffic" / f"{w['traffic']}.json").exists()
    for m in bench["per_layer"]:
        assert (ROOT / "portbench" / "metrics" / f"{m['name']}.py").exists()


def test_a_new_mix_config_and_metric_are_files_and_entries(tmp_path,
                                                           tiny_root):
    """A throwaway cell: its configuration, mix and per-layer metric are
    new files beside copies of the harness's own parts, found by name."""
    base = tmp_path / "parts"
    for kind in ("scripts", "reference", "metrics"):
        shutil.copytree(ROOT / "portbench" / kind, base / kind)
    (base / "traffic").mkdir()
    mix = json.loads((ROOT / "portbench/traffic/l2svm.json").read_text())
    mix["check_fits"] = 2
    (base / "traffic" / "throwaway.json").write_text(json.dumps(mix))
    (base / "metrics" / "fits_read.py").write_text(
        "def read(ctx):\n    return float(len(ctx.fits))\n")
    bench = json.loads((tiny_root / "BENCHMARK.json").read_text())
    cfg = json.loads((ROOT / "portbench/configs/dense-10m.json").read_text())
    cfg.update(name="narrow", rows=5_000)
    (tiny_root / "narrow.json").write_text(json.dumps(cfg))
    bench["configs"].append({"name": "narrow", "source": "x",
                             "file": "narrow.json", "reduced": [],
                             "why": "a test"})
    bench["workloads"].append({"name": "narrow.throwaway", "config": "narrow",
                               "traffic": "throwaway", "chips": 1,
                               "why": "a test"})
    bench["per_layer"].append({"name": "fits_read", "unit": "1",
                               "better": "higher", "source": "host_clock",
                               "layer": "a test", "moves": "step_ms",
                               "workloads": ["narrow.throwaway"]})
    (tiny_root / "BENCHMARK.json").write_text(json.dumps(bench))
    res, lines = harness.run_cell("narrow.throwaway", 2 ** 33 + 5, 0.3, True,
                                  t_start=time.perf_counter(), root=tiny_root,
                                  base=base, device="cpu")
    assert res["correct"] is True and res["failed"] == 0
    assert res["metrics"]["fits_read"]["value"] == res["attempted"] >= 1
    assert "row_roofline" not in res["metrics"]      # no card, nothing read
    assert list(res)[-1] == "checks" and len(lines) == 2


class Ev:
    def __init__(self, name, start_us, dur_us, dev, act, corr=0):
        self._v = (name, int(start_us * 1e3), int(dur_us * 1e3), dev, act,
                   corr)

    def name(self):
        return self._v[0]

    def start_ns(self):
        return self._v[1]

    def duration_ns(self):
        return self._v[2]

    def device_type(self):
        return f"DeviceType.{self._v[3]}"

    def activity_type(self):
        return self._v[4]

    def correlation_id(self):
        return self._v[5]


#: the benchmark's host spans of :func:`synthetic_trace`, in seconds:
#: the window and its two fits
WINDOW = (0.0, 100e-6)
FITS = [(0.0, 40e-6), (50e-6, 100e-6)]


def synthetic_trace():
    """A 100 µs window of two fits: a Row launch (kernel + combine) and a
    library GEMV each, a copy, a gap between the fits; a kernel that runs
    before its fit span opens on the device's clock is still the fit's by
    its launch."""
    row = "void row_tile_kernel<Prog>(rk::BBinds<Prog::NB>, float*)"
    comb = "void rk::combine<Prog>(float const*, float*, int, double)"
    gemv = "internal::gemvx::kernel<int, float>"
    return [
        Ev("cudaLaunchKernel", 1, 1, "CPU", "cuda_runtime", 1),
        Ev("cudaLaunchKernel", 2, 1, "CPU", "cuda_runtime", 2),
        Ev("cudaLaunchKernel", 3, 1, "CPU", "cuda_runtime", 3),
        Ev("cudaLaunchKernel", 51, 1, "CPU", "cuda_runtime", 4),
        Ev("cudaLaunchKernel", 52, 1, "CPU", "cuda_runtime", 5),
        Ev("cudaLaunchKernel", 53, 1, "CPU", "cuda_runtime", 6),
        Ev(row, 5, 10, "CUDA", "kernel", 1),
        Ev(comb, 15, 2, "CUDA", "kernel", 2),
        Ev(gemv, 20, 10, "CUDA", "kernel", 3),
        Ev("Memcpy DtoH (Device -> Pinned)", 30, 2, "CUDA", "gpu_memcpy"),
        Ev(row, 49, 10, "CUDA", "kernel", 4),        # before its span
        Ev(comb, 59, 2, "CUDA", "kernel", 5),
        Ev(gemv, 58, 12, "CUDA", "kernel", 6),       # overlaps the combine
    ]


def reduced():
    return tracing.reduce_events(synthetic_trace(), WINDOW, FITS)


def test_trace_reduction_union_gaps_and_fits():
    tr = reduced()
    assert tr.window_s == pytest.approx(100e-6)
    assert len(tr.ops) == 7 and sum(o.kernel for o in tr.ops) == 6
    # busy: [5, 17], [20, 32], [49, 70]
    assert tr.busy_s == pytest.approx((12 + 12 + 21) * 1e-6)
    assert [round((e - s) * 1e6) for s, e in tr.gaps] == [5, 3, 17, 30]
    by_fit = tracing.ops_by_fit(tr)
    assert [len(f) for f in by_fit] == [4, 3]
    assert [o.template for o in by_fit[1]] == ["row", "row", ""]
    assert tracing.outside_fits(tr) == 0
    b = tracing.breakdown(tr)
    assert b["idle_gaps"][0] == ["fit", pytest.approx(30e-6)]
    assert b["idle_gaps"][1][0] == "none"
    assert b["device_ops"][0][0].startswith("internal::gemvx")


def test_a_launch_between_fits_is_counted_outside():
    tr = tracing.reduce_events(synthetic_trace(), WINDOW,
                               [(0.0, 40e-6), (52e-6, 100e-6)])
    assert tracing.outside_fits(tr) == 1       # launched at 51 µs


def test_the_trace_clock_is_the_profilers():
    """A host reading moved by :func:`tracing.to_trace_clock` lands where
    the profiler stamps an event it records at that moment."""
    import time as _time
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        clock = tracing.to_trace_clock()
        t0 = _time.perf_counter()
        with record_function("mark"):
            torch.ones(4).add_(1)
        t1 = _time.perf_counter()
    mark = [e for e in prof.profiler.kineto_results.events()
            if e.name() == "mark"][0]
    start = mark.start_ns() * 1e-9
    assert clock(t0) - 1e-3 <= start <= clock(t1) + 1e-3


def test_readers_on_the_synthetic_trace():
    tr = reduced()
    ctx = SimpleNamespace(trace=tr, fits=[(40e-6, 2), (50e-6, 2)], steps=4,
                          window_s=tr.window_s, plan_ms=12.5,
                          launch_seq=[("row", 0.006), ("cell", None)],
                          fit_least_ms=0.01)
    read = {e["name"]: m.read for e, m in
            registry.readers(registry.benchmark(), "dense-10m.l2svm")}
    assert read["launches_per_step"](ctx) == pytest.approx(6 / 4)
    assert read["idle_share"](ctx) == pytest.approx(55.0)
    assert read["plan_ms"](ctx) == 12.5
    # 2 fits of 0.01 ms least in 0.1 ms
    assert read["step_mfu"](ctx) == pytest.approx(20.0)
    # 2 x 6 µs least over (10 + 2) + (10 + 2) µs of Row and its combine
    assert read["row_roofline"](ctx) == pytest.approx(50.0)
    assert rooflines.share(ctx, "outer") is None
    ctx.launch_seq = [("row", 0.006), ("row", 0.006)]
    assert read["row_roofline"](ctx) is None       # no fit launched two


def test_a_fit_with_another_launch_count_is_left_out():
    """The second fit launches one Row kernel more than the first (a loop
    that ran a step further): the share is read over the fits that launch
    as many as set-up recorded, and the others are left out."""
    events = synthetic_trace()
    events.append(Ev("cudaLaunchKernel", 54, 1, "CPU", "cuda_runtime", 7))
    events.append(Ev("void row_tile_kernel<Prog>(float*)", 75, 5, "CUDA",
                     "kernel", 7))
    tr = tracing.reduce_events(events, WINDOW, FITS)
    ctx = SimpleNamespace(trace=tr, launch_seq=[("row", 0.006)])
    # the first fit alone: 6 µs over its Row kernel and combine, 12 µs
    assert rooflines.share(ctx, "row") == pytest.approx(50.0)
    ctx.launch_seq = [("row", 0.006), ("row", 0.0005)]
    # the second fit alone: 6.5 µs over 10 + 2 + 5 µs
    assert rooflines.share(ctx, "row") == pytest.approx(100 * 6.5 / 17)
    ctx.launch_seq = [("row", 0.006)] * 3
    assert rooflines.share(ctx, "row") is None      # no fit launched three


def test_a_new_roofline_is_a_file_and_an_entry(tmp_path, monkeypatch):
    """``cell_roofline``, written as a throwaway reader with its entry
    alone: the launches recorded in set-up give every Cell launch its
    least time (the kernels' CPU forms stand for the launches here), and
    the reader reads a share from a trace of those launches."""
    import numpy as np
    from portbench import launches
    from repro_torch.kernels import cellwise, multiagg, rowwise
    from conftest import tiny_config
    for mod, fn in ((cellwise, "cell_plain"), (rowwise, "row_plain"),
                    (multiagg, "multiagg_plain")):
        def counted(*a, _mod=mod, _f=getattr(mod, fn), **k):
            _mod.launches += 1
            return _f(*a, **k)
        monkeypatch.setattr(mod, fn, counted)
    cell = harness.Cell("dense-10m.l2svm")
    cfg = tiny_config(cell.cfg)
    ops = cell.script.draw(cfg, 3, "cpu")
    fin = cell.script.fit_input(ops, cfg, np.random.default_rng(0))
    _out, seq = launches.record(lambda: cell.script.port_fit(ops, fin, cfg))
    cells = [least for t, least in seq if t == "cell"]
    assert cells and all(v is not None and v > 0 for v in cells)
    assert any(t == "row" for t, _v in seq)
    # one fit's Cell launches, each taking twice its least time
    ops, t = [], 0.0
    for least in cells:
        op = tracing.Op("void cell_full_agg<Prog>(float*)", t,
                        t + 2e-3 * least, True, t)
        ops.append(op)
        t = op.end + 1e-6
    tracing.classify(ops)
    tr = tracing.Trace((0.0, t), ops, [(0.0, t)])
    base = tmp_path / "parts"
    shutil.copytree(ROOT / "portbench" / "metrics", base / "metrics")
    (base / "metrics" / "cell_roofline.py").write_text(
        "from portbench import rooflines\n\n\n"
        "def read(ctx):\n    return rooflines.share(ctx, \"cell\")\n")
    bench = registry.benchmark()
    bench["per_layer"].append({
        "name": "cell_roofline", "unit": "%", "better": "higher",
        "source": "device_trace", "layer": "Kernels: the generated CUDA "
        "kernels", "moves": "step_ms", "workloads": ["dense-10m.l2svm"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    read = {e["name"]: m.read for e, m in registry.readers(
        registry.benchmark(tmp_path), "dense-10m.l2svm", base)}
    ctx = SimpleNamespace(trace=tr, launch_seq=seq)
    assert read["cell_roofline"](ctx) == pytest.approx(50.0)


def test_no_jax_is_loaded_and_the_references_load_no_port():
    code = r"""
import pathlib, sys
sys.path[0:0] = [sys.argv[1], sys.argv[1] + "/src"]
from portbench import registry
for kind in ("reference",):
    for p in sorted(pathlib.Path(sys.argv[1], "portbench", kind).glob("*.py")):
        registry.module(kind, p.stem)
assert not any(n.split(".")[0] == "repro_torch" for n in sys.modules), \
    "a reference loads the port"
import portbench.harness, portbench.calibrate, portbench.tracing
for kind in ("scripts", "metrics"):
    for p in sorted(pathlib.Path(sys.argv[1], "portbench", kind).glob("*.py")):
        registry.module(kind, p.stem)
import repro_torch.algos, repro_torch.core, repro_torch.kernels.ops
bad = {n.split(".")[0] for n in sys.modules} & {"jax", "jaxlib", "flax", "repro"}
assert not bad, bad
print("ok")
"""
    r = subprocess.run([sys.executable, "-c", code, str(ROOT)],
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0 and r.stdout.strip() == "ok", r.stderr


def test_forbidden_names_compare_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "reprox", object())
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "repro.core", object())
    assert harness.forbidden_modules() == ["repro"]


def _run(cwd, env=None):
    return subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", "dense-10m.l2svm",
         "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=cwd,
        capture_output=True, text=True, timeout=300, env=env)


def test_no_card_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    r = _run(ROOT, env)
    assert r.returncode == 2 and r.stdout == ""
    assert "no CUDA card" in r.stderr


def test_benchmark_files_alone_give_no_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    r = _run(tmp_path)
    assert r.returncode != 0 and r.stdout == ""


def test_reservoir_keeps_k_and_draws_from_the_seed():
    import numpy as np
    picks = []
    for _ in range(2):
        r = harness.Reservoir(3, np.random.default_rng(5))
        for i in range(100):
            r.offer(i, i)
        picks.append(sorted(r.items))
    assert picks[0] == picks[1] and len(picks[0]) == 3
    assert not math.isnan(sum(picks[0]))
