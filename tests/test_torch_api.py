"""The staged API of the port against the JAX reference's: ``fused →
trace → plan → compile``, forward and gradient (``torch.autograd.grad``
against ``jax.grad`` of the summed outputs), on the L2SVM, mlogreg and
kmeans regions, through ``tests/torch_harness.py``.  Tolerance 1e-5."""

import ast
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core import FusionContext, fused, ir
from repro_torch.kernels import cellwise, multiagg, rowwise

from torch_harness import allclose, regions, run_reference
from torch_regions import GRADS, inputs, run_port

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parents[1]
REGIONS = regions(48, 12, k=3)
@pytest.mark.parametrize("name", sorted(REGIONS))
def test_forward_and_gradient_match_reference(name):
    ref, port, shapes = REGIONS[name]
    vals = inputs(shapes, seed=sum(map(ord, name)))
    grad_wrt = GRADS.get(name, ())
    want, want_g = run_reference(ref, vals, grad_wrt)
    got, got_g = run_port(port, vals, grad_wrt)
    allclose(got, want, label=f"{name} fwd")
    for g in grad_wrt:
        allclose(got_g[g], want_g[g], label=f"{name} grad[{g}]")


@pytest.mark.parametrize("kernels", ["cuda", "never"])
def test_kernel_policy_on_cpu_is_the_plain_path(kernels):
    """On CPU tensors both policies run the torch-eager oracle: same
    numbers, and no kernel launches."""
    ref, port, shapes = REGIONS["l2svm/objective_full"]
    vals = inputs(shapes)
    before = (cellwise.launches, multiagg.launches, rowwise.launches)
    got, grads = run_port(port, vals, ("w",), kernels=kernels)
    want, want_g = run_reference(ref, vals, ("w",))
    allclose(got, want)
    allclose(grads["w"], want_g["w"])
    assert (cellwise.launches, multiagg.launches, rowwise.launches) == before


def test_vector_world_round_trip():
    f = fused(lambda x, y: ir.relu(x * y))
    ctx = FusionContext(device="cpu")
    x = np.arange(5, dtype=np.float32) - 2
    with ctx:
        out = f(x, 2.0)
    assert tuple(out.shape) == (5,)
    np.testing.assert_allclose(out.numpy(), np.maximum(2 * x, 0))
    with ctx:
        s = fused(lambda x: (x * x).sum())(x)
    assert tuple(s.shape) == () and float(s) == pytest.approx(10.0)


def test_explain_reports_plan_and_execution():
    ref, port, shapes = REGIONS["l2svm/objective_full"]
    planned = port.trace(**inputs(shapes)).plan(
        context=FusionContext(device="cpu"))
    rep = planned.explain(include_backward=True)
    assert rep["winner"]["operators"] == planned.fused_signatures()
    assert rep["execution"]["donated_inputs"] == []
    assert rep["execution"]["kernels"] == "cuda"
    assert rep["backward"]["n_operators"] > 0
    assert {c["mode"] for c in rep["candidates"]} == {"gen", "fa", "fnr",
                                                      "none"}


def test_port_imports_neither_jax_nor_repro():
    code = ("import sys, repro_torch, repro_torch.algos.l2svm, "
            "repro_torch.algos.als_cg, repro_torch.algos.data, "
            "repro_torch.interop, repro_torch.kernels.blocksparse, "
            "repro_torch.kernels.outerprod, repro_torch.kernels.cuda_src, "
            "repro_torch.kernels.ops, repro_torch.kernels.build, "
            "repro_torch.kernels.sweep, repro_torch.core.api, "
            "repro_torch.faults, repro_torch.serve, "
            "repro_torch.serve.fusion, repro_torch.serve.metrics, "
            "repro_torch.serve.engine, repro_torch.launch.serve, "
            "repro_torch.models, repro_torch.models.layers, "
            "repro_torch.models.attention, repro_torch.models.lm, "
            "repro_torch.configs, repro_torch.configs.registry\n"
            "from repro_torch.configs import ARCH_IDS, get_config\n"
            "cfgs = [get_config(a) for a in ARCH_IDS]\n"
            "from repro_torch import faults\n"
            "faults.ensure_registered()\n"
            "from repro_torch.kernels import cuda_src, sweep\n"
            "for c in sweep.cases():\n"
            "    sweep.fused_cplan(c, 8, 4)\n"
            "for c in sweep.outer_cases():\n"
            "    cp, _ = sweep.fused_cplan(c, *c.shape, {'X': 0.5})\n"
            "    cuda_src.source_for(cp, c.bs)\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro'))\n"
            "print(bad)\nsys.exit(1 if bad else 0)\n")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120,
                       env={"PYTHONPATH": str(ROOT / "src"),
                            "PATH": "/usr/bin:/bin"})
    assert r.returncode == 0, r.stdout + r.stderr


def _imported_names(tree):
    """Every module name a source imports: import statements, and
    ``importlib.import_module`` / ``__import__`` calls with a literal (or
    f-string) first argument; a call whose name is not spelled out in the
    source is reported as ``?``."""
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""
        elif isinstance(node, ast.Call):
            f = node.func
            name = f.attr if isinstance(f, ast.Attribute) else \
                getattr(f, "id", None)
            if name not in ("import_module", "__import__"):
                continue
            arg = node.args[0] if node.args else None
            if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
                yield arg.value
            elif isinstance(arg, ast.JoinedStr) and arg.values and \
                    isinstance(arg.values[0], ast.Constant):
                yield str(arg.values[0].value)
            else:
                yield "?"


def test_import_scan_sees_dynamic_imports():
    tree = ast.parse("import importlib\n"
                     "importlib.import_module(f'{pkg}.core.ir')\n"
                     "__import__('jax.numpy')\n"
                     "import_module('repro.core')\n")
    assert list(_imported_names(tree)) == ["importlib", "?", "jax.numpy",
                                           "repro.core"]


@pytest.mark.parametrize("path", sorted(
    [str(p.relative_to(ROOT)) for p in (ROOT / "src" / "repro_torch")
     .rglob("*.py")] + ["chip_smoke.py"]))
def test_no_jax_or_repro_import_in_source(path):
    tree = ast.parse((ROOT / path).read_text())
    for n in _imported_names(tree):
        assert n.split(".")[0] not in ("jax", "jaxlib", "repro", "?"), \
            f"{path} imports {n}"
