"""``tools/fusionlint_torch.py`` (the port's plan linter) against the
reference's ``tools/fusionlint.py``.

Both tools are loaded by path (as ``tests/test_verify.py`` loads the
reference's) and run in this process, the port's with ``device="cpu"``:
each returns 0 and prints the same summary line — plans verified,
errors, warnings and, under ``--strict``, fallbacks (none silent) and
rewrite variants — over the same regions, modes and meshes.
"""

import importlib.util
import subprocess
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[1]


def _load(name: str):
    spec = importlib.util.spec_from_file_location(
        name, REPO / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def tools():
    return _load("fusionlint_torch"), _load("fusionlint")


def summary(capsys) -> str:
    lines = capsys.readouterr().out.strip().splitlines()
    return lines[-1]


ALL = ["l2svm", "mlogreg", "kmeans", "glm", "autoencoder", "als_cg"]


@pytest.mark.parametrize("level,algos,serving", [
    ("cheap", ALL, False),
    ("strict", ["l2svm", "kmeans", "als_cg"], False),
    ("strict", ["mlogreg"], True),
])
def test_counts_match_the_reference(tools, capsys, level, algos, serving):
    port, ref = tools
    modes = list(ref.MODES) if level == "cheap" else ["gen"]
    assert port.lint(algos, modes, level, verbose=False, serving=serving,
                     device="cpu") == 0
    got = summary(capsys)
    assert ref.lint(algos, modes, level, verbose=False,
                    serving=serving) == 0
    want = summary(capsys)
    assert got == want
    assert "0 error(s)" in got
    if level == "strict":
        assert "(0 silent)" in got and "(0 unclean)" in got


def test_faults_every_site_handled(tools, capsys):
    port, ref = tools
    assert port.main(["--faults", "--verbose"]) == 0
    out = capsys.readouterr().out
    assert "[MISSING HANDLER]" not in out
    assert ref.main(["--faults"]) == 0
    assert out.strip().splitlines()[-1] == \
        capsys.readouterr().out.strip().splitlines()[-1]
    from repro_torch import faults
    assert {s.name for s in faults.ensure_registered()} >= {
        "plan.build", "kernels.launch", "serve.batch_dispatch",
        "serve.worker"}


def test_serving_verifies_the_warmed_plans(tools, capsys):
    """--serving: a workers=0 FusionServer warmed (planned, nothing run)
    on the harness's hinge and softmax regions at three row classes
    holds six plans, each verifying strict-clean."""
    port, _ref = tools
    n, failed = port.lint_serving("strict", verbose=True, device="cpu")
    assert (n, failed) == (6, [])
    out = capsys.readouterr().out
    assert out.count("serving/") >= 6


def test_cli_imports_nothing_of_the_reference():
    code = ("import runpy, sys; sys.argv = ['fusionlint_torch', "
            "'--algo', 'kmeans', '--mode', 'gen', '--strict', "
            "'--device', 'cpu'];\n"
            "try:\n runpy.run_path('tools/fusionlint_torch.py', "
            "run_name='__main__')\n"
            "except SystemExit as e:\n assert e.code == 0, e.code\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'repro')]\nassert not bad, bad\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    assert "0 error(s)" in res.stdout


def test_the_card_is_the_default_device(tools):
    port, _ref = tools
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device resolves")
    with pytest.raises(RuntimeError, match="is_available"):
        port.main(["--algo", "kmeans", "--mode", "gen"])
