"""The port's README snippet runs verbatim: ``ci:torch_lm`` (a reduced
olmoe served by the port's ``Engine`` on the CPU) through the repo's
``tools/check_docs.py``, loaded by path as ``tests/test_docs.py`` loads
it."""

import importlib.util
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]


def _load_checker():
    spec = importlib.util.spec_from_file_location(
        "check_docs", REPO / "tools" / "check_docs.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_torch_lm_snippet_runs_verbatim():
    checker = _load_checker()
    assert "torch_lm" in checker.snippet_names()
    snippet = checker.ci_snippet("torch_lm")
    assert "Engine" in snippet and 'device="cpu"' in snippet
    assert "import jax" not in snippet and "from repro." not in snippet
    res = checker.run_snippet("torch_lm")
    assert res.returncode == 0, res.stdout + res.stderr
    outs = eval(res.stdout.strip().splitlines()[-1])
    assert [len(o) for o in outs] == [8, 8, 8]
