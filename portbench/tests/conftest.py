"""The benchmark's own tests (``python -m pytest portbench/tests`` from the
repo root; the tests marked ``gpu`` need the card and skip without it)."""

import json
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)


def tiny_config(cfg: dict) -> dict:
    """A configuration cut to a size the CPU runs in a blink."""
    cfg = dict(cfg)
    if cfg["data"] == "dense":
        cfg["rows"] = 20_000
    else:
        cfg["rows"], cfg["cols"] = 2_000, 1_000
    return cfg


@pytest.fixture
def tiny_root(tmp_path):
    """A root whose BENCHMARK.json is the repo's, its configurations cut
    by :func:`tiny_config`."""
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for c in bench["configs"]:
        cfg = tiny_config(json.loads((ROOT / c["file"]).read_text()))
        dst = tmp_path / c["file"]
        dst.parent.mkdir(parents=True, exist_ok=True)
        dst.write_text(json.dumps(cfg))
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    return tmp_path


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")
