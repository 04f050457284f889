"""``python -m repro_torch.launch.train`` on the CPU (``--device cpu``):
a run with checkpoints, then a second process that resumes from the
earlier checkpoint (the later one removed, as if the run had stopped
there) and gives the uninterrupted run's losses for the steps after it,
bit for bit (the CPU's step is deterministic)."""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

SRC = Path(__file__).resolve().parents[1] / "src"


def cli(*args) -> str:
    env = dict(os.environ, PYTHONPATH=str(SRC))
    r = subprocess.run([sys.executable, "-m", "repro_torch.launch.train",
                        "--preset", "tiny", "--device", "cpu", *args],
                       capture_output=True, text=True, timeout=300, env=env)
    assert r.returncode == 0, r.stderr[-3000:]
    return r.stdout


def losses(out: str) -> dict:
    line = [ln for ln in out.splitlines() if ln.startswith("losses ")][-1]
    rec = json.loads(line[len("losses "):])
    return {rec["first_step"] + i: v for i, v in enumerate(rec["losses"])}


@pytest.mark.parametrize("extra", [(), ("--arch", "minitron-4b",
                                        "--fusion", "gen")])
def test_cli_runs_then_resumes_to_the_same_losses(tmp_path, extra):
    ckpt = tmp_path / "ckpt"
    args = ("--steps", "6", "--batch", "2", "--seq", "16",
            "--ckpt-dir", str(ckpt), "--ckpt-every", "3", *extra)
    first = cli(*args)
    assert "step     5 loss" in first and "done: 6 steps" in first
    assert sorted(p.name for p in ckpt.iterdir()) == ["step_3", "step_6"]
    full = losses(first)
    assert sorted(full) == [1, 2, 3, 4, 5, 6]
    shutil.rmtree(ckpt / "step_6")
    second = cli(*args, "--resume")
    assert "resumed from step 3" in second
    again = losses(second)
    assert sorted(again) == [4, 5, 6]
    assert all(again[s] == full[s] for s in again), (again, full)
