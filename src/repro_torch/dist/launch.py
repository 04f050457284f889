"""Start the rank processes of a mesh and watch them to the end.

:func:`run_ranks` starts one process per rank, all at once, and waits for
them under one deadline.  The first rank that exits with an error, or the
deadline, ends the run: every rank still alive is killed and
:class:`RankFailure` is raised with each rank's exit code and the end of
its output.  A rank stuck in a collective whose peer died therefore fails
the run at once, never stalls it.
"""

from __future__ import annotations

import os
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Callable, Optional, Sequence


class RankFailure(RuntimeError):
    """A rank exited with an error, or the deadline passed."""


def run_ranks(argv: Callable[[int], Sequence[str]], world: int,
              timeout: float, env: Optional[dict] = None,
              cwd: Optional[str] = None) -> list[str]:
    """Run ``argv(rank)`` for every rank in ``range(world)`` and return
    each rank's combined stdout and stderr, in rank order; raises
    :class:`RankFailure` when a rank fails or ``timeout`` seconds pass."""
    with tempfile.TemporaryDirectory(prefix="repro_ranks_") as tmp:
        logs = [Path(tmp) / f"rank{r}.log" for r in range(world)]
        procs = []
        try:
            for r in range(world):
                with open(logs[r], "wb") as fh:
                    procs.append(subprocess.Popen(
                        list(argv(r)), stdout=fh, stderr=subprocess.STDOUT,
                        env=env, cwd=cwd))
            deadline = time.monotonic() + timeout
            failed = None
            while True:
                codes = [p.poll() for p in procs]
                bad = [r for r, c in enumerate(codes) if c not in (None, 0)]
                if bad:
                    failed = "rank(s) " + ", ".join(
                        f"{r} (code {codes[r]})" for r in bad) + \
                        " exited with an error"
                    break
                if all(c == 0 for c in codes):
                    break
                if time.monotonic() > deadline:
                    failed = f"deadline of {timeout:g} s passed"
                    break
                time.sleep(0.05)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
            for p in procs:
                p.wait()
        outs = [log.read_text(errors="replace") for log in logs]
    if failed is not None:
        tails = "\n".join(
            f"--- rank {r} (code {p.returncode}) ---\n{out[-3000:]}"
            for r, (p, out) in enumerate(zip(procs, outs)))
        raise RankFailure(f"{failed}; every other rank was stopped\n{tails}")
    return outs


def rank_env(threads: int = 1) -> dict:
    """The environment for rank processes: this one's, with
    ``OMP_NUM_THREADS`` set (ranks share the host's cores)."""
    return dict(os.environ, OMP_NUM_THREADS=str(threads))
