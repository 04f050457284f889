"""Atomic, async checkpointing in the reference's on-disk format.

Layout: ``<dir>/step_<n>/{manifest.json, arrays.npz}`` written to a temp
directory and atomically renamed on commit — a crash mid-save never
corrupts the latest checkpoint.  Saves run on a background thread
(training continues; ``wait()`` joins, and an error of the save thread is
raised by the next call).  The npz keys are the reference's: the tree's
key paths joined with ``/`` (dict keys sorted), so either package reads
what the other wrote.

Every tensor is copied to host memory before :meth:`CheckpointStore.save`
returns: the reference's async save may hand its arrays to the thread
because JAX arrays are immutable, but the port's optimizer updates its
tensors in place, and the next step must not change a tensor that the
thread is still writing.

bf16 leaves are stored as the reference stores them, as raw 2-byte
``|V2`` records (NumPy has no bfloat16), and restored by reinterpreting
those bits as ``torch.bfloat16``.  The reference's own restore casts them
with ``astype`` and so cannot read them back (ROADMAP.md queue C).
"""

from __future__ import annotations

import json
import os
import shutil
import threading
import time
from pathlib import Path
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.tree import flatten_with_path, map_with_path, path_key

#: NumPy's dtype of a raw bf16 record, as ``np.savez`` stores the
#: reference's bf16 arrays
BF16_RECORD = np.dtype("V2")


def to_host(leaf) -> np.ndarray:
    """A copy of one leaf in host memory as NumPy (bf16 as ``|V2``
    records of its bits)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu", copy=True)
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(BF16_RECORD)
        return t.numpy()
    return np.array(leaf)


def from_host(arr: np.ndarray, like) -> Any:
    """A stored array as a leaf like ``like``: a tensor of its dtype on its
    device (``|V2`` records are bf16 bits), else a NumPy array."""
    if arr.dtype == BF16_RECORD:
        t = torch.from_numpy(np.ascontiguousarray(arr).view(np.int16)) \
            .view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(arr))
    if isinstance(like, torch.Tensor):
        return t.to(device=like.device, dtype=like.dtype)
    return t.numpy() if t.dtype != torch.bfloat16 else arr


def _flatten(tree) -> dict[str, np.ndarray]:
    return {path_key(p): to_host(leaf) for p, leaf in flatten_with_path(tree)}


class CheckpointStore:
    def __init__(self, directory: str | Path, keep: int = 3):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    # -- save ---------------------------------------------------------------
    def save(self, step: int, tree: Any, extra: Optional[dict] = None,
             blocking: bool = False) -> None:
        self.wait()
        flat = _flatten(tree)          # device→host copy happens here
        meta = {"step": step, "extra": extra or {},
                "keys": sorted(flat), "time": time.time()}

        def _write():
            try:
                tmp = self.dir / f".tmp_step_{step}"
                if tmp.exists():
                    shutil.rmtree(tmp)
                tmp.mkdir(parents=True)
                np.savez(tmp / "arrays.npz", **flat)
                (tmp / "manifest.json").write_text(json.dumps(meta))
                final = self.dir / f"step_{step}"
                if final.exists():
                    shutil.rmtree(final)
                os.rename(tmp, final)
                self._gc()
            except BaseException as e:   # surfaced by wait()
                self._error = e

        if blocking:
            _write()
            self._raise_if_failed()
        else:
            self._thread = threading.Thread(target=_write, daemon=True)
            self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        self._raise_if_failed()

    def _raise_if_failed(self):
        if self._error is not None:
            e, self._error = self._error, None
            raise e

    def _gc(self) -> None:
        steps = sorted(self.steps())
        for s in steps[:-self.keep]:
            shutil.rmtree(self.dir / f"step_{s}", ignore_errors=True)

    # -- restore ------------------------------------------------------------
    def steps(self) -> list[int]:
        out = []
        for p in self.dir.glob("step_*"):
            if (p / "manifest.json").exists():
                out.append(int(p.name.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        s = self.steps()
        return s[-1] if s else None

    def restore(self, like: Any, step: Optional[int] = None
                ) -> tuple[Any, dict]:
        """Restore into the structure of ``like`` (the latest step by
        default): each leaf a new tensor of the ``like`` leaf's dtype on its
        device.  Returns (tree, the manifest's ``extra``)."""
        step = step if step is not None else self.latest_step()
        assert step is not None, "no checkpoint found"
        d = self.dir / f"step_{step}"
        meta = json.loads((d / "manifest.json").read_text())
        with np.load(d / "arrays.npz") as arrays:
            tree = map_with_path(
                lambda path, leaf: from_host(arrays[path_key(path)], leaf),
                like)
        return tree, meta["extra"]
