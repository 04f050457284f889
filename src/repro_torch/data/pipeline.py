"""Deterministic, restart-exact, host-sharded token pipeline.

Design for 1000+ nodes: every host computes its shard of every global
batch purely from (seed, step, host_index) — no coordinator, no state to
checkpoint beyond the step counter, and elastic re-sharding is just a
change of (host_index, n_hosts).  Sources: synthetic LM stream (default)
or a memory-mapped token file.  A background prefetch thread keeps
``depth`` batches ready.

A copy of the reference's ``repro.data.pipeline`` (NumPy only): the same
(seed, step, index) gives the same tokens bit for bit.  Batches are NumPy
arrays; the train step moves them to its device.
"""

from __future__ import annotations

import queue
import threading
from dataclasses import dataclass
from typing import Iterator, Optional

import numpy as np


@dataclass(frozen=True)
class DataConfig:
    seq_len: int = 1024
    global_batch: int = 8
    vocab: int = 256
    seed: int = 0
    n_codebooks: int = 1
    token_file: Optional[str] = None     # memmap int32 tokens
    prefetch_depth: int = 2


class TokenSource:
    """Maps (step, global example index) → token sequence, statelessly."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        self._mm = None
        if cfg.token_file:
            self._mm = np.memmap(cfg.token_file, dtype=np.int32, mode="r")

    def example(self, step: int, index: int) -> np.ndarray:
        cfg = self.cfg
        L = cfg.seq_len + 1
        if self._mm is not None:
            n_windows = (len(self._mm) - 1) // L
            # deterministic shuffled window id
            rng = np.random.default_rng(
                (cfg.seed * 1_000_003 + step) * 1_000_003 + index)
            w = int(rng.integers(0, n_windows))
            seq = np.asarray(self._mm[w * L:(w + 1) * L])
        else:
            rng = np.random.default_rng(
                (cfg.seed * 1_000_003 + step) * 1_000_003 + index)
            shape = (L, cfg.n_codebooks) if cfg.n_codebooks > 1 else (L,)
            seq = rng.integers(0, cfg.vocab, size=shape, dtype=np.int32)
        return seq


class ShardedLoader:
    """Yields this host's shard of each global batch."""

    def __init__(self, cfg: DataConfig, host_index: int = 0,
                 n_hosts: int = 1, start_step: int = 0):
        assert cfg.global_batch % n_hosts == 0
        self.cfg = cfg
        self.source = TokenSource(cfg)
        self.host_index = host_index
        self.n_hosts = n_hosts
        self.step = start_step
        self._q: queue.Queue = queue.Queue(maxsize=cfg.prefetch_depth)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _build(self, step: int) -> dict:
        cfg = self.cfg
        per_host = cfg.global_batch // self.n_hosts
        lo = self.host_index * per_host
        seqs = np.stack([self.source.example(step, lo + i)
                         for i in range(per_host)])
        return {"tokens": seqs[:, :-1], "targets": seqs[:, 1:],
                "step": step}

    def _worker(self) -> None:
        step = self.step
        while not self._stop.is_set():
            batch = self._build(step)
            while not self._stop.is_set():
                try:
                    self._q.put(batch, timeout=0.1)
                    break
                except queue.Full:
                    continue
            step += 1

    def __next__(self) -> dict:
        batch = self._q.get()
        self.step = batch["step"] + 1
        return batch

    def __iter__(self) -> Iterator[dict]:
        return self

    def close(self) -> None:
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=2)
