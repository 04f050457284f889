"""Fault-tolerant training loop (the reference's ``repro.train.loop``).

  * periodic **async checkpoints** with atomic commit (no corrupt latest);
  * **preemption-safe restart**: data cursor = step counter (stateless
    loader), optimizer and parameters restored from the latest checkpoint;
  * **straggler detection**: per-step wall-time EWMA; a step slower than
    ``straggler_factor``× the EWMA is recorded (logged and counted);
  * NaN/overflow guard: skip-and-log bad steps rather than poisoning the
    optimizer state.

A step's wall time ends when its loss reaches the host (``float`` of the
loss waits for the device), as the reference's ``device_get`` does.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Optional

import numpy as np

from repro_torch.checkpoint.store import CheckpointStore


@dataclass
class LoopConfig:
    total_steps: int = 100
    checkpoint_every: int = 50
    log_every: int = 10
    straggler_factor: float = 3.0
    ewma_alpha: float = 0.1
    skip_nonfinite: bool = True


@dataclass
class LoopState:
    step: int = 0
    ewma_step_time: Optional[float] = None
    straggler_events: list = field(default_factory=list)
    skipped_steps: list = field(default_factory=list)
    losses: list = field(default_factory=list)
    step_times: list = field(default_factory=list)


def run_loop(train_step: Callable, params, opt_state, loader,
             cfg: LoopConfig, store: Optional[CheckpointStore] = None,
             start_step: int = 0,
             on_metrics: Optional[Callable] = None) -> tuple:
    """Returns (params, opt_state, LoopState)."""
    st = LoopState(step=start_step)
    while st.step < cfg.total_steps:
        batch = next(loader)
        host_batch = {k: v for k, v in batch.items() if k != "step"}
        t0 = time.perf_counter()
        new_params, new_opt, metrics = train_step(params, opt_state,
                                                  host_batch)
        loss = float(metrics["loss"])
        dt = time.perf_counter() - t0
        st.step_times.append(dt)

        # ---- straggler detection -----------------------------------------
        if st.ewma_step_time is not None \
                and dt > cfg.straggler_factor * st.ewma_step_time:
            st.straggler_events.append((st.step, dt, st.ewma_step_time))
        st.ewma_step_time = (dt if st.ewma_step_time is None else
                             (1 - cfg.ewma_alpha) * st.ewma_step_time
                             + cfg.ewma_alpha * dt)

        # ---- bad-step guard -----------------------------------------------
        if cfg.skip_nonfinite and not np.isfinite(loss):
            st.skipped_steps.append(st.step)
        else:
            params, opt_state = new_params, new_opt
            st.losses.append(loss)

        st.step += 1
        if on_metrics and st.step % cfg.log_every == 0:
            on_metrics(st.step, loss, dt, metrics)
        if store is not None and st.step % cfg.checkpoint_every == 0:
            store.save(st.step, {"params": params, "opt": opt_state},
                       extra={"step": st.step})
    if store is not None:
        store.save(st.step, {"params": params, "opt": opt_state},
                   extra={"step": st.step}, blocking=True)
    return params, opt_state, st


def resume(store: CheckpointStore, params_like, opt_like) -> tuple:
    """Restart path: returns (params, opt_state, start_step) from the
    latest checkpoint, on the devices of ``params_like`` / ``opt_like``."""
    tree, extra = store.restore({"params": params_like, "opt": opt_like})
    return tree["params"], tree["opt"], int(extra["step"])
