"""Deterministic, seeded fault injection for the fused-plan stack.

The serving layer's resilience claims (degradation ladders, circuit
breakers, worker respawn) are only worth anything if they are
*exercised*: this module provides the chaos harness that exercises them
reproducibly.  Production code declares named **fault sites** at the
points where real systems fail and calls :func:`fault_point` there.  With
no schedule installed the call is one global read and a ``None`` check
(nanoseconds; the hot path stays hot).  Tests install a
:class:`FaultSchedule` — a seeded, deterministic list of
:class:`FaultRule`\\ s — and the same seed always produces the same fault
sequence, so every chaos scenario is a normal reproducible test, not a
flake generator.

The port's sites and their counterparts in the JAX package::

    plan.build            plan.jit_build       staged / batched plan
                                               function build (the batched
                                               build generates and compiles
                                               its CUDA kernels)
    kernels.launch        kernels.pallas_call  a fused operator's dispatch
                                               to a generated kernel
    serve.batch_dispatch  serve.batch_dispatch the batched serving dispatch
    serve.worker          serve.worker         the server's worker loop

The reference's ``dist.segment`` site (distributed segment planning) waits
for the distributed-segments slice (ROADMAP.md queue A item 5).

Fault kinds::

    error      raise FaultInjected at the site
    crash      raise WorkerCrash (worker loop: thread dies, pool respawns)
    latency    time.sleep(delay_s) at the site
    nonfinite  fault_point returns the rule; the caller poisons the
               site's *outputs* with NaN (runtime sites only)

Every registered site names its **handler** — the subsystem that turns
the injected fault into a degradation instead of a lost request.

Usage::

    from repro_torch import faults
    sched = faults.FaultSchedule([
        faults.FaultRule("serve.batch_dispatch", kind="error", at=(0,)),
        faults.FaultRule("serve.worker", kind="crash", p=0.05),
    ], seed=7)
    with faults.inject(sched):
        ...  # first batched dispatch fails; workers crash w.p. 0.05
    sched.events()   # what actually fired, in order
"""

from __future__ import annotations

import contextlib
import random
import threading
import time
from dataclasses import dataclass, field
from typing import Optional

__all__ = [
    "FaultSite", "FaultRule", "FaultSchedule", "FaultInjected",
    "WorkerCrash", "register_site", "sites", "ensure_registered",
    "install", "uninstall", "active", "inject", "fault_point", "poison",
]


class FaultInjected(RuntimeError):
    """An injected fault (kind ``error``) surfacing at a fault site.

    Handlers treat it exactly like the real failure it stands in for;
    nothing in the recovery path special-cases injected errors."""

    def __init__(self, site: str, kind: str = "error",
                 message: str = "") -> None:
        self.site = site
        self.kind = kind
        super().__init__(
            f"injected fault at {site}" + (f": {message}" if message else ""))


class WorkerCrash(FaultInjected):
    """An injected worker-thread crash (kind ``crash``) — escapes the
    per-batch error handling on purpose, so the respawn path is what
    catches it."""

    def __init__(self, site: str, message: str = "") -> None:
        super().__init__(site, "crash", message)


# --------------------------------------------------------------------------
# site registry
# --------------------------------------------------------------------------

@dataclass(frozen=True)
class FaultSite:
    """One named injection point.  ``kinds`` is the subset of fault
    kinds meaningful there; ``handler`` names the recovery mechanism
    (``fusionlint --faults`` fails on an empty one)."""
    name: str
    description: str
    kinds: tuple[str, ...]
    handler: str


_SITES: dict[str, FaultSite] = {}
_SITES_LOCK = threading.Lock()


def register_site(name: str, description: str, kinds: tuple[str, ...],
                  handler: str) -> FaultSite:
    """Declare a fault site (idempotent; module import time)."""
    site = FaultSite(name, description, tuple(kinds), handler)
    with _SITES_LOCK:
        _SITES[name] = site
    return site


def sites() -> list[FaultSite]:
    """Every registered fault site (import the stack first, or use
    :func:`ensure_registered`)."""
    with _SITES_LOCK:
        return list(_SITES.values())


def ensure_registered() -> list[FaultSite]:
    """Import every module that declares fault sites, then list them —
    the ``fusionlint --faults`` entry point."""
    import repro_torch.core.codegen   # noqa: F401  plan.build
    import repro_torch.kernels.ops    # noqa: F401  kernels.launch
    import repro_torch.serve.fusion   # noqa: F401  serve.batch_dispatch/worker
    return sites()


# --------------------------------------------------------------------------
# schedules
# --------------------------------------------------------------------------

@dataclass(frozen=True)
class FaultRule:
    """One line of a fault schedule.

    Fires at site ``site`` either on exact hit indices ``at`` (the
    site's 0-based invocation counter under the installed schedule) or
    with probability ``p`` per hit, capped at ``count`` total firings.
    ``delay_s`` is the sleep for ``latency`` faults."""
    site: str
    kind: str = "error"
    p: float = 0.0
    at: tuple[int, ...] = ()
    count: Optional[int] = None
    delay_s: float = 0.0
    message: str = ""

    def __post_init__(self):
        if self.kind not in ("error", "crash", "latency", "nonfinite"):
            raise ValueError(f"unknown fault kind {self.kind!r}")


@dataclass
class _RuleState:
    rule: FaultRule
    rng: random.Random
    fired: int = 0


class FaultSchedule:
    """A deterministic fault plan: same rules + same seed → the same
    fault sequence, independent of wall clock (each rule draws from its
    own seeded RNG, one draw per site hit, whether or not it fires)."""

    def __init__(self, rules: list[FaultRule], seed: int = 0) -> None:
        self.rules = tuple(rules)
        self.seed = int(seed)
        self._lock = threading.Lock()
        self._hits: dict[str, int] = {}
        self._states = [
            _RuleState(r, random.Random(f"{self.seed}:{i}"))
            for i, r in enumerate(self.rules)]
        self._events: list[tuple[str, str, int]] = []

    def poke(self, site: str) -> Optional[FaultRule]:
        """Advance ``site``'s hit counter; return the rule that fires
        at this hit (first match wins), or None."""
        with self._lock:
            hit = self._hits.get(site, 0)
            self._hits[site] = hit + 1
            fired: Optional[FaultRule] = None
            for st in self._states:
                if st.rule.site != site:
                    continue
                # one draw per hit keeps the sequence deterministic even
                # when an earlier rule already fired this hit
                draw = st.rng.random() if st.rule.p > 0.0 else 1.0
                if fired is not None:
                    continue
                if st.rule.count is not None and st.fired >= st.rule.count:
                    continue
                if hit in st.rule.at or draw < st.rule.p:
                    st.fired += 1
                    fired = st.rule
            if fired is not None:
                self._events.append((site, fired.kind, hit))
            return fired

    def hits(self, site: str) -> int:
        with self._lock:
            return self._hits.get(site, 0)

    def events(self) -> list[tuple[str, str, int]]:
        """Every fault that fired: ``(site, kind, hit_index)`` in order."""
        with self._lock:
            return list(self._events)


# --------------------------------------------------------------------------
# installation + the injection point
# --------------------------------------------------------------------------

#: process-global on purpose: server worker threads must observe the
#: schedule the test thread installed
_ACTIVE: Optional[FaultSchedule] = None
_ACTIVE_LOCK = threading.Lock()


def install(schedule: FaultSchedule) -> None:
    global _ACTIVE
    with _ACTIVE_LOCK:
        _ACTIVE = schedule


def uninstall() -> None:
    global _ACTIVE
    with _ACTIVE_LOCK:
        _ACTIVE = None


def active() -> Optional[FaultSchedule]:
    return _ACTIVE


@contextlib.contextmanager
def inject(schedule: FaultSchedule):
    """Install ``schedule`` for the duration of the block."""
    install(schedule)
    try:
        yield schedule
    finally:
        uninstall()


def fault_point(site: str) -> Optional[FaultRule]:
    """The injection point production code calls at a registered site.

    No schedule installed: one global read, returns None.  Otherwise
    applies the schedule's firing rule for this hit — raising for
    ``error``/``crash``, sleeping for ``latency``, and *returning* the
    rule for ``nonfinite`` so the caller can :func:`poison` the site's
    outputs (only runtime sites declare the kind)."""
    sched = _ACTIVE
    if sched is None:
        return None
    rule = sched.poke(site)
    if rule is None:
        return None
    if rule.kind == "crash":
        raise WorkerCrash(site, rule.message)
    if rule.kind == "error":
        raise FaultInjected(site, "error", rule.message)
    if rule.kind == "latency":
        time.sleep(rule.delay_s)
        return None
    return rule          # nonfinite: caller poisons its outputs


def poison(value):
    """NaN-poison one output structure (tensors, NumPy arrays / scalars,
    tuples thereof) — the runtime half of ``nonfinite`` injection.  A
    tensor stays a tensor on its device."""
    import numpy as np
    import torch
    if isinstance(value, tuple):
        return tuple(poison(v) for v in value)
    if isinstance(value, torch.Tensor):
        return value * float("nan")
    return np.asarray(value) * np.float32("nan")
