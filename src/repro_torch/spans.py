"""Host spans: named intervals recorded where the port does its work, so
that a device trace's idle gaps can be named by what the host was doing.

A call site opens a span by name::

    from repro_torch import spans
    with spans.span("sync"):
        value = float(t.reshape(()))

With no recorder installed :func:`span` is one global read and returns a
shared no-op object: no allocation, no clock read.  :func:`recording`
installs a :class:`Recorder` for the duration of a block, the way
:func:`repro_torch.faults.inject` installs a fault schedule; it keeps
every span closed meanwhile in memory, on the clock of
``time.perf_counter_ns()``, and records Python's collector passes as
``py.gc`` spans (through ``gc.callbacks``, hooked only while recording).
Nothing is written anywhere: the caller reads ``Recorder.spans``, a
:class:`Span` each.

Recording is kept cheap, since it runs inside the timed fits: an open and
a close each add one (name, thread, clock) triple to a flat list in one
call, through one shared object a name (no allocation that outlives the
call, so the collector runs no more often); the tree is rebuilt when
``spans`` is read.

A span's parent is the innermost span open on its own thread; a span
opened on a thread with none open takes the innermost open ``*.run`` span
(an algorithm's fit, on any thread) as its parent, so that the planned
backward, which runs on autograd's device thread, shares its fit's root.

The port's spans::

    <algo>.run              an algorithm's ``run`` call (algos/)
    <algo>.init             its host-side set-up before the loop
    als_cg.transpose        ALS's Xᵀ, each fit
    sync                    a device-to-host read (``algos.util.fs``), or
                            a call that makes the host wait for the card
                            (a copy from pageable host memory, BCSR.pieces'
                            repeat_interleave, the BCSR segment sums'
                            segment_reduce); the ragged expert layer's
                            group sizes, a train step's finiteness check
    fused.call:<region>     a fused region's call (``Fused.__call__``)
    fused.backward:<region> its planned backward (autograd's backward)
    fused.plan:<region>     trace, plan and compile on a signature miss,
                            and each backward plan's first compile (one
                            per set of inputs differentiated)
    kernels.build           building the generated kernels, and loading
                            one on a launcher miss
    py.gc                   one pass of Python's cyclic collector
    train.step              one optimizer step (``launch.train``)
    optim.adamw             its AdamW update
    attn.window, attn.full  an attention layer with / without a sliding
                            window (``models.attention``), forward, and
                            its backward (:func:`backward_span`)
    moe                     an expert layer (``models.moe``), forward and
                            backward

Counters are readings of one call, kept beside the spans under the same
recorder (:attr:`Recorder.counts`); with no recorder :func:`count` is one
global read::

    attn.blocks             (query block, key block) tiles one attention
                            call visits, over its batch rows and heads
    moe.held_slots          (token, slot) pairs one expert-layer call
                            routes to the experts held here
"""

from __future__ import annotations

import contextlib
import functools
import gc
import threading
import time
from typing import NamedTuple, Optional

__all__ = ["Span", "Count", "Recorder", "NOOP", "span", "spanned",
           "backward_span", "count", "recording", "active"]

_now = time.perf_counter_ns
_thread = threading.get_ident


class Span(NamedTuple):
    """One closed span; times in ``time.perf_counter_ns()`` nanoseconds."""
    id: int
    parent: Optional[int]
    thread: int
    name: str
    start_ns: int
    end_ns: int


class Count(NamedTuple):
    """One counter reading: ``value`` for one call, read at ``ns``."""
    name: str
    value: int
    ns: int


class _NoSpan:
    """What :func:`span` returns with no recorder installed (:data:`NOOP`,
    also for a call site whose span does not apply)."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


NOOP = _NoSpan()
_ACTIVE: Optional["Recorder"] = None
_ACTIVE_LOCK = threading.Lock()


class _Named:
    """The spans of one name under one recorder: each open and close adds
    a (name, thread, clock) triple to the recorder's log, a close with the
    name None.  It keeps nothing of a call, so one object serves every
    call of its name, on every thread."""
    __slots__ = ("_add", "name")

    def __init__(self, add, name: str):
        self._add, self.name = add, name

    def __enter__(self):
        self._add((self.name, _thread(), _now()))
        return self

    def __exit__(self, *exc):
        self._add((None, _thread(), _now()))
        return False


class Recorder:
    """The spans closed while it was installed (:attr:`spans`)."""

    def __init__(self) -> None:
        self._log: list = []        # flat (name or None, thread, ns) triples
        self._add = self._log.extend
        self._named: dict[str, _Named] = {}
        #: every counter reading, in the order they were taken
        self.counts: list[Count] = []

    def _span(self, name: str) -> _Named:
        named = self._named.get(name)
        if named is None:
            named = self._named[name] = _Named(self._add, name)
        return named

    def _replay(self):
        """(closed spans in the order they closed, the spans still open
        on each thread): a span's parent is the innermost span open on its
        thread, else the innermost open ``*.run`` span on any thread."""
        log = self._log
        stacks: dict[int, list] = {}
        runs: list = []
        closed: list[Span] = []
        ids = 0
        for i in range(0, len(log) - 2, 3):
            name, thread, ns = log[i], log[i + 1], log[i + 2]
            stack = stacks.setdefault(thread, [])
            if name is not None:
                ids += 1
                parent = stack[-1][0] if stack else (
                    runs[-1][0] if runs else None)
                entry = (ids, parent, name, ns)
                stack.append(entry)
                if name.endswith(".run"):
                    runs.append(entry)
            elif stack:
                sid, parent, sname, start = entry = stack.pop()
                if sname.endswith(".run"):
                    runs.remove(entry)
                closed.append(Span(sid, parent, thread, sname, start, ns))
        return closed, stacks

    @property
    def spans(self) -> list[Span]:
        """Every span closed so far, in the order they closed."""
        return self._replay()[0]

    def open_names(self) -> list[str]:
        """The names of the spans open on the calling thread, outermost
        first."""
        return [e[2] for e in self._replay()[1].get(_thread(), [])]

    def _gc(self, phase: str, info: dict) -> None:
        """``gc.callbacks`` hook: one ``py.gc`` span a collector pass."""
        self._add(("py.gc" if phase == "start" else None, _thread(), _now()))


def span(name: str):
    """A context manager recording the span ``name`` under the installed
    recorder; the shared no-op object when none is installed."""
    rec = _ACTIVE
    if rec is None:
        return NOOP
    return rec._span(name)


def count(name: str, value: int) -> None:
    """Record ``value``, one call's reading of the counter ``name``, under
    the installed recorder; nothing without one."""
    rec = _ACTIVE
    if rec is not None:
        rec.counts.append(Count(name, int(value), _now()))


def backward_span(name: str, inp, out) -> None:
    """Record the span ``name`` over autograd's backward from ``out`` to
    ``inp`` (tensors): a gradient hook on ``out`` opens it, one on ``inp``
    closes it, both on autograd's thread.  Nothing without a recorder, or
    where either tensor takes no gradient."""
    rec = _ACTIVE
    if rec is None or not (getattr(inp, "requires_grad", False)
                           and getattr(out, "requires_grad", False)):
        return
    named = rec._span(name)

    def opened(grad):
        named.__enter__()

    def closed(grad):
        named.__exit__(None, None, None)
    out.register_hook(opened)
    inp.register_hook(closed)


def spanned(name: str):
    """Decorator: each call of the function runs inside ``span(name)``."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return call
    return wrap


def active() -> Optional[Recorder]:
    """The installed recorder, or None."""
    return _ACTIVE


@contextlib.contextmanager
def recording():
    """Install a new :class:`Recorder` (and its ``py.gc`` hook) for the
    block; yields it.  One recorder at a time: raises when one is
    installed."""
    global _ACTIVE
    rec = Recorder()
    with _ACTIVE_LOCK:
        if _ACTIVE is not None:
            raise RuntimeError("a span recorder is already installed")
        _ACTIVE = rec
    hook = rec._gc
    gc.callbacks.append(hook)
    try:
        yield rec
    finally:
        gc.callbacks.remove(hook)
        with _ACTIVE_LOCK:
            _ACTIVE = None
