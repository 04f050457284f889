"""Immutable fusion contexts.

A :class:`FusionContext` bundles every knob the staged pipeline consumes —
selection mode, kernel policy, target device, cost-model parameters.
Contexts are frozen: "changing" one produces a new object via
:meth:`FusionContext.with_`.

Scoping is explicit.  A context is itself a context manager that pushes
onto a thread-local *stack of immutable objects* (the only mutable state),
so library code can read :func:`current_context` without threading an
argument through every call:

    ctx = FusionContext(mode="fa", device="cpu")
    with ctx:
        loss = hinge(X, w, y)          # planned and run under ctx

``fusion_mode(...)`` remains as sugar deriving a child context from the
current one.
"""

from __future__ import annotations

import contextlib
import threading
from dataclasses import dataclass, field, replace
from typing import Any, Optional

from .cost import CostParams, TPU_V5E

_STACK = threading.local()

KERNEL_MODES = ("never", "cuda")


def require_local(layout) -> None:
    """The port plans and runs on one device: distributed layouts wait for
    the distributed-segments slice (ROADMAP.md queue A item 5)."""
    if layout is not None:
        raise NotImplementedError(
            "repro_torch runs on one device: layout=None is the only "
            "layout this port supports yet (distributed segments are "
            "ROADMAP.md queue A item 5)")


@dataclass(frozen=True)
class FusionContext:
    """Immutable bundle of every knob the staged pipeline consumes.

    Fields
    ------
    mode : str
        Candidate-selection arm — ``"gen"`` (cost-based MPSkipEnum, the
        paper's contribution), ``"fa"`` (fuse-all heuristic), ``"fnr"``
        (fuse-no-redundancy), or ``"none"`` (every operator basic).
    kernels : str
        Fused-operator execution policy — ``"cuda"`` (the generated CUDA
        template kernels for tensors on the card) or ``"never"`` (the
        torch-eager interpreter of the CPlan program everywhere).  Tensors
        on the CPU always take the torch-eager path.
    device : str
        Where operands are placed and the plan runs: ``"cuda"`` (default)
        or ``"cpu"``.  Asking for ``"cuda"`` without a card raises; there
        is no fallback to the CPU.
    staged : bool
        Staged plan function (default True): the whole ExecPlan runs as one
        callable shared across structurally-equal plans through the
        whole-plan cache.  False keeps per-operator dispatch without the
        whole-plan cache (the serving ladder's bottom tier and a debug
        path), under the same ``kernels`` policy.
    params : CostParams
        Analytical cost-model constants (the reference's TPU v5e figures
        by default, so the port selects the reference's plans).
    layout : None
        Distributed layout; only ``None`` is supported (see
        :func:`require_local`).
    verify : str
        Plan-verifier level at the stage boundaries
        (:mod:`repro_torch.core.verify`) — ``"cheap"`` (default),
        ``"strict"``, or ``"off"``.  Error-severity diagnostics raise
        :class:`~repro_torch.core.verify.VerificationError`.
    rewrite : bool
        Algebraic rewrite pass between trace and plan (default True):
        ``Traced.plan()`` plans the verified DAG variants of
        :mod:`repro_torch.core.rewrite` and selects the global cost argmin.
    """

    mode: str = "gen"
    kernels: str = "cuda"
    device: str = "cuda"
    staged: bool = True
    params: CostParams = field(default_factory=lambda: TPU_V5E)
    layout: Optional[Any] = None
    verify: str = "cheap"               # "off" | "cheap" | "strict"
    rewrite: bool = True                # SPORES-style variant sweep in plan()

    def __post_init__(self) -> None:
        if self.kernels not in KERNEL_MODES:
            raise ValueError(f"kernels must be one of {KERNEL_MODES}, "
                             f"got {self.kernels!r}")

    def with_(self, **kw) -> "FusionContext":
        """Derived context with the given fields replaced."""
        return replace(self, **kw)

    def key(self) -> tuple:
        """Hashable identity used in plan-cache signatures — includes the
        cost-model constants so custom CostParams re-plan instead of
        silently reusing a plan selected under different bandwidths."""
        require_local(self.layout)
        p = self.params
        pkey = (p.read_bw, p.write_bw, p.compute_bw, p.dtype_bytes,
                p.sparse_idx_bytes, p.max_fused_inputs,
                tuple(sorted(p.input_read_bw.items())),
                p.dist.signature() if p.dist is not None else None)
        return (self.mode, self.kernels, self.device, self.staged, pkey,
                self.verify, self.rewrite)

    # -- scoping ------------------------------------------------------------
    def __enter__(self) -> "FusionContext":
        _stack().append(self)
        return self

    def __exit__(self, *exc) -> None:
        top = _stack().pop()
        assert top is self, "unbalanced FusionContext scopes"


def _stack() -> list:
    s = getattr(_STACK, "stack", None)
    if s is None:
        s = []
        _STACK.stack = s
    return s


_DEFAULT = FusionContext()


def current_context() -> FusionContext:
    """Innermost scoped context, or the process-wide default."""
    s = _stack()
    return s[-1] if s else _DEFAULT


@contextlib.contextmanager
def fusion_mode(mode: Optional[str] = None, kernels: Optional[str] = None,
                device: Optional[str] = None,
                params: Optional[CostParams] = None,
                verify: Optional[str] = None,
                rewrite: Optional[bool] = None):
    """Sugar: scope a context derived from the current one."""
    kw = {k: v for k, v in dict(mode=mode, kernels=kernels, device=device,
                                params=params, verify=verify,
                                rewrite=rewrite).items() if v is not None}
    ctx = current_context().with_(**kw)
    with ctx:
        yield ctx
