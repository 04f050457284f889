"""Cost-based operator-fusion-plan optimization (the paper's contribution).

Pipeline: IR (HOP DAG) → OFMC candidate exploration (memo table) →
cost-based candidate selection (plan partitions, interesting points,
MPSkipEnum) → code generation (CPlans → generated CUDA kernels / torch
fused operators, plan cache).

Public surface: the staged API (``fused(fn).trace(...).plan(...)
.compile()``), its ``@fused`` call sugar, immutable
:class:`FusionContext` scoping, layout-aware execution
(:class:`FusionLayout`), and plan-cache introspection.  The module
``__all__`` below equals the reference's ``repro.core.__all__``
(``tests/test_torch_api_surface.py``).
"""

from . import ir
from .api import (Compiled, Fused, FusionInputError, Planned, Traced,
                  fuse_exprs, fused)
from .codegen import plan_cache_stats, whole_plan_cache_stats
from .context import (FusionContext, current_config, current_context,
                      fusion_mode)
from .cost import CostParams, TPU_V5E
from .grad import NonDifferentiableError
from .layout import FusionLayout
from .partitions import PlanInvariantError
from .select import plan
from .verify import (Diagnostic, VerificationError, VerifyReport,
                     verify_plan)

__all__ = [
    # IR + planning entry points
    "ir", "plan",
    # staged pipeline
    "Fused", "fused", "Traced", "Planned", "Compiled", "fuse_exprs",
    # contexts
    "FusionContext", "fusion_mode", "current_context", "current_config",
    # layout-aware execution
    "FusionLayout",
    # cost model
    "CostParams", "TPU_V5E",
    # plan verifier
    "Diagnostic", "VerifyReport", "verify_plan",
    # introspection + errors
    "plan_cache_stats", "whole_plan_cache_stats",
    "NonDifferentiableError", "FusionInputError",
    "PlanInvariantError", "VerificationError",
]
