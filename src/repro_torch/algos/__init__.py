"""The paper's algorithm suite on the port (so far: L2SVM and ALS-CG).

Every algorithm runs under any experimental arm:
  mode ∈ {"gen", "fa", "fnr", "none"}  — planner arms, plus ``"hand"`` —
  direct torch, the stand-in for SystemML's hand-coded fused operators.
"""

from . import als_cg, data, l2svm

ALGOS = {
    "l2svm": l2svm,
    "als_cg": als_cg,
}
