"""The paper's algorithm suite on the port (this slice: L2SVM).

Every algorithm runs under any experimental arm:
  mode ∈ {"gen", "fa", "fnr", "none"}  — planner arms, plus ``"hand"`` —
  direct torch, the stand-in for SystemML's hand-coded fused operators.
"""

from . import data, l2svm

ALGOS = {
    "l2svm": l2svm,
}
