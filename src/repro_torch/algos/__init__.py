"""The paper's Table-2 algorithm suite on the port.

Every algorithm runs under any experimental arm:
  mode ∈ {"gen", "fa", "fnr", "none"}  — planner arms, plus ``"hand"`` —
  direct torch, the stand-in for SystemML's hand-coded fused operators.
"""

from . import als_cg, autoencoder, data, glm, kmeans, l2svm, mlogreg

ALGOS = {
    "l2svm": l2svm,
    "mlogreg": mlogreg,
    "glm": glm,
    "kmeans": kmeans,
    "als_cg": als_cg,
    "autoencoder": autoencoder,
}
