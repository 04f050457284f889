"""Small shared helpers for the algorithm suite."""


def fs(x) -> float:
    """Python float from any single-element tensor (fused ops return
    (1,1))."""
    return float(x.reshape(()))
