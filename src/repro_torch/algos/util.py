"""Small shared helpers for the algorithm suite."""

from repro_torch import spans
from repro_torch.core import FusionContext


def fs(x) -> float:
    """Python float from any single-element tensor (fused ops return
    (1,1)): the algorithms' one read from the device, in a ``sync``
    span."""
    with spans.span("sync"):
        return float(x.reshape(()))


def run_context(mode: str, kernels: str, device, layout) -> FusionContext:
    """The context an algorithm's ``run`` scopes its fused regions in:
    ``device`` when given, else the mesh's device under a layout over a
    :class:`~repro_torch.dist.Mesh` (each rank runs on its own), else the
    default (the card)."""
    ctx = FusionContext(mode=mode, kernels=kernels, layout=layout)
    mesh = getattr(layout, "mesh", layout)
    if device is None:
        device = getattr(mesh, "device", None)
    return ctx if device is None else ctx.with_(device=str(device))
