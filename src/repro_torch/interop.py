"""Operands carried across packages: data, the iterate and, for the LM,
its weights and optimizer state.  :func:`to_torch` turns numpy arrays (or
arrays produced by another framework and converted to numpy) into
contiguous fp32 tensors on a device; :func:`to_bcsr` carries a block-sparse
matrix across (the reference's ``BCSR`` or anything with its attributes),
and :func:`to_dict_compressed` a CLA-compressed one (the reference's
``DictCompressed`` or anything with its attributes); :func:`to_sharded_bcsr`
carries a block-row partition, and :func:`to_layout` a layout over an
abstract mesh (the reference's ``FusionLayout`` over its ``LogicalMesh``),
so both packages can be handed the same plan inputs;
:func:`lm_params_from_jax` turns the reference's LM params tree into the
port's LM state dict, :func:`lm_cache_from_jax` its caches (K/V and
recurrent states) into the port's, and :func:`adamw_state_from_jax` its
AdamW state into the port's."""

from __future__ import annotations

import numpy as np
import torch

from repro_torch import spans
from repro_torch.kernels.blocksparse import BCSR, DictCompressed, ShardedBCSR


def resolve_device(device) -> torch.device:
    """``device`` as a torch device; raises when the card is asked for and
    there is none (never falls back to the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={str(device)!r} was requested but "
            f"torch.cuda.is_available() is False; pass device='cpu' to run "
            f"on the CPU")
    return dev


def to_torch(values, device="cuda"):
    """Contiguous fp32 tensor(s) on ``device`` from one array-like, or a
    list / tuple of them (same structure back).  A copy from the host to
    the card runs in a ``sync`` span: from pageable memory it waits for
    the card's queue."""
    device = resolve_device(device)
    if isinstance(values, (list, tuple)):
        return type(values)(to_torch(v, device) for v in values)
    to_card = device.type == "cuda"
    if isinstance(values, torch.Tensor):
        with (spans.span("sync") if to_card and values.device.type == "cpu"
              else spans.NOOP):
            return values.to(device=device, dtype=torch.float32).contiguous()
    with spans.span("sync") if to_card else spans.NOOP:
        return torch.as_tensor(np.ascontiguousarray(values, dtype=np.float32),
                               device=device)


def to_bcsr(x, device="cuda"):
    """The port's :class:`~repro_torch.kernels.blocksparse.BCSR` on
    ``device`` from any object with numpy-convertible ``data`` (nb, bs,
    bs) fp32, ``rows`` / ``cols`` (nb,) block indices sorted row-major,
    and a ``shape`` and ``bs``: the reference's BCSR (duck-typed, nothing
    of its package is imported) or the port's own."""
    device = resolve_device(device)
    if isinstance(x, BCSR):
        return x.to(device)
    idx = lambda a: torch.as_tensor(np.array(a, dtype=np.int32),
                                    device=device)
    return BCSR(to_torch(np.array(x.data, dtype=np.float32), device),
                idx(x.rows), idx(x.cols), tuple(x.shape), int(x.bs))


def to_dict_compressed(x, device="cuda"):
    """The port's :class:`~repro_torch.kernels.blocksparse.DictCompressed`
    on ``device`` from any object with numpy-convertible ``values`` (ncol,
    ndist) fp32, ``codes`` (nrow, ncol) int32 and ``counts`` (ncol, ndist)
    fp32 and a ``shape``: the reference's DictCompressed (duck-typed,
    nothing of its package is imported) or the port's own."""
    device = resolve_device(device)
    if isinstance(x, DictCompressed):
        return x.to(device)
    return DictCompressed(
        to_torch(np.array(x.values, dtype=np.float32), device),
        torch.as_tensor(np.array(x.codes, dtype=np.int32), device=device),
        to_torch(np.array(x.counts, dtype=np.float32), device),
        tuple(x.shape))


def to_sharded_bcsr(x, device="cuda"):
    """The port's :class:`~repro_torch.kernels.blocksparse.ShardedBCSR` on
    ``device`` from any object with numpy-convertible ``data`` (nparts,
    nb_max, bs, bs) fp32, ``rows`` / ``cols`` (nparts, nb_max) block
    indices, and a ``shape``, ``bs`` and ``nparts``: the reference's
    ShardedBCSR (duck-typed) or the port's own."""
    device = resolve_device(device)
    if isinstance(x, ShardedBCSR):
        return x.to(device)
    idx = lambda a: torch.as_tensor(np.array(a, dtype=np.int32),
                                    device=device)
    return ShardedBCSR(to_torch(np.array(x.data, dtype=np.float32), device),
                       idx(x.rows), idx(x.cols), tuple(x.shape), int(x.bs),
                       int(x.nparts))


def to_layout(layout):
    """The port's :class:`~repro_torch.core.layout.FusionLayout` from a
    layout over an abstract mesh: anything with a ``mesh`` (``.shape`` and
    ``.axis_names``) and ``specs`` mapping names to partition specs (each
    a sequence of entries) — the reference's FusionLayout over its
    LogicalMesh (duck-typed).  The mesh becomes a
    :class:`~repro_torch.dist.LogicalMesh`, each spec a tuple."""
    from repro_torch.core.layout import FusionLayout
    from repro_torch.dist import LogicalMesh
    mesh = LogicalMesh({a: int(layout.mesh.shape[a])
                        for a in layout.mesh.axis_names})
    return FusionLayout(mesh, {name: tuple(spec)
                               for name, spec in layout.specs.items()})


def _leaf_tensor(a) -> torch.Tensor:
    """A CPU tensor of one array leaf in its own dtype.  A JAX bf16 array
    comes across as numpy's ``ml_dtypes.bfloat16``, which
    ``torch.from_numpy`` refuses: it is widened to fp32 (exact) and cast
    back."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def lm_params_from_jax(tree) -> dict:
    """The port's :class:`~repro_torch.models.LM` state dict from the
    reference's params tree (leaves as numpy arrays): ``blocks[i]`` leaves
    (G, ...) are unstacked into layer ``g * P + i`` (P pattern layers a
    group), ``rest[j]`` becomes layer ``G * P + j``; every leaf kind
    (attention, MLP, MoE experts (E, d, f), Mamba, mLSTM) carries over
    under its name.  Load it with ``LM.load_state_dict``."""
    state = {"embed": _leaf_tensor(tree["embed"])}
    if "head" in tree:
        state["head"] = _leaf_tensor(tree["head"])
    for k, v in tree["final_norm"].items():
        state[f"final_norm.{k}"] = _leaf_tensor(v)
    blocks = tree["blocks"]
    P = len(blocks)
    G = 0
    for i, block in enumerate(blocks):
        for name, params in block.items():
            for k, v in params.items():
                t = _leaf_tensor(v)
                G = t.shape[0]
                for g in range(G):
                    state[f"layers.{g * P + i}.{name}.{k}"] = t[g].clone()
    for j, layer in enumerate(tree.get("rest", [])):
        for name, params in layer.items():
            for k, v in params.items():
                state[f"layers.{G * P + j}.{name}.{k}"] = _leaf_tensor(v)
    return state


def lm_cache_from_jax(tree, device="cuda") -> dict:
    """The port's LM caches from the reference's (leaves as numpy arrays):
    the same ``{"blocks": [...], "rest": [...]}`` structure and leaf names
    (``k`` / ``v``, ``h`` / ``conv``, ``C`` / ``n`` / ``m``), each leaf a
    writable tensor of its dtype on ``device``."""
    device = resolve_device(device)
    conv = lambda layer: {k: _leaf_tensor(v).to(device)
                          for k, v in layer.items()}
    return {"blocks": [conv(c) for c in tree["blocks"]],
            "rest": [conv(c) for c in tree.get("rest", [])]}


def adamw_state_from_jax(tree) -> dict:
    """The port's AdamW state (:func:`repro_torch.optim.adamw.init`'s
    structure) from the reference's for an LM (leaves as numpy arrays):
    its moments ``m`` and ``v`` carried over as
    :func:`lm_params_from_jax` carries the parameters, and its step
    ``count``, on the CPU."""
    return {"m": lm_params_from_jax(tree["m"]),
            "v": lm_params_from_jax(tree["v"]),
            "count": torch.tensor(int(np.asarray(tree["count"])),
                                  dtype=torch.int32)}
