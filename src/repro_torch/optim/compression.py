"""Gradient compression with error feedback, for slow links: int8 linear
quantization or top-k sparsification (the reference's
``repro.optim.compression``).

Compress locally, (reduce,) decode, and carry the quantization residual
into the next step (error feedback keeps SGD convergence; Karimireddy et
al., 2019).  Off by default.  ``jax.lax.top_k``'s threshold is
``torch.topk``'s k-th value, and the ``>=`` keeps its ties.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.tree import map_tree, map_with_path, flatten_with_path


@dataclass(frozen=True)
class CompressionConfig:
    kind: str = "none"          # none | int8 | topk
    topk_frac: float = 0.01


def compress_decompress(g: torch.Tensor, residual: torch.Tensor,
                        cfg: CompressionConfig):
    """Returns (decoded gradient, new residual).  The decoded value is
    what the collective would transport; residual = g - decoded."""
    if cfg.kind == "none":
        return g, torch.zeros_like(residual)
    g = g + residual                        # error feedback
    if cfg.kind == "int8":
        scale = torch.max(torch.abs(g)) / 127.0 + 1e-12
        q = torch.clamp(torch.round(g / scale), -127, 127)
        dec = q * scale
    elif cfg.kind == "topk":
        k = max(1, int(g.numel() * cfg.topk_frac))
        flat = g.reshape(-1)
        thresh = torch.topk(torch.abs(flat), k).values[-1]
        dec = torch.where(torch.abs(flat) >= thresh, flat,
                          torch.zeros((), dtype=flat.dtype,
                                      device=flat.device)).reshape(g.shape)
    else:
        raise ValueError(cfg.kind)
    return dec, g - dec


def apply_tree(grads, residuals, cfg: CompressionConfig):
    if cfg.kind == "none":
        return grads, residuals
    pairs = {path: compress_decompress(g, r, cfg) for (path, g), (_q, r) in
             zip(flatten_with_path(grads), flatten_with_path(residuals))}
    pick = lambda i: map_with_path(lambda path, _g: pairs[path][i], grads)
    return pick(0), pick(1)


def init_residuals(grads_like):
    return map_tree(lambda g: torch.zeros(g.shape, dtype=torch.float32,
                                          device=g.device), grads_like)
