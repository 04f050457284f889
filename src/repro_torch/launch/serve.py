"""Serving step factories: prefill and single-token decode over the port's
:class:`~repro_torch.models.LM`, which holds its weights.  Both run without
autograd, and unchanged on a model sharded over a mesh (``LM.shard_``, as
``serve.Engine(mesh=...)`` places it): the layers run on the rank's blocks
and the logits come back whole.  ``prefill_specs``, ``decode_specs`` and
``cache_specs_abstract`` are the reference's dry-run stand-ins as
``meta`` tensors of its shapes and dtypes (no allocation): the dry-run's
inputs (:mod:`repro_torch.launch.dryrun_lib`)."""

from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.models import LM
from repro_torch.models.lm import N_PATCHES


def make_prefill_step(model: LM):
    @torch.no_grad()
    def prefill_step(tokens, cache, prefix_emb=None):
        logits, cache, _ = model.apply(tokens, prefix_emb=prefix_emb,
                                       caches=cache)
        return logits[:, -1:], cache
    return prefill_step


def make_serve_step(model: LM):
    """One new token against populated caches (K/V and recurrent
    states): greedy next token (int32), the logits and the caches."""
    @torch.no_grad()
    def serve_step(cache, token, pos: int):
        logits, cache = model.decode_step(cache, token, pos)
        next_tok = torch.argmax(logits, dim=-1).to(torch.int32)
        return next_tok, logits, cache
    return serve_step


def prefill_specs(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    """The prefill's inputs as ``meta`` tensors: tokens int32 (B, S) or
    (B, S, nc); llava's patches bf16 (B, 256, d), its tokens S − 256."""
    B, S = shape.global_batch, shape.seq_len
    if cfg.frontend == "vision":
        S = S - N_PATCHES
    tok_shape = (B, S, cfg.n_codebooks) if cfg.n_codebooks > 1 else (B, S)
    specs = {"tokens": torch.empty(tok_shape, dtype=torch.int32,
                                   device="meta")}
    if cfg.frontend == "vision":
        specs["patches"] = torch.empty((B, N_PATCHES, cfg.d_model),
                                       dtype=torch.bfloat16, device="meta")
    return specs


def decode_specs(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    """The decode step's inputs as ``meta`` tensors: one token int32 (B,
    1) or (B, 1, nc) and its position, an int32 scalar."""
    B = shape.global_batch
    tok_shape = (B, 1, cfg.n_codebooks) if cfg.n_codebooks > 1 else (B, 1)
    return {"token": torch.empty(tok_shape, dtype=torch.int32,
                                 device="meta"),
            "pos": torch.empty((), dtype=torch.int32, device="meta")}


def cache_specs_abstract(model: LM, shape: ShapeConfig) -> dict:
    """The decode cache of ``shape`` (batch, max length) as ``meta``
    tensors of :meth:`LM.init_cache`'s structure (no allocation)."""
    return model.init_cache(shape.global_batch, shape.seq_len,
                            device="meta")
