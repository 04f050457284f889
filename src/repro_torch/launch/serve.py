"""Serving step factories: prefill and single-token decode over the port's
:class:`~repro_torch.models.LM`, which holds its weights.  Both run without
autograd.  The reference's dry-run helpers (``prefill_specs``,
``decode_specs``, ``cache_specs_abstract``, built on
``jax.ShapeDtypeStruct``) wait with the dry-run tools (ROADMAP.md queue A
item 7)."""

from __future__ import annotations

import torch

from repro_torch.models import LM


def make_prefill_step(model: LM):
    @torch.no_grad()
    def prefill_step(tokens, cache, prefix_emb=None):
        logits, cache, _ = model.apply(tokens, prefix_emb=prefix_emb,
                                       caches=cache)
        return logits[:, -1:], cache
    return prefill_step


def make_serve_step(model: LM):
    """One new token against a populated KV cache: greedy next token
    (int32), the logits and the cache."""
    @torch.no_grad()
    def serve_step(cache, token, pos: int):
        logits, cache = model.decode_step(cache, token, pos)
        next_tok = torch.argmax(logits, dim=-1).to(torch.int32)
        return next_tok, logits, cache
    return serve_step
