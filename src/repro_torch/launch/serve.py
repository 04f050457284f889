"""Serving step factories: prefill and single-token decode over the port's
:class:`~repro_torch.models.LM`, which holds its weights.  Both run without
autograd, and unchanged on a model sharded over a mesh (``LM.shard_``, as
``serve.Engine(mesh=...)`` places it): the layers run on the rank's blocks
and the logits come back whole.  The reference's dry-run helpers
(``prefill_specs``, ``decode_specs``, ``cache_specs_abstract``, built on
``jax.ShapeDtypeStruct``) wait with the dry-run tools (ROADMAP.md queue A
item 7.4)."""

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
    """One new token against populated caches (K/V and recurrent
    states): greedy next token (int32), the logits and the caches."""
    @torch.no_grad()
    def serve_step(cache, token, pos: int):
        logits, cache = model.decode_step(cache, token, pos)
        next_tok = torch.argmax(logits, dim=-1).to(torch.int32)
        return next_tok, logits, cache
    return serve_step
