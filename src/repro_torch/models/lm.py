"""Unified decoder LM over all ten architectures, as an ``nn.Module``.

The reference groups layers into the architecture's repeating *pattern*
(gemma: 5 local + 1 global; jamba: 7 Mamba + 1 attention with MoE every
2nd layer; plain: period 1) and scans stacked parameters over the groups;
here the layers are held one by one (a ``ModuleList`` in execution order:
group 0's pattern, group 1's, ..., then the rest layers) and run in a
Python loop.  ``cfg.remat`` and ``cfg.scan_layers`` are JAX's knobs and
have no effect here.  The caches keep the reference's structure,
``{"blocks": [per pattern layer], "rest": [...]}``, each layer's by its
kind — attention ``{"k", "v"}``, Mamba ``{"h", "conv"}``, mLSTM ``{"C",
"n", "m"}`` — with a leading group axis on block leaves only.  Every layer
writes its cache or recurrent state in place.  Modality frontends are
stubs as in the reference: llava takes precomputed patch embeddings
(``prefix_emb``), musicgen sums its codebooks' embeddings and has a head
per codebook.

:meth:`LM.shard_` turns a model into one rank's part of a layout on a
mesh (``serve.Engine(mesh=...)`` calls it): its parameters become the
rank's blocks, and every layer runs on them (:mod:`.sharded`); the
embedding looks up the rank's block of the vocabulary (other ids give
zeros) and reduces, and the logits' vocabulary blocks are gathered, so
that an ``argmax`` sees every logit.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.interop import resolve_device
from . import attention as attn_mod
from . import mamba as mamba_mod
from . import xlstm as xlstm_mod
from .layers import apply_norm, mlp, mlp_params, norm_params
from .moe import moe, moe_params
from .sharded import Sharded, place, weights

N_PATCHES = 256          # llava vision-stub prefix length


@dataclass(frozen=True)
class LayerSpec:
    kind: str            # attn | mamba | mlstm
    window: int = 0
    use_moe: bool = False


def build_pattern(cfg: ModelConfig) -> list[LayerSpec]:
    if cfg.block_type == "xlstm":
        return [LayerSpec("mlstm")]
    if cfg.block_type == "jamba":
        p = cfg.attn_period
        specs = []
        for i in range(p):
            kind = "attn" if i == p - 1 else "mamba"
            specs.append(LayerSpec(kind, 0, cfg.n_experts > 0
                                   and i % cfg.moe_period == 1))
        return specs
    if cfg.local_global_period:
        p = cfg.local_global_period
        return [LayerSpec("attn", cfg.sliding_window if i < p - 1 else 0,
                          cfg.n_experts > 0)
                for i in range(p)]
    return [LayerSpec("attn", cfg.sliding_window,
                      cfg.n_experts > 0)]


def _dtype(cfg: ModelConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


def _params(values: dict, dtype, device) -> nn.ParameterDict:
    """Uninitialised parameters of the shapes of ``values`` (a dict of
    tensors), under its names."""
    return nn.ParameterDict({
        k: nn.Parameter(torch.empty(v.shape, dtype=dtype, device=device))
        for k, v in values.items()})


class LM(nn.Module):
    """The decoder on ``device`` (the card unless ``"cpu"`` is asked for)
    in ``cfg.dtype``.  Parameters are allocated here and drawn by
    :meth:`init`, or loaded from a state dict (e.g.
    :func:`repro_torch.interop.lm_params_from_jax`)."""

    def __init__(self, cfg: ModelConfig, device="cuda"):
        super().__init__()
        self.cfg = cfg
        self.device = resolve_device(device)
        self.dtype = _dtype(cfg)
        self.pattern = build_pattern(cfg)
        P = len(self.pattern)
        self.n_groups = cfg.n_layers // P
        self.rest_specs = self.pattern[:cfg.n_layers % P]
        self.specs = self.pattern * self.n_groups + self.rest_specs
        d, V, nc = cfg.d_model, cfg.vocab, cfg.n_codebooks
        dev, dt = self.device, self.dtype
        self.embed = nn.Parameter(torch.empty(
            (nc, V, d) if nc > 1 else (V, d), dtype=dt, device=dev))
        if not cfg.tie_embeddings:
            self.head = nn.Parameter(torch.empty(
                (d, nc * V) if nc > 1 else (d, V), dtype=dt, device=dev))
        else:
            self.head = None
        self.final_norm = _params(norm_params(cfg), dt, dev)
        self.layers = nn.ModuleList(
            nn.ModuleDict({name: _params(p, dt, dev) for name, p in
                           self._layer_params(spec, None).items()})
            for spec in self.specs)
        #: the layout this rank's parameters are blocks of (None: whole)
        self.shard: Optional[Sharded] = None

    @torch.no_grad()
    def shard_(self, mesh, specs: dict, weights=None) -> "LM":
        """Make this model one rank's part of the layout ``specs`` (every
        state-dict key's spec, :func:`repro_torch.dist.sharding.
        param_specs`) on ``mesh``: each parameter is replaced by the
        rank's block of it on ``mesh.device`` (``weights(key, index)``
        gives the block where the model has no values, e.g. one built on
        the ``meta`` device; see :func:`.sharded.place`).  A model placed
        by the same specs on the same mesh already stays as it is; any
        other layout of a sharded model raises.  Returns the module."""
        specs = {k: tuple(v) for k, v in specs.items()}
        if self.shard is not None:
            if self.shard.mesh is mesh and self.shard.specs == specs:
                return self
            raise RuntimeError("the model is sharded by another layout "
                               "already")
        missing = set(self.state_dict()) ^ set(specs)
        if missing:
            raise ValueError(f"specs and parameters differ: {sorted(missing)}")
        place(self, mesh, specs, weights)
        self.shard = Sharded(mesh, specs)
        self.device = torch.device(mesh.device)
        return self

    # ------------------------------------------------------------------ init
    def _layer_params(self, spec: LayerSpec,
                      gen: Optional[torch.Generator]) -> dict:
        """One layer's parameters drawn from ``gen`` (meta tensors of their
        shapes without one)."""
        cfg = self.cfg
        dev = gen.device if gen is not None else "meta"
        p = {"ln1": norm_params(cfg, device=dev)}
        if spec.kind == "attn":
            p["inner"] = attn_mod.attn_params(gen, cfg)
        elif spec.kind == "mamba":
            p["inner"] = mamba_mod.mamba_params(gen, cfg)
        else:
            p["inner"] = xlstm_mod.xlstm_params(gen, cfg)
        if cfg.d_ff:
            p["ln2"] = norm_params(cfg, device=dev)
            p["mlp"] = (moe_params(gen, cfg) if spec.use_moe
                        else mlp_params(gen, cfg))
        return p

    @torch.no_grad()
    def init(self, gen: torch.Generator) -> "LM":
        """Draw every weight from ``gen`` (in fp32 on the generator's
        device, then cast), one layer at a time: embeddings and head
        N(0, 1/d), each projection N(0, 1/fan_in) (Mamba's depthwise conv
        at the reference's 0.1); rmsnorm scales 0, layernorm scales 1 and
        biases 0; Mamba's ``A_log``, ``D`` and biases the reference's fixed
        values.  The same generator state gives the same weights in any
        dtype up to its rounding.  Returns the module."""
        cfg = self.cfg
        d = cfg.d_model
        self.embed.copy_(torch.randn(self.embed.shape, generator=gen,
                                     device=gen.device) * d ** -0.5)
        if self.head is not None:
            self.head.copy_(torch.randn(self.head.shape, generator=gen,
                                        device=gen.device) * d ** -0.5)
        for k, v in norm_params(cfg).items():
            self.final_norm[k].copy_(v)
        for spec, layer in zip(self.specs, self.layers):
            for name, values in self._layer_params(spec, gen).items():
                for k, v in values.items():
                    layer[name][k].copy_(v)
        return self

    # --------------------------------------------------------------- forward
    def _apply_layer(self, spec: LayerSpec, p, x, positions, cache=None,
                     decode=False, pos=None, sh=None):
        """One layer; its cache or state (if any) is written in place.
        Returns (x, the MoE aux loss: None in decode or without MoE).
        ``sh``: the layer's :class:`.sharded.Scope` under a mesh."""
        cfg = self.cfg
        si = sm = None
        if sh is not None:
            si, sm = sh.sub("inner"), sh.sub("mlp")
        h = apply_norm(x, p["ln1"], cfg)      # norm leaves: never sharded
        if spec.kind == "attn":
            if decode:
                y, _ = attn_mod.decode_attention(
                    h, p["inner"], cfg, cache=cache, pos=pos,
                    window=spec.window, sh=si)
            else:
                y, _ = attn_mod.attention(
                    h, p["inner"], cfg, positions=positions,
                    window=spec.window, cache=cache, sh=si)
        elif spec.kind == "mamba":
            y, _ = (mamba_mod.mamba_decode(h, p["inner"], cfg, cache, sh=si)
                    if decode else
                    mamba_mod.mamba(h, p["inner"], cfg, state=cache, sh=si))
        else:
            y, _ = (xlstm_mod.mlstm_decode(h, p["inner"], cfg, cache, sh=si)
                    if decode else
                    xlstm_mod.mlstm(h, p["inner"], cfg, state=cache, sh=si))
        x = x + y
        aux = None
        if cfg.d_ff:
            h2 = apply_norm(x, p["ln2"], cfg)
            if spec.use_moe:
                y2, aux = moe(h2, p["mlp"], cfg, with_aux=not decode, sh=sm)
            else:
                y2 = mlp(h2, p["mlp"], cfg.mlp_type, sh=sm)
            x = x + y2
        return x, aux

    def _scopes(self) -> list:
        """Each layer's :class:`.sharded.Scope` (Nones without a mesh)."""
        if self.shard is None:
            return [None] * len(self.specs)
        return [self.shard.scope(f"layers.{i}.")
                for i in range(len(self.specs))]

    def _layer_caches(self, caches):
        """The cache of each layer in execution order (views of the block
        leaves at their group), or Nones."""
        if caches is None:
            return [None] * len(self.specs)
        P = len(self.pattern)
        out = [{k: v[g] for k, v in caches["blocks"][i].items()}
               for g in range(self.n_groups) for i in range(P)]
        return out + list(caches["rest"])

    def _table(self, name: str):
        """(the ``embed`` / ``head`` parameter, FSDP blocks gathered, and
        its :class:`.sharded.Scope`; the parameter itself without a
        mesh)."""
        t = getattr(self, name)
        if self.shard is None:
            return t, None
        sh = self.shard.scope("")
        return weights({name: t}, sh)[name], sh

    def _embed(self, tokens, prefix_emb=None):
        cfg = self.cfg
        tokens = torch.as_tensor(tokens, device=self.device).long()
        embed, sh = self._table("embed")
        if sh is not None and sh.tp_dim("embed") is not None:
            # the rank's block of the vocabulary; other ids give zeros
            V = embed.shape[-2]
            v0 = sh.r * V

            def look(table, ids):
                ids = ids - v0
                hit = (ids >= 0) & (ids < V)
                return torch.where(hit[..., None],
                                   table[torch.where(hit, ids, 0)], 0.0)
        else:
            look = lambda table, ids: table[ids]          # noqa: E731
        if cfg.n_codebooks > 1:     # musicgen: (B, S, nc) summed streams
            x = sum(look(embed[c], tokens[..., c])
                    for c in range(cfg.n_codebooks))
        else:
            x = look(embed, tokens)
        if sh is not None and sh.tp_dim("embed") is not None:
            x = sh.reduce(x)
        if prefix_emb is not None:  # llava: prepend patch embeddings
            prefix = torch.as_tensor(prefix_emb, device=self.device)
            x = torch.cat([prefix.to(x.dtype), x], dim=1)
        return x

    def _logits(self, x):
        cfg = self.cfg
        name = "head" if self.head is not None else "embed"
        head, sh = self._table(name)
        out = x @ (head if self.head is not None else head.T)
        if sh is not None and sh.tp_dim(name) is not None:
            out = sh.gather(out)    # every rank sees every logit
        if cfg.n_codebooks > 1:
            out = out.reshape(*x.shape[:-1], cfg.n_codebooks, cfg.vocab)
        return out

    def apply(self, tokens, *, prefix_emb=None, caches=None):
        """Full-sequence forward (train / prefill).  Returns (logits,
        caches, moe_aux): with ``caches``, each attention layer's K/V are
        written into its first S positions and each recurrent layer's
        final state into its state, in place (the recurrent layers start
        from the state they are given, as the reference's do), and the
        same caches are returned; moe_aux is the MoE layers' load-balance
        loss summed over layers (fp32; 0 without MoE)."""
        x = self._embed(tokens, prefix_emb)
        B, S = x.shape[:2]
        positions = torch.arange(S, device=self.device).expand(B, S)
        aux = torch.zeros((), dtype=torch.float32, device=self.device)
        for spec, p, c, sh in zip(self.specs, self.layers,
                                  self._layer_caches(caches), self._scopes()):
            x, a = self._apply_layer(spec, p, x, positions, cache=c, sh=sh)
            if a is not None:
                aux = aux + a
        x = apply_norm(x, self.final_norm, self.cfg)
        return self._logits(x), caches, aux

    def forward(self, tokens, prefix_emb=None):
        """The training forward, :meth:`apply` without caches: (logits,
        moe_aux).  ``torch.func.functional_call`` runs it over a dict of
        parameters (the train step's)."""
        logits, _, aux = self.apply(tokens, prefix_emb=prefix_emb)
        return logits, aux

    def decode_step(self, caches, token, pos: int):
        """One decode step.  token: (B, 1) (or (B, 1, nc)); pos: the
        position it takes.  Returns (logits (B, 1, V...), caches) with
        every attention layer's K/V written at ``pos`` and every recurrent
        layer's state advanced by the token."""
        pos = int(pos)
        x = self._embed(token)
        for spec, p, c, sh in zip(self.specs, self.layers,
                                  self._layer_caches(caches), self._scopes()):
            x, _ = self._apply_layer(spec, p, x, None, cache=c, decode=True,
                                     pos=pos, sh=sh)
        x = apply_norm(x, self.final_norm, self.cfg)
        return self._logits(x), caches

    # ---------------------------------------------------------------- caches
    def _layer_cache(self, spec: LayerSpec, batch: int, max_len: int, dev):
        cfg, dt = self.cfg, self.dtype
        if spec.kind == "attn":
            return attn_mod.init_cache(cfg, batch, max_len, dt, dev)
        if spec.kind == "mamba":
            return mamba_mod.init_mamba_state(cfg, batch, dt, dev)
        return xlstm_mod.init_xlstm_state(cfg, batch, dev)

    def init_cache(self, batch: int, max_len: int, device=None) -> dict:
        """Zeroed caches of ``batch`` rows on ``device`` (default: the
        model's): block leaves (G, batch, ...), rest leaves (batch,
        ...)."""
        G = self.n_groups
        dev = self.device if device is None else torch.device(device)
        blocks = [{k: v.expand((G,) + v.shape).clone() for k, v in
                   self._layer_cache(spec, batch, max_len, dev).items()}
                  for spec in self.pattern]
        rest = [self._layer_cache(s, batch, max_len, dev)
                for s in self.rest_specs]
        return {"blocks": blocks, "rest": rest}


# --------------------------------------------------------------------------
# loss
# --------------------------------------------------------------------------

def lm_loss(logits: torch.Tensor, targets: torch.Tensor,
            n_codebooks: int = 1) -> torch.Tensor:
    """Causal cross-entropy (mean over tokens), in fp32."""
    lf = logits.float()
    m = torch.amax(lf, dim=-1, keepdim=True)
    lse = m + torch.log(torch.sum(torch.exp(lf - m), dim=-1, keepdim=True))
    tgt = torch.gather(lf, -1, targets.long()[..., None])
    return torch.mean(lse[..., 0] - tgt[..., 0])
