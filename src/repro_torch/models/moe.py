"""Mixture-of-Experts layers: token-choice top-k routing, in PyTorch.

Interchangeable implementations over the same gates (numerics equal up to
summation order):

* ``dense`` — every expert computes every token, the gates combine them
  (E/k× the FLOPs of the active experts; the configurations' default).
* ``ragged`` — tokens sorted by expert, one ``torch.matmul`` per expert
  group (the reference's ``lax.ragged_dot``), dropless.
* ``capacity`` — GShard-style dispatch into an (E, C, d) buffer; (token,
  slot) pairs past an expert's capacity C drop to the residual path.
* ``a2a`` — the reference's expert-parallel dispatch: inside
  ``dist.sharding.activation_rules``, on a model whose experts shard over
  ``model`` and whose tokens split over the data axes, each rank
  dispatches its tokens at a capacity of its own and sends each expert's
  rows to the expert's rank with one all-to-all over ``model`` each way;
  otherwise the local capacity dispatch, as the reference falls back.

Under a mesh (``sh``, :mod:`.sharded`) every form computes the rank's
experts only where the experts are sharded over ``model`` (expert
parallelism), or each expert's block of ff columns (ff-TP), and reduces
the partial sums over the model group.  The router is replicated, so
every rank routes every token alike.

Every combine is deterministic: a token's k contributions are summed in
slot order (no ``index_add_``, whose CUDA form sums with float atomics);
under a mesh a rank sums its own experts' contributions in slot order
(the others' are zero) before the reduction.  Where autograd records
under a mesh, the token rows and gates entering a rank's own experts pass
``Scope.enter``, so that their gradients' partial sums are all-reduced over
the model group.  ``dense``, ``capacity`` and ``a2a`` index by no mask,
so they run on ``meta`` tensors (the dry-run); ``ragged``'s group sizes
are data.
Sorting by expert is stable, as ``jnp.argsort`` is, so the tokens that
``capacity`` drops are the reference's.

One device's share of the experts (``cfg.experts_held`` of them from
``cfg.expert_first``, no mesh): the router routes every token over all
``n_experts`` (its aux loss too), only the held experts compute, on the
(token, slot) pairs routed to them, and the layer gives their part of the
output; nothing stands in for the other shares or their exchange.
``ragged`` sizes its buffers by the held pairs and runs the held experts
one at a time, forward and a backward that computes them again, so that
no more than one expert's rows are ever kept: a share's pairs are as many
as the router sends it (a whole layer's always T·k), and the step's
memory would follow the routing.  Each call runs inside the span ``moe``
(forward and backward) and counts its held pairs (``moe.held_slots``).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch import spans
from repro_torch.configs.base import ModelConfig
from .layers import _gelu, normal
from .sharded import weights


def moe_params(gen: Optional[torch.Generator], cfg: ModelConfig) -> dict:
    """The router (d, E) and the held experts' weights w1 (E', d, f), w2
    (E', f, d) and, for the gated kinds, w3 (E', d, f) (E' =
    ``cfg.experts_held`` or E), drawn from ``gen`` (fp32, see
    :func:`~repro_torch.models.layers.normal`)."""
    d, f = cfg.d_model, cfg.d_ff
    e = cfg.experts_held or cfg.n_experts
    s_in, s_out = d ** -0.5, f ** -0.5
    p = {"router": normal(gen, (d, cfg.n_experts), s_in),
         "w1": normal(gen, (e, d, f), s_in),
         "w2": normal(gen, (e, f, d), s_out)}
    if cfg.mlp_type in ("swiglu", "geglu"):
        p["w3"] = normal(gen, (e, d, f), s_in)
    return p


def _gates(x: torch.Tensor, router: torch.Tensor, k: int,
           with_aux: bool = True, sh=None):
    """(T, E) normalized top-k gate weights (in x's dtype), the top-k
    weights and experts (T, k), and the load-balance aux loss (fp32; None
    unless ``with_aux``).  Where autograd records on a mesh whose data
    blocks split the tokens, the aux's two per-expert means are the whole
    batch's (one all-reduce over the row group), as the reference's
    global step computes them."""
    logits = (x @ router).float()
    probs = torch.softmax(logits, dim=-1)
    topv, topi = torch.topk(probs, k, dim=-1)
    topv = topv / torch.sum(topv, dim=-1, keepdim=True)
    gates = torch.zeros_like(probs).scatter(1, topi, topv)    # (T, E)
    if not with_aux:
        return gates.to(x.dtype), topv, topi, None
    # Switch-style load-balance aux loss
    e = probs.shape[-1]
    frac = torch.mean((gates > 0).float(), dim=0)
    mean_p = torch.mean(probs, dim=0)
    if (sh is not None and torch.is_grad_enabled() and sh.mesh.n > 1
            and sh.sh.batch_split):
        from repro_torch.dist.mesh import row_mean_fn
        both = row_mean_fn(sh.mesh, torch.cat([frac, mean_p]))
        frac, mean_p = both[:e], both[e:]
    aux = e * torch.sum(frac * mean_p)
    return gates.to(x.dtype), topv, topi, aux


def _act(cfg: ModelConfig):
    return F.silu if cfg.mlp_type == "swiglu" else _gelu


def _experts(h_in: torch.Tensor, p, cfg: ModelConfig) -> torch.Tensor:
    """Every expert's MLP over its own rows: h_in (E, R, d) -> (E, R, d),
    one batched matmul per weight (x broadcast over E reads no copy)."""
    h = _act(cfg)(h_in @ p["w1"])
    if "w3" in p:
        h = h * (h_in @ p["w3"])
    return h @ p["w2"]


def _experts_of(cfg: ModelConfig, sh):
    """(first expert, count, partial): the experts this rank holds, and
    whether its outputs are partial sums to reduce over the model group
    (expert- or ff-parallel weights)."""
    E = cfg.n_experts
    if cfg.experts_held:
        if sh is not None:
            raise ValueError("a share of the experts (experts_held) is one "
                             "device's, under no mesh")
        return cfg.expert_first, cfg.experts_held, False
    if sh is None:
        return 0, E, False
    d = sh.tp_dim("w1")
    if d == 0:                       # expert parallel: a block of experts
        return sh.r * (E // sh.tp), E // sh.tp, True
    return 0, E, d == 2              # ff-TP: every expert's ff block


def _slot_sum(y: torch.Tensor) -> torch.Tensor:
    """(T, k, d) -> (T, d): each token's k contributions summed in slot
    order."""
    out = y[:, 0]
    for j in range(1, y.shape[1]):
        out = out + y[:, j]
    return out


def _entered(x: torch.Tensor, w: torch.Tensor, partial: bool, sh):
    """(x, w) entering the rank's own experts where its outputs are
    partial sums (:meth:`.sharded.Scope.enter`)."""
    if not partial:
        return x, w
    return sh.enter(x), sh.enter(w)


def moe_dense(x: torch.Tensor, p, cfg: ModelConfig, *,
              with_aux: bool = True, sh=None):
    """x: (T, d) -> (T, d).  All experts compute, gates combine."""
    gates, _, _, aux = _gates(x, p["router"], cfg.top_k, with_aux, sh)
    e0, El, partial = _experts_of(cfg, sh)
    x, gates = _entered(x, gates, partial, sh)
    y = _experts(x[None], p, cfg)                            # (E, T, d)
    if El != cfg.n_experts:
        gates = gates[:, e0:e0 + El]
    out = torch.einsum("etd,te->td", y, gates).to(x.dtype)
    return (sh.reduce(out) if partial else out), aux


def moe_ragged(x: torch.Tensor, p, cfg: ModelConfig, *,
               with_aux: bool = True, sh=None):
    """Dropless sort-based routing: the (token, slot) pairs routed to the
    held experts sorted by expert (buffers sized by them), one matmul per
    expert group; each token's pairs summed in slot order, a pair routed
    elsewhere adding zero."""
    T, k = x.shape[0], cfg.top_k
    _, topv, topi, aux = _gates(x, p["router"], k, with_aux, sh)
    e0, El, partial = _experts_of(cfg, sh)
    x, topv = _entered(x, topv, partial, sh)
    local = topi.reshape(-1) - e0                            # (T*k,)
    group = torch.where((local >= 0) & (local < El), local, El)
    order = torch.argsort(group, stable=True)
    with spans.span("sync"):
        sizes = torch.bincount(group, minlength=El + 1).tolist()
    n = sum(sizes[:El])
    spans.count("moe.held_slots", n)
    pairs = order[:n]                                        # held, by expert
    w, tok = topv.reshape(-1).to(x.dtype)[pairs], pairs // k
    if cfg.experts_held:
        names = [n for n in ("w1", "w2", "w3") if n in p]
        out = _Share.apply(x, w, tok, sizes[:El], cfg, names,
                           *(p[n] for n in names))
    else:
        # pair i's row of the held rows, or the zero row n for a pair
        # routed elsewhere
        row_of = torch.full((T * k,), n, dtype=torch.long, device=x.device)
        row_of[pairs] = torch.arange(n, device=x.device)
        out = _held(x, w, tok, row_of.view(T, k), sizes[:El], p, cfg)
    out = out.to(x.dtype)
    return (sh.reduce(out) if partial else out), aux


def _held(x, w, tok, row_of, sizes, p, cfg: ModelConfig) -> torch.Tensor:
    """(T, d): the held experts over their pairs (``sizes`` of them each,
    in expert order: token ``tok``, gate ``w``), each token's pairs summed
    in slot order."""
    xs = _Dispatch.apply(x, tok, row_of)
    y = torch.empty_like(xs)
    start = 0
    for j, rows in enumerate(sizes):
        if rows:
            y[start:start + rows] = _experts(
                xs[start:start + rows][None],
                {n: p[n][j:j + 1] for n in ("w1", "w2", "w3") if n in p},
                cfg)[0]
        start += rows
    return _Combine.apply(y * w[:, None], tok, row_of)


def _groups(sizes):
    """(expert, its rows' slice) of each expert that holds pairs, in expert
    order."""
    start = 0
    for j, rows in enumerate(sizes):
        if rows:
            yield j, slice(start, start + rows)
        start += rows


class _Share(torch.autograd.Function):
    """One device's share of the experts over its pairs (``sizes`` of them
    each, in expert order: token ``tok``, gate ``w``), one expert at a
    time: the forward adds each expert's gated rows into its tokens'
    output (a token meets an expert once, so no sum races), the backward
    computes each expert's rows again under autograd and takes their
    gradients.  Nothing is kept of the experts' rows."""

    @staticmethod
    def forward(ctx, x, w, tok, sizes, cfg, names, *weights):
        ctx.save_for_backward(x, w, tok, *weights)
        ctx.rest = (sizes, cfg, names)
        out = torch.zeros_like(x)
        for j, sl in _groups(sizes):
            t = tok[sl]
            y = _experts(x[t][None], {n: W[j:j + 1] for n, W in
                                      zip(names, weights)}, cfg)[0]
            out.index_put_((t,), y * w[sl, None], accumulate=True)
        return out

    @staticmethod
    def backward(ctx, g):
        x, w, tok, *weights = ctx.saved_tensors
        sizes, cfg, names = ctx.rest
        need_x, need_w = ctx.needs_input_grad[:2]
        need = ctx.needs_input_grad[6:]
        dx = torch.zeros_like(x) if need_x else None
        dw = torch.empty_like(w) if need_w else None
        dW = [torch.zeros_like(W) if nd else None
              for W, nd in zip(weights, need)]
        for j, sl in _groups(sizes):
            t = tok[sl]
            with torch.enable_grad():
                xs = x[t].requires_grad_(need_x)
                Wj = [W[j:j + 1].detach().requires_grad_(nd)
                      for W, nd in zip(weights, need)]
                y = _experts(xs[None], dict(zip(names, Wj)), cfg)[0]
            gt = g[t]
            if need_w:
                dw[sl] = (gt * y.detach()).sum(-1)
            want = [v for v in [xs, *Wj] if v.requires_grad]
            if not want:
                continue
            got = iter(torch.autograd.grad(y, want, gt * w[sl, None]))
            if need_x:
                dx.index_put_((t,), next(got), accumulate=True)
            for dWn, Wn in zip(dW, Wj):
                if Wn.requires_grad:
                    dWn[j] = next(got)[0]
        return (dx, dw, None, None, None, None, *dW)


def _combine(y: torch.Tensor, row_of: torch.Tensor) -> torch.Tensor:
    """(T, d): each token's rows of ``y`` (``row_of`` (T, k), the zero row
    ``len(y)`` for none) summed in slot order."""
    y = torch.cat([y, y.new_zeros((1, y.shape[1]))])
    out = y[row_of[:, 0]]
    for j in range(1, row_of.shape[1]):
        out = out + y[row_of[:, j]]
    return out


class _Dispatch(torch.autograd.Function):
    """``x[tok]``, the held pairs' token rows; its gradient is
    :func:`_combine`'s sum of each token's pairs in slot order (the
    adjoint), not autograd's scatter of an index, which sorts."""

    @staticmethod
    def forward(ctx, x, tok, row_of):
        ctx.save_for_backward(row_of)
        return x[tok]

    @staticmethod
    def backward(ctx, g):
        (row_of,) = ctx.saved_tensors
        return _combine(g, row_of), None, None


class _Combine(torch.autograd.Function):
    """:func:`_combine`; its gradient is the gather ``g[tok]`` (a held pair
    reads its token's), not autograd's scatter into a zero row that most
    slots share."""

    @staticmethod
    def forward(ctx, y, tok, row_of):
        ctx.save_for_backward(tok)
        return _combine(y, row_of)

    @staticmethod
    def backward(ctx, g):
        (tok,) = ctx.saved_tensors
        return g[tok], None, None


def _dispatch(topi: torch.Tensor, e: int, capacity_factor: float):
    """The capacity dispatch of (token, slot) pairs: (order, slot, keep,
    C) — the stable sort by expert, each ranked pair's row in the (E·C)
    buffer, whether it fits its expert's capacity C."""
    T, k = topi.shape
    flat_e = topi.reshape(-1)
    order = torch.argsort(flat_e, stable=True)
    ranked_e = flat_e[order]
    # position within the expert group: running index minus group start
    starts = torch.searchsorted(ranked_e, torch.arange(e, device=topi.device),
                                side="left")
    pos_in_grp = torch.arange(T * k, device=topi.device) - starts[ranked_e]
    C = max(1, int(T * k / e * capacity_factor))
    keep = pos_in_grp < C
    slot = ranked_e * C + pos_in_grp
    return order, slot, keep, C


def moe_capacity(x: torch.Tensor, p, cfg: ModelConfig,
                 capacity_factor: float = 1.25, *, with_aux: bool = True,
                 sh=None):
    """GShard-style capacity dispatch: (token, slot) pairs sorted by
    expert fill a (E, C, d) buffer, each expert runs its rows, results
    gather back; pairs past capacity contribute 0 (the residual path),
    written to an overflow row that is discarded, as the reference's."""
    T, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    _, topv, topi, aux = _gates(x, p["router"], k, with_aux, sh)
    e0, El, partial = _experts_of(cfg, sh)
    x, topv = _entered(x, topv, partial, sh)
    order, slot, keep, C = _dispatch(topi, e, capacity_factor)
    buf = _fill(x, topi, order, slot, keep, e * C)
    if El != e:                      # this rank's experts' rows only
        ranked_e = topi.reshape(-1)[order]
        keep = keep & (ranked_e >= e0) & (ranked_e < e0 + El)
        buf, slot = buf[e0 * C:(e0 + El) * C], slot - e0 * C
    y = _experts(buf.reshape(El, C, d), p, cfg).reshape(El * C, d)
    ranked_w = topv.reshape(-1).to(x.dtype)[order]
    contrib = torch.where(keep[:, None],
                          y[torch.clamp(slot, 0, El * C - 1)]
                          * ranked_w[:, None], 0.0)
    # back to (token, slot) order, then each token's slots in order
    contrib = contrib[torch.argsort(order)]
    out = _slot_sum(contrib.reshape(T, k, d)).to(x.dtype)
    return (sh.reduce(out) if partial else out), aux


def _fill(x: torch.Tensor, topi: torch.Tensor, order, slot, keep,
          rows: int) -> torch.Tensor:
    """The (rows, d) dispatch buffer: each kept (token, slot) pair's token
    row at its slot; the pairs past capacity are written to an overflow
    row that is cut off (the reference's), so no mask indexes a tensor."""
    T, k = topi.shape
    tok_of = torch.arange(T, device=x.device).repeat_interleave(k)
    buf = torch.zeros((rows + 1, x.shape[1]), dtype=x.dtype,
                      device=x.device)
    buf[torch.where(keep, slot, rows)] = x[tok_of[order]]
    return buf[:rows]


def capacity_dropped(x: torch.Tensor, p, cfg: ModelConfig,
                     capacity_factor: float = 1.25) -> int:
    """How many (token, slot) pairs :func:`moe_capacity` drops on ``x``
    at ``capacity_factor``."""
    _, _, topi, _ = _gates(x, p["router"], cfg.top_k)
    _o, _s, keep, _c = _dispatch(topi, cfg.n_experts, capacity_factor)
    return int((~keep).sum())


class _ScaleGrad(torch.autograd.Function):
    """The identity; its gradient times ``c``."""

    @staticmethod
    def forward(ctx, t, c):
        ctx.c = c
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return g * ctx.c, None


def moe_a2a(x: torch.Tensor, p, cfg: ModelConfig,
            capacity_factor: float = 1.25, *, with_aux: bool = True,
            sh=None):
    """Expert-parallel dispatch with one all-to-all over ``model`` each
    way (the reference's ``shard_map``).

    Active inside ``dist.sharding.activation_rules`` on a sharded model
    whose experts shard over ``model`` (:func:`~repro_torch.dist.sharding.
    moe_expert_parallel`) and whose tokens split over the data axes (its
    batch is the rank's block, ``Sharded.batch_split``); otherwise the
    local capacity dispatch, as the reference falls back.  The rank's
    tokens (replicated over ``model``) are dispatched at the capacity C =
    max(1, int(T_loc·k/E·cf)) of its own; the (E, C, d) buffer goes to the
    experts' ranks ((E/ep, ep·C, d)), their outputs come back, each
    token's slots are summed in slot order, and aux is averaged over the
    data blocks.  Each expert rank computes every model peer's copy of the
    tokens, as the reference's does, so where autograd records the
    experts' weight gradients are scaled by 1/ep: the copies' gradients
    are equal, and the loss counts the tokens once."""
    from repro_torch.dist import sharding as shlib
    from repro_torch.dist.mesh import all_to_all_fn, row_mean_fn
    rules = shlib.current_rules()
    mesh = None if sh is None else sh.mesh
    if (rules is None or mesh is None
            or rules[0].shape != mesh.shape
            or not shlib.moe_expert_parallel(mesh, cfg)
            or sh.tp_dim("w1") != 0 or not mesh.row_axes
            or not sh.sh.batch_split):
        return moe_capacity(x, p, cfg, capacity_factor, with_aux=with_aux,
                            sh=sh)
    T, d = x.shape
    e, k, ep = cfg.n_experts, cfg.top_k, mesh.tp
    _, topv, topi, aux = _gates(x, p["router"], k, with_aux)
    order, slot, keep, C = _dispatch(topi, e, capacity_factor)
    buf = _fill(x, topi, order, slot, keep, e * C).reshape(e, C, d)
    # each expert's rows to its owner: (E, C, d) -> (E/ep, ep·C, d)
    buf = all_to_all_fn(mesh, buf, 0, 1, "model")
    pw = {w: p[w] for w in ("w1", "w2", "w3") if w in p}
    if torch.is_grad_enabled() and ep > 1:
        pw = {w: _ScaleGrad.apply(t, 1.0 / ep) if t.requires_grad else t
              for w, t in pw.items()}
    y = _experts(buf, pw, cfg)
    # the results home: (E/ep, ep·C, d) -> (E, C, d)
    y = all_to_all_fn(mesh, y, 1, 0, "model").reshape(e * C, d)
    ranked_w = topv.reshape(-1).to(x.dtype)[order]
    contrib = torch.where(keep[:, None],
                          y[torch.clamp(slot, 0, e * C - 1)]
                          * ranked_w[:, None], 0.0)
    contrib = contrib[torch.argsort(order)]
    out = _slot_sum(contrib.reshape(T, k, d)).to(x.dtype)
    if aux is not None:
        aux = row_mean_fn(mesh, aux)
    return out, aux


def moe(x: torch.Tensor, p, cfg: ModelConfig, *, with_aux: bool = True,
        sh=None):
    """x: (B, S, d) -> (B, S, d), plus the load-balance aux scalar (None
    unless ``with_aux``: decode needs none)."""
    B, S, d = x.shape
    fn = {"ragged": moe_ragged, "capacity": moe_capacity,
          "dense": moe_dense, "a2a": moe_a2a}[cfg.moe_impl]
    with spans.span("moe"):
        out, aux = fn(x.reshape(B * S, d), weights(p, sh), cfg,
                      with_aux=with_aux, sh=sh)
        out = out.reshape(B, S, d)
    spans.backward_span("moe", x, out)
    return out, aux
