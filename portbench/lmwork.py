"""The work of an LM training fit (``scripts/lm_train.py``), from the
configuration's shapes alone: never from the plan or the kernels, so it
reads the same whatever implements it.

A fit is ``fit_steps`` AdamW steps of ``n_microbatches`` micro-batches of
``micro_batch`` packed sequences of ``seq_len`` tokens.  A micro-batch's
forward does, per layer, the attention projections (q of n_heads·head_dim,
k and v of n_kv_heads·head_dim, o), the router over all experts, the held
experts' SwiGLU over their balanced share of the slots (tokens ·
experts_per_token · held / routed), and 4·head_dim operations a visible
(query, key) pair of the causal window (scores and values); then the
head over the vocabulary.  Training counts three forwards (the backward
twice the forward: 8·head_dim a pair for dP, dV, dK and dQ, never the
scores a kernel recomputes).  Bytes: every parameter read by each
micro-batch's forward and backward and its gradient written, then AdamW's
read and write of the parameter, its gradient and two moments.
"""

from __future__ import annotations

from portbench import work


def pairs(S: int, window: int) -> int:
    """Visible (query, key) pairs of one causal sequence of S tokens,
    within ``window`` keys (0: all before)."""
    if not window or window >= S:
        return S * (S + 1) // 2
    return window * (window + 1) // 2 + (S - window) * window


def shapes(cfg: dict) -> dict:
    d, hd = cfg["hidden_size"], cfg["head_dim"]
    return {"d": d, "hd": hd, "H": cfg["num_attention_heads"],
            "KV": cfg["num_key_value_heads"], "f": cfg["moe_intermediate_size"],
            "E": cfg["router_experts"], "held": cfg["num_experts"],
            "k": cfg["num_experts_per_tok"], "V": cfg["vocab_size"],
            "S": cfg["seq_len"], "B": cfg["micro_batch"],
            "windows": [cfg["sliding_window"] if t == "sliding_attention"
                        else 0 for t in cfg["layer_types"]]}


def params(cfg: dict) -> int:
    s = shapes(cfg)
    d, hd, H, KV = s["d"], s["hd"], s["H"], s["KV"]
    layer = (d * H * hd * 2 + d * KV * hd * 2 + d * s["E"]
             + s["held"] * 3 * d * s["f"] + 2 * d)
    return len(s["windows"]) * layer + 2 * s["V"] * d + d


def attn_flops(cfg: dict, window: int) -> tuple[int, int]:
    """(forward, backward) operations of one attention layer's scores and
    values over one micro-batch."""
    s = shapes(cfg)
    n = s["B"] * s["H"] * pairs(s["S"], window)
    return 4 * s["hd"] * n, 8 * s["hd"] * n


def microbatch_forward_flops(cfg: dict) -> int:
    s = shapes(cfg)
    T = s["B"] * s["S"]
    d, hd = s["d"], s["hd"]
    slots = T * s["k"] * s["held"] // s["E"]
    total = 2 * T * d * s["V"]
    for w in s["windows"]:
        total += 2 * T * d * (2 * s["H"] * hd + 2 * s["KV"] * hd)
        total += 2 * T * d * s["E"]
        total += 2 * slots * 3 * d * s["f"]
        total += attn_flops(cfg, w)[0]
    return total


def fit_work(cfg: dict) -> tuple[int, int]:
    """(bytes, fp32 operations) of one fit."""
    mb, steps = cfg["n_microbatches"], cfg["fit_steps"]
    flops = steps * mb * 3 * microbatch_forward_flops(cfg)
    nbytes = steps * 4 * params(cfg) * (3 * mb + 7)
    return nbytes, flops


def attn_launches_per_fit(cfg: dict) -> int:
    """Attention kernels a fit launches: per layer and micro-batch, one
    forward and two backward."""
    return (cfg["fit_steps"] * cfg["n_microbatches"]
            * len(cfg["layer_types"]) * 3)


def attn_least_ms_per_fit(cfg: dict) -> float:
    """The least time of a fit's attention (forward and backward of every
    layer and micro-batch): its operations at the fp32 peak (q, k, v and
    out over HBM are two orders under it)."""
    flops = sum(sum(attn_flops(cfg, w)) for w in shapes(cfg)["windows"])
    return cfg["fit_steps"] * cfg["n_microbatches"] * work.least_ms(0, flops)
