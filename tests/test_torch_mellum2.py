"""``mellum2-12b-a2.5b`` on the port against the plain reference
(``tests/plain_mellum2.py``) at ``.reduced()`` size on the CPU, with two
KV heads a group of two query heads and a share of the experts: logits,
the aux loss, the loss and every gradient, one AdamW step through
``launch.train.make_train_step`` with 2 micro-batches (1e-5 of the
largest); the YaRN frequencies against the formula at full width; the
window block loop against the masked dense product; one device's shares
of the experts adding up to the uncut layer; and the benchmark's script
against its own plain reference (``portbench/reference/lm_train.py``) at
a tiny size, the TF32 control and the half-rows fault over its limits.
"""

import sys
from dataclasses import replace
from pathlib import Path

import numpy as np
import pytest
import torch

import plain_mellum2 as plain
from repro_torch import spans
from repro_torch.configs import get_config
from repro_torch.kernels.attention import tiles_visited
from repro_torch.launch.train import TrainConfig, make_loss_fn, \
    make_train_step, value_and_grad
from repro_torch.models import LM
from repro_torch.models.attention import _chunked_attention, rope_freqs
from repro_torch.models.moe import moe, moe_params
from repro_torch.optim import adamw

ROOT = Path(__file__).resolve().parents[1]
ARCH = "mellum2-12b-a2.5b"
#: relative to the largest magnitude of each compared tensor: the port and
#: the plain reference sum in other orders (blocked attention, sorted
#: experts, the fused loss), a few fp32 ulps
RTOL = 1e-5


def small(**kw):
    """The reduced configuration with GQA (4 query heads over 2 KV heads),
    8 routed experts of which 4 are held from expert 2, and attention in
    blocks of 8."""
    base = replace(get_config(ARCH).reduced(), n_kv_heads=2, n_experts=8,
                   top_k=4, experts_held=4, expert_first=2, attn_chunk=8)
    return replace(base, **kw)


def model(cfg, seed=0):
    m = LM(cfg, device="cpu").init(torch.Generator().manual_seed(seed))
    return m.requires_grad_(False)


def batch(cfg, B=2, S=32, seed=1):
    rng = np.random.default_rng(seed)
    toks = torch.as_tensor(rng.integers(0, cfg.vocab, (B, S + 1)))
    return {"tokens": toks[:, :-1], "targets": toks[:, 1:]}


def close(got, want, rtol=RTOL):
    got, want = torch.as_tensor(got).float(), torch.as_tensor(want).float()
    assert got.shape == want.shape
    err = float((got - want).abs().max().detach())
    assert err <= rtol * max(float(want.abs().max()), 1e-30), err


def test_the_configuration_is_the_published_shape():
    cfg = get_config(ARCH)
    assert (cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd) == \
        (2304, 32, 4, 128)
    assert (cfg.n_experts, cfg.top_k, cfg.d_ff, cfg.vocab) == \
        (64, 8, 896, 98304)
    m = LM(replace(cfg, n_layers=4), device="meta")
    assert [(s.window, s.rope) for s in m.specs] == \
        [(1024, "default")] * 3 + [(0, "yarn")]
    assert cfg.moe_impl == "ragged" and cfg.dtype == "float32"


def test_yarn_frequencies_follow_the_formula():
    cfg = get_config(ARCH)
    got, scale = rope_freqs(128, cfg.rope_theta, cfg.yarn)
    want, want_scale = plain.yarn_inv_freq(128, cfg.rope_theta, cfg.yarn)
    close(got, want, 1e-6)
    assert scale == want_scale == pytest.approx(1.2772588722239782)
    base, _ = rope_freqs(128, cfg.rope_theta)
    # extrapolated below dim 18, interpolated by 16 from dim 35, a ramp
    # between: low 18 and high 35 at d 128, θ 5e5
    assert torch.equal(got[:19], base[:19])
    close(got[35:], base[35:] / 16, 1e-6)
    inside = got[19:35] / base[19:35]
    assert bool(((inside < 1) & (inside > 1 / 16)).all())


@pytest.mark.parametrize("window", [0, 300])
def test_window_block_loop_matches_masked_dense(window):
    g = torch.Generator().manual_seed(3)
    q, k, v = (torch.randn((1, 3072, 2, 16), generator=g) for _ in range(3))
    pos = torch.arange(3072)[None]
    with spans.recording() as rec:
        got = _chunked_attention(q, k, v, pos, window)
    close(got, plain.dense_attention(q, k, v, window))
    (count,) = [c.value for c in rec.counts if c.name == "attn.blocks"]
    # blocks of 1,024: the full layer visits 6 tiles a head, a window of
    # 300 a block's own and, past the first, the one before it: 5
    assert count == 2 * tiles_visited(3072, window, 1024)
    assert tiles_visited(3072, 300, 1024) == 5 < tiles_visited(3072, 0, 1024)


def test_logits_loss_and_every_gradient_match_the_plain_reference():
    cfg = small()
    m = model(cfg)
    W = {k: v.clone() for k, v in m.state_dict().items()}
    b = batch(cfg)
    with torch.no_grad():
        logits, aux = m(b["tokens"])
    want_logits, want_aux = plain.forward(W, b["tokens"], cfg)
    close(logits, want_logits)
    close(aux, want_aux)
    tc = TrainConfig(fusion="gen")
    (total, ce), grads = value_and_grad(make_loss_fn(m, cfg, tc),
                                        dict(m.named_parameters()), b)
    leaves = {k: v.clone().requires_grad_(True) for k, v in W.items()}
    want_total, want_ce = plain.loss(leaves, b["tokens"], b["targets"], cfg)
    want_grads = torch.autograd.grad(want_total, list(leaves.values()))
    close(total, want_total)
    close(ce, want_ce)
    for (name, _), want in zip(leaves.items(), want_grads):
        close(grads[name], want)


def test_one_adamw_step_with_two_microbatches():
    """The moments (the clipped mean gradient and its square) and the
    parameters at 1e-5 of their largest: a first step moves a parameter by
    about lr = 3e-6 of its own scale, so the moments carry the check;
    AdamW's eps is 1 here, which keeps the step smooth in the gradient (at
    1e-8 it is lr · sign(g), which flips on a gradient's last ulp)."""
    cfg = small()
    m = model(cfg, seed=4)
    W = {k: v.clone() for k, v in m.state_dict().items()}
    start = {k: v.clone() for k, v in W.items()}
    b = batch(cfg, B=4, S=16, seed=5)
    tc = TrainConfig(n_microbatches=2, fusion="gen",
                     opt=adamw.OptConfig(eps=1.0))
    params = dict(m.named_parameters())
    opt = adamw.init(params, tc.opt)
    params, opt, metrics = make_train_step(m, cfg, tc)(params, opt, b)
    grads = {k: torch.zeros_like(v) for k, v in W.items()}
    ces = []
    for i in range(2):
        leaves = {k: v.clone().requires_grad_(True) for k, v in W.items()}
        total, ce = plain.loss(leaves, b["tokens"][2 * i:2 * i + 2],
                               b["targets"][2 * i:2 * i + 2], cfg)
        for k, g in zip(leaves, torch.autograd.grad(total,
                                                    list(leaves.values()))):
            grads[k] += g / 2
        ces.append(float(ce))
    close(metrics["loss"], sum(ces) / 2)
    m_, v_ = ({k: torch.zeros_like(x) for k, x in W.items()} for _ in "mv")
    plain.adamw_step(W, grads, m_, v_, 1, eps=1.0)
    for k in W:
        close(opt["m"][k], m_[k])
        close(opt["v"][k], v_[k])
        close(params[k], W[k])
        assert not torch.equal(params[k], start[k]) or not grads[k].any()


def test_expert_shares_add_up_to_the_uncut_layer():
    """Four shares of 2 experts each, every share routing over all 8: the
    outputs add up to the uncut layer's, and each share's aux is the
    router's, the same in every share (counted once)."""
    cfg = replace(get_config(ARCH).reduced(), n_experts=8, top_k=4,
                  experts_held=0)
    g = torch.Generator().manual_seed(6)
    p = moe_params(g, cfg)
    x = torch.randn((2, 16, cfg.d_model), generator=g)
    whole, whole_aux = moe(x, p, cfg)
    parts = []
    with spans.recording() as rec:
        for i in range(4):
            share = replace(cfg, experts_held=2, expert_first=2 * i)
            pi = {k: (v if k == "router" else v[2 * i:2 * i + 2])
                  for k, v in p.items()}
            out, aux = moe(x, pi, share)
            assert float(aux) == float(whole_aux)
            parts.append(out)
    close(sum(parts), whole)
    # each pair routed to one share's experts: 32 tokens x 4 slots in all
    held = [c.value for c in rec.counts if c.name == "moe.held_slots"]
    assert sum(held) == 32 * 4 and all(0 < n < 32 * 4 for n in held)


def test_expert_share_weights_are_the_held_experts_only():
    cfg = small()
    p = moe_params(None, cfg)
    assert tuple(p["router"].shape) == (cfg.d_model, 8)
    assert tuple(p["w1"].shape) == (4, cfg.d_model, cfg.d_ff)
    with pytest.raises(ValueError, match="under no mesh"):
        from repro_torch.models.moe import _experts_of
        _experts_of(cfg, object())


# -- the benchmark's script against its plain reference -------------------

def _bench():
    for p in (str(ROOT),):
        if p not in sys.path:
            sys.path.insert(0, p)
    from portbench import calibrate, compare, precision, registry
    script = registry.module("scripts", "lm_train")
    ref = registry.module("reference", "lm_train")
    return calibrate, compare, precision, registry, script, ref


def tiny_bench_config(registry):
    """The cell's configuration at a CPU size: widths cut (the port's
    configuration cut alike), two sequences of 32 tokens a micro-batch."""
    cfg = registry.config(registry.benchmark(ROOT), "mellum2-12b-ep8", ROOT)
    cfg = dict(cfg, hidden_size=64, head_dim=16, num_attention_heads=4,
               num_key_value_heads=2, moe_intermediate_size=32,
               router_experts=8, num_experts=4, expert_first=2,
               num_experts_per_tok=4, sliding_window=8, vocab_size=128,
               seq_len=32, micro_batch=2, rows=64)
    mc = replace(get_config(ARCH), d_model=64, head_dim=16, n_heads=4,
                 n_kv_heads=2, d_ff=32, n_experts=8, top_k=4,
                 sliding_window=8, vocab=128, attn_chunk=8, n_layers=4,
                 experts_held=4, expert_first=2)
    return cfg, mc


def test_the_benchmark_script_agrees_with_its_reference(monkeypatch):
    calibrate, compare, precision, registry, script, ref = _bench()
    cfg, mc = tiny_bench_config(registry)
    monkeypatch.setattr(script, "model_config", lambda c: mc)
    ops = script.draw(cfg, 2 ** 33 + 7, "cpu")
    port_ops = script.prepare(ops, cfg)
    fin = script.fit_input(ops, cfg, np.random.default_rng(3))
    assert isinstance(fin["batch_seed"], int)
    with spans.recording() as rec:
        params, losses = script.port_fit(port_ops, fin, cfg)
    names = {s.name for s in rec.spans}
    assert {"lm_train.run", "train.step", "optim.adamw", "attn.window",
            "attn.full", "moe", "sync"} <= names
    with torch.no_grad():
        want, want_losses = ref.fit(ops, fin, cfg, precision.fp32_mm)
        ctl, ctl_losses = ref.fit(ops, fin, cfg, precision.tf32_mm)
        bad, bad_losses = ref.fit(ops, fin, cfg,
                                  calibrate.half_rows_mm(cfg["rows"]))
    mix = registry.mix("lm_train8k")
    lim = mix["limits"]
    assert compare.obj_gap(losses, want_losses) <= lim["obj_gap"]
    assert compare.param_gap(params, want) <= lim["param_gap"]
    for p, ls in ((ctl, ctl_losses), (bad, bad_losses)):
        assert (compare.param_gap(p, want) > lim["param_gap"]
                or compare.obj_gap(ls, want_losses) > lim["obj_gap"])
    # a fit starts from the pristine weights: a second fit on the same
    # batch gives the same change
    again, again_losses = script.port_fit(port_ops, fin, cfg)
    assert again_losses == losses


def test_the_loss_over_the_vocabulary_slice_takes_a_layout_that_builds():
    """The fused loss's Row CPlans at 65,536 x 12,288 (the cell's): no tile
    geometry whose pass holds part of a row (``row.cuh``'s static_assert:
    R a multiple of T / LT), so the forward goes to the staged layout."""
    from repro_torch.core import FusionContext
    from repro_torch.core.codegen import compile_plan
    from repro_torch.kernels import cuda_src
    from repro_torch.launch import train
    with FusionContext():
        planned = train._lse.trace(torch.empty((65536, 12288),
                                               device="meta")).plan()
        cplans = [cp for ep in (planned.eplan, planned.backward().eplan)
                  for cp in compile_plan(ep).cplans()]
    layouts = []
    for cp in cplans:
        src = cuda_src.source_for(cp)
        if src.template == "row":
            layouts.append(src.layout)
        if src.layout == "tile":
            lt = int(src.text.split("LT = ")[1].split(",")[0])
            assert src.rows % (src.threads // lt) == 0
    assert layouts.count("staged") == 2
