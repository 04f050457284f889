"""The port's fused loss and train step against the reference's, on the
CPU, at ``.reduced()`` size (see ``test_torch_train_grads``).

``fusion="gen"`` runs the softmax-CE's log-sum-exp rows through the
planner (one Row CPlan forward, its planned backward one more), on the CPU
through the kernels' plain versions, as the reference's own CPU tests run
its ``_fused_lse``.  The fused loss and gradients are held to the
reference's fused ones and to the port's unfused ones within 1e-5 (of the
largest gradient); the step with ``n_microbatches=2`` (the reference's
``lax.scan``, a loop here) and the AdamW update after it to the
reference's step: the first moment within 2e-5 of its largest (a batch of
4: twice the gradient tests' tokens summed) and the second (quadratic in
the gradient) within 4e-5, and the
parameters' update within 1e-5 of the learning rate wherever the first
moment is at least 1e-3 of its largest (AdamW's first step is g / |g|,
decided by rounding where g is near 0).
"""

import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.launch import train as ref_train
from repro_torch.interop import lm_params_from_jax
from repro_torch.launch import train
from repro_torch.optim import adamw

from test_torch_train_grads import (batch, close_grads, close_scalar,
                                    np_tree, pair, ref_value_and_grad)


@pytest.mark.parametrize("arch", ["minitron-4b", "musicgen-large",
                                  "llava-next-34b"])
def test_fused_loss_matches_reference_and_unfused(arch):
    rcfg, ref, params, cfg, port = pair(arch)
    b = batch(cfg)
    loss, _ce, want = ref_value_and_grad(
        ref, rcfg, params, b, ref_train.TrainConfig(fusion="gen"))
    got = {}
    for fusion in ("gen", "off"):
        loss_fn = train.make_loss_fn(port, cfg,
                                     train.TrainConfig(fusion=fusion))
        (got_loss, _), got[fusion] = train.value_and_grad(
            loss_fn, dict(port.named_parameters()), b)
        close_scalar(got_loss, loss)
        close_grads(got[fusion], want)
    close_grads(got["gen"], got["off"])


def test_fused_lse_is_one_row_operator_each_way():
    """The fused LSE over (rows, V) plans one Row no_agg CPlan, and its
    backward one more, as the reference's; the operator is compiled once
    per shape and reused."""
    V = 256
    x = torch.randn((32, V), generator=torch.Generator().manual_seed(0))
    train._LSE_OPS.clear()
    from repro_torch.core import fusion_mode
    with fusion_mode(device="cpu"):
        want = torch.logsumexp(x, 1, keepdim=True)
        xr = x.clone().requires_grad_(True)
        got = train._fused_lse(xr, "gen")
        train._fused_lse(x, "gen")
    assert len(train._LSE_OPS) == 1
    (op,) = train._LSE_OPS.values()
    cps = op._cplan.cplans()
    assert [(c.ttype.name, c.variant) for c in cps] == [("ROW", "no_agg")]
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
    g = torch.randn((32, 1), generator=torch.Generator().manual_seed(1))
    (gx,) = torch.autograd.grad(got, xr, g)
    torch.testing.assert_close(gx, torch.softmax(x, 1) * g, rtol=1e-5,
                               atol=1e-6)
    bwd = op._get_bwd()[0].cplans()
    assert [(c.ttype.name, c.variant) for c in bwd] == [("ROW", "no_agg")]
    # the activations need their gradient: autograd's backward ran the
    # every-input plan, the only one held
    assert list(op._bwd_plans) == [op.planned.wrt_key()]


#: the update is compared where |first moment| >= COND x its largest
COND = 1e-3
#: the step's batch of 4 sums twice the tokens of the gradient tests' batch
#: of 2 into each gradient (xlstm's embedding gradient differs by 1.35e-5
#: of the largest at batch 4 without microbatches)
STEP_RTOL = 2e-5


def _ref_step(arch, tc_kw, opt):
    rcfg, ref, params, cfg, port = pair(arch)
    b = batch(cfg, B=4)
    rtc = ref_train.TrainConfig(opt=opt, **tc_kw)
    step = jax.jit(ref_train.make_train_step(ref, rcfg, rtc))
    new_p, new_o, metrics = step(params, ref_train.adamw.init(params, opt),
                                 {k: jnp.asarray(v) for k, v in b.items()})
    return (lm_params_from_jax(np_tree(new_p)), np_tree(new_o),
            {k: float(v) for k, v in metrics.items()}, cfg, port, b)


@pytest.mark.parametrize("arch,tc_kw", [
    ("minitron-4b", {"n_microbatches": 2}),
    ("xlstm-1.3b", {"n_microbatches": 2}),
    ("olmoe-1b-7b", {"n_microbatches": 1, "fusion": "gen"}),
])
def test_train_step_matches_reference(arch, tc_kw):
    opt = adamw.OptConfig(lr=1e-2, warmup_steps=0)
    want_p, want_o, want_m, cfg, port, b = _ref_step(arch, tc_kw, opt)
    params = {k: v.detach().clone() for k, v in port.named_parameters()}
    step = train.make_train_step(port, cfg,
                                 train.TrainConfig(opt=opt, **tc_kw))
    new_p, new_o, metrics = step(params, adamw.init(params, opt), b)
    for k in ("loss", "grad_norm", "lr"):
        close_scalar(metrics[k], want_m[k])
    assert int(new_o["count"]) == int(want_o["count"]) == 1
    want_m1 = lm_params_from_jax(want_o["m"])
    close_grads(new_o["m"], want_m1, rtol=STEP_RTOL)
    # v = (1 - b2) g^2: twice g's relative error
    close_grads(new_o["v"], lm_params_from_jax(want_o["v"]),
                rtol=2 * STEP_RTOL)
    # AdamW's first step is m / sqrt(v) = g / |g|: where g is near 0 its
    # rounding decides the step, so the update is held where the first
    # moment is at least COND of the largest
    top = max(float(v.abs().max()) for v in want_m1.values())
    for k, p in params.items():
        well = want_m1[k].abs() >= COND * top
        err = (new_p[k] - want_p[k]).abs()[well]
        assert err.numel() == 0 or float(err.max()) <= 1e-5 * opt.lr, k


def test_step_updates_in_place_and_skips_a_nonfinite_loss():
    """The step writes its update into the tensors it was given, with the
    bits of ``adamw.update`` on the same gradients (into copies); a
    non-finite loss leaves them as they were."""
    _rc, _r, _p, cfg, port = pair("minitron-4b")
    opt = adamw.OptConfig(lr=1e-2, warmup_steps=0)
    tc = train.TrainConfig(opt=opt)
    b = batch(cfg)
    p0 = {k: v.detach().clone() for k, v in port.named_parameters()}
    (_l, _ce), grads = train.value_and_grad(
        train.make_loss_fn(port, cfg, tc), p0, b)
    pw = {k: v.clone() for k, v in p0.items()}
    want_p, want_o, _m = adamw.update(grads, adamw.init(pw, opt), pw, opt)
    p1 = {k: v.clone() for k, v in p0.items()}
    o1 = adamw.init(p1, opt)
    got_p, got_o, _m = train.make_train_step(port, cfg, tc)(p1, o1, b)
    assert got_o["count"] is o1["count"] and int(o1["count"]) == 1
    for k in p1:
        assert got_p[k] is p1[k] and torch.equal(p1[k], want_p[k])
        assert torch.equal(o1["m"][k], want_o["m"][k])
        assert torch.equal(o1["v"][k], want_o["v"][k])
    p2 = {k: v.clone() for k, v in p0.items()}
    p2["final_norm.scale"].fill_(float("nan"))
    o2 = adamw.init(p2, opt)
    snap = {k: v.clone() for k, v in p2.items()}
    _p, _o, m = train.make_train_step(port, cfg, tc)(p2, o2, b)
    assert not np.isfinite(float(m["loss"]))
    assert int(o2["count"]) == 0
    for k in p2:
        assert torch.equal(p2[k], snap[k]) or k == "final_norm.scale"
    assert bool(torch.isnan(p2["final_norm.scale"]).all())
    assert not any(bool(v.any()) for v in o2["m"].values())


class _CliConfig(Exception):
    """Carries the configuration the reference's CLI built out of it."""


def _reference_cli_config(monkeypatch, arch: str, preset: str):
    """The configuration ``repro.launch.train.main`` builds for ``--arch``
    and ``--preset``: its ``LM(cfg)``, the first call after the preset
    is applied, is stopped with the configuration it is given."""
    def stop(cfg):
        raise _CliConfig(cfg)
    monkeypatch.setattr(ref_train, "LM", stop)
    monkeypatch.setattr(sys, "argv", ["train", "--arch", arch,
                                      "--preset", preset])
    with pytest.raises(_CliConfig) as got:
        ref_train.main()
    return got.value.args[0]


def test_default_microbatches_and_presets_match_reference(monkeypatch):
    """``default_microbatches`` over every configuration, shape and a few
    data-parallel widths, and the CLI's presets, equal the reference's:
    each preset against the configuration the reference's own ``main``
    builds from the same flags."""
    from dataclasses import asdict

    from repro.configs import get_config as ref_get_config
    from repro.configs.shapes import SHAPES as REF_SHAPES
    from repro_torch.configs import ARCH_IDS, SHAPES, get_config
    for arch in ARCH_IDS:
        cfg, rcfg = get_config(arch), ref_get_config(arch)
        for name, shape in SHAPES.items():
            for dp in (1, 8, 64, 512):
                assert train.default_microbatches(cfg, shape, dp) == \
                    ref_train.default_microbatches(rcfg, REF_SHAPES[name],
                                                   dp), (arch, name, dp)
        for preset in ("tiny", "100m", "full"):
            got = asdict(train.preset_config(arch, preset))
            want = _reference_cli_config(monkeypatch, arch, preset)
            assert got == asdict(want), (arch, preset)
