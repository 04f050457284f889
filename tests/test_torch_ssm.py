"""The port's recurrent layers (``repro_torch.models.{mamba,xlstm}``)
against the reference's.

The reference's parameters (its ``mamba_params`` / ``xlstm_params``) and
numpy inputs and states from a seed go through both packages on the CPU,
fp32, at jamba's and xlstm's ``.reduced()`` sizes (d_model 64; Mamba
d_inner 128, N 8, conv 4; mLSTM 4 heads of 32).  Outputs and states are
held to the reference's within 1e-5 of their max |value|; a prefill of P
tokens followed by k decodes to the forward over P + k within 1e-5.
``F.softplus`` returns x above 20 where JAX's softplus is exact (log1p of
exp(-x) ≤ 2.1e-9 there, far below these tolerances).
"""

from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.models import mamba as ref_mamba
from repro.models import xlstm as ref_xlstm
from repro_torch.configs import get_config
from repro_torch.models import mamba, xlstm

RTOL = 1e-5


def cfgs(arch: str, **kw):
    return (replace(get_config(arch).reduced(), **kw),
            replace(ref_get_config(arch).reduced(), **kw))


def params(ref_fn, ref_cfg, seed: int = 0):
    rp = ref_fn(jax.random.PRNGKey(seed), ref_cfg, jnp.float32)
    return rp, {k: torch.from_numpy(np.array(v)) for k, v in rp.items()}


def close(got, want, rtol: float = RTOL) -> None:
    got, want = got.detach().numpy(), np.asarray(want)
    assert got.shape == want.shape
    err = float(np.max(np.abs(got - want)))
    assert err <= rtol * max(float(np.max(np.abs(want))), 1e-30), err


def rand(shape, seed: int, scale: float = 1.0) -> np.ndarray:
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def mamba_state(cfg, B: int, seed: int) -> dict:
    di = cfg.ssm_expand * cfg.d_model
    return {"h": rand((B, di, cfg.ssm_state), seed, 0.5),
            "conv": rand((B, cfg.ssm_conv - 1, di), seed + 1, 0.5)}


def xlstm_state(cfg, B: int, seed: int) -> dict:
    H = cfg.n_heads
    hd = cfg.ssm_expand * cfg.d_model // H
    return {"C": rand((B, H, hd, hd), seed, 0.3),
            "n": rand((B, H, hd), seed + 1, 0.3),
            "m": rand((B, H), seed + 2, 0.3)}


def to_torch(state: dict) -> dict:
    return {k: torch.from_numpy(v.copy()) for k, v in state.items()}


# --------------------------------------------------------------------------
# Mamba
# --------------------------------------------------------------------------

@pytest.mark.parametrize("with_state", [False, True])
def test_mamba_matches_reference(with_state):
    cfg, ref_cfg = cfgs("jamba-v0.1-52b")
    rp, pp = params(ref_mamba.mamba_params, ref_cfg)
    x = rand((2, 11, cfg.d_model), 1)
    st = mamba_state(cfg, 2, 2) if with_state else None
    want, wst = ref_mamba.mamba(jnp.asarray(x), rp, ref_cfg, state=(
        None if st is None else {k: jnp.asarray(v) for k, v in st.items()}))
    pst = None if st is None else to_torch(st)
    got, gst = mamba.mamba(torch.from_numpy(x), pp, cfg, state=pst)
    close(got, want)
    if with_state:
        assert gst is pst                    # written in place
        for k in ("h", "conv"):
            close(gst[k], wst[k])
    else:
        assert gst is None and wst is None


def test_mamba_decode_matches_reference():
    cfg, ref_cfg = cfgs("jamba-v0.1-52b")
    rp, pp = params(ref_mamba.mamba_params, ref_cfg, seed=3)
    x = rand((3, 1, cfg.d_model), 4)
    st = mamba_state(cfg, 3, 5)
    want, wst = ref_mamba.mamba_decode(
        jnp.asarray(x), rp, ref_cfg, {k: jnp.asarray(v) for k, v in
                                      st.items()})
    pst = to_torch(st)
    got, gst = mamba.mamba_decode(torch.from_numpy(x), pp, cfg, pst)
    close(got, want)
    assert gst is pst
    for k in ("h", "conv"):
        close(gst[k], wst[k])


def test_mamba_prefill_then_decode_equals_forward():
    cfg, ref_cfg = cfgs("jamba-v0.1-52b")
    _rp, pp = params(ref_mamba.mamba_params, ref_cfg, seed=6)
    P, k = 9, 4
    x = torch.from_numpy(rand((2, P + k, cfg.d_model), 7))
    full, _ = mamba.mamba(x, pp, cfg)
    st = mamba.init_mamba_state(cfg, 2, torch.float32)
    out, _ = mamba.mamba(x[:, :P], pp, cfg, state=st)
    close(out, full[:, :P].numpy())
    for t in range(P, P + k):
        y, st = mamba.mamba_decode(x[:, t:t + 1], pp, cfg, st)
        close(y, full[:, t:t + 1].numpy())


# --------------------------------------------------------------------------
# mLSTM
# --------------------------------------------------------------------------

def test_cell_step_matches_reference():
    cfg, _ = cfgs("xlstm-1.3b")
    st = xlstm_state(cfg, 2, 8)
    H, hd = cfg.n_heads, cfg.ssm_expand * cfg.d_model // cfg.n_heads
    q, k, v = (rand((2, H, hd), s) for s in (9, 10, 11))
    ipre, fpre = rand((2, H), 12, 3.0), rand((2, H), 13, 3.0)
    fpre[0, 0] = 30.0                # past F.softplus's threshold
    (wC, wn, wm), wh = ref_xlstm._cell_step(
        tuple(jnp.asarray(st[k_]) for k_ in ("C", "n", "m")),
        tuple(jnp.asarray(a) for a in (q, k, v, ipre, fpre)))
    t = to_torch(st)
    logf = -torch.nn.functional.softplus(-torch.from_numpy(fpre))
    (gC, gn, gm), gh = xlstm._cell_step(
        (t["C"], t["n"], t["m"]),
        tuple(torch.from_numpy(a) for a in (q, k, v, ipre)) + (logf,))
    assert gC is t["C"]                  # C updated in place
    for g, w in ((gC, wC), (gn, wn), (gm, wm), (gh, wh)):
        close(g, w)


@pytest.mark.parametrize("with_state", [False, True])
def test_mlstm_matches_reference(with_state):
    cfg, ref_cfg = cfgs("xlstm-1.3b")
    rp, pp = params(ref_xlstm.xlstm_params, ref_cfg, seed=14)
    x = rand((2, 10, cfg.d_model), 15)
    st = xlstm_state(cfg, 2, 16) if with_state else None
    want, wst = ref_xlstm.mlstm(jnp.asarray(x), rp, ref_cfg, state=(
        None if st is None else {k: jnp.asarray(v) for k, v in st.items()}))
    pst = None if st is None else to_torch(st)
    got, gst = xlstm.mlstm(torch.from_numpy(x), pp, cfg, state=pst)
    close(got, want)
    if with_state:
        assert gst is pst
        for k in ("C", "n", "m"):
            close(gst[k], wst[k])


def test_mlstm_decode_matches_reference():
    cfg, ref_cfg = cfgs("xlstm-1.3b")
    rp, pp = params(ref_xlstm.xlstm_params, ref_cfg, seed=17)
    x = rand((3, 1, cfg.d_model), 18)
    st = xlstm_state(cfg, 3, 19)
    want, wst = ref_xlstm.mlstm_decode(
        jnp.asarray(x), rp, ref_cfg, {k: jnp.asarray(v) for k, v in
                                      st.items()})
    pst = to_torch(st)
    got, gst = xlstm.mlstm_decode(torch.from_numpy(x), pp, cfg, pst)
    close(got, want)
    for k in ("C", "n", "m"):
        close(gst[k], wst[k])


def test_mlstm_prefill_then_decode_equals_forward():
    cfg, ref_cfg = cfgs("xlstm-1.3b")
    _rp, pp = params(ref_xlstm.xlstm_params, ref_cfg, seed=20)
    P, k = 8, 4
    x = torch.from_numpy(rand((2, P + k, cfg.d_model), 21))
    full, _ = xlstm.mlstm(x, pp, cfg)
    st = xlstm.init_xlstm_state(cfg, 2)
    out, _ = xlstm.mlstm(x[:, :P], pp, cfg, state=st)
    close(out, full[:, :P].numpy())
    for t in range(P, P + k):
        y, st = xlstm.mlstm_decode(x[:, t:t + 1], pp, cfg, st)
        close(y, full[:, t:t + 1].numpy())


# --------------------------------------------------------------------------
# serving keeps its in-place updates, training differentiates
# --------------------------------------------------------------------------

def _pinned_scan(u, dt, B_, C_, A, h0):
    """The selective scan as serving ran it before training could
    differentiate it: every step overwrites its dBx in place."""
    dA = torch.exp(dt[..., None] * A)
    hs = dt[..., None] * B_[:, :, None, :] * u[..., None]
    h = h0
    for t in range(u.shape[1]):
        h = hs[:, t].addcmul_(h, dA[:, t])
    return torch.einsum("bldn,bln->bld", hs, C_), h


def _pinned_cell_step(state, inputs):
    """The mLSTM step as serving ran it before: C updated in place."""
    C, n, m = state
    q, k, v, ipre, logf = inputs
    m_new = torch.maximum(logf + m, ipre)
    i_g = torch.exp(ipre - m_new)[..., None]
    f_g = torch.exp(logf + m - m_new)[..., None]
    C.mul_(f_g[..., None]).add_(i_g[..., None] * (v[..., :, None]
                                                  * k[..., None, :]))
    n = f_g * n + i_g * k
    h_num = (C @ q[..., None])[..., 0]
    h_den = torch.maximum(torch.abs(torch.sum(n * q, dim=-1)),
                          torch.exp(-m_new))[..., None]
    return (C, n, m_new), h_num / h_den


def test_serving_scan_and_cell_step_keep_their_bits_and_update_in_place():
    """Under ``no_grad`` the scan and the cell step run in place and give
    the bits of the serving path as it was; with autograd recording they
    run out of place with the same bits, and differentiate."""
    cfg, _ = cfgs("jamba-v0.1-52b")
    di, N = cfg.ssm_expand * cfg.d_model, cfg.ssm_state
    u, dt = (torch.from_numpy(rand((2, 9, di), s, 0.5)) for s in (30, 31))
    dt = dt.abs()
    B_, C_ = (torch.from_numpy(rand((2, 9, N), s)) for s in (32, 33))
    A = -torch.from_numpy(rand((di, N), 34)).abs()
    h0 = torch.from_numpy(rand((2, di, N), 35, 0.5))
    want_y, want_h = _pinned_scan(u, dt, B_, C_, A, h0.clone())
    with torch.no_grad():
        y, h = mamba._selective_scan(u, dt, B_, C_, A, h0.clone())
    assert torch.equal(y, want_y) and torch.equal(h, want_h)
    ur = u.clone().requires_grad_(True)
    y2, h2 = mamba._selective_scan(ur, dt, B_, C_, A, h0.clone())
    assert torch.equal(y2.detach(), want_y) and torch.equal(h2.detach(),
                                                            want_h)
    (gu,) = torch.autograd.grad(y2.sum() + h2.sum(), ur)
    assert gu.shape == u.shape and bool(torch.isfinite(gu).all())

    cfg, _ = cfgs("xlstm-1.3b")
    st = xlstm_state(cfg, 2, 36)
    H, hd = cfg.n_heads, cfg.ssm_expand * cfg.d_model // cfg.n_heads
    q, k, v = (torch.from_numpy(rand((2, H, hd), s)) for s in (37, 38, 39))
    ipre, logf = (torch.from_numpy(rand((2, H), s)) for s in (40, 41))
    logf = -logf.abs()
    inputs = (q, k, v, ipre, logf)
    t = to_torch(st)
    (wC, wn, wm), wh = _pinned_cell_step((t["C"].clone(), t["n"], t["m"]),
                                         inputs)
    C0 = t["C"].clone()
    with torch.no_grad():
        (gC, gn, gm), gh = xlstm._cell_step((C0, t["n"], t["m"]), inputs)
    assert gC is C0
    for g, w in ((gC, wC), (gn, wn), (gm, wm), (gh, wh)):
        assert torch.equal(g, w)
    qr = q.clone().requires_grad_(True)
    vr = v.clone().requires_grad_(True)
    C1 = t["C"].clone()
    (rC, _rn, _rm), rh = xlstm._cell_step((C1, t["n"], t["m"]),
                                          (qr, k, vr, ipre, logf))
    assert rC is not C1 and torch.equal(C1, t["C"])
    assert torch.equal(rC.detach(), wC) and torch.equal(rh.detach(), wh)
    (gv,) = torch.autograd.grad(rh.sum() + rC.sum(), vr)
    assert bool(torch.isfinite(gv).all()) and bool(gv.abs().sum() > 0)
