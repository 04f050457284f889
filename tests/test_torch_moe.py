"""The port's MoE layers (``repro_torch.models.moe``) against the
reference's.

The reference's expert weights (drawn by its ``moe_params``) and numpy
tokens from a seed go through both packages' ``_gates``, ``moe_dense``,
``moe_ragged``, ``moe_capacity`` and ``moe_a2a`` (no mesh: the local
capacity dispatch in both) on the CPU at olmoe's ``.reduced()`` size
(d_model 64, 4 experts, top-2, d_ff 128), fp32.  Outputs are held to the
reference's within 1e-5 of max |out|; gates and the aux loss within 1e-6.
"""

from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.models import moe as ref_moe
from repro_torch.configs import get_config
from repro_torch.models import moe

RTOL = 1e-5
IMPLS = ["dense", "ragged", "capacity", "a2a"]


def setup(mlp_type: str = "swiglu", T: int = 24, seed: int = 0, **kw):
    """(the port's cfg, the reference's cfg, the reference's params, the
    port's params, tokens (T, d) as numpy)."""
    cfg = replace(get_config("olmoe-1b-7b").reduced(), mlp_type=mlp_type,
                  **kw)
    ref_cfg = replace(ref_get_config("olmoe-1b-7b").reduced(),
                      mlp_type=mlp_type, **kw)
    rp = ref_moe.moe_params(jax.random.PRNGKey(seed), ref_cfg, jnp.float32)
    pp = {k: torch.from_numpy(np.array(v)) for k, v in rp.items()}
    x = np.random.default_rng(seed + 1).standard_normal(
        (T, cfg.d_model)).astype(np.float32)
    return cfg, ref_cfg, rp, pp, x


def close(got, want, rtol: float = RTOL) -> None:
    got, want = got.detach().numpy(), np.asarray(want)
    assert got.shape == want.shape
    err = float(np.max(np.abs(got - want)))
    assert err <= rtol * float(np.max(np.abs(want))), err


def test_gates_and_aux_match_reference():
    cfg, _rc, rp, pp, x = setup(T=40)
    g, topv, topi, aux = moe._gates(torch.from_numpy(x), pp["router"],
                                    cfg.top_k)
    rg, rv, ri, raux = ref_moe._gates(jnp.asarray(x), rp["router"],
                                      cfg.top_k)
    np.testing.assert_array_equal(topi.numpy(), np.asarray(ri))
    np.testing.assert_allclose(g.numpy(), np.asarray(rg), atol=1e-6)
    np.testing.assert_allclose(topv.numpy(), np.asarray(rv), atol=1e-6)
    assert float(aux) == pytest.approx(float(raux), abs=1e-6)
    assert (g > 0).sum(dim=1).eq(cfg.top_k).all()


@pytest.mark.parametrize("mlp_type", ["swiglu", "geglu"])
@pytest.mark.parametrize("impl", IMPLS)
def test_moe_matches_reference(impl, mlp_type):
    cfg, ref_cfg, rp, pp, x = setup(mlp_type, moe_impl=impl)
    fn = {"dense": moe.moe_dense, "ragged": moe.moe_ragged,
          "capacity": moe.moe_capacity, "a2a": moe.moe_a2a}[impl]
    ref_fn = getattr(ref_moe, f"moe_{impl}")
    got, aux = fn(torch.from_numpy(x), pp, cfg)
    want, raux = ref_fn(jnp.asarray(x), rp, ref_cfg)
    close(got, want)
    assert float(aux) == pytest.approx(float(raux), abs=1e-6)
    # the (B, S, d) entry point dispatches on cfg.moe_impl
    got3, _ = moe.moe(torch.from_numpy(x).reshape(4, 6, -1), pp, cfg)
    close(got3.reshape(x.shape), want)


@pytest.mark.parametrize("impl", IMPLS)
def test_moe_without_aux_is_the_same_output(impl):
    """``with_aux=False`` (the decode path's) skips the load-balance loss
    only: the same output bit for bit, and no aux."""
    cfg, _rc, _rp, pp, x = setup(moe_impl=impl)
    xt = torch.from_numpy(x).reshape(4, 6, -1)
    want, aux = moe.moe(xt, pp, cfg)
    got, none = moe.moe(xt, pp, cfg, with_aux=False)
    assert aux is not None and none is None
    assert torch.equal(got, want)


def _ref_drops(topi: np.ndarray, e: int, capacity_factor: float) -> int:
    """Pairs past capacity, counted from the reference's top-k experts
    with its own rule (stable sort, position within the expert group)."""
    T, k = topi.shape
    counts = np.bincount(topi.reshape(-1), minlength=e)
    C = max(1, int(T * k / e * capacity_factor))
    return int(np.maximum(counts - C, 0).sum())


@pytest.mark.parametrize("capacity_factor", [0.5, 1.0])
def test_capacity_drops_match_reference(capacity_factor):
    """A case that drops tokens: the outputs (so the pairs dropped and
    which) equal the reference's, and the count equals the one from the
    reference's routing."""
    cfg, ref_cfg, rp, pp, x = setup(T=40, seed=3)
    got, _ = moe.moe_capacity(torch.from_numpy(x), pp, cfg, capacity_factor)
    want, _ = ref_moe.moe_capacity(jnp.asarray(x), rp, ref_cfg,
                                   capacity_factor)
    close(got, want)
    _g, _v, ri, _a = ref_moe._gates(jnp.asarray(x), rp["router"],
                                    cfg.top_k)
    dropped = moe.capacity_dropped(torch.from_numpy(x), pp, cfg,
                                   capacity_factor)
    assert dropped == _ref_drops(np.asarray(ri), cfg.n_experts,
                                 capacity_factor)
    assert dropped > 0
    dense, _ = moe.moe_dense(torch.from_numpy(x), pp, cfg)
    assert float((got - dense).abs().max()) > 1e-3


def test_forms_agree_when_nothing_drops():
    """dense, ragged and capacity at a factor of E/k (capacity T) compute
    the same function; the combines give the same bits on a rerun."""
    cfg, _rc, _rp, pp, x = setup(T=40, seed=5)
    xt = torch.from_numpy(x)
    cf = cfg.n_experts / cfg.top_k
    dense, _ = moe.moe_dense(xt, pp, cfg)
    assert moe.capacity_dropped(xt, pp, cfg, cf) == 0
    for fn in (moe.moe_ragged,
               lambda *a: moe.moe_capacity(*a, capacity_factor=cf)):
        out, _ = fn(xt, pp, cfg)
        close(out, dense.numpy())
        assert torch.equal(out, fn(xt, pp, cfg)[0])
