"""The port's training loss and gradients (``repro_torch.launch.train``)
against the reference's, on the CPU.

Each test builds the reference's model at its ``.reduced()`` size (fp32,
d_model 64, vocab 256), draws its parameters with the reference's own
``init`` and carries them across with ``interop.lm_params_from_jax`` into
the port's ``LM``.  Tokens and targets come from a numpy seed (2 x 16
tokens).  The port's ``make_loss_fn`` loss is held to the reference's
within 1e-5 relative, and every parameter's gradient to
``jax.value_and_grad``'s within 1e-5 of the largest gradient: Mamba
(jamba) and mLSTM (xlstm) layers included, whose recurrences the port
runs out of place under autograd.
"""

import functools
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.launch import train as ref_train
from repro.models import LM as RefLM
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.interop import lm_params_from_jax
from repro_torch.launch import train
from repro_torch.models import LM

RTOL = 1e-5


def np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@functools.lru_cache(maxsize=None)
def _ref_params(arch: str, seed: int):
    cfg = ref_get_config(arch).reduced()
    return RefLM(cfg).init(jax.random.PRNGKey(seed))


def pair(arch: str, seed: int = 0):
    """(reference config, model, params; the port's config and model with
    the same weights on the CPU)."""
    rcfg = ref_get_config(arch).reduced()
    params = _ref_params(arch, seed)
    cfg = get_config(arch).reduced()
    port = LM(cfg, device="cpu")
    port.load_state_dict(lm_params_from_jax(np_tree(params)))
    return rcfg, RefLM(rcfg), params, cfg, port


def batch(cfg, B: int = 2, S: int = 16, seed: int = 1) -> dict:
    """Tokens and targets (and llava's patch embeddings) from a seed."""
    rng = np.random.default_rng(seed)
    shape = (B, S, cfg.n_codebooks) if cfg.n_codebooks > 1 else (B, S)
    out = {"tokens": rng.integers(0, cfg.vocab, size=shape).astype(np.int32),
           "targets": rng.integers(0, cfg.vocab,
                                   size=shape).astype(np.int32)}
    if cfg.frontend == "vision":
        out["patches"] = rng.standard_normal(
            (B, 4, cfg.d_model)).astype(np.float32)
    return out


def ref_value_and_grad(model, rcfg, params, b, tc):
    loss_fn = ref_train.make_loss_fn(model, rcfg, tc)
    (loss, ce), grads = jax.value_and_grad(loss_fn, has_aux=True)(
        params, {k: jnp.asarray(v) for k, v in b.items()})
    return float(loss), float(ce), lm_params_from_jax(np_tree(grads))


def close_grads(got: dict, want: dict, rtol: float = RTOL) -> float:
    """Every gradient within ``rtol`` of the largest; returns the largest
    error."""
    assert set(got) == set(want)
    top = max(float(v.abs().max()) for v in want.values())
    err = max(float((got[k].float() - want[k]).abs().max()) for k in want)
    assert err <= rtol * top, (err, top)
    return err


def close_scalar(got, want, rtol: float = RTOL) -> None:
    assert abs(float(got) - float(want)) <= rtol * max(1.0, abs(float(want)))


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_loss_and_every_gradient_match_reference(arch):
    rcfg, ref, params, cfg, port = pair(arch)
    b = batch(cfg)
    loss, ce, want = ref_value_and_grad(ref, rcfg, params, b,
                                        ref_train.TrainConfig())
    loss_fn = train.make_loss_fn(port, cfg, train.TrainConfig())
    (got_loss, got_ce), got = train.value_and_grad(
        loss_fn, dict(port.named_parameters()), b)
    close_scalar(got_loss, loss)
    close_scalar(got_ce, ce)
    close_grads(got, want)
    # every parameter is reached by the loss (jamba's dt_bias through its
    # last channel only)
    assert all(float(g.abs().max()) > 0 for g in got.values())


def test_gradients_run_out_of_place_only_under_autograd():
    """The recurrent layers' in-place state updates are what made the
    backward raise; under autograd the port's xlstm and jamba layers now
    differentiate, and without it they still run the serving path."""
    for arch in ("xlstm-1.3b", "jamba-v0.1-52b"):
        _rc, _r, _p, cfg, port = pair(arch)
        b = batch(cfg)
        loss_fn = train.make_loss_fn(port, cfg, train.TrainConfig())
        with torch.no_grad():
            (no_grad_loss, _ce) = loss_fn(dict(port.named_parameters()), b)
        (loss, _), _g = train.value_and_grad(
            loss_fn, dict(port.named_parameters()), b)
        assert float(no_grad_loss) == float(loss)


@pytest.mark.parametrize("arch", ["minitron-4b", "musicgen-large"])
def test_model_parameters_stay_as_they_were(arch):
    """The step's gradients come from the dict it is given, through
    ``functional_call``: the model's own parameters are not touched."""
    _rc, _r, _p, cfg, port = pair(arch)
    before = {k: v.clone() for k, v in port.state_dict().items()}
    params = {k: v + 1.0 for k, v in port.named_parameters()}
    loss_fn = train.make_loss_fn(port, cfg, train.TrainConfig())
    (loss_shifted, _), _g = train.value_and_grad(loss_fn, params, batch(cfg))
    (loss, _), _g = train.value_and_grad(
        loss_fn, dict(port.named_parameters()), batch(cfg))
    assert float(loss_shifted) != float(loss)
    for k, v in port.state_dict().items():
        assert torch.equal(v, before[k]), k
