"""The port's LM (``repro_torch.models``) against the reference's.

Each test builds the reference's model (JAX, its parameters drawn by its
own ``init``) and carries the parameters across with
``interop.lm_params_from_jax`` into the port's ``LM`` on the CPU; tokens
and other inputs come from a numpy seed.  Configurations are the
reference's ``.reduced()`` ones (fp32, d_model 64).  Logits are held to
the reference's within 1e-5 of max |logit|; the port's decode against its
own full forward at the reference's 2e-2; the MoE aux loss within 1e-5;
the fused rmsnorm at the reference test's 1e-5 (values) and 1e-4
(gradient).
"""

import functools
from dataclasses import fields, replace

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.models import LM as RefLM
from repro.models import attention as ref_attention
from repro.models import layers as ref_layers
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.interop import lm_cache_from_jax, lm_params_from_jax
from repro_torch.models import LM, attention, layers

#: the architectures with MoE layers
MOE_ARCHS = ["grok-1-314b", "olmoe-1b-7b", "jamba-v0.1-52b"]
RTOL = 1e-5
DECODE_VS_FULL = 2e-2


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@functools.lru_cache(maxsize=None)
def _ref_params(cfg, seed: int):
    """The reference's params for ``cfg`` (its ``moe_impl`` set to the
    default: the draws do not depend on it), drawn once per test
    process, and the port's state dict of them."""
    params = RefLM(cfg).init(jax.random.PRNGKey(seed))
    return params, lm_params_from_jax(_np(params))


def pair(cfg, seed: int = 0):
    """(reference model, its params, the port's model with the same
    weights on the CPU)."""
    params, state = _ref_params(replace(cfg, moe_impl="dense"), seed)
    port = LM(cfg, device="cpu")
    port.load_state_dict(state)
    return RefLM(cfg), params, port


def tokens(cfg, B: int, S: int, seed: int = 1) -> np.ndarray:
    shape = (B, S, cfg.n_codebooks) if cfg.n_codebooks > 1 else (B, S)
    return np.random.default_rng(seed).integers(
        0, cfg.vocab, size=shape).astype(np.int32)


def close(got, want, rtol: float = RTOL) -> float:
    """max |got - want| against ``rtol`` x max |want|; returns it."""
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape
    err = float(np.max(np.abs(got - want)))
    assert err <= rtol * float(np.max(np.abs(want))), err
    return err


def close_aux(got, want) -> None:
    assert abs(float(got) - float(want)) <= RTOL * max(1.0,
                                                       abs(float(want)))


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_forward_matches_reference(arch):
    cfg = get_config(arch).reduced()
    ref, params, port = pair(cfg)
    toks = tokens(cfg, 2, 16)
    prefix = None
    if cfg.frontend == "vision":
        prefix = np.random.default_rng(3).standard_normal(
            (2, 4, cfg.d_model)).astype(np.float32)
    want, _, want_aux = ref.apply(params, jnp.asarray(toks),
                                  prefix_emb=prefix)
    with torch.no_grad():
        got, _, aux = port.apply(toks, prefix_emb=prefix)
    close(got, want)
    close_aux(aux, want_aux)
    assert (float(aux) > 0) == (arch in MOE_ARCHS)


def prefill_decode(cfg, ref, params, port, self_check: bool = True):
    """Prefill 9 of 12 tokens into both packages' caches, then decode the
    last 3: logits and every cache leaf (K/V, Mamba and mLSTM states)
    against the reference's, and (``self_check``) the port's decode
    logits against its own full forward."""
    B, S = 2, 12
    toks = tokens(cfg, B, S)
    P = S - 3
    ref_decode = jax.jit(ref.decode_step)
    rc = ref.init_cache(B, S)
    _, rc, _ = ref.apply(params, jnp.asarray(toks[:, :P]), caches=rc)
    with torch.no_grad():
        full, _, _ = port.apply(toks)
        pc = port.init_cache(B, S)
        _, pc, _ = port.apply(toks[:, :P], caches=pc)
        for t in range(P, S):
            want, rc = ref_decode(params, rc, jnp.asarray(
                toks[:, t:t + 1]), t)
            got, pc = port.decode_step(pc, toks[:, t:t + 1], t)
            close(got, want)
            err = float((got - full[:, t:t + 1]).abs().max())
            assert not self_check or err < DECODE_VS_FULL, (t, err)
    for i, block in enumerate(rc["blocks"]):
        assert set(pc["blocks"][i]) == set(block)
        for k in block:
            close(pc["blocks"][i][k], block[k])


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_prefill_decode_matches_reference(arch):
    cfg = get_config(arch).reduced()
    prefill_decode(cfg, *pair(cfg))


@pytest.mark.parametrize("arch", ["minitron-4b", "jamba-v0.1-52b",
                                  "xlstm-1.3b"])
def test_decode_from_the_reference_cache(arch):
    """The reference's caches after its prefill (K/V, Mamba and mLSTM
    states), carried over with ``interop.lm_cache_from_jax``, are the
    port's start: one decode step from them gives the reference's logits
    and writes the reference's caches."""
    cfg = get_config(arch).reduced()
    ref, params, port = pair(cfg)
    toks = tokens(cfg, 2, 10)
    rc = ref.init_cache(2, 12)
    _, rc, _ = ref.apply(params, jnp.asarray(toks[:, :9]), caches=rc)
    pc = lm_cache_from_jax(_np(rc), device="cpu")
    want, rc = ref.decode_step(params, rc, jnp.asarray(toks[:, 9:]), 9)
    with torch.no_grad():
        got, pc = port.decode_step(pc, toks[:, 9:], 9)
    close(got, want)
    for i, block in enumerate(rc["blocks"]):
        for k in block:
            close(pc["blocks"][i][k], block[k])


@pytest.mark.parametrize("impl", ["ragged", "capacity", "a2a"])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_impl_matches_reference(arch, impl):
    """Every ``moe_impl`` besides the configs' own (dense): forward logits
    and aux loss, and prefill -> decode, against the reference's.  A
    capacity dispatch drops by the tokens it is given, so its decode is
    not held to the full forward."""
    cfg = replace(get_config(arch).reduced(), moe_impl=impl)
    ref, params, port = pair(cfg)
    toks = tokens(cfg, 2, 16)
    want, _, want_aux = ref.apply(params, jnp.asarray(toks))
    with torch.no_grad():
        got, _, aux = port.apply(toks)
    close(got, want)
    close_aux(aux, want_aux)
    prefill_decode(cfg, ref, params, port, self_check=impl == "ragged")


@pytest.mark.parametrize("arch,window", [("yi-34b", 0), ("gemma3-27b", 6)])
def test_chunked_attention_matches_reference_and_dense(arch, window):
    base = replace(get_config(arch).reduced(), sliding_window=window)
    chunked = replace(base, attn_chunk=4)
    ref, params, port = pair(chunked)
    dense = LM(replace(base, attn_chunk=0), device="cpu")
    dense.load_state_dict(port.state_dict())
    toks = tokens(base, 2, 16)
    want, _, _ = ref.apply(params, jnp.asarray(toks))
    with torch.no_grad():
        got, _, _ = port.apply(toks)
        got_dense, _, _ = dense.apply(toks)
    close(got, want)
    close(got, got_dense.numpy())


def test_grouped_decode_matches_reference_and_repeat():
    cfg = replace(get_config("yi-34b").reduced(), n_kv_heads=2)
    grouped = replace(cfg, gqa_grouped=True)
    ref, params, port = pair(grouped)
    plain = LM(cfg, device="cpu")
    plain.load_state_dict(port.state_dict())
    toks = tokens(cfg, 2, 12)
    rc = ref.init_cache(2, 12)
    _, rc, _ = ref.apply(params, jnp.asarray(toks[:, :8]), caches=rc)
    want, _ = ref.decode_step(params, rc, jnp.asarray(toks[:, 8:9]), 8)
    with torch.no_grad():
        outs = []
        for m in (port, plain):
            c = m.init_cache(2, 12)
            _, c, _ = m.apply(toks[:, :8], caches=c)
            outs.append(m.decode_step(c, toks[:, 8:9], 8)[0])
    close(outs[0], want)
    close(outs[0], outs[1].numpy())


def test_sliding_window_masks_differently():
    """Changing token 0 changes the last logits through the global layer;
    a model whose layers are all windowed (4 layers of window 32 reach 124
    positions back) does not see it at position 127."""
    cfg = get_config("gemma3-27b").reduced()
    ref, params, port = pair(cfg)
    toks = tokens(cfg, 1, 128, seed=2)
    toks2 = toks.copy()
    toks2[0, 0] = (toks[0, 0] + 1) % cfg.vocab
    local = LM(replace(cfg, local_global_period=0), device="cpu")
    local.load_state_dict(port.state_dict())
    with torch.no_grad():
        l1, l2 = port.apply(toks)[0], port.apply(toks2)[0]
        w1, w2 = local.apply(toks)[0], local.apply(toks2)[0]
    close(l1, ref.apply(params, jnp.asarray(toks))[0])
    close(l2, ref.apply(params, jnp.asarray(toks2))[0])
    assert float((l1[:, -1] - l2[:, -1]).abs().max()) > 0
    assert float((w1[:, -1] - w2[:, -1]).abs().max()) == 0.0
    assert float((w1[:, 0] - w2[:, 0]).abs().max()) > 0


def test_rope_matches_reference():
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 5, 3, 16)).astype(np.float32)
    pos = rng.integers(0, 1000, size=(2, 5)).astype(np.int32)
    want = ref_attention.rope(jnp.asarray(x), jnp.asarray(pos), 1e4)
    got = attention.rope(torch.from_numpy(x), torch.from_numpy(pos), 1e4)
    close(got, want)


@pytest.mark.parametrize("kind", ["swiglu", "geglu", "gelu", "relu2"])
def test_mlp_matches_reference(kind):
    rng = np.random.default_rng(5)
    x = rng.standard_normal((3, 7, 64)).astype(np.float32)
    p = {k: (rng.standard_normal(s) * 0.2).astype(np.float32)
         for k, s in (("w1", (64, 128)), ("w2", (128, 64)),
                      ("w3", (64, 128)))}
    want = ref_layers.mlp(jnp.asarray(x), p, kind)
    got = layers.mlp(torch.from_numpy(x),
                     {k: torch.from_numpy(v) for k, v in p.items()}, kind)
    close(got, want)


@pytest.mark.parametrize("kind", ["rmsnorm", "layernorm"])
def test_norm_matches_reference(kind):
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 6, 16)).astype(np.float32)
    s = (rng.standard_normal(16) * 0.1).astype(np.float32)
    b = (rng.standard_normal(16) * 0.1).astype(np.float32)
    bias = b if kind == "layernorm" else None
    want = ref_layers.norm(jnp.asarray(x), jnp.asarray(s), kind,
                           None if bias is None else jnp.asarray(bias))
    got = layers.norm(torch.from_numpy(x), torch.from_numpy(s), kind,
                      None if bias is None else torch.from_numpy(bias))
    close(got, want)


def test_fused_rmsnorm_matches_reference_values_and_gradient():
    """``norm(fusion="gen")`` plans one fused operator (a ROW CPlan)
    whose values and gradient equal the reference's staged norm at its
    test's 1e-5 / 1e-4."""
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, 6, 16)).astype(np.float32)
    s = (rng.standard_normal(16) * 0.1).astype(np.float32)
    xj, sj = jnp.asarray(x), jnp.asarray(s)
    want = ref_layers.norm(xj, sj, fusion="gen")
    gwant = jax.grad(lambda v: jnp.sum(ref_layers.norm(v, sj,
                                                       fusion="gen")))(xj)
    xt = torch.from_numpy(x).requires_grad_(True)
    got = layers.norm(xt, torch.from_numpy(s), fusion="gen")
    (g,) = torch.autograd.grad(got.sum(), xt)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(g.numpy(), np.asarray(gwant), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(
        got.detach().numpy(),
        layers.norm(torch.from_numpy(x), torch.from_numpy(s)).numpy(),
        rtol=1e-5, atol=1e-6)
    (compiled,) = [c for key, c in layers._rms._staged.items()
                   if ("X", "dense", (12, 16), 2) in key]
    assert compiled.planned.fused_signatures() == [
        {"template": "ROW", "root": "mul", "inputs": ["X", "eps_s", "lit",
                                                     "s"],
         "driver": None, "n_covered": 8}]


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_config_equals_reference(arch):
    cfg, ref = get_config(arch), ref_get_config(arch)
    assert type(cfg).__module__ == "repro_torch.configs.base"
    for f in fields(ref):
        assert getattr(cfg, f.name) == getattr(ref, f.name), f.name
    assert [f.name for f in fields(cfg)] == [f.name for f in fields(ref)]
    for c, r in ((cfg, ref), (cfg.reduced(), ref.reduced())):
        assert (c.active_params, c.total_params, c.hd) == \
            (r.active_params, r.total_params, r.hd)


def test_bf16_params_carry_across_exactly():
    cfg = replace(get_config("minitron-4b").reduced(), dtype="bfloat16")
    ref = RefLM(cfg)
    params = _np(ref.init(jax.random.PRNGKey(0)))
    assert params["embed"].dtype == ml_dtypes.bfloat16
    port = LM(cfg, device="cpu")
    port.load_state_dict(lm_params_from_jax(params))
    assert port.embed.dtype == torch.bfloat16
    np.testing.assert_array_equal(port.embed.float().detach().numpy(),
                                  params["embed"].astype(np.float32))
    wq = params["blocks"][0]["inner"]["wq"]
    np.testing.assert_array_equal(
        port.layers[1].inner.wq.float().detach().numpy(),
        wq[1].astype(np.float32))


def test_cache_write_past_the_end_raises():
    cfg = get_config("minitron-4b").reduced()
    port = LM(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    cache = port.init_cache(1, 8)
    with torch.no_grad():
        port.decode_step(cache, [[1]], 7)
        with pytest.raises(IndexError, match="past the cache"):
            port.decode_step(cache, [[1]], 8)
        with pytest.raises(IndexError, match="past the cache"):
            port.apply(tokens(cfg, 1, 9), caches=cache)


def test_init_draws_the_same_weights_in_any_dtype():
    cfg = get_config("starcoder2-7b").reduced()
    a = LM(cfg, device="cpu").init(torch.Generator().manual_seed(3))
    b = LM(replace(cfg, dtype="bfloat16"), device="cpu").init(
        torch.Generator().manual_seed(3))
    for (name, pa), (_n, pb) in zip(a.state_dict().items(),
                                    b.state_dict().items()):
        assert pb.dtype == torch.bfloat16
        assert torch.equal(pa.to(torch.bfloat16), pb), name
    assert a.layers[0].ln1.scale.eq(1).all()      # layernorm scale
    assert a.head.std().item() == pytest.approx(cfg.d_model ** -0.5,
                                                rel=0.05)
