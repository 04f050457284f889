"""The port's AdamW and gradient compression (``repro_torch.optim``)
against the reference's, on the CPU.

One AdamW step from the same state: the reference's parameters of a
``.reduced()`` minitron-4b, its AdamW state with random moments at step
5 (carried over with ``interop.adamw_state_from_jax``) and random
gradients go through both packages' ``update``.  The new parameters are
held within 1e-6 of the learning rate plus the fp32 rounding of the
largest parameter (the moments are random positive, so every step is
well-conditioned), the moments within 1e-6 of their largest; the update
is written into the given tensors.  The int8 and top-k
compressed steps: ``apply_tree`` of both packages on the same tree of
gradients and residuals (decoded gradients and residuals within 1e-6 of
the largest; int8's rounding to the same levels, top-k's threshold
keeping the same entries), then the update.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.models import LM as RefLM
from repro.optim import adamw as ref_adamw
from repro.optim import compression as ref_comp
from repro_torch.interop import adamw_state_from_jax, lm_params_from_jax
from repro_torch.optim import adamw, compression

OPT = dict(lr=1e-3, warmup_steps=10, decay_steps=100)


def np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _setup(seed: int = 0, state_dtype: str = "float32"):
    cfg = ref_get_config("minitron-4b").reduced()
    params = RefLM(cfg).init(jax.random.PRNGKey(seed))
    leaves, treedef = jax.tree_util.tree_flatten(params)
    rng = np.random.default_rng(seed + 1)
    draw = lambda scale: jax.tree_util.tree_unflatten(treedef, [
        jnp.asarray((rng.standard_normal(l.shape) * scale)
                    .astype(np.float32)) for l in leaves])
    grads = draw(0.05)
    dt = jnp.bfloat16 if state_dtype == "bfloat16" else jnp.float32
    state = {"m": jax.tree_util.tree_map(lambda a: a.astype(dt), draw(0.01)),
             "v": jax.tree_util.tree_map(
                 lambda a: (a * a + 1e-6).astype(dt), draw(0.01)),
             "count": jnp.asarray(5, jnp.int32)}
    return params, grads, state


def _max_abs(tree: dict) -> float:
    return max(float(v.float().abs().max()) for v in tree.values())


def step_tol(want_p: dict) -> float:
    """A parameter after one step: 1e-6 of the step (the learning rate)
    plus the fp32 rounding of the largest parameter."""
    return 1e-6 * OPT["lr"] + 2 ** -23 * _max_abs(want_p)


def _diff(a: dict, b: dict) -> float:
    assert set(a) == set(b)
    return max(float((a[k].float() - b[k].float()).abs().max()) for k in a)


@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16"])
def test_one_step_from_the_same_state_matches_reference(state_dtype):
    params, grads, state = _setup(state_dtype=state_dtype)
    opt_r = ref_adamw.OptConfig(state_dtype=state_dtype, **OPT)
    opt = adamw.OptConfig(state_dtype=state_dtype, **OPT)
    want_p, want_s, want_m = ref_adamw.update(grads, state, params, opt_r)
    want_p = lm_params_from_jax(np_tree(want_p))
    want_s = adamw_state_from_jax(np_tree(want_s))
    p = lm_params_from_jax(np_tree(params))
    g = lm_params_from_jax(np_tree(grads))
    s = adamw_state_from_jax(np_tree(state))
    assert int(s["count"]) == 5
    got_p, got_s, got_m = adamw.update(g, s, p, opt)
    assert int(got_s["count"]) == int(want_s["count"]) == 6
    # in place: the given tensors, updated
    assert got_s["count"] is s["count"]
    for k in p:
        assert got_p[k] is p[k]
        assert got_s["m"][k] is s["m"][k] and got_s["v"][k] is s["v"][k]
    for k in ("grad_norm", "lr"):
        assert abs(float(got_m[k]) - float(want_m[k])) <= \
            1e-6 * abs(float(want_m[k]))
    # a bf16 moment may round to the neighbouring value
    tol = 1e-6 if state_dtype == "float32" else 2 ** -7
    assert _diff(got_p, want_p) <= step_tol(want_p) * (
        1 if state_dtype == "float32" else 1e3)
    for name in ("m", "v"):
        assert _diff(got_s[name], want_s[name]) <= \
            tol * _max_abs(want_s[name])
        assert all(t.dtype == (torch.bfloat16 if state_dtype == "bfloat16"
                               else torch.float32)
                   for t in got_s[name].values())


def test_bf16_parameters_update_in_fp32_and_round_back():
    params, grads, state = _setup()
    to16 = lambda t: jax.tree_util.tree_map(
        lambda a: a.astype(jnp.bfloat16), t)
    opt_r, opt = ref_adamw.OptConfig(**OPT), adamw.OptConfig(**OPT)
    want_p, _s, _m = ref_adamw.update(to16(grads), state, to16(params),
                                      opt_r)
    want_p = lm_params_from_jax(np_tree(want_p))
    got_p, _s, _m = adamw.update(lm_params_from_jax(np_tree(to16(grads))),
                                 adamw_state_from_jax(np_tree(state)),
                                 lm_params_from_jax(np_tree(to16(params))),
                                 opt)
    mismatched = sum(int((got_p[k] != want_p[k]).sum()) for k in want_p)
    total = sum(v.numel() for v in want_p.values())
    assert all(v.dtype == torch.bfloat16 for v in got_p.values())
    # the fp32 results round to the same bf16 but at a rounding boundary
    assert mismatched <= 1e-4 * total
    assert _diff(got_p, want_p) <= 2 ** -8 * _max_abs(want_p)


@pytest.mark.parametrize("step", [0, 1, 5, 10, 11, 55, 100, 1000])
def test_schedule_matches_reference(step):
    want = float(ref_adamw.schedule(step, ref_adamw.OptConfig(**OPT)))
    got = float(adamw.schedule(step, adamw.OptConfig(**OPT)))
    assert abs(got - want) <= 1e-7 * max(abs(want), 1e-12)


def test_init_matches_reference_structure():
    p = {"w": torch.ones((3, 2)), "b": {"x": torch.zeros((4,),
                                                         dtype=torch.bfloat16)}}
    for dt, want in (("float32", torch.float32),
                     ("bfloat16", torch.bfloat16)):
        s = adamw.init(p, adamw.OptConfig(state_dtype=dt))
        assert s["m"]["w"].dtype == s["v"]["b"]["x"].dtype == want
        assert s["m"]["b"]["x"].shape == (4,) and int(s["count"]) == 0
        assert s["count"].dtype == torch.int32


def test_adamw_decreases_quadratic():
    params = {"w": torch.ones((4,)) * 5.0}
    cfg = adamw.OptConfig(lr=0.5, warmup_steps=0, decay_steps=100,
                          weight_decay=0.0)
    state = adamw.init(params, cfg)
    for _ in range(50):
        grads = {"w": 2 * params["w"]}
        params, state, _m = adamw.update(grads, state, params, cfg)
    assert float(params["w"].abs().max()) < 1.0


@pytest.mark.parametrize("kind", ["int8", "topk"])
def test_compressed_step_matches_reference(kind):
    """Compression works leaf by leaf (int8's scale, top-k's k), so both
    packages get the same tree: a (64, 32) matrix and a nested vector."""
    rng = np.random.default_rng(7)
    arr = lambda *shape, scale=1.0: (rng.standard_normal(shape) * scale
                                     ).astype(np.float32)
    tree = lambda f: {"w": f(arr(64, 32, scale=0.5)),
                      "b": {"x": f(arr(100, scale=0.5))}}
    params_np, grads_np, res_np = (tree(lambda a: a) for _ in range(3))
    m_np, v_np = tree(lambda a: a * 0.01), tree(lambda a: a * a + 1e-4)
    J = lambda t: jax.tree_util.tree_map(jnp.asarray, t)
    # copies: the port's update writes into the tensors it is given
    T = lambda t: jax.tree_util.tree_map(
        lambda a: torch.from_numpy(a.copy()), t)
    cfg_r = ref_comp.CompressionConfig(kind=kind, topk_frac=0.05)
    cfg = compression.CompressionConfig(kind=kind, topk_frac=0.05)
    dec_r, res_r = ref_comp.apply_tree(J(grads_np), J(res_np), cfg_r)
    dec, new_res = compression.apply_tree(T(grads_np), T(res_np), cfg)
    flat = lambda t: {"/".join(map(str, p)): torch.as_tensor(np.array(v))
                      for p, v in _paths(t)}
    dec_w, res_w = flat(dec_r), flat(res_r)
    got_d, got_r = flat(dec), flat(new_res)
    assert _diff(got_d, dec_w) <= 1e-6 * _max_abs(dec_w)
    assert _diff(got_r, res_w) <= 1e-6 * _max_abs(res_w)
    for k in dec_w:                 # the same entries kept or levels taken
        assert torch.equal(got_d[k] == 0, dec_w[k] == 0), k
    state_r = {"m": J(m_np), "v": J(v_np), "count": jnp.asarray(5, jnp.int32)}
    state = {"m": T(m_np), "v": T(v_np), "count": torch.tensor(5)}
    want_p, _s, _m = ref_adamw.update(dec_r, state_r, J(params_np),
                                      ref_adamw.OptConfig(**OPT))
    want_p = flat(want_p)
    got_p, _s, _m = adamw.update(dec, state, T(params_np),
                                 adamw.OptConfig(**OPT))
    assert _diff(flat(got_p), want_p) <= step_tol(want_p)


def _paths(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _paths(tree[k], path + (k,))
    else:
        yield path, tree


def test_compression_error_feedback_unbiased():
    g_true = torch.from_numpy(
        np.random.default_rng(0).normal(size=(64,)).astype(np.float32))
    cfg = compression.CompressionConfig(kind="int8")
    res = torch.zeros_like(g_true)
    acc = torch.zeros_like(g_true)
    for _ in range(50):
        dec, res = compression.compress_decompress(g_true, res, cfg)
        acc = acc + dec
    np.testing.assert_allclose((acc / 50).numpy(), g_true.numpy(), atol=0.02)


def test_topk_keeps_ties_and_feeds_back_the_rest():
    g = torch.tensor([3.0, -3.0, 1.0, 0.5, -3.0, 0.1, 2.0, 0.0])
    cfg = compression.CompressionConfig(kind="topk", topk_frac=0.25)
    dec, res = compression.compress_decompress(g, torch.zeros_like(g), cfg)
    # k = 2, threshold 3.0: all three entries of magnitude 3 pass (>=)
    assert dec.tolist() == [3.0, -3.0, 0.0, 0.0, -3.0, 0.0, 0.0, 0.0]
    assert torch.equal(dec + res, g)
    want, _r = ref_comp.compress_decompress(
        jnp.asarray(g.numpy()), jnp.zeros((8,), jnp.float32),
        ref_comp.CompressionConfig(kind="topk", topk_frac=0.25))
    assert np.asarray(want).tolist() == dec.tolist()


def test_no_compression_passes_gradients_through():
    g = {"w": torch.ones((3,))}
    r = compression.init_residuals(g)
    cfg = compression.CompressionConfig()
    assert compression.apply_tree(g, r, cfg) == (g, r)
    dec, res = compression.compress_decompress(g["w"], r["w"], cfg)
    assert dec is g["w"] and not bool(res.any())
