"""The port's continuous-batching ``Engine`` against the reference's.

Counterparts of ``tests/test_serve_engine.py``: the reference's model and
``Engine`` (JAX) and the port's (``repro_torch.serve.Engine`` over an
``LM`` on the CPU carrying the same weights through
``interop.lm_params_from_jax``) serve the same numpy prompts; greedy
tokens must be equal.  Admission, the bounded queue and deadlines raise
the reference's error types with its messages.  Two faults of the
reference are pinned, and the port serves both cases: its slot-axis
fault (a rest layer's cache sliced on the group axis when
``batch_slots`` equals the number of groups), and its recurrent-state
leak (a request in a reused slot starts from the previous request's
Mamba / mLSTM state).
"""

import time
from dataclasses import replace

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.models import LM as RefLM
from repro.serve import DeadlineExceededError as RefDeadlineExceededError
from repro.serve import Engine as RefEngine
from repro.serve import Request as RefRequest
from repro_torch.configs import get_config
from repro_torch.interop import lm_params_from_jax
from repro_torch.models import LM
from repro_torch.serve import (AdmissionError, DeadlineExceededError,
                               Engine, QueueFullError, Request)
from repro_torch.serve.engine import RECURRENT_LEAVES


def pair(cfg, seed: int = 0):
    """(the reference's params, the port's LM with the same weights)."""
    params = RefLM(cfg).init(jax.random.PRNGKey(seed))
    port = LM(cfg, device="cpu")
    port.load_state_dict(lm_params_from_jax(
        jax.tree_util.tree_map(np.asarray, params)))
    return params, port


@pytest.fixture(scope="module")
def starcoder():
    cfg = get_config("starcoder2-7b").reduced()
    return cfg, *pair(cfg)


def prompts(cfg, lengths, seed: int):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab, size=p).astype(np.int32)
            for p in lengths]


def serve(engine, request_cls, ps, max_new: int, **kw) -> list:
    reqs = [request_cls(prompt=p, max_new=max_new, **kw) for p in ps]
    for r in reqs:
        engine.submit(r)
    engine.run_until_done()
    assert all(r.done and r.error is None for r in reqs)
    return [r.out for r in reqs]


@pytest.mark.parametrize("arch", ["starcoder2-7b", "minitron-4b",
                                  "olmoe-1b-7b", "jamba-v0.1-52b",
                                  "xlstm-1.3b"])
def test_tokens_equal_the_reference_engine(arch):
    """Three requests through the port's two slots (the third takes a
    slot whose recurrent state the port zeroes) against the reference's
    engine, each request on a fresh slot there (three slots where the
    model has recurrent layers, whose state the reference's engine
    carries over to the next request in a slot: see the next test)."""
    cfg = get_config(arch).reduced()
    params, port = pair(cfg)
    ps = prompts(cfg, (7, 12, 3), seed=0)
    recurrent = any(s.kind != "attn" for s in port.specs)
    want = serve(RefEngine(ref_get_config(arch).reduced(), params,
                           batch_slots=3 if recurrent else 2, max_len=32),
                 RefRequest, ps, 6)
    got = serve(Engine(port, batch_slots=2, max_len=32), Request, ps, 6)
    assert got == want


def recurrent_leaves(cache) -> dict:
    """The recurrent-state leaves of an engine's cache, as numpy."""
    return {f"{part}{i}.{k}": np.asarray(v)
            for part in ("blocks", "rest")
            for i, layer in enumerate(cache[part])
            for k, v in layer.items() if k in RECURRENT_LEAVES}


@pytest.mark.parametrize("arch", ["xlstm-1.3b", "jamba-v0.1-52b"])
def test_reused_slot_serves_fresh_tokens_where_the_reference_leaks(arch):
    """One slot serves prompt A, then prompt B.  The reference's admission
    hands B's prefill the slot's old cache and its Mamba / mLSTM layers
    start from that state: its final recurrent state differs from B served
    on a fresh engine (jamba's by about 6e-4 after ten steps, xlstm's by
    more), and so do its xlstm tokens (jamba's logits move by about 1e-3,
    short of changing a token).  The port zeroes the slot's
    recurrent state at admission: its B tokens equal its fresh run and the
    reference's fresh run, and its final state equals its fresh run's bit
    for bit."""
    cfg = get_config(arch).reduced()
    ref_cfg = ref_get_config(arch).reduced()
    params, port = pair(cfg)
    a = np.arange(9, 14, dtype=np.int32)
    b = np.arange(5, 9, dtype=np.int32)
    runs = {}
    for name, prompts_ in (("fresh", [b]), ("reused", [a, b])):
        ref = RefEngine(ref_cfg, params, batch_slots=1, max_len=32)
        eng = Engine(port, batch_slots=1, max_len=32)
        runs[name] = (serve(ref, RefRequest, prompts_, 6)[-1],
                      recurrent_leaves(ref.cache),
                      serve(eng, Request, prompts_, 6)[-1],
                      recurrent_leaves(eng.cache))
    ref_fresh, ref_fresh_st, fresh, fresh_st = runs["fresh"]
    ref_reused, ref_reused_st, reused, reused_st = runs["reused"]
    leak = max(float(np.max(np.abs(ref_reused_st[k] - ref_fresh_st[k])))
               for k in ref_fresh_st)
    assert leak > 1e-4
    if arch == "xlstm-1.3b":
        assert ref_reused != ref_fresh
    assert reused == fresh == ref_fresh
    for k, v in fresh_st.items():
        np.testing.assert_array_equal(reused_st[k], v)
        err = float(np.max(np.abs(v - ref_fresh_st[k])))
        assert err <= 1e-5 * max(1.0, float(np.max(np.abs(v)))), (k, err)


def test_engine_matches_direct_decode(starcoder):
    cfg, _params, model = starcoder
    (prompt,) = prompts(cfg, (7,), seed=0)
    engine = Engine(model, batch_slots=2, max_len=32)
    req = Request(prompt=prompt, max_new=5)
    engine.submit(req)
    engine.run_until_done()

    # direct greedy decode, feeding the prompt's last token first as the
    # engine does
    with torch.no_grad():
        cache = model.init_cache(1, 32)
        model.apply(prompt[None], caches=cache)
        out, pos, cur = [], len(prompt), int(prompt[-1])
        for _ in range(5):
            logits, cache = model.decode_step(cache, [[cur]], pos)
            cur = int(torch.argmax(logits[0, -1]))
            out.append(cur)
            pos += 1
    assert req.out == out


def test_slot_reuse_matches_the_reference(starcoder):
    cfg, params, model = starcoder
    ps = prompts(cfg, (5, 9, 3, 7, 11), seed=1)
    want = serve(RefEngine(ref_get_config("starcoder2-7b").reduced(),
                           params, batch_slots=2, max_len=48), RefRequest,
                 ps, 4)
    engine = Engine(model, batch_slots=2, max_len=48)
    got = serve(engine, Request, ps, 4)
    assert all(len(o) == 4 for o in got) and got == want
    assert all(s is None for s in engine.slots)


def test_admission_rejects_impossible_requests(starcoder):
    cfg, _params, model = starcoder
    engine = Engine(model, batch_slots=2, max_len=16)
    p4, p0, p16, p15, p5 = prompts(cfg, (4, 0, 16, 15, 5), seed=2)
    with pytest.raises(AdmissionError, match="max_new must be >= 1, got 0"):
        engine.submit(Request(prompt=p4, max_new=0))
    with pytest.raises(AdmissionError, match="empty prompt"):
        engine.submit(Request(prompt=p0, max_new=4))
    with pytest.raises(AdmissionError,
                       match="prompt length 16 exceeds the cache budget: "
                             "max_len=16 leaves room for at most 15"):
        engine.submit(Request(prompt=p16, max_new=4))
    assert engine._queue.empty()          # nothing impossible enqueued
    ok = [Request(prompt=p15, max_new=1), Request(prompt=p5, max_new=3)]
    for r in ok:
        engine.submit(r)
    engine.run_until_done()
    assert ok[0].done and len(ok[0].out) == 1
    assert ok[1].done and len(ok[1].out) == 3


def test_bounded_queue_rejects_with_typed_error(starcoder):
    cfg, _params, model = starcoder
    engine = Engine(model, batch_slots=1, max_len=32, max_queue=2)
    ps = prompts(cfg, (4, 4, 4), seed=3)
    admitted = [Request(prompt=p, max_new=2) for p in ps[:2]]
    for r in admitted:
        engine.submit(r)
    with pytest.raises(QueueFullError, match="admission queue is full "
                                             r"\(2 requests\)"):
        engine.submit(Request(prompt=ps[2], max_new=2))
    engine.run_until_done()               # admitted requests still finish
    assert all(r.done and len(r.out) == 2 for r in admitted)


def test_deadline_expires_queued_request(starcoder):
    cfg, _params, model = starcoder
    engine = Engine(model, batch_slots=1, max_len=32)
    p_late, p_ok = prompts(cfg, (4, 4), seed=4)
    late = Request(prompt=p_late, max_new=2, deadline_s=0.0)
    ok = Request(prompt=p_ok, max_new=2)
    engine.submit(late)
    engine.submit(ok)
    time.sleep(0.01)                      # let the deadline lapse
    engine.run_until_done()
    assert late.done and isinstance(late.error, DeadlineExceededError)
    assert late.out == []
    assert ok.done and ok.error is None and len(ok.out) == 2


def test_deadline_evicts_a_decoding_request_as_the_reference(starcoder):
    """A deadline that passes between steps evicts the request at the
    next step with the tokens it has; its slot serves the next one."""
    cfg, params, model = starcoder
    p1, p2 = prompts(cfg, (5, 6), seed=5)
    outs = []
    for engine, req_cls, err_cls in (
            (RefEngine(ref_get_config("starcoder2-7b").reduced(), params,
                       batch_slots=1, max_len=32), RefRequest,
             RefDeadlineExceededError),
            (Engine(model, batch_slots=1, max_len=32), Request,
             DeadlineExceededError)):
        first, second = req_cls(prompt=p1, max_new=8), \
            req_cls(prompt=p2, max_new=2)
        engine.submit(first)
        engine.submit(second)
        engine.step()
        first._deadline_at = time.perf_counter() - 1.0
        engine.run_until_done()
        assert first.done and isinstance(first.error, err_cls)
        assert str(first.error) == "deadline passed after 1 of 8 tokens"
        assert second.done and second.error is None
        outs.append((first.out, second.out))
    assert outs[0] == outs[1] and len(outs[1][0]) == 1


def test_temperature_sampling_is_seeded_and_in_range(starcoder):
    cfg, _params, model = starcoder
    ps = prompts(cfg, (6, 9), seed=6)

    def sample(seed):
        return serve(Engine(model, batch_slots=2, max_len=40, seed=seed),
                     Request, ps, 12, temperature=1.5)

    a, b, c = sample(0), sample(0), sample(1)
    assert a == b
    assert a != c
    assert all(0 <= t < cfg.vocab for out in a + c for t in out)
    greedy = serve(Engine(model, batch_slots=2, max_len=40), Request, ps, 12)
    assert a != greedy


def test_reference_slot_axis_fault_is_pinned_and_the_port_serves():
    """gemma3 reduced with 5 layers: pattern 2, so 2 groups and 1 rest
    layer.  With batch_slots == 2 == n_groups the reference slices the
    rest layer's (B, max_len, KV, hd) cache on axis 1 and fails; at 3
    slots it serves.  The port slices on the cache's known axes and gives
    the reference's 3-slot tokens at 2 slots."""
    cfg = replace(get_config("gemma3-27b").reduced(), n_layers=5)
    ref_cfg = replace(ref_get_config("gemma3-27b").reduced(), n_layers=5)
    params, port = pair(cfg)
    assert (port.n_groups, len(port.rest_specs)) == (2, 1)
    (prompt,) = prompts(cfg, (7,), seed=7)
    with pytest.raises(TypeError, match="dynamic_update_slice update shape "
                                        "must be smaller than operand "
                                        "shape"):
        serve(RefEngine(ref_cfg, params, batch_slots=2, max_len=16),
              RefRequest, [prompt], 4)
    want = serve(RefEngine(ref_cfg, params, batch_slots=3, max_len=16),
                 RefRequest, [prompt], 4)
    got = serve(Engine(port, batch_slots=2, max_len=16), Request, [prompt],
                4)
    assert got == want and len(got[0]) == 4


@pytest.mark.parametrize("kw,err", [({"mesh": object()}, TypeError),
                                    ({"layout": "auto"}, ValueError),
                                    ({"layout": "best"}, ValueError)])
def test_sharded_serving_is_not_ported_yet(starcoder, kw, err):
    """Sharded serving is ported (tests/test_torch_sharded_engine.py);
    what is not a mesh, a layout without one and an unknown layout are
    refused before anything is placed."""
    _cfg, _params, model = starcoder
    with pytest.raises(err, match="mesh|layout"):
        Engine(model, **kw)


def test_engine_runs_on_the_models_device_only(starcoder):
    """The engine's cache and sampler live on the model's device; asking
    for the card without one raises (no fallback to the CPU)."""
    cfg, _params, model = starcoder
    engine = Engine(model, batch_slots=1, max_len=8)
    assert engine.cache["blocks"][0]["k"].device.type == "cpu"
    assert engine.cache["blocks"][0]["k"].shape == (
        model.n_groups, 1, 8, cfg.n_kv_heads, cfg.hd)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="is_available"):
            LM(cfg)
