"""The span recorder's counters and backward spans (``repro_torch.spans``):
with no recorder a counter keeps nothing and costs one global read;
readings kept in order beside nested spans; a backward span opened and
closed by gradient hooks, on autograd's thread, around the layer's
backward; the LM layers' spans and counters in a training step."""

import time
from dataclasses import replace

import torch

from repro_torch import spans
from repro_torch.configs import get_config
from repro_torch.launch.train import TrainConfig, make_train_step
from repro_torch.models import LM
from repro_torch.optim import adamw


def test_no_recorder_keeps_nothing_and_costs_a_read():
    assert spans.active() is None
    spans.count("attn.blocks", 5)                 # nothing to keep it
    x = torch.ones(3, requires_grad=True)
    y = x * 2
    spans.backward_span("moe", x, y)              # no hook registered
    assert y._backward_hooks is None and x._backward_hooks is None
    n = 100_000
    t0 = time.perf_counter()
    for _ in range(n):
        spans.count("attn.blocks", 1)
    per = (time.perf_counter() - t0) / n
    assert per < 5e-6, per


def test_readings_in_order_beside_nested_spans():
    with spans.recording() as rec:
        with spans.span("train.step"):
            spans.count("moe.held_slots", 7)
            with spans.span("moe"):
                spans.count("moe.held_slots", 9)
        spans.count("attn.blocks", 3)
    assert [(c.name, c.value) for c in rec.counts] == [
        ("moe.held_slots", 7), ("moe.held_slots", 9), ("attn.blocks", 3)]
    assert all(a.ns <= b.ns for a, b in zip(rec.counts, rec.counts[1:]))
    by = {s.name: s for s in rec.spans}
    assert by["moe"].parent == by["train.step"].id
    step = by["train.step"]
    assert step.start_ns <= rec.counts[0].ns <= step.end_ns


def test_backward_span_opens_and_closes_on_gradient_hooks():
    w = torch.randn(4, 4, requires_grad=True)
    with spans.recording() as rec:
        with spans.span("lm_train.run"):
            x = torch.randn(2, 4, requires_grad=True)
            h = x @ w
            y = torch.tanh(h) @ w
            spans.backward_span("moe", h, y)
            y.sum().backward()
    (back,) = [s for s in rec.spans if s.name == "moe"]
    run = next(s for s in rec.spans if s.name == "lm_train.run")
    assert run.start_ns <= back.start_ns <= back.end_ns <= run.end_ns
    # on autograd's thread with no span open there, the open .run span is
    # its parent
    assert back.parent == run.id


def test_a_training_step_records_the_lm_layers_spans_and_counters():
    cfg = replace(get_config("mellum2-12b-a2.5b").reduced(), n_experts=8,
                  top_k=4, experts_held=4, attn_chunk=8)
    m = LM(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    m.requires_grad_(False)
    params = dict(m.named_parameters())
    tc = TrainConfig(fusion="gen")
    step = make_train_step(m, cfg, tc)
    toks = torch.randint(0, cfg.vocab, (2, 33),
                         generator=torch.Generator().manual_seed(1))
    with spans.recording() as rec:
        step(params, adamw.init(params, tc.opt),
             {"tokens": toks[:, :-1], "targets": toks[:, 1:]})
    names = [s.name for s in rec.spans]
    # each of the 4 layers: its attention and expert layer forward and
    # backward
    assert names.count("attn.window") == 2 * 2
    assert names.count("attn.full") == 2 * 2
    assert names.count("moe") == 4 * 2
    assert names.count("train.step") == names.count("optim.adamw") == 1
    blocks = [c.value for c in rec.counts if c.name == "attn.blocks"]
    held = [c.value for c in rec.counts if c.name == "moe.held_slots"]
    assert len(blocks) == 4 and len(held) == 4
    # 64 tokens x 4 slots, half the experts held: some pairs, not all
    assert all(0 < n < 64 * 4 for n in held)
