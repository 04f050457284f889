"""The attention kernel (``kernels/csrc/attn.cuh``) on the card against its
plain version, the torch block loop ``models.attention._chunked_attention``
run on the same CUDA tensors: forward and every gradient, window and full,
at the mellum2 cell's head shapes (32 query heads over 4 KV heads of 128)
and at the other head sizes of the registry's configurations (gemma3's
168, musicgen's 64) and the largest (256); a ragged sequence, a mapped KV
head (``kv_of``) and bf16 input; the same bits twice; ``attn.blocks``
equal to the visiting rule's count; the kernel's refusals raised.  The
geometry's counts, the shapes every configuration gives the kernel and a
refusal on the CPU run here; the rest is marked ``gpu`` and skips without
a card.  Imports no JAX:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_attn_kernel.py
"""

import pytest
import torch

from repro_torch import spans
from repro_torch.configs import ARCH_IDS, PORT_IDS, get_config
from repro_torch.kernels import attention as kattn
from repro_torch.models.attention import _chunked_attention, _expand
from repro_torch.models.lm import build_pattern

H, KV, D = 32, 4, 128
#: relative to the largest magnitude: fp32 sums in another order and
#: block size than the block loop's (a few ulps of the output)
RTOL = 2e-5


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def draw(B, S, h=H, kv=KV, d=D, seed=0, device="cuda"):
    g = torch.Generator(device=device).manual_seed(seed)
    q = torch.randn((B, S, h, d), generator=g, device=device)
    k = torch.randn((B, S, kv, d), generator=g, device=device)
    v = torch.randn((B, S, kv, d), generator=g, device=device)
    do = torch.randn((B, S, h, d), generator=g, device=device)
    return q, k, v, do


def plain(q, k, v, window, kv_of=None):
    rep = q.shape[2] // k.shape[2]
    pos = torch.arange(q.shape[1], device=q.device).expand(q.shape[0], -1)
    return _chunked_attention(q, _expand(k, rep, kv_of),
                              _expand(v, rep, kv_of), pos, window)


def gap(a, b):
    return float((a.float() - b.float()).abs().max()
                 / b.float().abs().max())


def both(q, k, v, do, window, kv_of=None):
    """(out, dq, dk, dv) of the kernel and of the block loop."""
    outs = []
    for fn in (kattn.flash, plain):
        leaves = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]
        out = fn(*leaves, window, kv_of)
        out.backward(do)
        outs.append([out.detach()] + [t.grad for t in leaves])
    return outs


def test_tiles_visited_follow_the_causal_window():
    # full causal over 8,192 tokens: 128 query blocks see 1 .. 128 blocks
    assert kattn.tiles_visited(8192, 0) == 128 * 129 // 2
    # window 1,024: a block sees its own and the 16 before it (fewer first)
    assert kattn.tiles_visited(8192, 1024) == sum(
        min(i, 16) + 1 for i in range(128))
    assert kattn.tiles_visited(8192, 1024) * 4 < kattn.tiles_visited(8192, 0)
    # every visible pair lies in a visited tile, and every visited tile
    # holds one
    S, w, b = 300, 70, 64
    for q0 in range(0, S, b):
        seen = set(kattn.key_blocks(q0, S, w, b))
        need = {k // b for q in range(q0, min(q0 + b, S))
                for k in range(max(0, q - w + 1), q + 1)}
        assert seen == need


@pytest.mark.parametrize("arch", ARCH_IDS + PORT_IDS)
def test_every_configuration_s_attention_is_taken(arch):
    # the card runs a configuration's chunked attention on the kernel
    # alone (no fallback), so the kernel takes every head shape that a
    # configuration's attention layers give it
    cfg = get_config(arch)
    if not any(s.kind == "attn" for s in build_pattern(cfg)):
        pytest.skip(f"{arch} has no attention layer")
    q = (1, 8192, cfg.n_heads, cfg.hd)
    kv = (1, 8192, cfg.n_kv_heads, cfg.hd)
    assert kattn.shape_refusal(q, kv, kv) is None


def test_the_kernel_refuses_cpu_tensors():
    q, k, v, _do = draw(1, 8, 2, 1, 64, device="cpu")
    with pytest.raises(NotImplementedError, match="CUDA"):
        kattn.flash(q, k, v, 0)


@pytest.mark.gpu
@pytest.mark.parametrize("window", [0, 1024])
def test_forward_and_gradients_match_the_block_loop(card, window):
    q, k, v, do = draw(2, 2048)
    (o, dq, dk, dv), (ro, rdq, rdk, rdv) = both(q, k, v, do, window)
    for got, want in ((o, ro), (dq, rdq), (dk, rdk), (dv, rdv)):
        assert gap(got, want) < RTOL


@pytest.mark.gpu
@pytest.mark.parametrize("h,kv,d", [(32, 16, 168), (8, 8, 64), (4, 2, 256),
                                    (4, 2, 8)])
def test_other_head_sizes_match_the_block_loop(card, h, kv, d):
    # 168 and 256 keep K and V in one shared tile (head over 128); 168 and
    # 8 compute zero columns past the head
    q, k, v, do = draw(1, 1100, h, kv, d, seed=3)
    for window in (0, 300):
        (o, dq, dk, dv), (ro, rdq, rdk, rdv) = both(q, k, v, do, window)
        for got, want in ((o, ro), (dq, rdq), (dk, rdk), (dv, rdv)):
            assert gap(got, want) < RTOL


@pytest.mark.gpu
def test_ragged_sequence_mapped_heads_and_bf16(card):
    q, k, v, do = draw(1, 1000, 8, 2, 64, seed=1)
    kv_of = torch.tensor([1, 1, 0, 0, 1, 0, 1, 0], device=card)
    (o, dq, dk, dv), (ro, rdq, rdk, rdv) = both(q, k, v, do, 100, kv_of)
    for got, want in ((o, ro), (dq, rdq), (dk, rdk), (dv, rdv)):
        assert gap(got, want) < RTOL
    half = [t.bfloat16() for t in (q, k, v)]
    got = kattn.flash(*half, 100, kv_of)
    assert got.dtype == torch.bfloat16
    want = plain(*[t.float() for t in half], 100, kv_of)
    assert gap(got, want) < 1e-2          # the output rounded to bf16


@pytest.mark.gpu
def test_the_same_bits_twice(card):
    q, k, v, do = draw(1, 1024, seed=2)
    a, b = both(q, k, v, do, 256)[0], both(q, k, v, do, 256)[0]
    assert all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.gpu
def test_blocks_counted_as_visited(card):
    q, k, v, _do = draw(2, 4096)
    with spans.recording() as rec:
        kattn.flash(q, k, v, 1024)
        kattn.flash(q, k, v, 0)
    counts = [c.value for c in rec.counts if c.name == "attn.blocks"]
    assert counts == [2 * H * kattn.tiles_visited(4096, 1024),
                      2 * H * kattn.tiles_visited(4096, 0)]
    assert counts[0] < counts[1]


@pytest.mark.gpu
def test_refusals_raise_with_their_reason(card):
    for d in (90, 264):
        q, k, v, _do = draw(1, 64, 4, 2, d)
        with pytest.raises(NotImplementedError, match=f"head_dim {d}"):
            kattn.flash(q, k, v, 0)
    q, k, v, _do = draw(1, 64, 6, 4, 64)
    with pytest.raises(NotImplementedError, match="6 query heads"):
        kattn.flash(q, k, v, 0)
