"""The port's training substrate against the reference's, on the CPU: the
token loader (``repro_torch.data``), the checkpoint store
(``repro_torch.checkpoint``) and the fault-tolerant loop
(``repro_torch.train``).

Loader batches equal the reference's bit for bit.  Checkpoints go both
ways: what one package writes, the other restores, fp32 and bf16.  The
reference writes a bf16 leaf as raw 2-byte ``|V2`` records and then
cannot restore it (``astype`` of ``|V2`` to bfloat16 raises); that fault
is pinned here, and the port restores the same bytes to the same bits.
The loop's straggler and skip policies are driven as the reference's own
tests drive its loop.
"""

import json
import time

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.checkpoint import CheckpointStore as RefStore
from repro.data import DataConfig as RefDataConfig
from repro.data import ShardedLoader as RefLoader
from repro_torch.checkpoint import CheckpointStore
from repro_torch.data import DataConfig, ShardedLoader, TokenSource
from repro_torch.train import LoopConfig, resume, run_loop


# ---------------------------------------------------------------------------
# loader
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw", [
    dict(seq_len=16, global_batch=4, vocab=256, seed=3),
    dict(seq_len=8, global_batch=2, vocab=2048, n_codebooks=4, seed=1),
])
@pytest.mark.parametrize("hosts", [1, 2])
def test_loader_batches_equal_reference_bit_for_bit(kw, hosts):
    for host in range(hosts):
        ref = RefLoader(RefDataConfig(**kw), host, hosts, start_step=2)
        port = ShardedLoader(DataConfig(**kw), host, hosts, start_step=2)
        try:
            for _ in range(3):
                a, b = next(ref), next(port)
                assert a["step"] == b["step"]
                for k in ("tokens", "targets"):
                    assert a[k].dtype == b[k].dtype == np.int32
                    assert np.array_equal(a[k], b[k])
        finally:
            ref.close()
            port.close()


def test_token_file_windows_equal_reference(tmp_path):
    path = tmp_path / "tokens.bin"
    np.arange(1000, dtype=np.int32).tofile(path)
    from repro.data import TokenSource as RefSource
    kw = dict(seq_len=15, global_batch=2, token_file=str(path))
    a, b = RefSource(RefDataConfig(**kw)), TokenSource(DataConfig(**kw))
    for step, index in ((0, 0), (3, 1), (7, 5)):
        assert np.array_equal(a.example(step, index), b.example(step, index))


def test_loader_close_stops_the_prefetch_thread():
    loader = ShardedLoader(DataConfig(seq_len=4, global_batch=2, vocab=10))
    next(loader)
    loader.close()
    assert not loader._thread.is_alive()


# ---------------------------------------------------------------------------
# checkpoints, both ways
# ---------------------------------------------------------------------------

def _tree(seed: int = 0) -> dict:
    rng = np.random.default_rng(seed)
    return {"w": rng.standard_normal((8, 4)).astype(np.float32),
            "b": {"x": np.arange(5.0, dtype=np.float32),
                  "n": np.asarray(7, np.int32)}}


def _torch(tree, dtype=None):
    return jax.tree_util.tree_map(
        lambda a: torch.from_numpy(np.array(a)).to(
            dtype if dtype is not None and a.dtype == np.float32
            else torch.from_numpy(np.array(a)).dtype), tree)


def _jax(tree, dtype=None):
    return jax.tree_util.tree_map(
        lambda a: jnp.asarray(a, dtype if dtype is not None
                              and a.dtype == np.float32 else None), tree)


def test_port_restores_what_the_reference_wrote_fp32(tmp_path):
    t = _tree()
    RefStore(tmp_path).save(10, _jax(t), extra={"step": 10}, blocking=True)
    store = CheckpointStore(tmp_path)
    assert store.latest_step() == 10
    got, extra = store.restore(_torch(jax.tree_util.tree_map(
        np.zeros_like, t)))
    assert extra == {"step": 10}
    for p, leaf in zip(jax.tree_util.tree_leaves(t),
                       jax.tree_util.tree_leaves(got)):
        assert np.array_equal(p, leaf.numpy())


def test_reference_restores_what_the_port_wrote_fp32(tmp_path):
    t = _tree(1)
    CheckpointStore(tmp_path).save(3, _torch(t), extra={"step": 3},
                                   blocking=True)
    got, extra = RefStore(tmp_path).restore(_jax(jax.tree_util.tree_map(
        np.zeros_like, t)))
    assert extra == {"step": 3}
    for p, leaf in zip(jax.tree_util.tree_leaves(t),
                       jax.tree_util.tree_leaves(got)):
        assert np.array_equal(p, np.asarray(leaf))


def test_both_write_the_same_npz_keys_and_bytes(tmp_path):
    t = _tree(2)
    RefStore(tmp_path / "ref").save(1, _jax(t, jnp.bfloat16), blocking=True)
    CheckpointStore(tmp_path / "port").save(1, _torch(t, torch.bfloat16),
                                            blocking=True)
    a = np.load(tmp_path / "ref" / "step_1" / "arrays.npz")
    b = np.load(tmp_path / "port" / "step_1" / "arrays.npz")
    assert sorted(a.files) == sorted(b.files) == ["b/n", "b/x", "w"]
    for k in a.files:
        assert a[k].dtype == b[k].dtype and a[k].tobytes() == b[k].tobytes()
    assert a["w"].dtype == np.dtype("V2")
    meta = [json.loads((tmp_path / d / "step_1" / "manifest.json")
                       .read_text()) for d in ("ref", "port")]
    assert meta[0]["keys"] == meta[1]["keys"]


def test_bf16_reference_restore_fault_is_pinned_and_port_restores(tmp_path):
    """The reference cannot read back its own bf16 checkpoint
    (ROADMAP.md queue C); the port reads those bytes as the same bits."""
    t = _tree(3)
    want = _jax(t, jnp.bfloat16)
    RefStore(tmp_path).save(4, want, blocking=True)
    like = jax.tree_util.tree_map(jnp.zeros_like, want)
    with pytest.raises(ValueError, match="cast"):
        RefStore(tmp_path).restore(like)
    got, _extra = CheckpointStore(tmp_path).restore(
        _torch(jax.tree_util.tree_map(np.zeros_like, t), torch.bfloat16))
    assert got["w"].dtype == torch.bfloat16
    bits = lambda a: np.asarray(a).view(np.uint16)
    assert np.array_equal(bits(want["w"]),
                          got["w"].view(torch.int16).numpy().view(np.uint16))
    assert np.array_equal(np.asarray(want["b"]["x"]).astype(np.float32),
                          got["b"]["x"].float().numpy())
    assert int(got["b"]["n"]) == 7


def test_bf16_port_round_trip_keeps_the_bits(tmp_path):
    t = _torch(_tree(4), torch.bfloat16)
    store = CheckpointStore(tmp_path)
    store.save(2, t, blocking=True)
    got, _e = store.restore(jax.tree_util.tree_map(torch.zeros_like, t))
    assert torch.equal(got["w"].view(torch.int16), t["w"].view(torch.int16))
    # the reference reads the port's bf16 records with the same fault
    with pytest.raises(ValueError, match="cast"):
        RefStore(tmp_path).restore(_jax(_tree(4), jnp.bfloat16))
    raw = np.load(tmp_path / "step_2" / "arrays.npz")["w"]
    assert np.array_equal(raw.view(ml_dtypes.bfloat16).astype(np.float32),
                          t["w"].float().numpy())


def test_async_save_copies_before_it_returns(tmp_path):
    """The step after a save updates its tensors in place; the save holds
    the values it was given."""
    store = CheckpointStore(tmp_path)
    t = {"w": torch.ones((256, 256))}
    store.save(1, t)
    t["w"].add_(1.0)
    store.wait()
    got, _e = store.restore({"w": torch.zeros((256, 256))})
    assert bool((got["w"] == 1.0).all())


def test_checkpoint_async_gc_and_atomic(tmp_path):
    store = CheckpointStore(tmp_path, keep=2)
    for s in (1, 2, 3, 4):
        store.save(s, _torch(_tree(s)))
    store.wait()
    assert store.steps() == [3, 4]
    (tmp_path / ".tmp_step_6").mkdir()          # a crashed save
    assert store.latest_step() == 4


def test_a_failed_save_raises_on_the_next_call(tmp_path):
    store = CheckpointStore(tmp_path)
    (tmp_path / "step_5").write_text("a file where the step goes")
    store.save(5, {"w": torch.ones((2,))})
    with pytest.raises(OSError):
        store.wait()
    store.wait()                                 # raised once


# ---------------------------------------------------------------------------
# loop: restart + straggler + non-finite skip (the reference's own tests)
# ---------------------------------------------------------------------------

def _toy_step():
    def train_step(params, opt_state, batch):
        x = torch.as_tensor(batch["tokens"]).float()
        grad = torch.mean(x) * torch.ones_like(params["w"])
        params = {"w": params["w"] - 0.1 * grad}
        return params, opt_state, {"loss": torch.mean(params["w"] ** 2)}
    return train_step


def test_loop_checkpoint_restart(tmp_path):
    cfg = DataConfig(seq_len=4, global_batch=2, vocab=10, seed=1)
    store = CheckpointStore(tmp_path)
    loader = ShardedLoader(cfg, 0, 1)
    p1, _, st = run_loop(_toy_step(), {"w": torch.ones((3,))}, {}, loader,
                         LoopConfig(total_steps=6, checkpoint_every=3),
                         store=store)
    loader.close()
    assert store.latest_step() == 6 and len(st.step_times) == 6
    tree, extra = store.restore({"params": {"w": torch.zeros((3,))},
                                 "opt": {}}, step=3)
    loader2 = ShardedLoader(cfg, 0, 1, start_step=extra["step"])
    p2, _, _ = run_loop(_toy_step(), tree["params"], {}, loader2,
                        LoopConfig(total_steps=6, checkpoint_every=100),
                        start_step=extra["step"])
    loader2.close()
    assert torch.equal(p1["w"], p2["w"])
    params, opt, start = resume(store, {"w": torch.zeros((3,))}, {})
    assert start == 6 and torch.equal(params["w"], p1["w"])


def test_loop_matches_reference_loop_trace(tmp_path):
    """The same toy step in both packages: the same losses a step."""
    from repro.train import run_loop as ref_run_loop

    def ref_step(params, opt_state, batch):
        x = batch["tokens"].astype(jnp.float32)
        params = {"w": params["w"] - 0.1 * jnp.mean(x)
                  * jnp.ones_like(params["w"])}
        return params, opt_state, {"loss": jnp.mean(params["w"] ** 2)}

    cfg = dict(seq_len=4, global_batch=2, vocab=10, seed=5)
    lr, lp = RefLoader(RefDataConfig(**cfg)), ShardedLoader(DataConfig(**cfg))
    _p, _o, want = ref_run_loop(ref_step, {"w": jnp.ones((3,))}, {}, lr,
                                LoopConfig(total_steps=5))
    _p, _o, got = run_loop(_toy_step(), {"w": torch.ones((3,))}, {}, lp,
                           LoopConfig(total_steps=5))
    lr.close()
    lp.close()
    np.testing.assert_allclose(got.losses, want.losses, rtol=1e-6)


def test_loop_straggler_detection():
    loader = ShardedLoader(DataConfig(seq_len=4, global_batch=2, vocab=10))
    calls = {"n": 0}

    def slow_step(params, opt_state, batch):
        calls["n"] += 1
        time.sleep(0.25 if calls["n"] == 5 else 0.01)   # injected straggler
        return params, opt_state, {"loss": torch.tensor(0.0)}

    _, _, st = run_loop(slow_step, {}, {}, loader,
                        LoopConfig(total_steps=8, checkpoint_every=100,
                                   straggler_factor=3.0))
    loader.close()
    assert [s for s, _dt, _e in st.straggler_events] == [4]


@pytest.mark.parametrize("skip", [True, False])
def test_loop_skips_nonfinite(skip):
    loader = ShardedLoader(DataConfig(seq_len=4, global_batch=2, vocab=10))
    calls = {"n": 0}

    def nan_step(params, opt_state, batch):
        calls["n"] += 1
        loss = torch.tensor(float("nan") if calls["n"] == 2 else 1.0)
        return {"w": params["w"] + 1}, opt_state, {"loss": loss}

    p, _, st = run_loop(nan_step, {"w": torch.zeros(())}, {}, loader,
                        LoopConfig(total_steps=4, checkpoint_every=100,
                                   skip_nonfinite=skip))
    loader.close()
    assert st.skipped_steps == ([1] if skip else [])
    assert float(p["w"]) == (3.0 if skip else 4.0)   # one update dropped


def test_loop_logs_every_n_steps():
    loader = ShardedLoader(DataConfig(seq_len=4, global_batch=2, vocab=10))
    seen = []
    run_loop(lambda p, o, b: (p, o, {"loss": torch.tensor(2.0)}), {}, {},
             loader, LoopConfig(total_steps=7, log_every=3),
             on_metrics=lambda step, loss, dt, m: seen.append((step, loss)))
    loader.close()
    assert seen == [(3, 2.0), (6, 2.0)]
