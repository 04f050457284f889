"""Sharded LM training: ``launch.train.make_train_step(mesh=Mesh)`` on four
gloo CPU ranks of ``{data: 2, model: 2}``, as subprocesses of
``tests/torch_train_worker.py`` (one spawn: ``file://`` rendezvous in
``tmp_path``, ``OMP_NUM_THREADS=1``, a 60 s process-group timeout and a
join deadline after which every rank is killed), at ``.reduced()`` size,
against the reference's ``make_loss_fn`` under ``jax.value_and_grad``.

Each model's parameters are the reference's own ``init`` carried over
with ``interop.lm_params_from_jax``, placed FSDP × TP
(``param_specs(..., serve=False)``); the batch is 4 × 16 tokens from a
numpy seed, each data block its two sequences.  Held:

* minitron-4b, olmoe-1b-7b (``dense``), jamba-v0.1-52b and xlstm-1.3b:
  the loss and ce within 1e-5 relative, every gradient joined whole from
  the ranks' blocks within 1e-5 of the largest; the gradient norm with
  every block counted once within 1e-5 relative;
* olmoe-1b-7b with ``moe_impl="a2a"`` inside ``activation_rules``: the
  same against the reference run on each data block with its own
  capacity (``moe_capacity``, as the reference's ``shard_map`` dispatches
  a block's tokens), losses and gradients averaged over the blocks; the
  step runs one all-to-all over ``model`` each way a MoE layer and its
  backward's two;
* three sharded ``make_train_step`` steps of minitron-4b with
  ``fusion="gen"`` (the Row CPlan's plain version on the CPU) against
  three one-rank port steps: losses and grad norms within 1e-5 relative,
  every rank's updated blocks within 1e-5 of max |p|, written into the
  tensors the step was given; the same steps with ``fusion_layout`` a
  ``LogicalMesh`` of the step's shape, which prices the loss's plan only,
  within 1e-5 of them, and the step's own mesh refused;
* the CLI over ``--ranks 4 --model-axis 2``: its checkpoint (whole
  leaves) resumed on one rank gives the uninterrupted sharded run's
  losses, and a one-rank checkpoint resumed over the ranks the one-rank
  run's, within 1e-5 relative.
"""

import json
import shutil
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.launch import train as ref_train
from repro.models import LM as RefLM
from repro_torch.dist.launch import rank_env, run_ranks
from repro_torch.interop import lm_params_from_jax

import torch_train_worker as worker

WORKER = Path(__file__).resolve().parent / "torch_train_worker.py"
REPO = Path(__file__).resolve().parents[1]
MESH = {"data": 2, "model": 2}
RTOL = 1e-5


def spawn(case: str, shape: dict, tmp: Path, timeout: float = 120.0):
    world = int(np.prod(list(shape.values())))
    init = f"file://{tmp / ('rendezvous_' + case)}"
    run_ranks(lambda r: [sys.executable, str(WORKER), case, str(r),
                         str(world), init, str(tmp), json.dumps(shape)],
              world, timeout=timeout, env=rank_env())
    return [json.loads((tmp / f"{case}{r}.json").read_text())
            for r in range(world)]


def ref_params(arch: str, seed: int = 0):
    return RefLM(ref_get_config(arch).reduced()).init(
        jax.random.PRNGKey(seed))


def save_params(tmp: Path, archs) -> None:
    for arch in archs:
        p = jax.tree_util.tree_map(np.asarray, ref_params(arch))
        torch.save(lm_params_from_jax(p), tmp / f"params_{arch}.pt")


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("train")
    save_params(tmp, {a for a, _ in worker.GRAD_MODELS.values()})
    return tmp, spawn("train", MESH, tmp)


def _ref(arch: str, change: dict, b: dict):
    """(loss, ce, whole gradients) of the reference: the whole batch, or
    for ``a2a`` each data block through ``moe_capacity`` averaged."""
    rcfg = ref_get_config(arch).reduced()
    params = ref_params(arch)
    tc = ref_train.TrainConfig()
    blocks = [b]
    if change.get("moe_impl") == "a2a":
        from dataclasses import replace
        rcfg = replace(rcfg, moe_impl="capacity")
        k = worker.B // MESH["data"]
        blocks = [{n: v[i * k:(i + 1) * k] for n, v in b.items()}
                  for i in range(MESH["data"])]
    loss_fn = ref_train.make_loss_fn(RefLM(rcfg), rcfg, tc)
    outs = [jax.value_and_grad(loss_fn, has_aux=True)(
        params, {n: jnp.asarray(v.astype(np.int32)) for n, v in blk.items()})
        for blk in blocks]
    n = len(outs)
    loss = sum(float(o[0][0]) for o in outs) / n
    ce = sum(float(o[0][1]) for o in outs) / n
    grads = jax.tree_util.tree_map(lambda *g: sum(np.asarray(x) for x in g)
                                   / n, *[o[1] for o in outs])
    return loss, ce, lm_params_from_jax(grads)


@pytest.mark.parametrize("name", list(worker.GRAD_MODELS))
def test_sharded_loss_and_gradients_equal_the_reference(ranks, name):
    tmp, res = ranks
    arch, change = worker.GRAD_MODELS[name]
    cfg = worker.config(arch, change)
    loss, ce, want = _ref(arch, change, worker.batch(cfg))
    got = torch.load(tmp / f"grads_{name}.pt")
    assert set(got) == set(want)
    top = max(float(np.abs(np.asarray(v)).max()) for v in want.values())
    err = max(float((got[k] - torch.as_tensor(np.asarray(want[k])))
                    .abs().max()) for k in want)
    assert err <= RTOL * top, (err, top)
    norm = float(np.sqrt(sum(float((np.asarray(v, np.float64) ** 2).sum())
                             for v in want.values())))
    for r in res:
        rec = r[name]
        assert abs(rec["loss"] - loss) <= RTOL * abs(loss)
        assert abs(rec["ce"] - ce) <= RTOL * abs(ce)
        assert abs(rec["gnorm"] - norm) <= RTOL * norm
        # FSDP leaves' gradients arrive reduce-scattered
        assert rec["counts"]["reduce-scatter"] > 0
    if change.get("moe_impl") == "a2a":
        # one all-to-all each way a MoE layer, and the backward's two
        n_moe = cfg.n_layers
        assert res[0][name]["counts"]["all-to-all"] == 4 * n_moe


def test_sharded_steps_equal_one_rank_steps(ranks):
    _tmp, res = ranks
    for r in res:
        st = r["steps"]
        for (l1, g1), (ls, gs) in zip(st["trace"]["one"],
                                      st["trace"]["sharded"]):
            assert abs(ls - l1) <= RTOL * abs(l1)
            assert abs(gs - g1) <= RTOL * abs(g1)
        assert st["param_err"] <= RTOL
        assert st["in_place"]
    assert len(res[0]["steps"]["trace"]["one"]) == worker.STEPS


def test_an_abstract_fusion_layout_prices_the_sharded_loss_only(ranks):
    """``TrainConfig(fusion_layout=LogicalMesh(mesh.shape))`` in
    ``make_train_step(mesh=)``: the loss's plan is priced for the mesh and
    runs on the rank's rows, so the steps are the steps without it; the
    step's own mesh is refused."""
    _tmp, res = ranks
    for r in res:
        st = r["layout_steps"]
        assert st["priced"] and st["n_ops"] >= 1
        assert st["own_mesh_refused"]
        for (l1, g1), (ll, gl) in zip(r["steps"]["trace"]["sharded"],
                                      st["trace"]):
            assert abs(ll - l1) <= RTOL * abs(l1)
            assert abs(gl - g1) <= RTOL * abs(g1)
        assert len(st["trace"]) == worker.STEPS


def _cli(tmp: Path, ckpt: Path, *extra) -> list:
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "minitron-4b", "--preset", "tiny", "--batch", "4", "--seq", "16",
         "--device", "cpu", "--ckpt-dir", str(ckpt), "--ckpt-every", "2",
         *extra],
        capture_output=True, text=True, timeout=240, cwd=str(REPO),
        env=dict(rank_env(), PYTHONPATH=str(REPO / "src")))
    assert out.returncode == 0, out.stderr[-3000:]
    line = next(l for l in out.stdout.splitlines()
                if l.startswith("losses "))
    rec = json.loads(line[len("losses "):])
    return rec["losses"], rec["first_step"]


def test_cli_checkpoints_move_between_a_mesh_and_one_rank(tmp_path):
    sharded = ["--ranks", "4", "--model-axis", "2"]
    # sharded run, resumed from its step-2 checkpoint on one rank
    full, _ = _cli(tmp_path, tmp_path / "a", "--steps", "4", *sharded)
    shutil.rmtree(tmp_path / "a" / "step_4")
    resumed, first = _cli(tmp_path, tmp_path / "a", "--steps", "4",
                          "--resume")
    assert first == 3 and len(resumed) == 2
    for got, want in zip(resumed, full[2:]):
        assert abs(got - want) <= RTOL * abs(want)
    # one-rank run, resumed from its step-2 checkpoint over the ranks
    one, _ = _cli(tmp_path, tmp_path / "b", "--steps", "4")
    shutil.rmtree(tmp_path / "b" / "step_4")
    resumed, first = _cli(tmp_path, tmp_path / "b", "--steps", "4",
                          "--resume", *sharded)
    assert first == 3
    for got, want in zip(resumed, one[2:]):
        assert abs(got - want) <= RTOL * abs(want)
    # the sharded and one-rank runs agree step for step
    for got, want in zip(full, one):
        assert abs(got - want) <= RTOL * abs(want)
