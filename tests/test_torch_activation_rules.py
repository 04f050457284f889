"""The activation-sharding rules (``repro_torch.dist.sharding.
{current_rules, activation_rules, activation_spec, constrain}``), the
expert-parallel ``moe_a2a`` and the gathers over part of the row axes,
against the reference, on the CPU.

* ``activation_spec`` equals the reference's ``PartitionSpec`` entry for
  entry for every layout × mode × shape on ``pod16x16``,
  ``multipod2x16x16``, ``h100x256``, ``h100x2x256`` and ``{data: 2,
  model: 2}``; the rules nest and ``constrain`` is the identity outside
  them.
* On eight gloo CPU ranks of ``{pod: 2, data: 2, model: 2}`` (one spawn
  of ``tests/torch_train_worker.py rules``):

  - the repair: a minitron-4b of d_model 66, whose 66-wide dims
    ``_fit`` shards over ``data`` but not ``pod`` × ``data``, served by
    ``Engine(mesh=..., layout="auto")`` with ``serve_params`` off: its
    leaves gather over ``data`` alone (the group ``row:data``), its
    tokens are the unsharded engine's and its logits within 1e-5 of max
    |logit|;
  - ``"sp"``: the logits within 1e-5 of the unsharded model's, the
    layers' sums reduce-scattered along the sequence and their inputs
    all-gathered in place of the all-reduces of ``"dp"``, and the loss
    and every gradient (joined whole) the unsharded ones', under both
    modes;
  - ``moe_a2a`` of olmoe-1b-7b's layer 0 (4 experts, 2 a rank) on each
    data block's 32 tokens: the reference's ``moe_capacity`` of that
    block, within 1e-5 of max |y|, aux the mean of the blocks' auxes,
    with one all-to-all over ``model`` each way.
"""

from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.dist import sharding as ref_sh
from repro.models import moe as ref_moe
from repro_torch.configs import MESH_SHAPES
from repro_torch.dist import sharding as sh

from test_torch_sharded_train import save_params, spawn
import torch_train_worker as worker

MESHES = dict(MESH_SHAPES, **{"2x2": {"data": 2, "model": 2}})
LAYOUTS = ("btd", "bthd", "btf", "btv", "bt", "nope")
SHAPES = [(256, 4096, 8192), (8, 4096, 64, 128), (3, 7, 11),
          (32, 32768, 7168), (1, 1, 256000), (16, 4096), (4, 16, 4, 16)]


def _mesh(shape: dict):
    return SimpleNamespace(shape=dict(shape), axis_names=tuple(shape))


@pytest.mark.parametrize("mesh", list(MESHES))
def test_activation_spec_equals_the_reference(mesh):
    m = _mesh(MESHES[mesh])
    n = 0
    for layout in LAYOUTS:
        for mode in ("dp", "sp"):
            for shape in SHAPES:
                want = ref_sh.activation_spec(m, layout, shape, mode)
                got = sh.activation_spec(m, layout, shape, mode)
                if want is None:
                    assert got is None
                    continue
                assert got == tuple(want), (layout, mode, shape)
                n += 1
    assert n > 20


def test_rules_nest_and_constrain_is_the_identity_outside_them():
    a, b = _mesh({"data": 2, "model": 2}), _mesh({"data": 4})
    x = torch.ones(2, 3, 4)
    assert sh.current_rules() is None
    assert sh.constrain(x, "btd") is x
    with sh.activation_rules(a, "sp"):
        assert sh.current_rules() == (a, "sp")
        with sh.activation_rules(b):
            assert sh.current_rules() == (b, "dp")
        assert sh.current_rules() == (a, "sp")
        assert sh.constrain(x, "btd") is x
        with pytest.raises(ValueError):
            sh.constrain(torch.ones(3), "bthd")
    assert sh.current_rules() is None
    with pytest.raises(ValueError):
        with sh.activation_rules(a, "tp"):
            pass


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("rules")
    save_params(tmp, ["olmoe-1b-7b"])
    return tmp, spawn("rules", {"pod": 2, "data": 2, "model": 2}, tmp)


def test_leaves_gather_over_part_of_the_row_axes(ranks):
    _tmp, res = ranks
    for r in res:
        rep = r["repair"]
        assert rep["partial_leaves"], "no leaf keeps data alone"
        assert rep["groups"].get("row:data/2", 0) > 0
        assert rep["tokens"] == rep["unsharded"]
        assert rep["rel_err"] <= 1e-5


def test_sequence_parallel_logits_collectives_and_gradients(ranks):
    _tmp, res = ranks
    for r in res:
        sp, dp = r["sp"]["sp"], r["sp"]["dp"]
        for mode in (sp, dp):
            assert mode["rel_err"] <= 1e-5
            assert mode["grad_err"] <= 1e-5
            assert abs(mode["loss"] - r["sp"]["want_loss"]) <= \
                1e-5 * r["sp"]["want_loss"]
        assert dp["counts"]["reduce-scatter"] == 0
        # every layer's two sums and the embedding's scatter; the layers'
        # inputs and the logits' sequence gathered
        assert sp["counts"]["reduce-scatter"] > 0
        assert sp["counts"]["all-reduce"] < dp["counts"]["all-reduce"]
        assert sp["counts"]["all-gather"] > dp["counts"]["all-gather"]
        assert sp["counts"]["all-reduce"] + sp["counts"]["reduce-scatter"] \
            == dp["counts"]["all-reduce"]


def test_moe_a2a_is_the_capacity_dispatch_of_each_data_block(ranks):
    tmp, res = ranks
    cfg = worker.config("olmoe-1b-7b", {"moe_impl": "a2a"})
    rcfg = ref_get_config("olmoe-1b-7b").reduced()
    params = torch.load(tmp / "params_olmoe-1b-7b.pt")
    p = {k: jnp.asarray(params[f"layers.0.mlp.{k}"].numpy())
         for k in ("router", "w1", "w2", "w3")}
    xs = np.load(tmp / "a2a_x.npy")
    n = len(xs) // worker.A2A_TOKENS
    want, auxes = [], []
    for part in range(n):
        x = xs[part * worker.A2A_TOKENS:(part + 1) * worker.A2A_TOKENS]
        y, aux = ref_moe.moe_capacity(jnp.asarray(x), p, rcfg)
        want.append(np.asarray(y))
        auxes.append(float(aux))
    assert cfg.n_experts % 2 == 0
    for r in range(len(res)):
        got = torch.load(tmp / f"a2a{r}.pt")
        w = want[got["part"]]
        err = float(np.abs(got["y"].numpy() - w).max())
        assert err <= 1e-5 * float(np.abs(w).max())
        assert abs(float(got["aux"]) - np.mean(auxes)) <= 1e-5
        assert res[r]["a2a"]["counts"]["all-to-all"] == 2
