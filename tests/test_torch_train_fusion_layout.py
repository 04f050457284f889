"""The fused loss's options — ``TrainConfig.fusion_layout`` and
``fusion_staged`` — against the reference's, on the CPU,
at ``.reduced()`` size (see ``test_torch_train_grads``).

Under ``fusion_layout=LogicalMesh({"data": 8})`` the loss's Row plan is
priced for 8 devices and runs locally, as the reference's under its
``LogicalMesh``; ``fusion_staged=False`` dispatches it per operator.  Each
loss and every gradient is held to the reference's under the same options
within 1e-5 (of the largest gradient), and the loss operator's
``explain()["distributed"]`` — forward and planned backward — to the
reference's.  A sharded step takes a ``LogicalMesh`` only.  The real
``Mesh`` runs in ``tests/test_torch_dist.py``'s 8 gloo ranks.
"""

from types import SimpleNamespace

import pytest

from repro.dist.planner import LogicalMesh as RefMesh
from repro.launch import train as ref_train
from repro_torch.core import FusionLayout
from repro_torch.dist import LogicalMesh, RecordingMesh
from repro_torch.launch import train

from test_torch_train_grads import (batch, close_grads, close_scalar, pair,
                                    ref_value_and_grad)

ARCH = "minitron-4b"


@pytest.mark.parametrize("option", ["layout", "per_op"])
def test_loss_under_the_options_matches_reference(option):
    kw, ref_kw = ({"fusion_layout": LogicalMesh({"data": 8})},
                  {"fusion_layout": RefMesh({"data": 8})}) \
        if option == "layout" else ({"fusion_staged": False},
                                    {"fusion_staged": False})
    rcfg, ref, params, cfg, port = pair(ARCH)
    b = batch(cfg)
    ref_train._fused_lse.__dict__.pop("_ops", None)
    ref_train._fused_lse.__dict__.pop("_lse", None)
    loss, ce, want = ref_value_and_grad(
        ref, rcfg, params, b, ref_train.TrainConfig(fusion="gen", **ref_kw))
    train._LSE_OPS.clear()
    loss_fn = train.make_loss_fn(port, cfg,
                                 train.TrainConfig(fusion="gen", **kw))
    (got_loss, got_ce), got = train.value_and_grad(
        loss_fn, dict(port.named_parameters()), b)
    close_scalar(got_loss, loss)
    close_scalar(got_ce, ce)
    close_grads(got, want)
    (op,) = train._LSE_OPS.values()
    (ref_op,) = ref_train._fused_lse._ops.values()
    got_rep = op.explain(include_backward=True)
    want_rep = ref_op.explain(include_backward=True)
    for key in ("winner", "backward"):
        assert got_rep[key]["operators"] == want_rep[key]["operators"], key
    if option == "layout":
        assert got_rep["distributed"] == want_rep["distributed"]
        assert got_rep["distributed"]["n_fused_distributed"] >= 1
        # priced for the mesh, run locally: no segment step
        assert op._cplan._seg_plans == []
    else:
        assert not op._cplan.staged
        (bwd,) = op._bwd_plans.values()
        assert not bwd.staged


def test_a_sharded_step_takes_an_abstract_mesh_only():
    """A model placed on a mesh runs the loss on the rank's rows: its
    ``fusion_layout`` may be a ``LogicalMesh`` (bare or in a
    FusionLayout), which prices the plan; a mesh of ranks — the step's
    own included — raises."""
    step_mesh = RecordingMesh({"data": 2, "model": 2})
    placed = SimpleNamespace(shard=SimpleNamespace(mesh=step_mesh))
    for lay in (LogicalMesh({"data": 8}),
                FusionLayout(LogicalMesh({"data": 8}), {"L": ("data", None)}),
                None):
        train.make_loss_fn(placed, None,
                           train.TrainConfig(fusion="gen", fusion_layout=lay))
    for lay in (step_mesh, FusionLayout(step_mesh, {"L": ("data", None)}),
                RecordingMesh({"data": 4})):
        with pytest.raises(ValueError, match="LogicalMesh"):
            train.make_loss_fn(placed, None, train.TrainConfig(
                fusion="gen", fusion_layout=lay))
    # the one-process step takes a mesh as given
    train.make_loss_fn(SimpleNamespace(shard=None), None,
                       train.TrainConfig(fusion="gen",
                                         fusion_layout=step_mesh))


def test_fusion_layout_is_accepted_where_the_reference_takes_it():
    """``TrainConfig`` takes the reference's fields, in its order, but
    ``unroll_mb`` (the reference's choice between ``lax.scan`` and a
    Python loop; the port has the loop only)."""
    import dataclasses
    assert [f.name for f in dataclasses.fields(train.TrainConfig)] == \
        [f.name for f in dataclasses.fields(ref_train.TrainConfig)
         if f.name != "unroll_mb"]
    tc = train.TrainConfig(fusion="gen", fusion_layout=LogicalMesh(
        {"data": 8}), fusion_staged=False)
    assert tc.fusion_layout.shape == {"data": 8}
