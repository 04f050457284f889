"""The port's dry-run tools (``repro_torch.launch.{serve,train,dryrun_lib,
costing,roofline,mesh}``) against the reference's, on the CPU.

* The stand-ins: ``prefill_specs``, ``decode_specs``, ``train_batch_specs``
  and ``cache_specs_abstract`` have the reference's shapes and dtypes for
  every architecture and every shape it applies to (``meta`` tensors
  here, ``jax.ShapeDtypeStruct`` there).
* The pure functions: ``_seq_scan_flops``, ``model_flops_per_device``,
  ``model_bytes_per_device`` and ``analyze(hw=TPU_V5E)`` equal the
  reference's exactly, on a record and a probe both read.
* Recording against live: on four gloo CPU ranks of ``{data: 2, model:
  2}`` (one spawn of ``tests/torch_train_worker.py record``) every rank's
  sharded decode steps (TP layout, and xlstm's FSDP leaves) and train
  steps (two microbatches; olmoe's experts) issue the collectives that a
  ``RecordingMesh`` of its coordinates records on ``meta``: each kind's
  count and bytes and each group's, and the same FLOPs.
* At full width on ``meta``: minitron-4b's and olmoe-1b-7b's decode step
  on ``{data: 2, model: 2}`` (the sharded engine's layout) record 66 and
  34 collectives a token; the rank's ``argument_bytes`` of a decode cell
  on ``h100x256`` are the planner's ``_tree_accounting`` of its
  parameters and cache plus its token block; the FLOPs of a tiny dense
  train cell equal a closed-form count of its products; a train step of
  M microbatches counted from runs of two and three equals the step run
  whole; ``dryrun.main`` runs a cell end to end.
"""

import json
from dataclasses import replace

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.launch import costing as ref_costing
from repro.launch import roofline as ref_roofline
from repro.launch import serve as ref_serve
from repro.launch import train as ref_train
from repro.models import LM as RefLM
from repro_torch.configs import (ARCH_IDS, MESH_SHAPES, SHAPES, applicable,
                                 get_config)
from repro_torch.configs.base import ShapeConfig
from repro_torch.dist import LogicalMesh, RecordingMesh, planner
from repro_torch.dist import sharding as sh
from repro_torch.hw import TPU_V5E
from repro_torch.launch import costing, dryrun_lib, roofline
from repro_torch.launch import serve as serve_lib
from repro_torch.launch import train as train_lib
from repro_torch.models import LM

from test_torch_sharded_train import spawn

CELLS = [(a, s) for a in ARCH_IDS for s in SHAPES
         if applicable(get_config(a), SHAPES[s])]
DTYPES = {torch.int32: np.dtype("int32"), torch.float32: np.dtype("float32"),
          torch.bfloat16: jax.numpy.bfloat16}


def _same(got: torch.Tensor, want) -> None:
    assert got.device.type == "meta"
    assert tuple(got.shape) == tuple(want.shape)
    assert np.dtype(DTYPES[got.dtype]) == np.dtype(want.dtype)


@pytest.mark.parametrize("arch,shape", CELLS,
                         ids=[f"{a}-{s}" for a, s in CELLS])
def test_input_specs_equal_the_reference(arch, shape):
    cfg, rcfg, sc = get_config(arch), ref_get_config(arch), SHAPES[shape]
    if sc.kind == "train":
        got = train_lib.train_batch_specs(cfg, sc)
        want = ref_train.train_batch_specs(rcfg, sc)
    elif sc.kind == "prefill":
        got = serve_lib.prefill_specs(cfg, sc)
        want = ref_serve.prefill_specs(rcfg, sc)
    else:
        got = serve_lib.decode_specs(cfg, sc)
        want = ref_serve.decode_specs(rcfg, sc)
    assert set(got) == set(want)
    for k in want:
        _same(got[k], want[k])
    assert set(dryrun_lib.input_specs(arch, shape)) == set(want)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_cache_specs_abstract_equal_the_reference(arch):
    cfg, rcfg = get_config(arch), ref_get_config(arch)
    for sc in SHAPES.values():
        if sc.kind == "train" or not applicable(cfg, sc):
            continue
        got = serve_lib.cache_specs_abstract(LM(cfg, device="meta"), sc)
        want = ref_serve.cache_specs_abstract(RefLM(rcfg), sc)
        assert set(got) == set(want)
        for part in want:
            assert len(got[part]) == len(want[part])
            for g, w in zip(got[part], want[part]):
                assert set(g) == set(w)
                for k in w:
                    _same(g[k], w[k])


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_pure_functions_equal_the_reference(arch):
    cfg, rcfg = get_config(arch), ref_get_config(arch)
    for name, sc in SHAPES.items():
        if not applicable(cfg, sc):
            continue
        assert costing._seq_scan_flops(cfg, sc) == \
            ref_costing._seq_scan_flops(rcfg, sc)
        assert costing._probe_cfg(cfg, 2).n_layers == \
            ref_costing._probe_cfg(rcfg, 2).n_layers
        for dev in (256, 512):
            assert roofline.model_flops_per_device(arch, name, dev) == \
                ref_roofline.model_flops_per_device(arch, name, dev)
            assert roofline.model_bytes_per_device(arch, name, dev) == \
                ref_roofline.model_bytes_per_device(arch, name, dev)


def _ref_record(arch="olmoe-1b-7b", shape="train_4k"):
    coll = {"all-gather": 1.5e9, "all-reduce": 2.5e9, "reduce-scatter": 0.5e9,
            "all-to-all": 0.0, "collective-permute": 0.0}
    coll["total"] = sum(coll.values())
    return {"arch": arch, "shape": shape, "mesh": "pod16x16",
            "devices": 256, "collective_bytes_per_device": coll,
            "collective_bytes_per_device_trip_corrected": coll}


@pytest.mark.parametrize("probe", [False, True])
def test_analyze_equals_the_reference_on_the_tpu(probe, tmp_path,
                                                  monkeypatch):
    rec = _ref_record()
    if probe:
        (tmp_path / "olmoe-1b-7b__train_4k.json").write_text(json.dumps(
            {"total_flops": 3.3e18, "total_bytes": 7.7e15}))
    monkeypatch.setattr(ref_roofline, "PROBE_DIR", tmp_path)
    monkeypatch.setattr(roofline, "PROBE_DIR", tmp_path)
    with pytest.warns(RuntimeWarning) if not probe else _nothing():
        want = ref_roofline.analyze(dict(rec))
    with pytest.warns(RuntimeWarning) if not probe else _nothing():
        got = roofline.analyze(dict(rec), hw=TPU_V5E)
    for k in ("terms", "dominant", "model_flops", "useful_ratio",
              "roofline_fraction", "flops_per_device_corrected",
              "bytes_per_device_corrected", "cost_source"):
        assert got[k] == want[k], k


class _nothing:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def test_roofline_splits_nvlink_and_inter_node_bytes():
    from repro_torch.hw import H100_SXM
    shape = MESH_SHAPES["h100x256"]
    assert not roofline.spans_nodes(shape, "model/8")
    assert roofline.spans_nodes(shape, "row/32")
    assert roofline.spans_nodes(MESH_SHAPES["h100x2x256"], "row:pod/2")
    rec = {"mesh_shape": shape, "collective_bytes_per_device": {
        "total": 3e9, "group_bytes": {"model/8": 1e9, "row/32": 2e9}}}
    assert roofline.collective_seconds(rec, H100_SXM) == \
        1e9 / H100_SXM.ici_bw + 2e9 / H100_SXM.dcn_bw
    assert H100_SXM.dcn_bw == 50e9


@pytest.fixture(scope="module")
def recorded(tmp_path_factory):
    return spawn("record", {"data": 2, "model": 2},
                 tmp_path_factory.mktemp("record"))


def test_recording_equals_the_live_mesh(recorded):
    import torch_train_worker as worker
    for r, res in enumerate(recorded):
        for name, *_ in worker.RECORD_CELLS:
            live, rec = res[name]["live"], res[name]["recorded"]
            assert live == rec, (r, name)
            assert sum(live["counts"].values()) > 0
            assert res[name]["live_flops"] == res[name]["recorded_flops"]
    # the train steps reduce-scatter their FSDP leaves' gradients
    assert recorded[0]["minitron-train"]["live"]["counts"][
        "reduce-scatter"] > 0


@pytest.mark.parametrize("arch,count", [("minitron-4b", 66),
                                        ("olmoe-1b-7b", 34)])
def test_full_width_decode_records_the_engines_collectives(arch, count):
    mesh = RecordingMesh({"data": 2, "model": 2})
    rec = dryrun_lib.run_cell(arch, "decode_32k", mesh, "2x2",
                              variant={"serve_params": True}, save=False)
    counts = rec["collective_bytes_per_device"]["counts"]
    assert sum(counts.values()) == count
    # the embedding's and every layer's sums, and the logits' gather
    assert counts["all-gather"] == 1


def test_argument_bytes_equal_the_planners_accounting():
    arch, shape = "xlstm-1.3b", "decode_32k"
    name = "h100x256"
    mesh = RecordingMesh(MESH_SHAPES[name])
    rec = dryrun_lib.run_cell(arch, shape, mesh, name, save=False)
    cfg, sc = get_config(arch), SHAPES[shape]
    params, cache = planner._abstract_state(cfg, sc)
    lm = LogicalMesh(MESH_SHAPES[name])
    want = (planner._tree_accounting(
        lm, sh.param_specs(lm, cfg, params), params)["stored"]
        + planner._tree_accounting(
            lm, sh.cache_specs(lm, cfg, sc, cache), cache)["stored"])
    tokens = sc.global_batch // 32 * 4 + 4           # the block and pos
    assert rec["memory"]["argument_bytes"] == want + tokens


def test_flops_of_a_tiny_dense_train_cell_are_its_products():
    cfg = replace(get_config("minitron-4b").reduced(), attn_chunk=0)
    B, S = 4, 16
    shape = ShapeConfig("tiny", S, B, "train")
    rec = dryrun_lib.measure_cell("minitron-4b", "tiny",
                                  RecordingMesh({"data": 1, "model": 1}),
                                  cfg=cfg, shape=shape,
                                  variant={"n_mb": 1})
    T, d, f, V = B * S, cfg.d_model, cfg.d_ff, cfg.vocab
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    layer = (2 * T * d * H * hd * 2          # wq, wo
             + 2 * T * d * KV * hd * 2       # wk, wv
             + 2 * B * H * S * S * hd * 2    # scores, weights · v
             + 2 * T * d * f * (3 if cfg.mlp_type in ("swiglu", "geglu")
                                else 2))     # w1 (w3), w2
    forward = cfg.n_layers * layer + 2 * T * d * V
    assert rec["flops_per_device"] == 3 * forward     # + dgrad + wgrad
    assert rec["collective_bytes_per_device"]["total"] == 0


def test_microbatches_counted_from_two_and_three_equal_the_whole_step():
    cfg = get_config("minitron-4b").reduced()
    mesh = RecordingMesh({"data": 2, "model": 2})
    shape = ShapeConfig("mb", 16, 20, "train")
    whole = dryrun_lib.measure_cell("minitron-4b", "mb", mesh, cfg=cfg,
                                    shape=shape, variant={"n_mb": 5})
    ext = dryrun_lib.measure_train_cell("minitron-4b", "mb", mesh, cfg=cfg,
                                        shape=shape, variant={"n_mb": 5})
    assert ext["microbatches"] == {"M": 5, "extrapolated_from": [2, 3]}
    for k in ("flops_per_device", "bytes_per_device",
              "collective_bytes_per_device"):
        assert ext[k] == whole[k], k
    assert ext["memory"]["argument_bytes"] == \
        whole["memory"]["argument_bytes"]


def test_dryrun_cli_runs_a_cell(tmp_path, monkeypatch, capsys):
    from repro_torch.launch import dryrun
    monkeypatch.setattr(dryrun_lib, "RESULTS_DIR", tmp_path)
    assert dryrun.main(["--arch", "xlstm-1.3b", "--shape", "decode_32k",
                        "--mesh", "both"]) == 0
    out = capsys.readouterr().out
    assert out.count("OK   xlstm-1.3b × decode_32k") == 2
    recs = sorted(tmp_path.glob("*.json"))
    assert [p.name for p in recs] == [
        "xlstm-1.3b__decode_32k__h100x256.json",
        "xlstm-1.3b__decode_32k__h100x2x256.json"]
    monkeypatch.setattr(roofline, "RESULTS_DIR", tmp_path)
    monkeypatch.setattr(roofline, "PROBE_DIR", tmp_path / "no_probes")
    with pytest.warns(RuntimeWarning):
        rows = roofline.load_all()
    assert len(rows) == 2 and all(r["hw"] == "h100-sxm" for r in rows)
    assert "| xlstm-1.3b | decode_32k | h100x256 |" in roofline.table(rows)
