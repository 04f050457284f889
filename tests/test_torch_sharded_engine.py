"""Sharded LM serving: ``Engine(model, mesh=Mesh, layout="fixed"|"auto")``
on gloo CPU ranks, as subprocesses of ``tests/torch_sharded_worker.py``
(``file://`` rendezvous in ``tmp_path``, ``OMP_NUM_THREADS=1``, a 60 s
process-group timeout, a join deadline after which every rank is killed),
against the reference's ``Engine`` on the same numpy prompts.

The reduced minitron-4b, olmoe-1b-7b (4 experts: expert-parallel on a
model axis of 2), jamba-v0.1-52b (Mamba + attention + MoE) and
xlstm-1.3b, their parameters the reference's (``interop.lm_params_from_
jax``), on the meshes ``{data: 1, model: 1}``, ``{data: 1, model: 2}``
(also a one-KV-head minitron, whose KV head ``_fit`` leaves replicated
while the query heads split; with a model axis also a minitron whose
attention chunks of 4 take the chunked path on the rank's heads) and
``{data: 2, model: 2}`` (the slots split
over ``data``), each with the fixed and the planner's layout, and on the
last also the planner's layout with ``serve_params`` off (FSDP leaves
gathered before use); minitron also on a ``meta``-device model whose
blocks ``weights(key, index)`` cuts on demand.  Each run must give:

* greedy tokens equal to the reference ``Engine``'s (five requests
  through four slots, so one slot is reused; the reference gets a fresh
  slot for each, as its recurrent state leaks into a reused one);
* prefill and decode logits within 1e-5 of max |logit| of the unsharded
  engine's (fp32), bit for bit on ``{data: 1, model: 1}``;
* each rank's stored parameter and cache bytes equal to the planner's
  ``_tree_accounting`` for that mesh and layout;
* the same tokens on every rank.

A planted fault (rank 1 keeps its partial sums of layer 0's attention
output) must miss the logits bound, temperature sampling must draw the
unsharded engine's tokens, and a rank that raises must stop the others at
once.
"""

import json
import sys
import time
from dataclasses import replace
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.models import LM as RefLM
from repro.serve import Engine as RefEngine
from repro.serve import Request as RefRequest
from repro_torch.configs import ShapeConfig, get_config
from repro_torch.dist import LogicalMesh, planner
from repro_torch.dist.launch import RankFailure, rank_env, run_ranks
from repro_torch.interop import lm_params_from_jax

import torch_sharded_worker as worker

WORKER = Path(__file__).resolve().parent / "torch_sharded_worker.py"
MESHES = {"1x1": {"data": 1, "model": 1}, "1x2": {"data": 1, "model": 2},
          "2x2": {"data": 2, "model": 2}}
LOGIT_RTOL = 1e-5


def _world(shape: dict) -> int:
    return int(np.prod(list(shape.values())))


def _spawn(case: str, shape: dict, tmp: Path, timeout: float) -> list:
    init = f"file://{tmp / 'rendezvous'}"
    world = _world(shape)
    return run_ranks(lambda r: [sys.executable, str(WORKER), case, str(r),
                                str(world), init, str(tmp),
                                json.dumps(shape)],
                     world, timeout=timeout, env=rank_env())


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """(params directory, {model: the reference Engine's tokens})."""
    tmp = tmp_path_factory.mktemp("params")
    tokens = {}
    for name, (arch, change) in worker.MODELS.items():
        ref_cfg = replace(ref_get_config(arch).reduced(), **change)
        params = RefLM(ref_cfg).init(jax.random.PRNGKey(0))
        torch.save(lm_params_from_jax(jax.tree_util.tree_map(np.asarray,
                                                             params)),
                   tmp / f"params_{name}.pt")
        ps = worker.prompts(worker.config(name, get_config))
        eng = RefEngine(ref_cfg, params, batch_slots=len(ps),
                        max_len=worker.MAX_LEN)
        reqs = [RefRequest(prompt=p, max_new=worker.MAX_NEW) for p in ps]
        for r in reqs:
            eng.submit(r)
        eng.run_until_done()
        tokens[name] = [r.out for r in reqs]
    return tmp, tokens


@pytest.fixture(scope="module", params=list(MESHES))
def ranks(request, reference, tmp_path_factory):
    """(mesh name, every rank's readings) — one spawn a mesh."""
    params_dir, _ = reference
    tmp = tmp_path_factory.mktemp(f"mesh{request.param}")
    for f in params_dir.glob("params_*.pt"):
        (tmp / f.name).symlink_to(f)
    shape = MESHES[request.param]
    _spawn("serve", shape, tmp, timeout=240)
    for r in range(_world(shape)):
        (tmp / f"rank{r}.json").rename(tmp / f"serve{r}.json")
    return request.param, [
        {**json.loads((tmp / f"serve{r}.json").read_text()),
         "_deadline": json.loads((tmp / f"deadline{r}.json").read_text())}
        for r in range(_world(shape))]


def _runs(ranks_):
    _name, rs = ranks_
    return [(k, r, v) for r, res in enumerate(rs) for k, v in res.items()
            if "/" in k and not k.endswith("/fault")]


def test_tokens_equal_the_reference_engine(ranks, reference):
    _, want = reference
    runs = _runs(ranks)
    assert runs
    for key, r, v in runs:
        name = key.split("/")[0]
        assert v["tokens"] == want[name], (key, r)
        assert v["unsharded"] == want[name], (key, r)


def test_logits_within_the_bound_of_the_unsharded_engine(ranks):
    name, _ = ranks
    for key, r, v in _runs(ranks):
        assert v["rel_err"] <= LOGIT_RTOL, (key, r, v["rel_err"])
        if name == "1x1":         # asserted bit for bit in the rank too
            assert v["rel_err"] == 0.0, (key, r)


def test_stored_bytes_equal_the_planners(ranks):
    for key, r, v in _runs(ranks):
        assert v["stored"] == v["planner_stored"], (key, r)


def test_every_rank_serves_the_same_tokens_and_splits_the_slots(ranks):
    name, rs = ranks
    for key, _r, _v in _runs(ranks):
        assert all(res[key]["tokens"] == rs[0][key]["tokens"]
                   for res in rs), key
    shape = MESHES[name]
    for key, r, v in _runs(ranks):
        assert v["n_local"] == worker.SLOTS // shape["data"]
        assert v["slot0"] == (r // shape["model"]) * v["n_local"]
        assert v["collectives"] > 0 or name == "1x1", key


def test_layouts_are_the_planners_and_the_fsdp_run_gathers(ranks):
    """``auto`` records the planner's layout for the engine's decode cell
    (on a mesh without data blocks serve_params is a tie the key order
    breaks to False, which shards nothing more); the ``fsdp`` run's
    leaves are sharded over ``data``."""
    name, rs = ranks
    shape = ShapeConfig("engine_decode", worker.MAX_LEN, worker.SLOTS,
                        "decode")
    for key, r, v in _runs(ranks):
        model, lay = key.split("/")
        if lay in ("fixed", "meta"):
            assert v["layout"] is None and v["serve_params"]
            continue
        want = planner.plan_layout(LogicalMesh(MESHES[name]),
                                   worker.config(model, get_config), shape)
        if lay == "fsdp":
            want = replace(want, serve_params=False)
        assert v["layout"] == want.to_dict(), (key, r)
        assert v["serve_params"] is (lay != "fsdp"), (key, r)


def test_a_planted_reduction_fault_misses_the_logits(ranks):
    name, rs = ranks
    faults = [res[k]["rel_err"] for res in rs for k in res
              if k.endswith("/fault")]
    if name == "1x1":
        assert not faults
        return
    assert faults and max(faults) > 100 * LOGIT_RTOL, faults


def test_a_deadline_passed_on_one_rank_expires_on_every_rank(ranks):
    """Rank 1's deadlines pass at once, the others' in an hour: the
    ranks agree (one all-reduce of every queued and occupied request's
    expiry a step), so every rank ends every request with
    DeadlineExceededError and no token after a single collective, and
    none waits (one rank alone, rank 0, serves them all)."""
    name, rs = ranks
    n = len(worker.PROMPT_LENS)
    want = [[True, "NoneType", worker.MAX_NEW]] * n if name == "1x1" \
        else [[True, "DeadlineExceededError", 0]] * n
    for res in rs:
        assert res["_deadline"]["ends"] == want
        assert res["_deadline"]["collectives"] == (0 if name == "1x1"
                                                   else 1)


def test_sampled_tokens_equal_the_unsharded_engines(ranks, reference):
    """At temperature > 0 every rank advances the generator for every
    slot, its own or another data block's, so the sharded engine draws
    the unsharded engine's tokens (same seed) and no two data blocks
    share a stream."""
    _, greedy = reference
    _name, rs = ranks
    for res in rs:
        got = res["sampled"]
        assert got["tokens"] == got["unsharded"]
        assert got["tokens"] != greedy["minitron-4b"]
        assert got["tokens"] == rs[0]["sampled"]["tokens"]


def test_a_failing_rank_stops_the_others(tmp_path):
    """Rank 1 raises; the others, in a collective, are stopped well before
    the process group's 60 s timeout."""
    t0 = time.monotonic()
    with pytest.raises(RankFailure, match="rank 1 fails before"):
        _spawn("raise", {"data": 2, "model": 2}, tmp_path, timeout=120)
    assert time.monotonic() - t0 < 45
