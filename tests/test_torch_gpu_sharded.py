"""Sharded LM serving on the card: ``Engine(mesh=Mesh({"data": 1,
"model": 2}, device="cuda:0"))`` in two gloo rank processes on the one
card (``tests/torch_sharded_worker.py`` with device ``cuda:0``), every
reduced model of the worker (minitron-4b, olmoe-1b-7b, jamba-v0.1-52b,
xlstm-1.3b, a one-KV-head minitron, a minitron with attention chunks of
4) with the fixed and the planner's layout and a ``meta``-device model
placed block by block: tokens equal to the one-device engine's on the
card, also at temperature > 0, logits within 1e-5 of max |logit|,
stored bytes equal to the planner's, the planted partial-sum fault
rejected.  The weights are drawn by ``LM.init`` from seeded
``torch.Generator`` s (no JAX on the card's machine).  Marked ``gpu``;
without a card every test skips:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu_sharded.py
"""

import json
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.dist.launch import rank_env, run_ranks
from repro_torch.models import LM

import torch_sharded_worker as worker

pytestmark = pytest.mark.gpu
WORKER = Path(__file__).resolve().parent / "torch_sharded_worker.py"
MESH = {"data": 1, "model": 2}
LOGIT_RTOL = 1e-5


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Both ranks' readings (one spawn on the card)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    tmp = tmp_path_factory.mktemp("gpu_sharded")
    for i, name in enumerate(worker.MODELS):
        cfg = worker.config(name, get_config)
        model = LM(cfg, device="cpu").init(torch.Generator().manual_seed(i))
        torch.save(model.state_dict(), tmp / f"params_{name}.pt")
    init = f"file://{tmp / 'rendezvous'}"
    run_ranks(lambda r: [sys.executable, str(WORKER), "serve", str(r), "2",
                         init, str(tmp), json.dumps(MESH), "cuda:0"],
              2, timeout=600, env=rank_env(threads=2))
    return [json.loads((tmp / f"rank{r}.json").read_text())
            for r in range(2)]


def test_sharded_engine_on_the_card_equals_the_one_device_engine(ranks):
    for res in ranks:
        assert res["sampled"]["tokens"] == res["sampled"]["unsharded"]
        for key, v in res.items():
            if key.endswith("/fault") or key == "sampled":
                continue
            assert v["tokens"] == v["unsharded"], key
            assert v["rel_err"] <= LOGIT_RTOL, (key, v["rel_err"])
            assert v["stored"] == v["planner_stored"], key
            assert v["collectives"] > 0, key
    assert ranks[0].keys() == ranks[1].keys()
    assert {k.split("/")[0] for k in ranks[0]} == set(worker.MODELS) | {
        "sampled"}


def test_planted_partial_sums_miss_on_the_card(ranks):
    faults = [res[k]["rel_err"] for res in ranks for k in res
              if k.endswith("/fault")]
    assert faults and max(faults) > 100 * LOGIT_RTOL, faults
