"""The four examples of the PyTorch port (``examples/*_torch.py``) run on
the CPU at a small size, each ending in its own asserts:

* ``quickstart_torch``: every candidate's cost (1e-5 relative), mode,
  operator count and selection, and the winner's operators, equal to the
  reference quickstart's planning of the same operands (its numpy seeds);
* ``als_recommender_torch``: the loss traces of ``gen`` and ``hand``
  equal to the reference's ``als_cg.run`` on the reference example's
  ratings (1e-5 relative), at a reduced size and at its own;
* ``serve_lm_torch``: six requests served, tokens equal to direct greedy
  decoding of the same model;
* ``train_lm_torch``: the reference's defaults, overridden to the tiny
  preset for a few steps, through ``launch.train.main``.

The examples and the port's new modules import neither ``jax`` nor the
reference package.
"""

import json
import runpy
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.algos import als_cg as ref_als_cg
from repro.algos import data as ref_data
from repro.configs.als_paper import CONFIG as REF_ALS
from repro.core import fused as ref_fused
from repro.core import ir as ref_ir
from repro.kernels.blocksparse import BCSR as RefBCSR

ROOT = Path(__file__).resolve().parents[1]
EXAMPLES = ROOT / "examples"
sys.path.insert(0, str(EXAMPLES))

import als_recommender_torch  # noqa: E402
import quickstart_torch  # noqa: E402
import serve_lm_torch  # noqa: E402


def test_quickstart_plans_as_the_reference_example():
    got = quickstart_torch.main(["--device", "cpu"])
    data = quickstart_torch.operands()
    ref = ref_fused(lambda X, U, V, r: (ref_ir.neq0(X) * (U @ V.T)) @ V
                    + 1e-6 * U * r, sparsity={"X": 0.1})
    binds = {k: jnp.asarray(v) for k, v in data.items() if k != "X"}
    binds["X"] = RefBCSR.from_dense(data["X"], bs=128)
    want = ref.trace(**binds).plan(mode="gen").explain()
    assert len(got["candidates"]) == len(want["candidates"])
    for g, w in zip(got["candidates"], want["candidates"]):
        assert (g["mode"], g["n_fused"], g["selected"]) == \
            (w["mode"], w["n_fused"], w["selected"])
        assert g["cost"] == pytest.approx(w["cost"], rel=1e-5)
    assert json.loads(json.dumps(got["winner"])) == \
        json.loads(json.dumps(want["winner"]["operators"]))


@pytest.mark.parametrize("rows,cols,iters", [(512, 384, 2),
                                             (2048, 1536, 4)])
def test_als_recommender_losses_equal_the_reference(rows, cols, iters):
    got = als_recommender_torch.main(["--device", "cpu", "--rows",
                                      str(rows), "--cols", str(cols),
                                      "--iters", str(iters)])
    X = ref_data.ratings(rows, cols, rank=REF_ALS.rank,
                         bs=REF_ALS.block_size, block_density=0.15, seed=0)
    for mode in ("gen", "hand"):
        _U, _V, want = ref_als_cg.run(X, rank=REF_ALS.rank, lam=REF_ALS.lam,
                                      max_iter=iters,
                                      max_inner=REF_ALS.max_inner, mode=mode)
        np.testing.assert_allclose(got[mode], np.asarray(want), rtol=1e-5)


def test_serve_lm_serves_its_requests_greedily():
    outs = serve_lm_torch.main(["--device", "cpu", "--max-new", "5"])
    from repro_torch.configs import get_config
    from repro_torch.models import LM
    cfg = get_config("starcoder2-7b").reduced()
    model = LM(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    rng = np.random.default_rng(0)
    for p, out in zip((9, 17, 5, 24, 13, 7), outs):
        prompt = torch.as_tensor(rng.integers(0, cfg.vocab, size=p))[None]
        cache = model.init_cache(1, 96)
        with torch.no_grad():
            logits, _, _ = model.apply(prompt, caches=cache)
            want, tok, pos = [], int(prompt[0, -1]), p
            for _ in range(5):      # the engine feeds the last prompt token
                lg, _ = model.decode_step(cache, torch.tensor([[tok]]), pos)
                tok = int(torch.argmax(lg[0, -1]))
                want.append(tok)
                pos += 1
        assert out == want


def test_train_lm_runs_the_cli_with_the_reference_defaults(tmp_path,
                                                           monkeypatch,
                                                           capsys):
    monkeypatch.setattr(sys, "argv", [
        "train_lm_torch.py", "--device", "cpu", "--preset", "tiny",
        "--steps", "3", "--batch", "2", "--seq", "32",
        "--ckpt-dir", str(tmp_path / "ckpt")])
    mod = runpy.run_path(str(EXAMPLES / "train_lm_torch.py"),
                         run_name="__main__")
    assert mod["DEFAULTS"] == ["--arch", "minitron-4b", "--preset", "100m",
                               "--steps", "300", "--batch", "8", "--seq",
                               "512", "--fusion", "gen"]
    out = capsys.readouterr().out
    assert "done: 3 steps" in out
    losses = json.loads(out.split("losses ", 1)[1].splitlines()[0])
    assert len(losses["losses"]) == 3
    assert all(np.isfinite(losses["losses"]))


def test_examples_and_new_modules_import_neither_jax_nor_the_reference():
    code = ("import sys; sys.path.insert(0, 'examples'); "
            "import quickstart_torch, als_recommender_torch, serve_lm_torch; "
            "import repro_torch.dist.planner, repro_torch.dist.sharding, "
            "repro_torch.models.sharded, repro_torch.serve.engine, "
            "repro_torch.configs.meshes, repro_torch.configs.als_paper; "
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'repro' or "
            "m.startswith('repro.')]; print(bad)")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, check=True,
                         env={"PYTHONPATH": str(ROOT / "src"),
                              "PATH": "/usr/bin:/bin"})
    assert out.stdout.strip() == "[]"
    train = (EXAMPLES / "train_lm_torch.py").read_text()
    assert "import jax" not in train and "from repro." not in train
