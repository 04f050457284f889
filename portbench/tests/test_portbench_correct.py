"""The comparison that decides ``correct``, shown to fail: the TF32 control
put in the port's place, and a run driven with the timed path broken
underneath, on the CPU at a tiny size.  ``test_control_on_the_card`` runs
the control on the card at each cell's own size."""

import json
import time

import numpy as np
import pytest
import torch

from conftest import tiny_config
from portbench import calibrate, harness, registry

CELLS = [w["name"] for w in registry.benchmark()["workloads"]]
SEEDS = (2 ** 33 + 11, 4_000_000_001, 7)


def tiny_cell(name):
    cell = harness.Cell(name)
    cell.cfg = tiny_config(cell.cfg)
    return cell


def over(cell, numbers) -> bool:
    lim = cell.mix["limits"]
    return any(numbers[n] > lim[n] for n in lim)


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_fails_and_the_port_passes(cell):
    c = tiny_cell(cell)
    rows = calibrate.readings(c, SEEDS, SEEDS, device="cpu",
                              fits=2 if c.mix.get("objective") else 1)
    for r in rows:
        assert not over(c, r["program"]), r
        assert over(c, r["control"]), r


# -- the timed path broken underneath --------------------------------------

def _start(fin, params):
    """The parameters a fit starts from (its state before any step)."""
    if "w" in params:
        return {"w": torch.zeros_like(params["w"])}
    if "B" in params:
        return {"B": torch.zeros_like(params["B"])}
    if "C" in params:
        return {"C": fin["C0"].clone()}
    rng = np.random.default_rng(fin["seed"])
    U = torch.as_tensor(rng.normal(size=tuple(params["U"].shape)).astype(
        np.float32)) * 0.1
    V = torch.as_tensor(rng.normal(size=tuple(params["V"].shape)).astype(
        np.float32)) * 0.1
    return {"U": U, "V": V}


def state_unchanged(fit, script):
    """Every step returns the state it was given: the start's parameters,
    its objective repeated."""
    def broken(port_ops, fin, cfg):
        params, objs = fit(port_ops, fin, cfg)
        return _start(fin, params), [objs[0]] * len(objs)
    return broken


def half_the_rows(fit, script):
    """Half of the rows left out, the objective's sums scaled to the
    whole (the mean over the rest)."""
    def broken(port_ops, fin, cfg):
        half = dict(port_ops)
        if script == "als_cg":
            from repro_torch.kernels.blocksparse import BCSR
            X = port_ops["X"]
            mb = X.shape[0] // X.bs
            keep = X.rows < mb // 2
            half["X"] = BCSR(X.data[keep], X.rows[keep], X.cols[keep],
                             (mb // 2 * X.bs, X.shape[1]), X.bs)
        else:
            m = port_ops["X"].shape[0] // 2
            half = {k: v[:m] for k, v in port_ops.items()}
        params, objs = fit(half, fin, cfg)
        return params, [2.0 * v for v in objs]
    return broken


def answer_altered(fit, script):
    """The fit's answer altered where it is produced: its last objective
    and one parameter element, by one part in a thousand."""
    def broken(port_ops, fin, cfg):
        params, objs = fit(port_ops, fin, cfg)
        k = sorted(params)[0]
        params[k] = params[k].clone()
        params[k].view(-1)[0] *= 1.001
        return params, objs[:-1] + [objs[-1] * 1.001]
    return broken


@pytest.mark.parametrize("fault", [state_unchanged, half_the_rows,
                                   answer_altered])
@pytest.mark.parametrize("cell", CELLS)
def test_a_broken_timed_path_is_not_correct(cell, fault, tiny_root):
    c = harness.Cell(cell, tiny_root)
    script = c.mix["script"]
    res, lines = harness.run_cell(
        cell, SEEDS[0], 0.2, False, t_start=time.perf_counter(),
        root=tiny_root, device="cpu",
        entry=fault(c.script.port_fit, script))
    assert res["correct"] is False and res["failed"] >= 1, lines
    assert list(res)[-1] == "checks"


@pytest.mark.parametrize("cell", CELLS)
def test_a_sound_run_is_correct(cell, tiny_root):
    res, _lines = harness.run_cell(cell, SEEDS[1], 0.2, False,
                                   t_start=time.perf_counter(),
                                   root=tiny_root, device="cpu")
    assert res["correct"] is True and res["failed"] == 0
    assert set(res["metrics"]) == {e["name"] for e in registry.end_to_end(
        registry.benchmark(), cell)}


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CELLS)
def test_control_on_the_card(cell, card):
    c = harness.Cell(cell)
    _ms, cplans = harness.plan_regions(c.script, c.cfg)
    harness.build_kernels(cplans)
    rows = calibrate.readings(c, SEEDS, SEEDS, device="cuda")
    for r in rows:
        assert not over(c, r["program"]), r
        assert over(c, r["control"]), r
    print(json.dumps(rows))


@pytest.mark.gpu
def test_centroids_over_half_the_rows_on_the_card(card):
    """K-Means at its own size: every centroid update over half the rows
    reads over the ``param_gap`` limit, the port under it."""
    c = harness.Cell("dense-10m.kmeans")
    _ms, cplans = harness.plan_regions(c.script, c.cfg)
    harness.build_kernels(cplans)
    rows = calibrate.readings(c, SEEDS, (), SEEDS, device="cuda", fits=2)
    lim = c.mix["limits"]["param_gap"]
    for r in rows:
        assert r["program"]["param_gap"] <= lim, r
        assert r["fault"]["param_gap"] > lim, r
    print(json.dumps(rows))


def test_a_wrong_last_centroid_update_is_not_correct(tiny_root):
    """K-Means records each iteration's objective before it updates the
    centroids, so a last update over half the rows leaves the objective
    as it was: the returned centroids' ``param_gap`` catches it."""
    cell = "dense-10m.kmeans"
    c = harness.Cell(cell, tiny_root)
    last = c.cfg["kmeans_max_iter"]
    rows = c.cfg["rows"]
    updates = []

    def mm(a, b):
        if a.shape[-1] == rows and b.shape[-2] == rows:
            updates.append(1)
            if len(updates) % last == 0:
                return calibrate.half_rows_mm(rows)(a, b)
        return torch.matmul(a, b)

    def broken(port_ops, fin, cfg):
        with torch.no_grad():
            return c.reference.fit(port_ops, fin, cfg, mm)

    res, lines = harness.run_cell(
        cell, SEEDS[2], 0.2, False, t_start=time.perf_counter(),
        root=tiny_root, device="cpu", entry=broken)
    checks = res["checks"]
    assert res["correct"] is False, lines
    assert checks["obj_gap"]["value"] <= checks["obj_gap"]["limit"]
    assert checks["param_gap"]["value"] > checks["param_gap"]["limit"]
