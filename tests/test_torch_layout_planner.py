"""The port's layout planner (``repro_torch.dist.planner``) against the
reference's (``repro.dist.planner``): for every applicable (arch, shape,
mesh) cell of the production meshes, ``search(...).to_dict()`` — every
candidate, its terms, collective and memory bytes, feasibility, the
winner and the fixed layout — equals the reference's, floats to 1e-12
relative (the port sums its per-layer leaves where the reference sums
stacked ones).  Also ``plan_layout`` / ``auto_variant`` on the same
meshes, ``validate_layout`` on every candidate of a cell, the fallback
warning of a failing search, and ``write_report`` / ``main`` writing only
where they are told (``tmp_path``).
"""

import json
import math

import pytest

from repro.configs import get_config as ref_get_config
from repro.dist import planner as ref_planner
from repro_torch.configs import (ARCH_IDS, MESH_SHAPES, SHAPES, applicable,
                                 get_config)
from repro_torch.dist import LogicalMesh, planner

CELLS = [(arch, shape, mesh) for arch in ARCH_IDS for shape in SHAPES
         for mesh in MESH_SHAPES
         if applicable(get_config(arch), SHAPES[shape])]


def assert_close(got, want, path="") -> None:
    """Equal structures; floats within 1e-12 relative."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and got.keys() == want.keys(), path
        for k in want:
            assert_close(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            assert_close(g, w, f"{path}[{i}]")
    elif isinstance(want, float) and not isinstance(want, bool):
        assert isinstance(got, (int, float)), path
        if math.isinf(want):
            assert got == want, path
        else:
            assert math.isclose(got, want, rel_tol=1e-12, abs_tol=1e-300), \
                (path, got, want)
    else:
        assert got == want, (path, got, want)


@pytest.mark.parametrize("arch,shape,mesh", CELLS,
                         ids=[f"{a}-{s}-{m}" for a, s, m in CELLS])
def test_search_equals_the_reference(arch, shape, mesh):
    sig = planner.signature_of(MESH_SHAPES[mesh])
    want = ref_planner.search(ref_get_config(arch), SHAPES[shape],
                              sig).to_dict()
    got = planner.search(get_config(arch), SHAPES[shape], sig).to_dict()
    assert_close(got, want)


@pytest.mark.parametrize("mesh", list(MESH_SHAPES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_plan_layout_and_auto_variant_equal_the_reference(arch, mesh):
    cfg, ref_cfg = get_config(arch), ref_get_config(arch)
    m = LogicalMesh(MESH_SHAPES[mesh])
    ref_m = ref_planner.LogicalMesh(MESH_SHAPES[mesh])
    for shape in SHAPES.values():
        if not applicable(cfg, shape):
            continue
        got = planner.plan_layout(m, cfg, shape)
        want = ref_planner.plan_layout(ref_m, ref_cfg, shape)
        assert got.to_dict() == want.to_dict()
        fixed = planner.fixed_layout(cfg, shape, planner.signature_of(m))
        assert (got.tp, got.moe) == (fixed.tp, fixed.moe)   # realisable
        for variant in (None, {"act": "sp"}, {"serve_params": False}):
            assert planner.auto_variant(m, cfg, shape, variant) == \
                ref_planner.auto_variant(ref_m, ref_cfg, shape, variant)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_every_candidate_validates_as_the_reference(arch):
    cfg, ref_cfg = get_config(arch), ref_get_config(arch)
    shape = SHAPES["decode_32k"]
    sig = planner.signature_of(MESH_SHAPES["multipod2x16x16"])
    layouts = planner.enumerate_layouts(cfg, shape, sig)
    assert [l.to_dict() for l in layouts] == [
        l.to_dict() for l in ref_planner.enumerate_layouts(ref_cfg, shape,
                                                           sig)]
    for lay in layouts:
        ref_lay = ref_planner.Layout(**lay.to_dict())
        assert planner.validate_layout(cfg, shape, lay) is \
            ref_planner.validate_layout(ref_cfg, shape, ref_lay) is True
    # an odd TP degree splits no head, ff or vocabulary dimension evenly
    odd = planner.Layout(tp=3, dp=1)
    assert planner.validate_layout(cfg, shape, odd) == \
        ref_planner.validate_layout(ref_cfg, shape,
                                    ref_planner.Layout(tp=3, dp=1))


def test_a_failing_search_warns_and_falls_back(monkeypatch):
    cfg = get_config("yi-34b")
    shape = SHAPES["decode_32k"]
    m = LogicalMesh(MESH_SHAPES["pod16x16"])

    def boom(*_a, **_k):
        raise RuntimeError("planted")
    monkeypatch.setattr(planner, "search", boom)
    fb = planner.Layout(tp=16, dp=16, serve_params=True)
    with pytest.warns(RuntimeWarning, match="planted"):
        assert planner.plan_layout(m, cfg, shape, fallback=fb) is fb
    with pytest.warns(RuntimeWarning):
        assert planner.auto_variant(m, cfg, shape, {"act": "sp"}) == \
            {"act": "sp"}


def test_reports_go_where_they_are_told(tmp_path, monkeypatch, capsys):
    cfg = get_config("xlstm-1.3b")
    res = planner.search(cfg, SHAPES["decode_32k"],
                         planner.signature_of(MESH_SHAPES["pod16x16"]))
    path = planner.write_report(res, name="xlstm-1.3b",
                                mesh_name="pod16x16", out_dir=tmp_path)
    assert path.parent == tmp_path
    assert json.loads(path.read_text()) == json.loads(json.dumps(
        res.to_dict()))
    assert planner.REPORT_DIR.name == "layouts_torch"
    # main() at the same cells: one report a cell, the reference's table
    out = tmp_path / "all"
    monkeypatch.setattr("sys.argv", ["planner", "--mesh", "pod16x16",
                                     "--out", str(out)])
    planner.main()
    table = capsys.readouterr().out.splitlines()
    n = sum(applicable(get_config(a), s) for a in ARCH_IDS
            for s in SHAPES.values())
    assert len(table) == n + 2 and len(list(out.glob("*.json"))) == n
    assert table[0].startswith("| arch | shape | mesh | fixed ms")
