"""The port's LM layout rules against the reference's (``repro.dist.
sharding``): ``param_specs`` (``serve`` True and False, ``moe`` "ep" /
"fftp" / None) and ``cache_specs`` for all ten architectures on both
production meshes, entry for entry, checked abstractly (the reference's
``jax.eval_shape`` trees, the port's ``meta``-device LM).

The port's parameter tree is the LM's flat state dict (no stacked
leaves): a reference leaf ``blocks[i]`` (G, ...) stands for the port's
layers ``g·P + i``, whose spec is the reference's without its leading
``None``; ``rest[j]`` is layer ``G·P + j`` with the same spec.  Also:
``batch_spec`` and ``moe_expert_parallel`` as the reference's, and
``local_shard`` / ``join_shards`` inverse to each other on every rank of
a 2 x 2 x 2 mesh.
"""

import itertools

import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.dist import planner as ref_planner
from repro.dist import sharding as ref_sh
from repro_torch.configs import ARCH_IDS, MESH_SHAPES, SHAPES, get_config
from repro_torch.dist import LogicalMesh, planner
from repro_torch.dist import sharding as sh

MESHES = {name: LogicalMesh(shape) for name, shape in MESH_SHAPES.items()}
ROLES = [(True, None), (False, None), (False, "ep"), (False, "fftp")]


def ref_to_port(ref_specs, n_groups: int) -> dict:
    """The reference's spec tree as the port's flat {key: spec}."""
    out = {"embed": tuple(ref_specs["embed"])}
    if "head" in ref_specs:
        out["head"] = tuple(ref_specs["head"])
    for k, s in ref_specs["final_norm"].items():
        out[f"final_norm.{k}"] = tuple(s)
    blocks = ref_specs["blocks"]
    P = len(blocks)
    for i, block in enumerate(blocks):
        for name, leaves in block.items():
            for k, s in leaves.items():
                stacked = tuple(s)
                assert not stacked or stacked[0] is None
                for g in range(n_groups):
                    out[f"layers.{g * P + i}.{name}.{k}"] = stacked[1:]
    for j, layer in enumerate(ref_specs.get("rest", [])):
        for name, leaves in layer.items():
            for k, s in leaves.items():
                out[f"layers.{n_groups * P + j}.{name}.{k}"] = tuple(s)
    return out


@pytest.mark.parametrize("serve,moe", ROLES,
                         ids=[f"serve{s}-{m}" for s, m in ROLES])
@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_specs_equal_the_reference(arch, mesh_name, serve, moe):
    cfg, ref_cfg = get_config(arch), ref_get_config(arch)
    mesh = MESHES[mesh_name]
    ref_params, _ = ref_planner._abstract_state(ref_cfg)
    params, _ = planner._abstract_state(cfg)
    n_groups = ref_params["blocks"][0]["ln1"]["scale"].shape[0]
    want = ref_to_port(ref_sh.param_specs(mesh, ref_cfg, ref_params,
                                          serve=serve, moe=moe), n_groups)
    got = sh.param_specs(mesh, cfg, params, serve=serve, moe=moe)
    assert got == want


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_cache_specs_equal_the_reference(arch, mesh_name):
    cfg, ref_cfg = get_config(arch), ref_get_config(arch)
    mesh = MESHES[mesh_name]
    shape = SHAPES["decode_32k"]
    _, ref_cache = ref_planner._abstract_state(ref_cfg, shape)
    _, cache = planner._abstract_state(cfg, shape)
    want = ref_sh.cache_specs(mesh, ref_cfg, shape, ref_cache)
    got = sh.cache_specs(mesh, cfg, shape, cache)
    assert list(got) == ["blocks", "rest"]
    for part in ("blocks", "rest"):
        assert len(got[part]) == len(want.get(part, []))
        for g, w in zip(got[part], want.get(part, [])):
            assert g == {k: tuple(v) for k, v in w.items()}
        # the leaves the specs are of agree too
        for layer, ref_layer in zip(cache[part], ref_cache.get(part, [])):
            assert {k: tuple(v.shape) for k, v in layer.items()} == \
                {k: tuple(v.shape) for k, v in ref_layer.items()}


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_expert_predicate_and_batch_spec_equal_the_reference(arch,
                                                             mesh_name):
    cfg, ref_cfg = get_config(arch), ref_get_config(arch)
    mesh = MESHES[mesh_name]
    assert sh.moe_expert_parallel(mesh, cfg) == \
        ref_sh.moe_expert_parallel(mesh, ref_cfg)
    for batch, rest in ((128, 0), (1, 1), (32, 2), (6, 0)):
        assert sh.batch_spec(mesh, cfg, batch, rest) == \
            tuple(ref_sh.batch_spec(mesh, ref_cfg, batch, rest))


SPECS = [(), ("data",), (None, "model"), ("model", ("pod", "data")),
         (("pod", "data"), None, "model"), (None, None, ("data", "model"))]


@pytest.mark.parametrize("spec", SPECS, ids=[repr(s) for s in SPECS])
def test_local_shard_and_join_shards_are_inverse(spec):
    mesh = LogicalMesh({"pod": 2, "data": 2, "model": 2})
    t = torch.from_numpy(np.random.default_rng(0).normal(
        size=(4, 8, 12)).astype(np.float32))
    blocks = {}
    for r, coords in enumerate(itertools.product(range(2), repeat=3)):
        c = dict(zip(mesh.axis_names, coords))
        assert sh.mesh_coords(mesh, r) == c
        blocks[r] = sh.local_shard(mesh, spec, t, coords=c)
        n = [sh.axis_size(mesh, e) for e in spec] + [1] * (3 - len(spec))
        assert tuple(blocks[r].shape) == tuple(
            d // k for d, k in zip(t.shape, n))
    assert torch.equal(sh.join_shards(mesh, spec, blocks), t)
