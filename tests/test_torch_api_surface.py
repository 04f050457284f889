"""The port's public surface: ``repro_torch.core.__all__`` equals the
reference's ``repro.core.__all__`` (pinned by ``tests/test_api_surface.py``),
every name is importable, ``current_config`` is ``current_context``, and
the call sugar returns the staged API's types."""

import numpy as np

import repro.core as ref_core
import repro_torch.core as core


def test_public_surface_equals_the_reference():
    assert sorted(core.__all__) == sorted(ref_core.__all__)
    assert len(core.__all__) == len(set(core.__all__)) == 24


def test_all_symbols_importable():
    for name in core.__all__:
        assert hasattr(core, name), name


def test_current_config_is_current_context():
    assert core.current_config is core.current_context
    with core.FusionContext(mode="fa", device="cpu") as ctx:
        assert core.current_config() is ctx


def test_staged_types_are_the_call_sugar_types():
    """The @fused sugar routes through the same staged objects the explicit
    API returns — one pipeline, two spellings."""
    f = core.fused(lambda X: (X * 2.0).sum())
    traced = f.trace(np.zeros((4, 4), np.float32))
    planned = traced.plan(mode="gen")
    compiled = planned.compile(device="cpu")
    assert isinstance(traced, core.Traced)
    assert isinstance(planned, core.Planned)
    assert isinstance(compiled, core.Compiled)
    with core.FusionContext(device="cpu"):
        f(np.ones((4, 4), np.float32))
    (staged,) = f._staged.values()
    assert isinstance(staged, core.Compiled)
