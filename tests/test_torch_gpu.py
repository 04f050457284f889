"""The generated CUDA kernels on the card: each sweep case against its
plain version on the same CUDA tensors (the Outer kernel's over BCSR
mains too), bit-for-bit repeatability (no float atomics), the Cell
kernel's vector walk at row counts that reach its tails, one Cell kernel
per call in the profiler, a misaligned operand refused, every L2SVM /
mlogreg / GLM / kmeans / autoencoder region forward and planned backward
on the card against the CPU, L2SVM and ALS-CG on the card against the
CPU, MLogReg, GLM, KMeans and the autoencoder on the card against
``kernels="never"``, KMeans' assignment rows, and the Outer kernel
launched exactly for a BCSR on the card; the request-axis kernels per
request and the fusion server on the card; a distributed segment's
misaligned row panel copied, not refused; the LM's fused rmsnorm at
3,072 columns as one Row launch; the fused softmax-CE loss at 32,000
columns in the Row kernel's staged layout; the staged layout at a small
width in one CTA and in a cluster of 4, on its scalar path and over a
request axis, and the streaming layout, against their plain versions;
the staged row_agg and full_agg in one CTA and in a cluster; L2SVM's and
MLogReg's backward of the weights alone (one Row pass, no ∇X).
Marked ``gpu``; without a card
every test skips.  Imports no JAX (the machine with the card has none):

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py
"""

import time

import numpy as np
import pytest
import torch

from repro_torch.algos import (als_cg, autoencoder, data, glm, kmeans,
                               l2svm, mlogreg)
from repro_torch.core import FusionContext
from repro_torch.core.codegen import _eval_basic, _is_fused, compile_plan
from repro_torch.kernels import (build, cellwise, cuda_src, multiagg, ops,
                                 outerprod, rowwise, sweep)
from repro_torch.kernels.blocksparse import BCSR

from torch_regions import GRADS, chip_smoke, inputs, regions, run_port


pytestmark = pytest.mark.gpu
torch.set_num_threads(1)
SWEEP_SHAPES = ((1031, 7), (100_003, 7))
REGION_SHAPE = (4099, 12, 3)


@pytest.fixture(scope="module")
def card():
    """The card, with every kernel these tests launch built up front, one
    nvcc per source in parallel (the tests' shapes share the sources)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    cplans = [sweep.fused_cplan(c, *SWEEP_SHAPES[0])[0]
              for c in sweep.cases()]
    for name, (fn, shapes) in regions(*REGION_SHAPE).items():
        planned = fn.trace(**{k: torch.empty(s, device="meta")
                              for k, s in shapes.items()}).plan(
            context=FusionContext(device="cpu"))
        cplans += compile_plan(planned.eplan).cplans()
        if name in GRADS:
            # the backward of every input, and of the inputs the region
            # tests differentiate (the one their autograd runs)
            for wrt in (None, GRADS[name]):
                cplans += compile_plan(planned.backward(wrt).eplan).cplans()
    srcs = [cuda_src.source_for(cp) for cp in cplans]
    srcs += [cuda_src.source_for(cp) for cp, _n in
             [sweep.fused_cplan(c, *s) for c, s in CELL_VECTOR_RUNS]
             + [sweep.fused_cplan(c, 33, 1) for c in _tail_cases()]]
    srcs += [cuda_src.source_for(_outer_plan(c)[0], c.bs)
             for c in sweep.outer_cases()]
    X = data.ratings(*ALS_SHAPE, rank=4, seed=6, device="cpu")
    srcs += [cuda_src.source_for(cp, X.bs) for cp in _als_cplans(X)]
    build.build_all({s.key: s for s in srcs}.values())
    return torch.device("cuda")


ALS_SHAPE = (768, 512)

#: the Cell kernel over (m,1) domains at these row counts reaches every
#: part of its vector walk: the loop of U groups, the last round of single
#: groups and the cells past the last group
TAIL_ROWS = (1, 3, 5, 7, 33, 1023, 100_003)


def _tail_cases():
    return [c for c in sweep.cases() if c.template == "cell"
            and c.min_n == 1]


#: reducing Cell CPlans in the vector walk and in the scalar walk
CELL_VECTOR_RUNS = [
    (next(c for c in sweep.cases() if c.name == name), shape)
    for name, shape in (("cell/full_agg_row_side", (100_003, 100)),
                        ("cell/no_agg_row_side", (100_003, 100)),
                        ("cell/full_agg_abs_sum", (100_003, 1)),
                        ("cell/col_agg_sum", (100_003, 7)),
                        ("cell/full_agg_mean", (100_003, 7)))]


def _outer_plan(case, seed=11):
    vals = sweep.outer_values(case, seed)
    cp, names = sweep.fused_cplan(case, *case.shape, sparsity={
        "X": BCSR.from_dense(vals["X"], case.bs).block_sparsity})
    return cp, names, vals


def _outer_env(case, names, vals, device):
    return {nid: (BCSR.from_dense(torch.tensor(vals[n], device=device),
                                  case.bs) if n == "X"
                  else torch.tensor(vals[n], device=device))
            for nid, n in names.items()}


def _als_cplans(X, rank=4):
    m, n = X.shape
    U = torch.empty((m, rank), device="meta")
    V = torch.empty((n, rank), device="meta")
    out = []
    for region, args in ((als_cg._wsq_mm, (X, U, V)),
                         (als_cg._wsq_mm, (X.T, V, U)),
                         (als_cg._loss_terms, (X, U, V))):
        planned = region.trace(*args).plan(
            context=FusionContext(device="cpu"))
        out += compile_plan(planned.eplan).cplans()
    return out


def _env(case, shape, names, device, seed=11):
    rng = np.random.default_rng(seed)
    vals = {k: (rng.normal(size=s) * 0.5).astype(np.float32)
            for k, s in case.shapes(*shape).items()}
    return {nid: torch.tensor(vals[n], device=device)
            for nid, n in names.items()}


@pytest.mark.parametrize("case", [pytest.param(c, id=c.name)
                                  for c in sweep.cases()])
def test_kernel_matches_plain(card, case):
    """``chip_smoke.py``'s limit: per element, 16 fp32 eps times a
    first-order bound of the plain computation's rounding."""
    cp, names = sweep.fused_cplan(case, *SWEEP_SHAPES[0])
    env = _env(case, SWEEP_SHAPES[0], names, card)
    got = ops.execute(cp, env, kernels="cuda")
    err, share = chip_smoke().measure(cp, env, got, case.name)
    assert share <= 1.0, f"max |kernel - plain| {err:.3e}, {share:.3g} x limit"


@pytest.mark.parametrize("name", ["cell/full_agg_sum", "cell/col_agg_min",
                                  "magg/k2_sum_max",
                                  "row/col_t_agg_mm4",
                                  "row/col_t_agg_hvp_mm5"])
def test_reductions_repeat_bit_for_bit(card, name):
    case = next(c for c in sweep.cases() if c.name == name)
    cp, names = sweep.fused_cplan(case, *SWEEP_SHAPES[1])
    env = _env(case, SWEEP_SHAPES[1], names, card)
    a = ops.execute(cp, env, kernels="cuda")
    b = ops.execute(cp, env, kernels="cuda")
    assert torch.equal(a, b)


@pytest.mark.parametrize("case", [pytest.param(c, id=c.name)
                                  for c in _tail_cases()])
def test_cell_walk_tails_match_plain(card, case):
    """The Cell kernel over (m,1) at m·N of 1 to 100,003 (CPlans of 33 rows
    resized: the same source), one launch a call, within the limit."""
    cp33, names = sweep.fused_cplan(case, 33, 1)
    for m in TAIL_ROWS:
        cp = sweep.with_rows(cp33, m)
        env = {b.nid: torch.tensor(
            np.random.default_rng(m).normal(size=tuple(b.shape)) * 0.5,
            dtype=torch.float32, device=card) for b in cp.binds}
        before = cellwise.launches
        got = ops.execute(cp, env, kernels="cuda")
        assert cellwise.launches == before + 1
        err, share = chip_smoke().measure(cp, env, got, f"{case.name} {m}")
        assert share <= 1.0, f"m {m}: {err:.3e}, {share:.3g} x limit"


@pytest.mark.parametrize("case,shape", [
    pytest.param(c, s, id=f"{c.name}-{s[0]}x{s[1]}")
    for c, s in CELL_VECTOR_RUNS])
def test_cell_calls_are_one_deterministic_launch(card, case, shape):
    """One Cell kernel a call under its own name in the profiler, within
    the limit, and the same bits twice (a reduction folds its partials in
    CTA order inside the kernel)."""
    from torch.profiler import ProfilerActivity, profile
    cp, names = sweep.fused_cplan(case, *shape)
    env = _env(case, shape, names, card)
    run = lambda: ops.execute(cp, env, kernels="cuda")
    a = run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        # idle time at each end, as chip_smoke.device_ms pads its traces:
        # without it a short kernel's launch can go missing from the trace
        time.sleep(chip_smoke().PROFILE_PAD_S)
        b = run()
        torch.cuda.synchronize()
        time.sleep(chip_smoke().PROFILE_PAD_S)
    kernels = [e for e in prof.key_averages()
               if e.self_device_time_total > 0]
    # 0 kernels would be a launch the profiler lost, 2 a second launch
    assert len(kernels) == 1 and kernels[0].count == 1, \
        f"{len(kernels)} kernels traced: " \
        f"{[(e.key[:60], e.count) for e in kernels]}"
    assert f"cell_{cp.variant}" in kernels[0].key
    assert torch.equal(a, b)
    err, share = chip_smoke().measure(cp, env, a, case.name)
    assert share <= 1.0, f"{err:.3e}, {share:.3g} x limit"


def test_misaligned_cell_operand_raises_on_the_card(card):
    case, shape = CELL_VECTOR_RUNS[1]
    cp, names = sweep.fused_cplan(case, *shape)
    env = _env(case, shape, names, card)
    main = env[cp.main.nid]
    shifted = torch.empty(main.numel() + 1, device=card)[1:].view(main.shape)
    shifted.copy_(main)
    before = cellwise.launches
    with pytest.raises(ValueError, match="16-byte"):
        ops.execute(cp, {**env, cp.main.nid: shifted}, kernels="cuda")
    assert cellwise.launches == before


def test_misaligned_panel_is_copied_on_the_card(card):
    """A rank's row panels that start off a 16-byte boundary (rows 2,501
    to 5,002 of (m, 1) operands) run the Cell kernel's vector walk on
    aligned copies, to the plain version's value on the same panels."""
    case, _shape = CELL_VECTOR_RUNS[2]                  # (m, 1) vector walk
    cp, names = sweep.fused_cplan(case, 10_004, 1)
    env = _env(case, (10_004, 1), names, card)
    panels = {nid: v[2501:5002] for nid, v in env.items()}
    assert all(v.data_ptr() % 16 for v in panels.values())
    before = cellwise.launches
    got = ops.execute(cp, panels, kernels="cuda", shard_rows=2501)
    assert cellwise.launches == before + 1
    want = ops.execute(cp, {nid: v.cpu() for nid, v in panels.items()},
                       kernels="never", shard_rows=2501)
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), rtol=1e-5)


def test_l2svm_on_the_card_matches_the_cpu(card):
    X, _Y, y = data.classification(512, 32, seed=3, device="cpu")
    before = (cellwise.launches, multiagg.launches, rowwise.launches)
    w, objs = l2svm.run(X, y, max_iter=5, kernels="cuda", device="cuda")
    after = (cellwise.launches, multiagg.launches, rowwise.launches)
    w_cpu, objs_cpu = l2svm.run(X, y, max_iter=5, device="cpu")
    assert all(a > b for a, b in zip(after, before))
    np.testing.assert_allclose(objs, objs_cpu, rtol=1e-5)
    np.testing.assert_allclose(w.cpu().numpy(), w_cpu.numpy(), rtol=1e-4,
                               atol=1e-5)


@pytest.mark.parametrize("name", sorted(regions(1, 1)))
def test_region_forward_and_gradient_on_the_card(card, name):
    """Tolerance 1e-4: the card's fused kernels sum in another order."""
    fn, shapes = regions(*REGION_SHAPE)[name]
    vals = inputs(shapes, seed=sum(map(ord, name)))
    grad_wrt = GRADS.get(name, ())
    got, got_g = run_port(fn, vals, grad_wrt, device="cuda")
    want, want_g = run_port(fn, vals, grad_wrt, device="cpu")
    for a, b in zip(got + tuple(got_g.values()),
                    want + tuple(want_g.values())):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("case", [pytest.param(c, id=c.name)
                                  for c in sweep.outer_cases()])
def test_outer_kernel_matches_plain(card, case):
    """The Outer kernel against ``outer_plain`` on the same CUDA tensors,
    at ``chip_smoke.py``'s limit; it launches exactly once."""
    cp, names, vals = _outer_plan(case)
    env = _outer_env(case, names, vals, card)
    before = outerprod.launches
    got = ops.execute(cp, env, kernels="cuda")
    assert outerprod.launches == before + 1
    err, share = chip_smoke().measure(cp, env, got, case.name)
    assert share <= 1.0, f"max |kernel - plain| {err:.3e}, {share:.3g} x limit"


@pytest.mark.parametrize("name,what", [
    ("outer/right_mm_bs128_r20_d1.0", "outer"),
    ("outer/full_agg_loss", "outer"),
    ("outer/right_mm_long_rows_bs128", "outer"),
    ("outer/full_agg_long_rows_bs16", "outer"),
    ("outer/right_mm_empty_rows", "bcsr_matmul")])
def test_sparse_results_repeat_bit_for_bit(card, name, what):
    """No float atomics: the Outer kernel walks each piece of a block row
    in order and folds pieces and partials in order (one launch per call,
    the fold included); the block product sums each block row in order."""
    case = next(c for c in sweep.outer_cases() if c.name == name)
    cp, names, vals = _outer_plan(case)
    env = _outer_env(case, names, vals, card)
    if what == "bcsr_matmul":
        X, v = env[cp.main.nid], torch.tensor(vals["V"], device=card)
        run = lambda: ops.bcsr_matmul(X, v)
    else:
        run = lambda: ops.execute(cp, env, kernels="cuda")
        if "long_rows" in name:               # rows cut into pieces
            assert int(env[cp.main.nid].pieces.ptr.diff().max()) > 1
    before = outerprod.launches
    assert torch.equal(run(), run())
    assert outerprod.launches == before + (2 if what == "outer" else 0)


def test_outer_launches_exactly_for_a_bcsr_on_the_card(card):
    """``als_cg.run`` on the card launches the Outer kernel and matches the
    CPU; ``ops.execute`` over a CPU BCSR never launches it."""
    X = data.ratings(*ALS_SHAPE, rank=4, seed=6, device="cpu")
    before = outerprod.launches
    _u, _v, gpu = als_cg.run(X, rank=4, max_iter=2, max_inner=2,
                             kernels="cuda", device="cuda")
    assert outerprod.launches > before
    mid = outerprod.launches
    _u, _v, cpu = als_cg.run(X, rank=4, max_iter=2, max_inner=2,
                             kernels="cuda", device="cpu")
    case = next(c for c in sweep.outer_cases()
                if c.name == "outer/full_agg_loss")
    cp, names, vals = _outer_plan(case)
    ops.execute(cp, _outer_env(case, names, vals, "cpu"), kernels="cuda")
    assert outerprod.launches == mid
    np.testing.assert_allclose(gpu, cpu, rtol=1e-5)


def _clusters():
    X, _c = data.clusters(2048, 16, seed=2, device="cpu")
    return X, X[:5].clone()


#: name -> (operands on the CPU, run)
ALGO_RUNS = {
    "mlogreg": (lambda: data.classification(2048, 24, k=4, seed=2,
                                            device="cpu")[:2],
                lambda a, **kw: mlogreg.run(*a, max_outer=3, max_inner=5,
                                            **kw)),
    "glm": (lambda: data.regression(2048, 16, seed=2, device="cpu"),
            lambda a, **kw: glm.run(*a, max_outer=3, max_inner=5, **kw)),
    "kmeans": (_clusters, lambda a, **kw: kmeans.run(*a, max_iter=5, **kw)),
    "autoencoder": (lambda: (data.images(1024, 64, seed=2, device="cpu"),),
                    lambda a, **kw: autoencoder.run(*a, h1=32, batch=128,
                                                    **kw)),
}


def _build_for(monkeypatch, run, args):
    """Every kernel ``run`` launches, built up front in parallel: the CPlans
    its CPU run executes (the same CPlans as on the card)."""
    seen = {}
    orig = ops.execute

    def spy(cplan, env, *, kernels="never"):
        seen[cplan.cache_key()] = cplan
        return orig(cplan, env, kernels=kernels)

    monkeypatch.setattr(ops, "execute", spy)
    run(args, kernels="cuda", device="cpu")
    monkeypatch.undo()
    build.build_all({s.key: s for s in map(cuda_src.source_for,
                                            seen.values())}.values())


@pytest.mark.parametrize("name", sorted(ALGO_RUNS))
def test_algorithm_on_the_card_matches_never(card, monkeypatch, name):
    """``run(kernels="cuda")`` launches the kernels and its trace agrees
    with ``kernels="never"`` on the card to ``chip_smoke.py``'s 1e-5."""
    make, run = ALGO_RUNS[name]
    args = make()
    _build_for(monkeypatch, run, args)
    before = cellwise.launches + multiagg.launches + rowwise.launches
    _params, got = run(args, kernels="cuda", device="cuda")
    assert cellwise.launches + multiagg.launches + rowwise.launches > before
    _params, want = run(args, kernels="never", device="cuda")
    assert len(got) == len(want) > 1
    np.testing.assert_allclose(got, want, rtol=chip_smoke().TRACE_RTOL)


def test_kmeans_assignment_rows_sum_to_one_on_the_card(card):
    """The fused row minimum on the card is found again in torch's D: every
    row's tie-split assignment sums to 1, at C0 and after the run."""
    X, C0 = (t.to(card) for t in _clusters())
    C, _wcss = kmeans.run(X, C0, max_iter=5)
    assert bool(torch.isfinite(C).all())
    for Cs in (C0, C):
        missed, off = chip_smoke().kmeans_assignment(X, Cs)
        assert missed == 0 and off <= 4 * chip_smoke().EPS32


# --------------------------------------------------------------------------
# the request axis and the server on the card
# --------------------------------------------------------------------------

BATCH_CASES = [c for c in sweep.cases() if c.template in ("cell", "row",
                                                            "magg")]


@pytest.mark.parametrize("case", [pytest.param(c, id=c.name)
                                  for c in BATCH_CASES])
def test_batched_kernel_is_one_launch_per_request_within_the_limit(card,
                                                                   case):
    """Three requests in one launch of the request-axis kernel, each held
    to ``chip_smoke.py``'s limit against its plain version; a reducing
    batch repeats bit for bit."""
    cp, _names = sweep.fused_cplan(case, *SWEEP_SHAPES[0])
    gen = torch.Generator(device="cuda").manual_seed(5)
    env, _real = chip_smoke().batch_env(cp, 3, gen)
    mods = (cellwise, multiagg, rowwise)
    before = [m.batched_launches for m in mods]
    got = ops.execute_batched(cp, env, kernels="cuda")
    assert sum(m.batched_launches for m in mods) == sum(before) + 1
    err, share, _lo = chip_smoke().batch_measure(cp, env, got, case.name)
    assert share <= 1.0, f"max |kernel - plain| {err:.3e}, {share:.3g} x limit"
    if cp.variant != "no_agg":
        assert torch.equal(got, ops.execute_batched(cp, env, kernels="cuda"))


def test_fusion_server_on_the_card_matches_direct_calls(card):
    """Two requests of one class served as one batch on the card: one
    request-axis launch, results on the card equal to the direct calls."""
    from repro_torch.serve import FusionServer
    rng = np.random.default_rng(8)
    cases = [tuple(torch.tensor(rng.normal(size=s).astype(np.float32),
                                device="cuda")
                   for s in ((m, 12), (12, 1), (m, 1))) for m in (50, 61)]
    server = FusionServer(workers=1, max_batch=4, pad_to=64, autostart=False)
    server._started = True
    try:
        futs = [server.submit(l2svm._hinge, *args) for args in cases]
        before = rowwise.batched_launches
        server._started = False
        server.start()
        for args, f in zip(cases, futs):
            got = f.result(timeout=300)
            assert got.device.type == "cuda"
            torch.testing.assert_close(got, l2svm._hinge(*args), rtol=1e-5,
                                       atol=1e-5)
        assert rowwise.batched_launches == before + 1
        assert server.metrics.snapshot()["runtime_fallbacks"] == []
    finally:
        server.close()


@pytest.fixture(scope="module")
def lm_norm_card():
    """The card, with the LM rmsnorm's Row kernel (sound and planted, at
    minitron-4b's width) built."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    smoke = chip_smoke()
    srcs = [cuda_src.source_for(cp) for _l, cp in smoke.lm_norm_cplans()]
    build.build_all({s.key: s for s in srcs + [smoke.planted(s)
                                               for s in srcs]}.values())
    return smoke


def test_lm_fused_rmsnorm_at_width_3072_is_one_row_launch(lm_norm_card):
    """``models.layers.norm(fusion="gen")`` over 2,048 x 3,072 on the card
    is one Row launch, every element within the kernel limit of its plain
    version, and the planted fault in its row mean fails that limit."""
    smoke = lm_norm_card
    gen = torch.Generator(device="cuda").manual_seed(21)
    x = torch.randn((smoke.LM_SEQ, 3072), generator=gen, device="cuda")
    s = 0.1 * torch.randn((3072,), generator=gen, device="cuda")
    chk = smoke.lm_norm_check(x, s)
    assert chk["launches"] == {"cell": 0, "magg": 0, "row": 1, "outer": 0}
    assert chk["share"] <= 1.0 < chk["fault_share"]
    want = torch.nn.functional.rms_norm(x, (3072,), weight=1.0 + s,
                                        eps=1e-6)
    torch.testing.assert_close(chk["out"], want, rtol=1e-5, atol=1e-5)


def test_fused_loss_streams_on_the_card_and_matches_plain(card):
    """The fused softmax-CE loss at 32,000 columns (the CLI's 100m
    preset) over 512 rows: forward and planned backward each one Row
    launch in the staged layout (a row a CTA), within the kernel limit of
    the plain version, the same bits twice (no float atomics), and the
    gradient equal to softmax · g within 1e-6."""
    from repro_torch.core import fusion_mode
    from repro_torch.launch import train
    smoke = chip_smoke()
    srcs = [cuda_src.source_for(cp) for _l, cp in smoke.loss_cplans(32_000)]
    assert [s.layout for s in srcs] == ["staged", "staged"]
    build.build_all(srcs)
    gen = torch.Generator(device="cuda").manual_seed(22)
    x = 2.0 * torch.randn((512, 32_000), generator=gen, device="cuda")
    g = torch.randn((512, 1), generator=gen, device="cuda")
    rowwise.launches = 0
    with fusion_mode(kernels="cuda"):
        xr = x.clone().requires_grad_(True)
        lse = train._fused_lse(xr, "gen")
        (gx,) = torch.autograd.grad(lse, xr, g)
        again = train._fused_lse(x, "gen")
    torch.cuda.synchronize()
    assert rowwise.launches == 3
    assert torch.equal(lse.detach(), again)
    torch.testing.assert_close(lse.detach(),
                               torch.logsumexp(x, 1, keepdim=True),
                               rtol=1e-6, atol=1e-5)
    torch.testing.assert_close(gx, torch.softmax(x, 1) * g, rtol=1e-5,
                               atol=1e-6)
    for _l, cp in smoke.loss_cplans(32_000, rows=512):
        env = {b.nid: (x if b.nid == cp.main.nid else g) for b in cp.binds}
        _err, share = smoke.compare(cp, env, _l)
        assert share <= 1.0


@pytest.mark.parametrize("layout,cluster,V", [
    ("staged", 1, 6_000), ("staged", 4, 6_000), ("staged", 4, 6_001),
    ("stream", 0, 6_000)])
def test_wide_row_layouts_match_plain_on_the_card(card, layout, cluster, V):
    """The fused loss's forward and backward over 257 rows of V columns,
    built in the staged layout (one CTA a row, or a cluster of 4; at
    6,001 columns the scalar path) or the streaming layout: one launch
    each within the kernel limit of its plain version, the same bits
    twice, and the backward's request-axis form (3 requests) equal per
    request to the single call."""
    smoke = chip_smoke()
    gen = torch.Generator(device="cuda").manual_seed(23)
    L = 2.0 * torch.randn((3, 257, V), generator=gen, device="cuda")
    g = torch.randn((3, 257, 1), generator=gen, device="cuda")
    for label, cp in smoke.loss_cplans(V, rows=257):
        src = (cuda_src._staged_source(cp, cluster=cluster)
               if layout == "staged" else cuda_src._stream_source(cp))
        assert (src.layout, src.cluster) == (layout, cluster)
        build.build_all([src])
        orig = cuda_src.source_for
        cuda_src.source_for = lambda c, bs=None: src if c is cp else \
            orig(c, bs)
        try:
            env = {b.nid: (L[0] if b.nid == cp.main.nid else g[0])
                   for b in cp.binds}
            rowwise.launches = 0
            got = rowwise.row(cp, env)
            again = rowwise.row(cp, env)
            torch.cuda.synchronize()
            assert rowwise.launches == 2
            assert torch.equal(got, again)
            _err, share = smoke.compare(cp, env, f"{layout} {label}")
            assert share <= 1.0
            benv = {b.nid: (L if b.nid == cp.main.nid else g)
                    for b in cp.binds}
            batched = rowwise.row_batched(cp, benv)
            torch.cuda.synchronize()
            for q in range(3):
                one = rowwise.row(cp, {nid: t[q] for nid, t in benv.items()})
                assert torch.equal(batched[q], one), (label, q)
        finally:
            cuda_src.source_for = orig


def _wide_row_cplan(expr, m: int, V: int):
    from repro_torch.core import cplan, ir, select
    X = ir.matrix("X", (m, V))
    g = ir.Graph.build([expr(X)])
    p = select.plan(g, "gen")
    spec = [s for s in p.specs if getattr(s, "fused", False)][-1]
    return cplan.build_cplan(g, spec)


@pytest.mark.parametrize("V,cluster", [(32_768, 1), (65_536, 4)])
@pytest.mark.parametrize("name,expr", [
    ("row_agg", lambda X: ir_exp(X * 0.5).rowsums()),
    ("row_mean", lambda X: (X * X).rowmeans()),
    ("full_agg", lambda X: ir_exp(X - X.rowmaxs()).sum())])
def test_staged_row_and_full_aggregates_match_plain_on_the_card(
        card, name, expr, V, cluster):
    """The staged layout's row_agg (a value a row, written by rank 0) and
    full_agg (a partial a cluster, folded by rk::combine) over 301 rows
    in one CTA and in a cluster of 4: within the kernel limit of the plain
    version, the same bits twice."""
    smoke = chip_smoke()
    cp = _wide_row_cplan(expr, 301, V)
    src = cuda_src._staged_source(cp, cluster=cluster)
    assert src.layout == "staged"
    build.build_all([src])
    gen = torch.Generator(device="cuda").manual_seed(24)
    env = {cp.main.nid: torch.randn((301, V), generator=gen, device="cuda")}
    orig = cuda_src.source_for
    cuda_src.source_for = lambda c, bs=None: src if c is cp else orig(c, bs)
    try:
        got = rowwise.row(cp, env)
        torch.cuda.synchronize()
        assert torch.equal(got, rowwise.row(cp, env))
        _err, share = smoke.compare(cp, env, f"{name} {V}")
        assert share <= 1.0
    finally:
        cuda_src.source_for = orig


def ir_exp(x):
    from repro_torch.core import ir
    return ir.exp(x)


#: the weights-only backward's check: X is 80 MB, well under the cells'
WRT_SHAPE = (200_003, 100, 5)


@pytest.mark.parametrize("name,weights", [("l2svm/objective_full", "w"),
                                          ("mlogreg/nll_obj_reg", "B")])
def test_weights_only_backward_on_the_card(name, weights):
    """L2SVM's and MLogReg's objectives with only the weights requiring a
    gradient, as their ``run`` asks: the backward launches the generated
    Row and Cell kernels with no fallback, allocates less than a tenth of
    X's bytes beyond what the call held before it (no ∇X: the peak stays
    under X's bytes plus 10 %), its Row is within the kernel limit of its
    plain version, and the gradient matches the every-input plan's within
    the same limit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    smoke = chip_smoke()
    fn, shapes = regions(*WRT_SHAPE)[name]
    vals = inputs(shapes, seed=sum(map(ord, name)))
    compiled = fn.trace(**vals).plan(context=FusionContext(
        kernels="cuda", device="cuda")).compile()
    masked = compiled.planned.backward([weights])
    cps = compile_plan(masked.eplan).cplans()
    assert [(c.ttype.name, c.variant) for c in cps] == \
        [("ROW", "col_t_agg"), ("CELL", "no_agg")]
    every_cps = compile_plan(compiled.planned.backward().eplan).cplans()
    build.build_all({s.key: s for s in map(cuda_src.source_for,
                                            cps + every_cps)}.values())
    args = {k: torch.tensor(v, device="cuda", requires_grad=k == weights)
            for k, v in vals.items()}
    out = compiled(**args)
    torch.cuda.synchronize()
    x_bytes = args["X"].numel() * args["X"].element_size()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    before = (rowwise.launches, cellwise.launches)
    (got,) = torch.autograd.grad(out[0, 0], args[weights])
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    assert (rowwise.launches, cellwise.launches) == \
        (before[0] + 1, before[1] + 1)
    assert peak - held < 0.1 * x_bytes, (peak, held, x_bytes)
    assert compiled.explain()["execution"]["fallbacks"] == []
    # the every-input plan on the same operands
    every, grad_names, ct_names = compiled._get_bwd()
    binds = {k: v.detach() for k, v in args.items()}
    binds.update({n: torch.ones((1, 1), device="cuda") for n in ct_names})
    want = dict(zip(grad_names, every(binds)))[weights]
    # the Row against its plain version, and the gradients within its
    # limit (the Cell's λ·w term adds the rounding of |∇|)
    row, graph = cps[0], masked.eplan.graph
    env = {n.nid: binds[n.name] for n in graph.inputs()}
    lits = compile_plan(masked.eplan, device="cuda")._literals()
    for spec in masked.eplan.specs:       # the scalars the Row binds
        if _is_fused(spec):
            break
        node = graph.by_id[spec.root]
        env[node.nid] = _eval_basic(graph, node, env, lits)
    env = {b.nid: env[b.nid] for b in row.binds}
    _err, share = smoke.compare(row, env, f"{name} weights-only Row")
    assert share <= 1.0
    limit = smoke.KERNEL_ULPS * smoke.EPS32 * (
        smoke.error_scale(row, env) + want.abs())
    worst = float(((got - want).abs() / limit).max())
    assert worst <= 1.0, f"{worst:.3g} x the limit"
