#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

Run from the repository root on a machine with an NVIDIA H100 and the CUDA
toolkit:

    python3 chip_smoke.py   # L2SVM, MLogReg, GLM and KMeans on X
                            # 10,000,000 x 100, the autoencoder on
                            # 1,000,000 x 784 images, ALS-CG on a BCSR of
                            # 480,256 x 17,792 (the Netflix shape)
    python3 chip_smoke.py --times   # only the main paths' profiles and
                                    # per-CPlan times, no checks: copied
                                    # into another checkout, it measures
                                    # that tree's package the same way
    python3 chip_smoke.py --lm-times   # only [lm]'s prefill, decode and
                                       # Engine.step() readings, likewise
    python3 chip_smoke.py --lm-train   # only [lm-train] (no result line)
    python3 chip_smoke.py --attn   # only [attn] (no result line)
    python3 chip_smoke.py --lm   # only [attn] and [lm] .. [lm-xlstm],
                                 # then the attention kernel's entry
    python3 chip_smoke.py --lm-sharded   # only [lm-sharded] and
                                         # [examples] (no result line)
    python3 chip_smoke.py --lm-train-sharded   # only [lm-train-sharded]
                                               # (no result line)
    python3 chip_smoke.py --dist   # only [dist], against the single-device
                                   # L2SVM and MLogReg traces it is held
                                   # to (no result line)

Phases, each reported on its own lines with its wall time:

1. environment: torch / CUDA versions, the card's name and power limit,
   TF32 switched off for matmuls and cuDNN;
2. build: every kernel this run launches is generated from its CPlan and
   compiled with nvcc, all builds started together;
3. kernels vs plain: every variant of the Cell, MAgg and Row kernels
   (CPlans from the port's planner, ``repro_torch.kernels.sweep``) at a
   ragged shape, at an (m,1) main and at the main path's width, each held
   against its plain PyTorch version on the same CUDA tensors, and the
   Cell kernel over (m,1) domains at m of 1, 3, 5, 7, 33, 1,023 and
   2,000,003 (and (m,4) ones with a (1,4) side), so that every part of its
   vector walk runs; then a fault planted in the kernels' ordered fold
   (the middle partial is dropped, in the Cell kernel's own fold or in
   ``rk::combine``; in a Row ``row_agg``, the middle element of every row,
   or in the warp layout the middle lane's partial; in a tile-layout Row
   ``col_t_agg`` also the middle row slice of each CTA) and one in the
   Cell vector walk (the second cell of every group dropped) must fail the
   same check at 2,000,003 rows; every reducing Cell case gives the same
   bits twice, and a Cell operand off a 16-byte boundary raises; each Row
   line names its layout (tile or warp), each Cell line its walk (vec or
   scal);
4. the main path's own CPlans at the main path's shapes, against plain
   (a reducing Cell CPlan also run twice for the same bits);
5. the main path: ``repro_torch.algos.l2svm.run`` for 5 iterations on
   X (m,100) fp32 with ``kernels="cuda"``, launch counters set to 0 just
   before it and read just after; the same run with ``kernels="never"``
   and the hand-written torch baseline must give the same objective trace,
   and a run with the planted fault must not; one more run under
   ``torch.profiler`` splits the device time by kernel; then
   ``repro_torch.core.fuse_exprs`` over L2SVM's regions hand-built with
   ``ir.matrix`` (the hinge, the objective, the line search's two sums,
   Σw² and the hand-derived gradient) on the same X, y and the trained w,
   counters set to 0 just before each call and read just after: equal to
   the ``@fused`` staged path's on the same bindings bit for bit, every
   fused step within the kernel limit of its plain version, a one-step
   region's outputs held to ``kernels="never"``'s the same way and a
   multi-step region's within TRACE_RTOL of them, and the objective with
   the planted fold fault leaving TRACE_RTOL;
6. timing: per main-path CPlan, the kernel's and its plain version's
   median time with CUDA events, beside the bound (bytes over 3.35 TB/s or
   fp32 flops over 67 TFLOP/s, the larger), with the kernels one call
   launched in the profiler (a Cell call must be one Cell kernel) and, for
   a Cell CPlan of 10⁶ cells or more, its SASS instructions per cell and
   the issue floor they give (``[sass]``);
7. ALS-CG: the Outer kernel's sweep (``right_mm`` / ``full_agg`` over BCSR
   mains, ``repro_torch.kernels.sweep.outer_cases``) against its plain
   version, with planted faults that must fail (``right_mm`` skips the
   middle block of every block row; ``full_agg`` drops a partial; the
   ``right_mm`` fold drops the middle piece of every row cut into pieces,
   on the long-row cases); a BCSR
   shaped like the paper's Netflix matrix (480,189 x 17,770 padded to
   480,256 x 17,792, bs 128, block density 0.25, planted rank 8, noise
   0.1) built on the card from a seeded ``torch.Generator``; the ALS
   CPlans at that shape against plain (the V update's also with the fold
   fault planted, which must fail); ``repro_torch.algos.als_cg.run``
   (rank 20, 6 outer x 5 inner iterations) with ``kernels="cuda"``,
   counters set to 0 just before it, its loss trace against
   ``kernels="never"`` and against a planted-fault run; the dense-mask
   hand baseline at a reduced 12,800 x 8,192; a profile; per-CPlan times
   (U update, V update, loss) beside their bounds; then ``_wsq_mm``
   hand-built with a BCSR leaf through ``fuse_exprs`` once, equal to the
   ``@fused`` path bit for bit, within the kernel limit, and with the
   planted middle-block fault over it;
8.-11. MLogReg (k = 5, 3 x 3 Newton-CG iterations), GLM (binomial
   probit, 3 x 3 IRLS-CG iterations), KMeans (k = 5, 5 iterations) on X
   (m,100) fp32, and the autoencoder (784-500-2-500-784, batch 512, 20
   SGD steps) on (1,000,000, 784) images, each with its data drawn on the
   card from a seeded ``torch.Generator``: ``run(kernels="cuda")`` with
   the counters set to 0 just before it and read just after (every kernel
   its CPlans route to must have launched), its trace against
   ``kernels="never"`` (1e-5) and against a planted-fault run (must fail),
   the hand baseline (the reference's 2e-2), KMeans' assignment rows
   summing to 1, a profile, then its CPlans at its shapes against plain
   (reducing Cell CPlans twice, bit for bit; GLM's Cell CPlans also with
   the planted group fault, which must fail) and timed beside their
   bounds;
12. ``[batch]``: the request-axis forms of the Cell, Row and MAgg kernels
   (``ops.execute_batched``, one launch per batch): every sweep case at
   B = 1, 3 and 8 requests of (1,031, 7) and (200,003, 100) classes, each
   request's real rows fewer than the class's (the rows past them zero),
   held per request to the kernel limit against its plain version;
   reducing cases twice for the same bits; a planted fault that makes
   every request read request 0's side inputs (their strides set to 0)
   and the per-request fold fault must fail; then the hinge, softmax,
   sum-of-squares (Cell) and two-sums (MAgg) regions at 8 requests of
   1,048,576 x 100, checked and timed beside their bounds;
13. ``[cla]``: X 10,000,000 x 100 with 64 levels a column, compressed on
   the card; a qualifying sum (the CLA path, no kernel) against the same
   region on the dense X, and a non-qualifying one (a side matrix) that
   densifies and launches the dense kernels, bit for bit;
14. ``[serve]``: the reference's serving harness verbatim
   (``benchmarks/serving.py``: 32 clients x 8 requests, rows 115 / 240 /
   490, 64 features, k = 5, pad_to 128, max_batch 8, 2 workers, warmed at
   every power-of-two batch), every case against its direct call (1e-5),
   launch counters set to 0 just before the load and read just after
   (request-axis launches = batches x fused CPlans), no runtime fallback;
   the same load at max_batch 1; the pad-safe aggregates at the same rows
   (the Cell and MAgg request-axis kernels); throughput, p50 / p95 / p99,
   occupancy;
15. ``[serve-wide]``: the same at the main path's width (100 features,
   rows 250,000 / 500,000 / 1,000,000 in classes of 262,144, 8 clients x
   4 requests), one batched dispatch profiled;
16. ``[chaos]``: a seeded schedule over ``serve.batch_dispatch`` (error,
   nonfinite) and ``serve.worker`` (crash) on the card: no request lost,
   every result equal to the direct call, the ladder's counters;
17. ``[dist]``: distributed segments on ``Mesh({"data": 4})``: 4 rank
   processes of this script (``--dist-rank``) on the one card over gloo
   (NCCL refuses two ranks on one device; gloo takes CUDA tensors through
   host memory), ``file://`` rendezvous in a temporary directory, a 120 s
   process-group timeout, and a deadline after which every rank is
   killed; every kernel they launch is built here first.  Each rank runs
   ``l2svm.run`` (5 iterations) and ``mlogreg.run`` (3 x 3) on the whole X
   10,000,000 x 100 with ``layout=mesh`` — traces held to this process's
   single-device ``kernels="cuda"`` traces and to the mesh's
   ``kernels="never"`` ones (1e-5), every Row and MAgg launch on a
   2,500,000-row panel, ≥ 1 distributed operator, no fallback — then the
   reference's 6-operand segment program at 4,000,000 x 64 (one segment
   step of ≥ 2 members, each exported output within the kernel limit of
   its member's plain version on whole operands) and ALS's ``right_mm``
   over the Netflix-shaped BCSR (938 block rows a rank, held to the
   single-device Outer kernel); planted faults that must fail: an
   all-reduce skipped and rank 1's panel dropped from an all-gather (the
   segment program), and the Row fold under the mesh (L2SVM, 2
   iterations); every panel call run again one rank at a time as the
   CPlan of its panel, held to its plain version on the same panel within
   the kernel limit per element and timed beside its panel bound (device
   ms from CUDA events queued behind a spin kernel, the profiler's, and
   the call's CUDA-event ms), and the collectives' wall time; then
   ``fuse_exprs`` of the hand-built hinge under ``fusion_mode(layout=
   mesh)`` (its Row launch on the rank's 2,500,000-row panel, equal to
   the staged ``_hinge.trace(...).plan(layout=mesh)`` path bit for bit,
   rank 1's panel dropped from the all-gather failing the kernel limit)
   and the fused loss ``launch.train._ce`` under ``TrainConfig(fusion=
   "gen", fusion_layout=mesh)`` over 512 x 256,000 fp32 logits (the
   [lm-train-sharded] batch over minitron-4b's vocabulary): the Row
   kernel's staged layout launched once each way on the rank's 128 rows,
   loss and gradient within 1e-5 of local planning's and of
   ``kernels="never"``'s, the planted staged-chunk fault leaving that,
   each panel timed beside its bound, its plain version and the library
   call (``torch.logsumexp``; ``softmax`` then ``mul_``);
18.-21. first ``[attn]``: the attention kernel
   (``kernels.attention.flash``, ``csrc/attn.cuh``) forward and backward
   on card tensors at the LM benchmark cell's shapes
   (``portbench/configs/mellum2-12b-ep8.json``: 32 query heads over 4 KV
   heads of 128, 8,192 tokens, window 1,024 and full) and at gemma3-27b's
   head shape (32 over 16 heads of 168, 2,048 tokens), out, dq, dk and dv
   each within ATTN_RTOL of max |x| of the torch block loop
   ``models.attention._chunked_attention`` (autograd through it) on the
   same tensors, a planted fault (the kernel's output of the last query
   block left out) that must fail, and the kernel's forward and forward +
   backward device times at the cell's micro-batch of 8 sequences beside
   the bound ``portbench.lmwork`` gives (the visible pairs' operations at
   the fp32 peak), and each build's ptxas register and spill lines; the
   kernel's launch counters set to 0 just after it.
   Then ``[lm]``, ``[lm-moe]``, ``[lm-hybrid]``, ``[lm-xlstm]``: the LM
   serving path, one phase a model of ``LM_ARCHS``: minitron-4b at full
   width for 8 of its 32 attention layers (d_model 3,072, vocab 256,000;
   the whole model is 4,190,306,304 parameters), olmoe-1b-7b at full
   width for 4 of its 16 layers (64 experts top-8, dense MoE; the whole
   model is 6,919,096,320 parameters),
   jamba-v0.1-52b at full width for one period of 8 of its 32 layers (7
   Mamba + 1 attention, MoE 16 experts top-2 on the odd layers:
   13,265,932,288 parameters; the whole model is 103 GB in bf16) and
   xlstm-1.3b at full width for 4 of its 48 mLSTM layers (4 heads of
   1,024; the whole model is 3,831,597,056 parameters), each
   drawn on the card from a seeded
   ``torch.Generator`` in bf16 and, after the bf16 model is freed, in
   fp32 of the same draws.  Each: ``serve.Engine`` (4 slots) serves its
   requests through its queue (minitron 2,048 / 777 / 512 / 33 / 1
   prompt tokens, olmoe and jamba 2,048 / 777 / 512 / 33, 32 new each;
   xlstm 512 / 129 / 33 / 1, 16 new; then the second prompt again, in a
   reused slot) token for token equal to direct ``LM.apply`` +
   ``decode_step`` runs from a zero state, the reused slot's equal to the
   fresh slot's; ``models.layers.norm(fusion="gen")`` over layer 0's
   input (2,048 x 3,072, x 2,048 or x 4,096 fp32) with the counters set
   to 0 just before it and read just after: exactly one Row launch, no
   fallback, in the Row kernel's staged layout, every element within the
   kernel limit of its plain version, the same bits twice, a planted
   fault (the middle chunk of each row never copied into shared memory)
   that must fail, its time beside its bound and ``F.rms_norm``, and the
   build's ptxas register and spill lines; prefill and decode ms beside
   their bounds (the weights the
   implementation reads, dense MoE reading every expert, and the active
   weights) and the host share of one profiled ``Engine.step()``; fp32
   ``decode_step`` logits over the last 8 positions (of 2,048; xlstm 136)
   within 1e-4 of max |logit| of the full forward's, with planted faults
   at the first decode step that must fail (K/V written at pos + 1, the
   Mamba / mLSTM state left unwritten, the MoE top gate zeroed), the MoE
   layers pinned to the full forward's experts and a token whose own
   top-k differs allowed only where the full forward's k-th and (k+1)-th
   probabilities are within 1e-5; xlstm's check held to 1e-4 in fp64 and
   in fp32 to twice its fp32 rounding floor (1e-4 where that is larger);
   minitron: layer 0's attention chunked (1,024) against dense within
   1e-5 (fp32), bf16 against fp32 prefill logits (recorded); for the MoE
   models one full-width MoE layer in fp32 through ``dense``, ``ragged``
   and ``capacity`` (factor E/k: nothing dropped) within 1e-5, and the
   pairs a factor of 1.0 drops; peak device memory and wall time per
   phase;
22. ``[lm-train]``: LM training, after the serving phases, the card's
   cache emptied first.  The fused softmax-CE loss alone (the
   ``launch.train._lse`` Row CPlans, forward and planned backward) over
   2,048 rows of logits N(0, 2²) at every configuration's vocabulary width
   (2,048, 32,000 (the CLI's 100m preset), 49,152, 50,304, 64,000, 65,536,
   131,072, 256,000 and 262,144), each held to its plain version on the
   same CUDA tensors within the kernel limit and run twice for the same
   bits, with its layout and cluster named (the Row kernel's staged
   layout: one CTA a row up to 50,304, a cluster of 4 / 8 / 16 CTAs
   beyond; at 2,048 the forward's tile layout and the backward staged),
   its build's ptxas register and spill line, two planted faults at
   256,000 that must fail (the middle chunk of each CTA's slice never
   copied; rank 8's partial left out of the cluster fold), the kernel's,
   plain version's and library calls' device times (``torch.logsumexp``;
   for the backward ``torch.softmax`` then ``mul_``) beside the bound; the
   same checks and times at the main paths' own shapes, 256 x 256,000
   (the steps below) and 4,096 x 32,000 (the CLI's), and at 256 x
   1,048,576, rows wider than a cluster holds, in the streaming layout
   with its planted fault (the middle column slice of the last fold pass
   dropped); the ptxas lines of the rmsnorm's warp-layout build at 256
   to 4,096 columns (``cuda_src.WARP_FLOATS_MAX``); minitron-4b at full
   width in fp32 with its depth cut to 2 layers: 3 steps of
   ``make_train_step`` (fusion "gen", batch 2 x 128) with
   ``kernels="cuda"`` against ``kernels="never"`` (loss and grad-norm
   traces within 1e-5 relative, 2 Row launches a step) and a
   planted-fault run that must fail; minitron-4b at full width and depth
   in bf16 (4.19e9 parameters, fp32 AdamW moments) for 3 steps through
   ``run_loop`` and ``ShardedLoader``: finite losses, 2 Row launches a
   step, the median step beside its bound (6 N T bf16 FLOP at the tensor
   cores' peak + AdamW's 22 bytes a parameter at HBM bandwidth), tokens a
   second, peak memory and the host share of one more, profiled step;
   then ``python -m repro_torch.launch.train`` at
   ``examples/train_lm.py``'s configuration (minitron-4b ``--preset
   100m --batch 8 --seq 512 --fusion gen``) for 10 steps with a checkpoint
   every 5, the step-10 checkpoint removed and a second process
   ``--resume``-d from step 5, its losses for steps 6-10 against the
   uninterrupted run's (bit for bit, or within 1e-6 relative: the line
   says which);
23. ``[lm-sharded]``: sharded LM serving, ``serve.Engine(mesh=
   Mesh({"data": 2, "model": 2}))`` in 4 rank processes of this script
   (``--lm-sharded-rank``) on the one card over gloo, fp32, three runs
   (SHARDED_RUNS): minitron-4b at full width for 8 of its 32 layers
   and olmoe-1b-7b at full width for 4 of its 16 layers (64 experts,
   expert-parallel over ``model``),
   each with ``layout="fixed"``, and xlstm-1.3b at full width for 2 of
   its 48 layers with ``layout="auto"`` and the planner's
   ``serve_params`` forced off (every FSDP-sharded leaf gathered over
   ``data`` before each use, a data block running a forward for each
   slot its peer serves); the weights drawn on the card tile by tile
   from seeded generators, each rank building the model on the meta
   device and drawing only the tiles of its blocks; first a one-rank
   ``Engine`` on the card with the same weights (drawn whole) serves the
   same requests (fixed runs: six of 2,048 / 96 / 33 / 17 / 5 / 33
   prompt tokens, 8 new each, 4 slots, the 2,048-token prompt prefilled
   through chunked attention; the FSDP run three of 33 / 17 / 5, 4 new);
   every rank's tokens equal to each other's and to the one-rank
   engine's (a token may differ only where the one-rank run's top-2
   margin is within 2 x SHARDED_RTOL of max |logit|), the prefill and
   four teacher-forced decode logits of the 33-token prompt and of the
   2,048-token one within SHARDED_RTOL (1e-5) of max |logit| of the
   one-rank engine's (olmoe's MoE layers pinned to the one-rank engine's
   experts, a routing flip allowed only at a near-tie, LM_TIE, and the
   unpinned error recorded: 2,048 tokens through 16 layers make 32,768
   top-8 choices, and another summation order flips a near-tie among
   them), its
   stored parameter and cache bytes equal to the layout planner's
   ``_tree_accounting``; of each fixed run also four requests sampled
   at temperature 1 equal to the one-rank engine's samples (same seed),
   a planted fault (rank 1 keeps its partial sums of layer 0's attention
   output) that must fail the logits check, the planner's own layout for
   the cell, and prefill (2,048 tokens) and decode ms, collectives a
   token and a step and their wall ms, Engine.step() walls and the host
   share of a profiled step, with the card's name and power limit; the
   collectives of a decode token equal to what the dry-run
   (``launch.dryrun_lib`` on ``meta`` under a ``RecordingMesh``)
   records for that step;
24. ``[lm-train-sharded]``: sharded training,
   ``launch.train.make_train_step(mesh=Mesh({"data": 2, "model": 2}))``
   in 4 rank processes of this script (``--lm-train-sharded-rank``) on
   the one card over gloo, each global batch 4 x 128 tokens: (a)
   minitron-4b at full width, 2 layers, fp32, fusion "gen", 3 steps
   against the one-rank step on the card from the same weights and
   batches (loss and grad-norm traces within 1e-5 relative; every rank's
   updated blocks within 1e-5 of max |p| of the one-rank run's wherever
   its first moment is at least 1e-3 of its largest; 2 Row launches a
   step on each rank; rank 1 leaving its part out of one FSDP
   reduce-scatter must fail); (b) olmoe-1b-7b at full width, 2 layers,
   ``moe_impl="a2a"`` (32 experts a rank, one all-to-all each way a
   layer), fp32, 2 steps against one rank dispatching each data block
   at its own capacity; (c) minitron-4b at full width and depth, bf16
   weights, fp32 AdamW moments, 2 steps (the second profiled): finite
   losses, each rank's stored bytes and collectives a step equal to the
   dry-run's for the same cell (run on the CPU meanwhile), peak memory
   beside the dry-run's arguments + temporaries, step ms, collectives
   ms, host share; the fused loss's Row kernel held to its plain version
   at a rank's 256 x 256,000;
25. ``[examples]``: ``examples/quickstart_torch.py``,
   ``als_recommender_torch.py`` and ``serve_lm_torch.py`` on the card at
   their default sizes, each in a process of its own ending in its own
   asserts (``train_lm_torch.py``'s configuration is [lm-train]'s CLI
   run);
26. one JSON line with every kernel (launches and times summed over the
   single-device paths; the request-axis forms with their serving
   launches and their times at 8 x 1,048,576 x 100; a ``dist`` record per
   kernel with the [dist] ranks' own launches, its worst panel check and
   its panel times; ``row_rmsnorm``, the Row kernel's fused-rmsnorm call
   of [lm], and ``row_rmsnorm_lm_moe`` / ``_lm_hybrid`` / ``_lm_xlstm``,
   its calls at 2,048 and 4,096 columns with each phase's prefill and
   decode times; ``row_loss`` / ``row_loss_vjp``, the fused loss's forward
   and backward at 256,000 columns in the staged layout, launches from
   [lm-train]'s full-size run, a part at every width;
   ``attn``, the attention kernel: [attn]'s worst check and times, its
   forward and backward launches counted over [lm], [lm-moe], [lm-hybrid]
   and [lm-xlstm] (every 2,048-token prefill of a transformer layer);
   ``row_loss_sharded`` / ``row_loss_vjp_sharded``, the same at a rank's
   256 x 256,000 of [lm-train-sharded], launches from its full-depth
   run; ``row_loss_panel`` / ``row_loss_vjp_panel``, the same over a
   rank's 128-row panel under ``fusion_layout=mesh`` in [dist], launches
   from every rank's counted run; each of the four kernels'
   ``fuse_exprs_launches``, the launches of the main-path and [als]
   ``fuse_exprs`` checks), the card line, and the final
   ``{"ok": true, ...}`` line.

Any failed check raises; the script then prints the traceback and exits 1
without a result line.  It imports nothing of JAX or of ``repro``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import statistics
import subprocess
import sys
import time
import traceback
from pathlib import Path
from typing import Callable, NamedTuple

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

N_MAIN = 100                 # the repo's L2SVM width (docs/architecture.md)
M_MAIN = 10_000_000          # rows: X is 4.0 GB fp32
M_SWEEP = 2_000_003          # sweep rows at the main path's width (ragged)
ITERS = 5
HBM_BW = 3.35e12             # H100 SXM HBM3, B/s (datasheet)
FP32_PEAK = 67e12            # H100 SXM fp32 outside the tensor cores, FLOP/s
EPS32 = 2.0 ** -23            # fp32 machine epsilon
#: kernel vs plain, per output element: |got - plain| <= KERNEL_ULPS *
#: EPS32 * scale, where scale is a first-order bound of the plain
#: computation's rounding (error_scale).  Both sides are fp32 and sum in
#: different orders; a sum of non-negative terms that lost one of its P
#: partials is off by about its value / P (P is in the thousands at the
#: sweep's 2,000,003 rows), far above the limit
KERNEL_ULPS = 16
#: objective and loss traces (kernels / torch-eager / hand torch):
#: relative; L2SVM's line search and ALS-CG's CG steps carry
#: reduction-order differences over the iterations
TRACE_RTOL = 1e-5
#: sweep cases at M_SWEEP rows whose planted fault (one partial dropped,
#: in the Cell kernel's own fold or in rk::combine; for a Row row_agg, the middle element of every row in the tile layout,
#: the middle lane's partial in the warp layout; for a tile-layout
#: col_t_agg also the middle row slice's partial of each CTA) must fail the
#: kernel check: sums of non-negative terms (Cell: one in each walk; one
#: per other kernel), a row sum of
#: four terms, and the tile layout's row minimum over (m,5) and MLogReg's
#: Hessian-vector close
PLANTED = ("cell/full_agg_abs_sum", "cell/full_agg_row_side",
           "magg/k3_min_mean_sum", "row/full_agg",
           "row/row_agg_sum", "row/row_agg_min_w5", "row/col_t_agg_hvp_mm5",
           "outer/right_mm_bs128_r20_d1.0", "outer/full_agg_loss")
PLANT = "#define RK_PLANTED_FAULT 1\n"
#: Outer cases whose planted fold fault (the middle piece of every row of
#: two or more pieces dropped) must fail the kernel check; the main path's
#: V update must fail it too
PLANTED_FOLD = ("outer/right_mm_long_rows_bs16",
                "outer/right_mm_long_rows_bs128")
PLANT_FOLD = "#define RK_PLANTED_FOLD 1\n"
#: Cell cases in the vector walk at M_SWEEP rows whose planted group fault
#: (the second cell of every four-cell group dropped: no_agg stores 0, a
#: reduction leaves it out) must fail the kernel check; the GLM path's
#: Cell CPlans must fail it too
PLANTED_GROUP = ("cell/no_agg_row_side", "cell/full_agg_row_side")
PLANT_GROUP = "#define RK_PLANTED_GROUP 1\n"
#: the Row staged layout's second planted fault: the cluster fold leaves
#: out rank K / 2's partial (sources of a cluster of 2 or more)
PLANT_RANK = "#define RK_PLANTED_RANK 1\n"
#: row counts the Cell kernel is held to plain at over an (m,1) domain,
#: so that its vector walk's last round and its cells past the last group
#: are reached (m·N of 1, 3, 5, 7, 33, 1,023 and M_SWEEP), and the (1,4)
#: side cases' row counts (m·N four times these)
TAIL_ROWS = (1, 3, 5, 7, 33, 1023, M_SWEEP)

#: ALS-CG main path: the Netflix ratings shape (480,189 users x 17,770
#: movies) padded to the block size, block density 0.25 (data.ratings'
#: default), planted rank 8, noise 0.1; rank 20, 6 outer x 5 inner
ALS_SHAPE = (480_189, 17_770)
ALS_BS = 128
ALS_DENSITY = 0.25
ALS_RANK = 20
ALS_ITERS = 6
ALS_INNER = 5
#: the dense-mask hand baseline densifies X (34 GB at the full shape): it
#: runs at this reduced shape, beside the gen path on the same matrix
ALS_HAND_SHAPE = (12_800, 8_192)
#: hand vs gen ALS trace: the reference's own tolerance between its hand
#: baseline and the fused path (tests/test_algos.py, 5e-2)
ALS_HAND_RTOL = 5e-2

#: the paper's other dense algorithms, at the L2SVM width (N_MAIN columns;
#: M_MAIN rows for MLogReg, GLM and KMeans); depth cut from the reference's
#: defaults, each cut logged with its phase.  The CG solves stop at 3
#: steps: on this white X the Hessian is near a multiple of the identity,
#: ||r||² falls ~10⁵-fold a step and reaches the fp32 floor of r's updates
#: by the third, while the reference's break rule (||r||² < 1e-12,
#: absolute) never fires at 10⁷ rows; the steps after it work on rounding
#: noise, p·Hp turns negative and the iterate becomes NaN, with the
#: kernels and with torch-eager alike (ROADMAP queue C)
LAM = 1e-3
MLR_K, MLR_OUTER, MLR_INNER = 5, 3, 3        # reference: 10 outer x 20 inner
GLM_OUTER, GLM_INNER = 3, 3                  # reference: 8 outer x 10 inner
KM_K, KM_ITERS = 5, 5                        # reference: 20 iterations
#: the autoencoder: MNIST-shaped images at density 0.25 (data.images), the
#: paper configuration H1 500, H2 2, batch 512; 20 SGD steps, not an epoch
AE_ROWS, AE_N = 1_000_000, 784
AE_H1, AE_H2, AE_BATCH, AE_STEPS = 500, 2, 512, 20
#: hand baseline vs the planned path on the four: the reference's own
#: tolerance between its hand-written baseline and its fused arms
#: (tests/test_algos.py, 2e-2)
HAND_RTOL = 2e-2

KERNELS = {   # name -> (skeleton source, the TPU kernel it replaces)
    "cell": ("src/repro_torch/kernels/csrc/cell.cuh",
             "src/repro/kernels/cellwise.py:55"),
    "magg": ("src/repro_torch/kernels/csrc/magg.cuh",
             "src/repro/kernels/multiagg.py:20"),
    "row": ("src/repro_torch/kernels/csrc/row.cuh",
            "src/repro/kernels/rowwise.py:25"),
    "outer": ("src/repro_torch/kernels/csrc/outer.cuh",
              "src/repro/kernels/outerprod.py:31"),
}


#: the Row kernel's staged layout (the fused loss, the rmsnorm) and its
#: streaming layout (rows wider than a cluster holds), in row.cuh's
#: row_launch
STAGED_SKELETON = "src/repro_torch/kernels/csrc/row_staged.cuh"
STREAM_SKELETON = "src/repro_torch/kernels/csrc/row_stream.cuh"


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60, check=True)
    return r.stdout.strip().splitlines()[0]


# --------------------------------------------------------------------------
# helpers
# --------------------------------------------------------------------------

def region_cplans(entries, prefix: str = "", layout=None):
    """CPlans of fused regions planned on shapes alone (meta tensors), in
    order: [(label, cplan)], each region's planned backward after its
    forward where ``entries`` (region, args, backward) asks for it:
    ``True`` for every input's gradient; the names of the inputs the
    algorithm differentiates add their backward's CPlans that the
    every-input one lacks (``:vjp[names]``); planned under ``layout``
    where given."""
    from repro_torch.core import FusionContext
    from repro_torch.core.codegen import compile_plan
    out = []
    with FusionContext(layout=layout):
        for region, args, bwd in entries:
            planned = region.trace(*args).plan()
            label = prefix + region.fn.__name__
            out += [(label, cp)
                    for cp in compile_plan(planned.eplan).cplans()]
            if not bwd:
                continue
            every = compile_plan(planned.backward().eplan).cplans()
            out += [(label + ":vjp", cp) for cp in every]
            if bwd is not True:
                have = {cp.cache_key() for cp in every}
                out += [(f"{label}:vjp[{','.join(bwd)}]", cp) for cp in
                        compile_plan(planned.backward(bwd).eplan).cplans()
                        if cp.cache_key() not in have]
    return out


def meta(*shape):
    import torch
    return torch.empty(shape, device="meta")


def main_path_cplans(m: int, n: int):
    """CPlans of one L2SVM iteration, in order: hinge, search terms, the
    objective forward and its planned backward, of every input and of w
    (the one ``l2svm.run`` runs)."""
    from repro_torch.algos import l2svm
    X, w, col, lam = meta(m, n), meta(n, 1), meta(m, 1), meta(1, 1)
    return region_cplans([(l2svm._hinge, (X, w, col), False),
                          (l2svm._search_terms, (col, col), False),
                          (l2svm._objective_full, (X, w, col, lam), ("w",))])


# --------------------------------------------------------------------------
# fuse_exprs: the one-shot entry point over hand-built regions
# --------------------------------------------------------------------------

def fuse_exprs_regions():
    """L2SVM's main-path regions as ``(label, @fused region)``: each is
    also hand-built with ``ir.matrix`` for ``fuse_exprs`` (:func:`hand_built`)
    — the hinge, the objective, the line search's two sums, Σw² and the
    hand-derived gradient (whose λw step is a Cell CPlan)."""
    from repro_torch.algos import l2svm
    from repro_torch.core import fused
    return [("hinge", l2svm._hinge), ("objective", l2svm._objective_full),
            ("search_terms", l2svm._search_terms),
            ("sum_sq", fused(lambda w: (w ** 2).sum())),
            ("gradient", l2svm._grad)]


def l2svm_shapes(m: int, n: int) -> dict:
    """Every operand name of :func:`fuse_exprs_regions` and its shape."""
    return {"X": (m, n), "w": (n, 1), "y": (m, 1), "lam": (1, 1),
            "out": (m, 1), "yXs": (m, 1)}


def hand_built(region, shapes: dict, sparsity: dict | None = None):
    """``region``'s expression over ``ir.matrix`` leaves of ``shapes``
    (name -> shape), as a user builds it for ``fuse_exprs``: one output,
    or a list of them."""
    from repro_torch.core import ir
    outs = region.fn(**{n: ir.matrix(n, tuple(shapes[n]), sparsity=(
        sparsity or {}).get(n, 1.0)) for n in region.names})
    return list(outs) if isinstance(outs, tuple) else outs


def fuse_exprs_cplans(m: int, n: int):
    """[(label, cplan)] of every :func:`fuse_exprs_regions` region at
    (m, n), planned as ``fuse_exprs`` plans them (the scoped context's
    mode and cost parameters, no rewrite sweep)."""
    from repro_torch.core import current_context, ir
    from repro_torch.core.codegen import compile_plan
    from repro_torch.core.select import plan as plan_graph
    ctx, shapes = current_context(), l2svm_shapes(m, n)
    out = []
    for label, region in fuse_exprs_regions():
        exprs = hand_built(region, shapes)
        graph = ir.Graph.build(exprs if isinstance(exprs, list) else [exprs])
        eplan = plan_graph(graph, ctx.mode, ctx.params)
        out += [(label, cp) for cp in compile_plan(eplan).cplans()]
    return out


@contextlib.contextmanager
def captured_plans():
    """Every ``CompiledPlan`` that ``fuse_exprs`` compiles inside the
    block, in order (``core.api.compile_plan`` wrapped)."""
    from repro_torch.core import api
    seen, real = [], api.compile_plan

    def spy(*args, **kw):
        seen.append(real(*args, **kw))
        return seen[-1]

    api.compile_plan = spy
    try:
        yield seen
    finally:
        api.compile_plan = real


def as_tuple(x) -> tuple:
    return x if isinstance(x, tuple) else (x,)


def plan_step_checks(cplan_obj, binds: dict, label: str) -> list:
    """Each fused step of a compiled plan held to its kernel on the plan's
    own plain values (every step run in order with ``kernels="never"``):
    :func:`compare`, within the kernel limit per element.  Returns
    [(kernel, cplan, max |error|, share of the limit)]."""
    from repro_torch.core.codegen import _eval_basic
    from repro_torch.kernels import ops
    graph = cplan_obj.plan.graph
    _in, _out, steps, _free, _seg = cplan_obj._steps()
    lits = cplan_obj._literals()
    env = {n.nid: binds[n.name] for n in graph.inputs()}
    env.update(lits)
    out = []
    for step in steps:
        if step[0] == "basic":
            env[step[1].nid] = _eval_basic(graph, step[1], env, lits)
            continue
        _kind, cp, bind_nids, roots = step
        senv = {nid: env[nid] for nid in bind_nids}
        kname = "outer" if cp.ttype.name == "OUTER" else kernel_name(cp)
        err, share = compare(cp, senv, f"{label} {kname} {cp.variant}")
        out.append((kname, cp, err, share))
        val = ops.execute(cp, senv, kernels="never")
        if len(roots) > 1:
            for k, r in enumerate(roots):
                env[r] = val[k].reshape(1, 1)
        else:
            env[roots[0]] = val
    return out


def out_rel(outs, refs) -> float:
    """Largest relative difference of two tuples of outputs, each output's
    largest |difference| over its reference's largest |value|; infinite
    when their number or shapes differ or a value is not finite."""
    if len(outs) != len(refs) or any(a.shape != c.shape
                                     for a, c in zip(outs, refs)):
        return math.inf
    rels = [float((a - c).abs().max()) / max(float(c.abs().max()), 1e-30)
            for a, c in zip(outs, refs)]
    return max(rels) if all(math.isfinite(r) for r in rels) else math.inf


def fuse_exprs_main(X, y, w, counters) -> dict:
    """The main-path check of ``fuse_exprs``: each of
    :func:`fuse_exprs_regions`, hand-built, over the main path's X and y
    and its trained w (a random direction s for y⊙Xs, the hinge of w for
    ``out``, λ = LAM), with ``kernels="cuda"`` and the counters set to 0
    just before each call and read just after; its outputs equal to the
    ``@fused`` staged path's on the same bindings bit for bit (both run
    the same whole-plan-cached function); every fused step of its plan
    held to its plain version on the plan's own values within the kernel
    limit; a one-step region's outputs held to ``kernels="never"``'s the
    same way, and a multi-step region's within TRACE_RTOL of them
    (:func:`out_rel`), the limit that the objective with the planted fold
    fault (a partial dropped in every reducing kernel) must leave.
    Returns the launches per kernel and the largest share of the limit."""
    import torch
    from repro_torch.core import FusionContext, fuse_exprs
    from repro_torch.algos import l2svm
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(2025)
    s = torch.randn((N_MAIN, 1), generator=gen, device="cuda")
    binds = {"X": X, "y": y, "w": w,
             "lam": torch.full((1, 1), LAM, device="cuda"),
             "out": l2svm._hinge(X, w, y), "yXs": y * (X @ s)}
    shapes = {k: tuple(v.shape) for k, v in binds.items()}
    launches = {k: 0 for k in counters}
    worst, failed = 0.0, []
    for label, region in fuse_exprs_regions():
        b = {n: binds[n] for n in region.names}
        with FusionContext(kernels="cuda"):
            torch.cuda.synchronize()
            for mod in counters.values():
                mod.launches = 0
            with captured_plans() as seen:
                got = as_tuple(fuse_exprs(hand_built(region, shapes), b))
            torch.cuda.synchronize()
            mine = {k: mod.launches for k, mod in counters.items()}
            staged = as_tuple(region(**b))
        with FusionContext(kernels="never"):
            never = as_tuple(fuse_exprs(hand_built(region, shapes), b))
        for k, n in mine.items():
            launches[k] += n
        same = len(got) == len(staged) and all(
            bool(torch.equal(a, c)) for a, c in zip(got, staged))
        steps = plan_step_checks(seen[0], b, f"[fuse_exprs] {label}")
        shares = [sh for _k, _cp, _e, sh in steps]
        if len(seen[0].plan.specs) == 1:
            # the region is one fused step: its outputs are the step's
            _k, cp, _e, _s = steps[0]
            names = {n.nid: n.name for n in seen[0].plan.graph.inputs()}
            env = {bd.nid: b[names[bd.nid]] for bd in cp.binds}
            whole = torch.cat([o.reshape(-1, 1) for o in got]) \
                if len(got) > 1 else got[0]
            err, share = measure(cp, env, whole,
                                 f"[fuse_exprs] {label} vs never")
            shares.append(share)
            vs_never = f"{err:.3e} = {share:.3g} x limit"
        else:
            rel = out_rel(got, never)
            vs_never = (f"largest relative difference {rel:.3e} (limit "
                        f"{TRACE_RTOL:g})")
            if not rel <= TRACE_RTOL:
                failed.append(f"{label}: {rel:.3e} from never")
        if label == "objective":
            want = float(never[0])
        worst = max([worst] + shares)
        log(f"[fuse_exprs] {label:12s} steps "
            f"{[(k, cp.variant) for k, cp, _e, _s in steps]}: launches "
            f"{json.dumps(mine)}; = @fused staged bit for bit {same}; "
            f"kernel vs plain per step {[f'{sh:.3g}' for sh in shares]} x "
            f"limit; vs never {vs_never}")
        if not same:
            failed.append(f"{label}: fuse_exprs differs from @fused")
        if not max(shares) <= 1.0:
            failed.append(f"{label}: over the kernel limit")
        if sum(mine.values()) < len(steps):
            failed.append(f"{label}: {mine} launches for {len(steps)} "
                          f"fused steps")
    b = {n: binds[n] for n in l2svm._objective_full.names}
    expr = hand_built(l2svm._objective_full, shapes)
    with FusionContext(kernels="cuda"), planted_fault():
        bad = float(fuse_exprs(expr, b))
    rel_fault = trace_rel([bad], [want])
    log(f"[fuse_exprs] planted fault (a partial dropped in every reducing "
        f"kernel) on the objective: {bad} vs never {want}, relative "
        f"{rel_fault:.3e} (must exceed {TRACE_RTOL:g})")
    if not rel_fault > TRACE_RTOL:
        failed.append("the planted fault passed the fuse_exprs check")
    missing = [k for k in ("cell", "magg", "row") if launches[k] == 0]
    if missing:
        failed.append(f"fuse_exprs never launched {missing}")
    log(f"[fuse_exprs] main path {X.shape[0]}x{X.shape[1]}: launches "
        f"{json.dumps(launches)}, largest share of the limit {worst:.3g}; "
        f"wall {time.perf_counter() - t0:.1f} s")
    if failed:
        raise AssertionError("[fuse_exprs]: " + "; ".join(failed))
    return {"launches": launches, "worst_share": worst}


def kernel_name(cplan) -> str:
    from repro_torch.kernels import cuda_src
    return cuda_src.source_for(cplan).template


def layout_name(cplan) -> str:
    """The Row kernel's layout ("tile", "warp", "staged" or "stream"), the
    Cell kernel's walk ("vec" or "scal"), "-" for the others (and for a
    tree that predates them)."""
    from repro_torch.kernels import cuda_src
    src = cuda_src.source_for(cplan)
    walk = getattr(src, "walk", "")
    return {"vector": "vec", "scalar": "scal"}.get(walk) or \
        getattr(src, "layout", "") or "-"


def random_env(cplan, gen, shared=None):
    """Random fp32 operands on the card for every bind (scaled so exp and
    friends stay finite); ``shared`` maps a shape to a tensor to reuse."""
    import torch
    env = {}
    for b in cplan.binds:
        shape = tuple(b.shape)
        if shared is not None and shape in shared:
            env[b.nid] = shared[shape]
        else:
            env[b.nid] = 0.3 * torch.randn(shape, generator=gen,
                                           device="cuda")
    return env


#: piecewise-constant ops: their outputs count as exact under rounding
STEP_OPS = {"sign", "round", "floor", "ceil", "neq0", "eq", "neq", "lt", "le",
            "gt", "ge"}


def _is_t(x) -> bool:
    import torch
    return isinstance(x, torch.Tensor)


def _mag(x):
    return x.abs() if _is_t(x) else abs(x)


def _reduce_scale(op, v, s, axis):
    """The bound of an aggregate of v (carrying s) along ``axis``."""
    import torch
    from repro_torch.kernels import ref
    s = s if _is_t(s) else torch.zeros_like(v)
    if op in ("min", "max"):
        return (ref.eval_node(op, [v], {"axis": axis}).abs()
                + ref.eval_node("max", [s], {"axis": axis}))
    if op == "sum_sq":
        return ref.eval_node("sum", [v * v + 2 * v.abs() * s],
                             {"axis": axis})
    return ref.eval_node(op, [v.abs() + s], {"axis": axis})


def _matmul_scale(a, sa, b, sb):
    out = a.abs() @ b.abs()
    if _is_t(sa):
        out = out + sa @ b.abs()
    if _is_t(sb):
        out = out + a.abs() @ sb
    return out


def _smooth_scale(op, xs, ss, val, attrs):
    import torch
    from repro_torch.kernels import ref
    leaves = [x.detach().expand(val.shape).clone().requires_grad_(True)
              if _is_t(x) and _is_t(s) else x for x, s in zip(xs, ss)]
    want = [x for x in leaves if _is_t(x) and x.requires_grad]
    out = val.abs()
    if want:
        with torch.enable_grad():
            grads = torch.autograd.grad(
                ref.eval_node(op, leaves, attrs).sum(), want)
        carried = iter(s for x, s in zip(leaves, ss)
                       if _is_t(x) and x.requires_grad)
        for g in grads:
            out = out + torch.nan_to_num(g.abs() * next(carried))
    return out


def _op_scale(op, xs, ss, val, attrs):
    """s(v) of one program op from its inputs xs and their bounds ss."""
    from repro_torch.kernels import ref
    if op in ref._AGG_FN and "axis" in attrs:
        return _reduce_scale(op, xs[0], ss[0], attrs["axis"])
    if op == "matmul":
        a, b = xs
        sa, sb = ss
        if attrs.get("ta"):
            a, sa = a.T, (sa.T if _is_t(sa) else sa)
        if attrs.get("tb"):
            b, sb = b.T, (sb.T if _is_t(sb) else sb)
        return _matmul_scale(a, sa, b, sb)
    if op == "t":
        return ss[0].T if _is_t(ss[0]) else ss[0]
    if op == "idx":
        return ss[0][:, attrs["lo"]:attrs["hi"]] if _is_t(ss[0]) else ss[0]
    if op in STEP_OPS:
        return val.abs()
    if op in ("relu", "abs", "neg"):
        return val.abs() + ss[0]
    if op in ("add", "sub", "min", "max"):
        return val.abs() + ss[0] + ss[1]
    if op == "mul":
        return val.abs() + _mag(xs[1]) * ss[0] + _mag(xs[0]) * ss[1]
    if op == "div":
        return val.abs() + (ss[0] + val.abs() * ss[1]) / _mag(xs[1])
    if op in ("plus_mult", "minus_mult"):
        return (val.abs() + ss[0] + _mag(xs[2]) * ss[1]
                + _mag(xs[1]) * ss[2])
    if op == "where":
        return val.abs() + ref.eval_node("where", [xs[0], *ss[1:]], {})
    return _smooth_scale(op, xs, ss, val, attrs)


def _program_scales(cplan, read, outer_mm=None):
    """(values, bounds) of every program node; ``read(nid)`` gives bound
    inputs (exact, s = 0); ``outer_mm`` = (nid, value, bound) stands in for
    the Outer template's per-block product."""
    from repro_torch.kernels import ref
    vals, scales = {}, {}

    def get(kind, r):
        if kind == "n":
            return vals[r], scales[r]
        return (read(r) if kind == "b" else r), 0.0

    for (nid, op, ins, _shape, attrs) in cplan.prog:
        if outer_mm is not None and nid == outer_mm[0]:
            vals[nid], scales[nid] = outer_mm[1], outer_mm[2]
            continue
        xs, ss = zip(*[get(k, r) for k, r in ins])
        attrs = dict(attrs)
        vals[nid] = ref.eval_node(op, list(xs), attrs)
        scales[nid] = _op_scale(op, list(xs), list(ss), vals[nid], attrs)
    return lambda nid: get("n" if nid in vals else "b", nid)


def error_scale(cplan, env):
    """Per output element, the size its fp32 rounding is held against: a
    first-order running error bound of the plain computation in units of
    fp32 eps.  Every program value v carries s(v) with |error(v)| <~ eps *
    s(v): inputs and literals are exact (s = 0); each op adds its own
    rounding |v| and carries its inputs' bounds through its partial
    derivatives (|b| s(a) + |a| s(b) for a*b, |A||B| + s(A)|B| + |A|s(B)
    for a matmul, sum |t| + sum s(t) for a sum, |f'(x)| s(x) for a smooth
    f); piecewise-constant ops count as exact.  The template's own
    reduction closes the bound.  Over a BCSR main the same bound is taken
    per non-zero block (:func:`bcsr_error_scale`)."""
    import torch
    from repro_torch.core.cplan import (COL_AGG, COL_T_AGG, FULL_AGG,
                                        NO_AGG, ROW_AGG)
    from repro_torch.kernels.blocksparse import BCSR
    if isinstance(env[cplan.main.nid], BCSR):
        return bcsr_error_scale(cplan, env)
    root = _program_scales(cplan, lambda nid: env[nid])
    if cplan.extra:
        roots = [(cplan.prog_root, cplan.agg_op)] + list(cplan.extra)
        return torch.cat([_reduce_scale(op, *root(r), "full").reshape(1, 1)
                          for r, op in roots])
    v, s = root(cplan.prog_root)
    if cplan.variant == NO_AGG:
        return s if _is_t(s) else torch.zeros_like(v)
    if cplan.variant == COL_T_AGG:
        c, sc = root(cplan.close_nid)
        return _matmul_scale(c.T, sc.T if _is_t(sc) else sc, v, s)
    axis = {FULL_AGG: "full", ROW_AGG: "row", COL_AGG: "col"}[cplan.variant]
    return _reduce_scale(cplan.agg_op, v, s, axis)


def bcsr_error_scale(cplan, env, chunk: int = 4096):
    """:func:`error_scale` of an Outer ``right_mm`` / ``full_agg`` CPlan
    over a BCSR main, block by block in chunks of ``chunk`` blocks (the
    values are as large as X): the per-block product U_b V_bᵀ carries
    |U_b||V_b|ᵀ, the chain its ops' bounds, and the close sums |v| + s
    against |closer| per block row (right_mm) or over everything
    (full_agg)."""
    import torch
    from repro_torch.core.cplan import FULL_AGG, RIGHT_MM
    from repro_torch.kernels import ops
    from repro_torch.kernels.blocksparse import BCSR
    X = env[cplan.main.nid]
    bs, (m, n) = X.bs, X.shape
    kind = {b.kind: b.nid for b in cplan.binds}
    fu, fv = env[kind["factor_u"]], env[kind["factor_v"]]
    mm = next(nid for (nid, op, *_r) in cplan.prog if op == "matmul")
    if cplan.variant == RIGHT_MM:
        closer = ops._as_dense(env[cplan.close_nid])
        closer = (closer.T if cplan.close_tb else closer).abs()
        out = torch.zeros((m // bs, bs, closer.shape[1]),
                          dtype=closer.dtype, device=closer.device)
    elif cplan.variant == FULL_AGG and cplan.agg_op in ("sum", "min",
                                                        "max"):
        parts = []
    else:
        raise NotImplementedError(f"error scale of {cplan.variant}")
    for c0 in range(0, X.nblocks, chunk):
        sub = BCSR(X.data[c0:c0 + chunk], X.rows[c0:c0 + chunk],
                   X.cols[c0:c0 + chunk], X.shape, bs)
        ub = ops._gather_blocks(fu, sub.rows, bs, 0)
        vb = ops._gather_blocks(fv, sub.cols, bs, 0).transpose(1, 2)
        root = _program_scales(cplan, ops._block_env(cplan, env, sub),
                               (mm, torch.bmm(ub, vb),
                                torch.bmm(ub.abs(), vb.abs())))
        v, s = root(cplan.prog_root)
        s = s if _is_t(s) else torch.zeros_like(v)
        if cplan.variant == RIGHT_MM:
            cb = ops._gather_blocks(closer, sub.cols, bs, 0)
            out.index_add_(0, sub.rows.long(), torch.bmm(v.abs() + s, cb))
        elif cplan.agg_op == "sum":
            parts.append((v.abs() + s).sum())
        else:
            parts.append(torch.stack([
                ops._block_agg(v, cplan.agg_op).reshape(()), s.max()]))
    if cplan.variant == RIGHT_MM:
        return out.reshape(m, -1)
    if cplan.agg_op == "sum":
        return torch.stack(parts).sum().reshape(1, 1)
    p = torch.stack(parts)
    return (ops._block_agg(p[:, 0], cplan.agg_op).abs()
            + p[:, 1].max()).reshape(1, 1)


#: row-wise CPlans over more rows than this are held to the limit in
#: chunks of this many rows (the plain version and the error scale of a
#: 10^7 x 100 output would need tens of GB at once)
MEASURE_ROWS = 1_000_000


def measure(cplan, env, got, label: str) -> tuple[float, float]:
    """(max |got - plain|, its largest share of the per-element limit);
    raises on a shape or non-finite mismatch.  A ``no_agg`` / ``row_agg``
    CPlan over a dense main of more than MEASURE_ROWS rows is measured in
    chunks of rows: each output row depends on its own rows only."""
    import torch
    from repro_torch.core.cplan import NO_AGG, ROW_AGG
    m = cplan.main.shape[0]
    main = env[cplan.main.nid]
    if m <= MEASURE_ROWS or cplan.extra or not isinstance(
            main, torch.Tensor) or cplan.variant not in (NO_AGG, ROW_AGG):
        return _measure(cplan, env, got, label)
    if tuple(got.shape[:1]) != (m,):
        raise AssertionError(f"{label}: shape {tuple(got.shape)}")
    err = share = 0.0
    for r0 in range(0, m, MEASURE_ROWS):
        rows = slice(r0, r0 + MEASURE_ROWS)
        sub = {nid: (t[rows] if t.shape[0] == m else t)
               for nid, t in env.items()}
        e, sh = _measure(cplan, sub, got[rows], f"{label} rows {r0}:")
        err, share = max(err, e), max(share, sh)
    return err, share


def _measure(cplan, env, got, label: str) -> tuple[float, float]:
    import torch
    from repro_torch.kernels import ops
    exp = ops.execute(cplan, env, kernels="never")
    torch.cuda.synchronize()
    if tuple(got.shape) != tuple(exp.shape):
        raise AssertionError(f"{label}: shape {tuple(got.shape)} != "
                             f"plain {tuple(exp.shape)}")
    fin = torch.isfinite(exp)
    if not bool(torch.equal(torch.isfinite(got), fin)):
        raise AssertionError(f"{label}: non-finite values differ")
    if not bool(fin.any()):
        return 0.0, 0.0
    diff = (got[fin] - exp[fin]).abs()
    scale = error_scale(cplan, env)
    if tuple(scale.shape) != tuple(exp.shape):
        raise AssertionError(f"{label}: error scale {tuple(scale.shape)}")
    limit = KERNEL_ULPS * EPS32 * scale[fin].clamp_min(
        torch.finfo(torch.float32).tiny)
    return float(diff.max()), float((diff / limit).max())


def compare(cplan, env, label: str) -> tuple[float, float]:
    """Kernel vs plain on the same CUDA tensors: (max |error|, its share of
    the limit); raises when any element is over its limit."""
    from repro_torch.kernels import ops
    got = ops.execute(cplan, env, kernels="cuda")
    err, share = measure(cplan, env, got, label)
    if not share <= 1.0:
        raise AssertionError(f"{label}: max |kernel - plain| = {err:.3e}, "
                             f"{share:.3g} x its limit")
    return err, share


def planted(src, fold: bool = False, group: bool = False,
            rank: bool = False):
    """``src`` built with a planted fault: the Cell kernel's fold and
    ``rk::combine`` drop the middle partial, the Row ``row_agg`` variant the middle element of every
    row (tile layout) or the middle lane's partial (warp layout), as does
    a warp-layout Row program's own row aggregate,
    the Row tile layout's ``col_t_agg`` close the middle row slice of each
    CTA, the Row streaming layout the middle column slice of its last fold
    pass, the Row staged layout never copies the middle chunk of a slice
    (the fused loss, the rmsnorm), the
    Outer ``right_mm`` skips the middle block of every block row; with ``fold``, the Outer ``right_mm`` fold drops the middle
    piece of every row of two or more pieces instead; with ``group``, the
    Cell kernel's vector walk drops the second cell of every group instead;
    with ``rank``, the Row staged layout's cluster fold leaves out rank
    K / 2's partial instead.
    A source with no such step is returned as is."""
    if rank:
        return dataclasses.replace(src, text=PLANT_RANK + src.text) \
            if getattr(src, "cluster", 0) > 1 else src
    if group:
        return dataclasses.replace(src, text=PLANT_GROUP + src.text) \
            if getattr(src, "walk", "") == "vector" else src
    if fold:
        return dataclasses.replace(src, text=PLANT_FOLD + src.text) \
            if src.template == "outer" and not src.elems else src
    return dataclasses.replace(src, text=PLANT + src.text) \
        if src.elems or src.template == "outer" or \
        (src.template, src.variant) == ("row", "row_agg") or \
        (getattr(src, "layout", "") in ("warp", "stream")
         and "rowtile::kPlanted" in src.text) or \
        getattr(src, "layout", "") == "staged" else src


@contextlib.contextmanager
def planted_fault(fold: bool = False, group: bool = False,
                  rank: bool = False):
    """Every reducing kernel launched inside runs its planted build (with
    ``fold``: the fold fault; with ``group``: every vector-walk Cell
    kernel its group fault; with ``rank``: every staged Row kernel of a
    cluster its rank fault)."""
    from repro_torch.kernels import cuda_src
    orig = cuda_src.source_for
    cuda_src.source_for = lambda cp, bs=None: planted(orig(cp, bs), fold,
                                                      group, rank)
    try:
        yield
    finally:
        cuda_src.source_for = orig


def fault_share(cplan, env, bad, label: str) -> float:
    """A planted build's output held to the plain version: its largest
    share of the per-element limit, infinite where its non-finite values
    or its shape differ (a staged chunk never copied leaves whatever the
    shared memory held)."""
    try:
        return measure(cplan, env, bad, label)[1]
    except AssertionError as e:
        log(f"{label}: {e}")
        return math.inf


def trace_rel(objs, ref_objs) -> float:
    """Largest relative difference of two objective traces; infinite when
    their lengths differ or a value is not finite."""
    if len(objs) != len(ref_objs) or not all(
            math.isfinite(v) for v in list(objs) + list(ref_objs)):
        return math.inf
    return max(abs(a - b) / max(abs(b), 1e-30)
               for a, b in zip(objs, ref_objs))


def time_ms(fn, reps: int = 10, rounds: int = 5) -> float:
    """Median over ``rounds`` of the CUDA-event time of ``reps``
    back-to-back calls, per call."""
    import torch
    fn()
    torch.cuda.synchronize()
    per = []
    for _ in range(rounds):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        b.synchronize()
        per.append(a.elapsed_time(b) / reps)
    return statistics.median(per)


#: GPU clock cycles of the spin kernel :func:`queued_ms` puts ahead of
#: the calls it times, and the H100's top SM clock (50.5 ms at it)
QUEUE_SPIN_CYCLES = 100_000_000
SM_MAX_HZ = 1.98e9


def queued_ms(fn, reps: int = 10, rounds: int = 5) -> float | None:
    """Device time per call from CUDA events with the host's launch path
    hidden: a spin kernel (``torch.cuda._sleep``) keeps the stream busy
    while the host enqueues the start event, ``reps`` calls and the end
    event, so the events time the calls' kernels back to back.  Median
    over ``rounds``; None when the host took longer to enqueue a round
    than the spin lasted (the events would hold host time)."""
    import torch
    fn()
    torch.cuda.synchronize()
    spin_s = QUEUE_SPIN_CYCLES / SM_MAX_HZ     # the shortest it can last
    per = []
    for _ in range(rounds):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(QUEUE_SPIN_CYCLES)
        t0 = time.perf_counter()
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        host_s = time.perf_counter() - t0
        b.synchronize()
        if host_s >= 0.5 * spin_s:
            return None
        per.append(a.elapsed_time(b) / reps)
    return statistics.median(per)


#: idle host time at each end of a profiler step that is read: without
#: it, the first calls' kernels could be missing from the trace
PROFILE_PAD_S = 0.05


def device_ms(fn, reps: int = 10, names: list | None = None):
    """Device time per call from a ``torch.profiler`` trace: the self
    device time of every kernel the calls launched, summed, over ``reps``;
    None when the trace holds no device time.  ``names``, where given,
    receives (kernel name, launches per call) of every kernel traced.  A first profiler step runs
    ``fn`` once and is discarded, and the step that is read is padded with
    ``PROFILE_PAD_S`` of idle time at each end.  A kernel launched a number
    of times that is not a multiple of ``reps`` is logged: the trace lost
    some of its launches."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1,
                                   repeat=1)) as prof:
        fn()
        torch.cuda.synchronize()
        prof.step()
        time.sleep(PROFILE_PAD_S)
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        time.sleep(PROFILE_PAD_S)
        prof.step()
    events = [e for e in prof.key_averages() if e.self_device_time_total > 0]
    lost = [f"{e.key[:40]} x{e.count}" for e in events if e.count % reps]
    if lost:
        log(f"[time] launches missing from a {reps}-call trace: {lost}")
    if names is not None:
        names += [(e.key, e.count / reps) for e in events]
    total_us = sum(e.self_device_time_total for e in events)
    return total_us / 1e3 / reps if total_us > 0 else None


def bound_ms(cplan, env, out) -> tuple[float, str]:
    """Least time for the same work: each distinct input read once and the
    output written once over HBM bandwidth, or the program's fp32 flops
    over the fp32 peak — the larger, and which one it is."""
    from repro_torch.kernels.blocksparse import BCSR
    if isinstance(env[cplan.main.nid], BCSR):
        return outer_bound_ms(cplan, env, out)
    seen, nbytes = set(), out.numel() * 4
    for t in env.values():
        if t.data_ptr() not in seen:
            seen.add(t.data_ptr())
            nbytes += t.numel() * 4
    t_bytes = nbytes / HBM_BW * 1e3
    t_flops = program_flops(cplan, out) / FP32_PEAK * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_flops else \
        (t_flops, "operations")


def program_flops(cplan, out) -> int:
    """fp32 operations of one call of a dense CPlan: a cell per program
    value, 2 x inner per matmul cell, the col_t_agg close."""
    rows = cplan.main.shape[0]
    flops = 0
    for (_nid, op, ins, shape, attrs) in cplan.prog:
        cells = shape[0] * shape[1]
        if op == "matmul":
            side = next(b.shape for b in cplan.binds
                        if ("b", b.nid) == ins[1])
            inner = side[1] if dict(attrs).get("tb") else side[0]
            flops += 2 * cells * inner
        else:
            flops += cells
    if cplan.variant == "col_t_agg":
        flops += 2 * rows * out.numel()
    return flops


def outer_bound_ms(cplan, env, out) -> tuple[float, str]:
    """:func:`bound_ms` of an Outer CPlan over a BCSR main, counting what
    this matrix needs: bytes are the nb non-zero blocks of X with their
    block indices and block-row pointer, each distinct dense operand (U,
    V, closer, sides) and the output; flops per block are 2 bs² r for
    U_b V_bᵀ, 2 bs² k for the right_mm close and bs² per chain op."""
    X = env[cplan.main.nid]
    nb, bs = X.nblocks, X.bs
    nbytes = (nb * bs * bs + 2 * nb + X.rowptr.numel()) * 4 \
        + out.numel() * 4
    seen = set()
    for b in cplan.binds[1:]:
        t = env[b.nid]
        if t.data_ptr() not in seen:
            seen.add(t.data_ptr())
            nbytes += t.numel() * 4
    r = next(b.shape[1] for b in cplan.binds if b.kind == "factor_u")
    ops_per_cell = sum(op != "matmul" for (_n, op, *_r) in cplan.prog)
    k = out.shape[1] if cplan.variant == "right_mm" else 0
    flops = nb * bs * bs * (2 * r + 2 * k + ops_per_cell)
    t_bytes, t_flops = nbytes / HBM_BW * 1e3, flops / FP32_PEAK * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_flops else \
        (t_flops, "operations")


def sm_clock_mhz() -> tuple[float, float]:
    """The card's current and maximum SM clocks (MHz), from nvidia-smi."""
    r = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
                        "--format=csv,noheader,nounits"], capture_output=True,
                       text=True, timeout=60, check=True)
    cur, top = r.stdout.strip().splitlines()[0].split(",")
    return float(cur), float(top)


def cuobjdump_path() -> str:
    """The CUDA toolkit's cuobjdump (beside nvcc where it is not on PATH)."""
    import shutil
    from repro_torch.kernels import build
    return shutil.which("cuobjdump") or str(
        Path(build.nvcc_path()).with_name("cuobjdump"))


def sass_loop_counts(src) -> dict:
    """Static SASS counts of a built Cell kernel (``cuobjdump -sass`` of
    its library): per kernel function, its instructions and those of its
    largest loop (the span from a backward branch's target to the branch,
    NOPs left out) — for the vector walk the loop of U groups in flight,
    so loop / (4 U) is the instructions a cell issues there.  Out-of-line
    slow paths (an IEEE division's) lie outside the span and are not
    counted."""
    import re
    from repro_torch.kernels import build
    text = subprocess.run([cuobjdump_path(), "-sass",
                           str(build.library_path(src))], capture_output=True,
                          text=True, timeout=120, check=True).stdout
    out = {}
    for chunk in re.split(r"\n\s*Function : ", text)[1:]:
        name = chunk.split("\n", 1)[0].strip()
        insts, labels, pending = [], {}, []
        for line in chunk.splitlines()[1:]:
            lab = re.match(r"\s*(\.L_x_\d+):", line)
            if lab:
                pending.append(lab.group(1))
                continue
            m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*?);", line)
            if not m:
                continue
            addr = int(m.group(1), 16)
            for lab_name in pending:
                labels[lab_name] = addr
            pending = []
            insts.append((addr, m.group(2).strip()))
        loop = 0
        for addr, ins in insts:
            t = re.search(r"BRA\s+(?:`\((\.L_x_\d+)\)|(0x[0-9a-f]+))", ins)
            if not t:
                continue
            dst = labels.get(t.group(1)) if t.group(1) else int(t.group(2), 16)
            if dst is not None and dst <= addr:
                loop = max(loop, sum(1 for a, i in insts if dst <= a <= addr
                                     and not i.startswith("NOP")))
        out[name] = {"insts": sum(1 for _a, i in insts
                                  if not i.startswith("NOP")),
                     "loop": loop}
    return out


def issue_floor(src, cells: int, busy=None) -> dict:
    """The issue floor of a Cell kernel: the SASS instructions a cell
    issues in the kernel's largest loop (:func:`sass_loop_counts`; the
    vector walk's loop of U groups of 4 cells, the scalar walk's loop of
    one cell), times the cells, over the SMs x 4 warp schedulers x 32
    lanes, at the SM clock nvidia-smi reports while ``busy`` runs on the
    card (a call of the kernel, repeated for about half a second) and at
    the card's maximum."""
    import threading
    import torch
    counts = sass_loop_counts(src)
    fn = max(counts, key=lambda k: counts[k]["loop"])
    per_cell = counts[fn]["loop"] / ((getattr(src, "group", 0) or 1)
                                     * (getattr(src, "unroll", 0) or 1))
    clocks = []
    reader = threading.Thread(
        target=lambda: (time.sleep(0.2), clocks.append(sm_clock_mhz())))
    reader.start()
    t0 = time.perf_counter()
    while busy is not None and time.perf_counter() - t0 < 0.5:
        for _ in range(100):
            busy()
    torch.cuda.synchronize()
    reader.join()
    cur, top = clocks[0]
    lanes = torch.cuda.get_device_properties(0).multi_processor_count * 128
    return {"function": fn[:60], "loop_insts": counts[fn]["loop"],
            "insts": counts[fn]["insts"], "per_cell": per_cell,
            "clock_mhz": cur, "max_clock_mhz": top,
            "floor_ms": cells * per_cell / (lanes * cur * 1e6) * 1e3,
            "floor_max_clock_ms": cells * per_cell / (lanes * top * 1e6)
            * 1e3}


def profile_run(label: str, fn) -> tuple[float, float]:
    """Where the time goes: one more run of ``fn`` (plans already cached)
    under ``torch.profiler``; device busy time per kernel name and the
    idle share of the host-clock wall time (profiler on).  Returns (wall
    ms, device busy ms)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule
    with profile(activities=[ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1,
                                   repeat=1)) as prof:
        torch.zeros(1, device="cuda").add_(1)    # tracer start-up, discarded
        torch.cuda.synchronize()
        prof.step()
        time.sleep(PROFILE_PAD_S)
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        time.sleep(PROFILE_PAD_S)
        prof.step()
    events = sorted(prof.key_averages(),
                    key=lambda e: -e.self_device_time_total)
    busy_ms = sum(e.self_device_time_total for e in events) / 1e3
    log(f"[profile] {label}: wall {wall_ms:.2f} ms, device busy "
        f"{busy_ms:.2f} ms, idle share {1 - busy_ms / wall_ms:.3f}")
    for e in events[:12]:
        log(f"[profile]   {e.self_device_time_total / 1e3:9.3f} ms "
            f"x{e.count:<4d} {e.key[:90]}")
    return wall_ms, busy_ms


# --------------------------------------------------------------------------
# ALS-CG helpers
# --------------------------------------------------------------------------

def padded(shape, bs: int = ALS_BS) -> tuple[int, int]:
    return tuple(-(-d // bs) * bs for d in shape)


def netflix_like(shape, seed: int = 0):
    """A BCSR ratings matrix built on the card from a seeded
    ``torch.Generator``, block row by block row: ``shape`` padded to
    ALS_BS, each block present with probability ALS_DENSITY (block (0, 0)
    always), values a planted rank-8 product plus 0.1 noise, zero in the
    padding rows and columns (what ``data.ratings`` draws with numpy,
    which would need a dense m x n array)."""
    import torch
    from repro_torch.kernels.blocksparse import BCSR
    bs = ALS_BS
    (m0, n0), (m, n) = shape, padded(shape)
    mb, nbc = m // bs, n // bs
    g = torch.Generator(device="cuda").manual_seed(seed)
    mask = torch.rand((mb, nbc), generator=g, device="cuda") < ALS_DENSITY
    mask[0, 0] = True
    rows, cols = torch.nonzero(mask, as_tuple=True)      # row-major
    Ut = torch.randn((m, 8), generator=g, device="cuda") / math.sqrt(8)
    Vt = torch.randn((n, 8), generator=g, device="cuda") / math.sqrt(8)
    Ut[m0:] = 0.0
    Vt[n0:] = 0.0
    live_r = (torch.arange(m, device="cuda") < m0).float().reshape(mb, bs, 1)
    live_c = (torch.arange(n, device="cuda") < n0).float().reshape(nbc, 1,
                                                                    bs)
    data = torch.empty((rows.numel(), bs, bs), device="cuda")
    ptr = torch.searchsorted(rows, torch.arange(mb + 1, device="cuda"))
    ptr = ptr.tolist()
    step = 256                                 # block rows per chunk
    for r0 in range(0, mb, step):
        a, b = ptr[r0], ptr[min(r0 + step, mb)]
        if a == b:
            continue
        ri, ci = rows[a:b], cols[a:b]
        blk = torch.bmm(Ut.reshape(mb, bs, 8)[ri],
                        Vt.reshape(nbc, bs, 8)[ci].transpose(1, 2))
        blk += 0.1 * torch.randn(blk.shape, generator=g, device="cuda")
        data[a:b] = blk * live_r[ri] * live_c[ci]
    return BCSR(data, rows.to(torch.int32), cols.to(torch.int32), (m, n),
                bs)


def outer_case_env(case, vals, names):
    """An Outer sweep case's numpy operands on the card (X as BCSR)."""
    import torch
    from repro_torch.kernels.blocksparse import BCSR
    return {nid: (BCSR.from_dense(torch.tensor(vals[n], device="cuda"),
                                  case.bs) if n == "X"
                  else torch.tensor(vals[n], device="cuda"))
            for nid, n in names.items()}


def meta_bcsr(shape):
    """A BCSR of ``shape`` at ALS_DENSITY with no data (planning needs
    shapes and block sparsity only)."""
    import torch
    from repro_torch.kernels.blocksparse import BCSR
    bs = ALS_BS
    nb = max(1, round(ALS_DENSITY * (shape[0] // bs) * (shape[1] // bs)))
    idx = torch.empty(nb, dtype=torch.int32, device="meta")
    return BCSR(torch.empty((nb, bs, bs), device="meta"), idx, idx, shape,
                bs)


def als_cplans(X, XT, rank: int = ALS_RANK):
    """The Outer CPlans of one ALS iteration: ``_wsq_mm`` over X (the U
    update), over Xᵀ (the V update) and ``_loss_terms``; X may be a
    :func:`meta_bcsr`."""
    import torch
    from repro_torch.algos import als_cg
    from repro_torch.core import FusionContext
    from repro_torch.core.codegen import compile_plan
    m, n = X.shape
    U = torch.empty((m, rank), device="meta")
    V = torch.empty((n, rank), device="meta")
    out = []
    with FusionContext():
        for label, region, args in (("_wsq_mm U-update", als_cg._wsq_mm,
                                     (X, U, V)),
                                    ("_wsq_mm V-update", als_cg._wsq_mm,
                                     (XT, V, U)),
                                    ("_loss_terms", als_cg._loss_terms,
                                     (X, U, V))):
            (cp,) = compile_plan(region.trace(*args).plan().eplan).cplans()
            out.append((label, cp))
    return out


def als_env(cplan, Xs, gen, rank: int = ALS_RANK):
    """Operands of an ALS CPlan on the card: the BCSR main, U and V drawn
    as the algorithm draws its start (0.1 x normal)."""
    import torch
    env = {}
    for b in cplan.binds:
        env[b.nid] = Xs if b.kind == "main" else 0.1 * torch.randn(
            tuple(b.shape), generator=gen, device="cuda")
    return env


def time_part(label, kname, cp, env, kernel, plain, out,
              library=None) -> dict:
    """One main-path CPlan's times (CUDA events and device, kernel and
    plain, and ``library``: one PyTorch call computing the same function,
    where there is one) beside its bound, logged as a ``[time]`` line, with
    the kernels one call launched on the card (a Cell call of this tree:
    exactly one Cell kernel, else it raises) and, for a Cell CPlan of
    MEASURE_ROWS cells or more, its issue floor (a ``[sass]`` line)."""
    from repro_torch.kernels import cuda_src
    ms, plain_ms = time_ms(kernel), time_ms(plain)
    traced = []
    dev_ms, dev_plain_ms = device_ms(kernel, names=traced), device_ms(plain)
    b_ms, b_by = bound_ms(cp, env, out)
    lib = ""
    part = {"region": label, "variant": cp.variant,
            "layout": layout_name(cp) if kname in ("row", "cell") else "-",
            "binds": [list(b.shape) for b in cp.binds], "ms": ms,
            "plain_ms": plain_ms, "device_ms": dev_ms,
            "plain_device_ms": dev_plain_ms, "bound_ms": b_ms,
            "bound_by": b_by}
    if library is not None:
        part["library_ms"] = time_ms(library)
        part["library_device_ms"] = device_ms(library)
        lib = (f" library {part['library_ms']:.4f} ms (device "
               f"{part['library_device_ms']})")
    part["device_kernels"] = [[k[:60], c] for k, c in traced]
    cells = cp.main.shape[0] * cp.main.shape[1]
    if kname == "cell" and cells >= MEASURE_ROWS:
        fl = issue_floor(cuda_src.source_for(cp), cells, kernel)
        part["issue_floor"] = fl
        log(f"[sass] {label} {cp.variant}: {fl['loop_insts']} SASS "
            f"instructions in the loop of {fl['function'][:40]}, "
            f"{fl['per_cell']:.2f} a cell ({fl['insts']} in the kernel); "
            f"issue floor {fl['floor_ms']:.4f} ms at {fl['clock_mhz']:g} "
            f"MHz under load, {fl['floor_max_clock_ms']:.4f} ms at "
            f"{fl['max_clock_mhz']:g} MHz; byte bound {b_ms:.4f} ms")
    one_launch = kname == "cell" and getattr(cuda_src.source_for(cp),
                                             "walk", "")
    if one_launch and not (
            len(traced) == 1 and traced[0][1] == 1
            and "cell_" in traced[0][0]):
        raise AssertionError(f"{label}: a Cell call launched {traced}, not "
                             f"one Cell kernel")
    per_call = " + ".join(f"{k.split('(')[0][:40]} x{c:g}"
                          for k, c in traced)
    log(f"[time] {label:22s} {kname:5s} {part['layout']:4s} "
        f"{cp.variant:9s} kernel {ms:.4f} ms "
        f"(device {dev_ms}) plain {plain_ms:.4f} ms (device "
        f"{dev_plain_ms}){lib} bound {b_ms:.4f} ms ({b_by}); per call on "
        f"the card: {per_call}")
    return part


def add_part(rec: dict, part: dict) -> None:
    for key in ("ms", "plain_ms", "bound_ms"):
        rec[key] += part[key]
    rec["bound_by"][part["bound_by"]] = \
        rec["bound_by"].get(part["bound_by"], 0) + 1
    rec["parts"].append(part)


def library_ms(rec: dict):
    """A kernel record's library time: the sum of its parts' when one
    PyTorch call computes each part, else None (no call does all)."""
    parts = rec["parts"]
    if parts and all("library_ms" in p for p in parts):
        return sum(p["library_ms"] for p in parts)
    return None


def new_record() -> dict:
    return {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "bound_by": {},
            "parts": []}


def _row_norms_call(cp, env):
    import torch
    X = env[cp.main.nid]
    return lambda: torch.einsum("ij,ij->i", X, X)


def sum_of_squares(cp) -> bool:
    """Whether a CPlan is one sum of squares (Σw², ΣB²: a ``full_agg``
    of ``pow2``, one root)."""
    return (cp.variant, cp.agg_op) == ("full_agg", "sum") and \
        not cp.extra and [op for (_n, op, *_r) in cp.prog] == ["pow2"]


def _sum_sq_call(cp, env):
    import torch
    if [op for (_n, op, *_r) in cp.prog] != ["pow2"] or cp.agg_op != "sum":
        raise AssertionError(f"{cp.prog}: not a sum of squares")
    x = env[cp.main.nid].reshape(-1)
    return lambda: torch.dot(x, x)


#: CPlans that one PyTorch call also computes: (label, kernel, variant) ->
#: that call on the CPlan's operands (Σw², ΣB²: the dot product of the
#: flattened operand with itself)
LIBRARY_CALLS = {
    ("kmeans _sq_rowsums", "row", "row_agg"): _row_norms_call,
    ("_objective_full", "cell", "full_agg"): _sum_sq_call,
    ("_objective_full:vjp", "cell", "full_agg"): _sum_sq_call,
    ("mlogreg _nll_obj_reg", "cell", "full_agg"): _sum_sq_call,
    ("mlogreg _nll_obj_reg:vjp", "cell", "full_agg"): _sum_sq_call,
}


def dense_times(main_cps, envs, per_kernel=None) -> dict:
    """A dense main path's CPlans timed, each added to its kernel's record
    in ``per_kernel`` (new records when None); returns the records."""
    from repro_torch.kernels import cellwise, multiagg, ref, rowwise
    wrappers = {"cell": cellwise.cell, "magg": multiagg.multiagg,
                "row": rowwise.row}
    if per_kernel is None:
        per_kernel = {k: new_record() for k in KERNELS}
    for (region, cp), env in zip(main_cps, envs):
        kname = kernel_name(cp)
        lib = LIBRARY_CALLS.get((region, kname, cp.variant))
        add_part(per_kernel[kname], time_part(
            region, kname, cp, env, lambda: wrappers[kname](cp, env),
            lambda: ref.execute_dense(cp, env), ref.execute_dense(cp, env),
            lib(cp, env) if lib else None))
    return per_kernel


def outer_times(cps, envs) -> dict:
    """The ALS CPlans timed: the Outer kernel's record."""
    from repro_torch.kernels import outerprod
    rec = new_record()
    for (label, cp), env in zip(cps, envs):
        part = time_part(label, "outer", cp, env,
                         lambda: outerprod.outer(cp, env),
                         lambda: outerprod.outer_plain(cp, env),
                         outerprod.outer_plain(cp, env))
        part["nblocks"] = env[cp.main.nid].nblocks
        add_part(rec, part)
    return rec


def l2svm_data(m: int):
    """The L2SVM main path's X (m, N_MAIN) and labels from a planted w,
    drawn on the card from a seeded ``torch.Generator``."""
    import torch
    g = torch.Generator(device="cuda").manual_seed(0)
    X = torch.randn((m, N_MAIN), generator=g, device="cuda")
    w_true = torch.randn((N_MAIN, 1), generator=g, device="cuda")
    noise = torch.randn((m, 1), generator=g, device="cuda")
    y = torch.where(X @ w_true + 0.5 * noise >= 0, 1.0, -1.0)
    return X, y


# --------------------------------------------------------------------------
# the four dense algorithms: MLogReg, GLM, KMeans, the autoencoder
# --------------------------------------------------------------------------

class AlgoPath(NamedTuple):
    """One dense algorithm's main path: its fused regions at the path's
    shapes (region, meta args, backward: True for every input's, or the
    names the run differentiates), its data drawn on the
    card, its run, and the check of what the run returns."""
    name: str
    depth: str
    regions: list
    data: Callable       # () -> operands on the card
    run: Callable        # (operands, **kw) -> (parameters, trace)
    check: Callable      # (operands, parameters) -> None; raises


def mlogreg_data(m: int):
    """X (m, N_MAIN) and one-hot labels (m, MLR_K) from a planted B plus
    0.5 noise on the logits (data.classification's model), drawn on the
    card (seeded)."""
    import torch
    g = torch.Generator(device="cuda").manual_seed(1)
    X = torch.randn((m, N_MAIN), generator=g, device="cuda")
    B = torch.randn((N_MAIN, MLR_K), generator=g, device="cuda")
    noise = torch.randn((m, MLR_K), generator=g, device="cuda")
    idx = torch.argmax(X @ B + 0.5 * noise, dim=1, keepdim=True)
    Y = torch.zeros((m, MLR_K), device="cuda").scatter_(1, idx, 1.0)
    return X, Y


def glm_data(m: int):
    """X (m, N_MAIN) and binary labels from a planted probit: y = 1 where
    X w + N(0, 1) > 0, w ~ N(0, 1/N_MAIN) (so P(y = 1) = Φ(X w)), drawn
    on the card (seeded)."""
    import torch
    g = torch.Generator(device="cuda").manual_seed(2)
    X = torch.randn((m, N_MAIN), generator=g, device="cuda")
    w = torch.randn((N_MAIN, 1), generator=g, device="cuda") / math.sqrt(
        N_MAIN)
    noise = torch.randn((m, 1), generator=g, device="cuda")
    return X, (X @ w + noise > 0).to(torch.float32)


def kmeans_data(m: int):
    """X (m, N_MAIN) around KM_K planted centres (4 x N(0, 1)) with unit
    noise, drawn on the card (seeded); C0 = X's first KM_K rows."""
    import torch
    g = torch.Generator(device="cuda").manual_seed(3)
    centres = 4.0 * torch.randn((KM_K, N_MAIN), generator=g, device="cuda")
    asg = torch.randint(0, KM_K, (m,), generator=g, device="cuda")
    X = centres[asg]
    X += torch.randn((m, N_MAIN), generator=g, device="cuda")
    return X, X[:KM_K].clone()


def images_data(m: int):
    """(m, AE_N) in [0, 1), a quarter of the cells non-zero (what
    data.images draws with numpy), drawn on the card (seeded)."""
    import torch
    g = torch.Generator(device="cuda").manual_seed(4)
    keep = torch.rand((m, AE_N), generator=g, device="cuda") < 0.25
    return (keep * torch.rand((m, AE_N), generator=g, device="cuda"),)


def finite(label: str, t, shape) -> None:
    import torch
    if tuple(t.shape) != tuple(shape) or not bool(torch.isfinite(t).all()):
        raise AssertionError(f"{label}: not a finite {tuple(shape)} tensor "
                             f"(got {tuple(t.shape)})")


def kmeans_assignment(X, C):
    """(rows with no centroid at their minimum distance, max |row sum of
    the tie-split assignment - 1|) of one KMeans assignment step on the
    card: the fused row minimum against torch's D, as ``kmeans.run``
    builds them."""
    import torch
    from repro_torch.algos import kmeans
    from repro_torch.core import FusionContext
    with FusionContext():
        xsq = kmeans._sq_rowsums(X)
        XC = X @ C.T
        csq = torch.sum(C * C, dim=1).reshape(1, -1)
        dmin = kmeans._min_dist(XC, xsq, csq)
    A = (xsq - 2.0 * XC + csq == dmin).to(torch.float32)
    hits = A.sum(dim=1, keepdim=True)
    sums = (A / hits).sum(dim=1)
    return int((hits == 0).sum()), float((sums - 1.0).abs().nan_to_num(
        math.inf).max())


def check_kmeans(ops, C) -> None:
    X, C0 = ops
    finite("kmeans C", C, (KM_K, N_MAIN))
    for label, Cs in (("C0", C0), ("the final C", C)):
        missed, off = kmeans_assignment(X, Cs)
        log(f"[kmeans] assignment at {label}: {missed} rows without a "
            f"match of the fused minimum, max |row sum - 1| {off:.3e}")
        if missed or not off <= 4 * EPS32:
            raise AssertionError(f"kmeans: assignment rows at {label} do "
                                 f"not sum to 1")


def check_autoencoder(_ops, params) -> None:
    Ws, bs = params
    dims = (AE_N, AE_H1, AE_H2, AE_H1, AE_N)
    for i, (W, b) in enumerate(zip(Ws, bs)):
        finite(f"autoencoder W{i + 1}", W, (dims[i], dims[i + 1]))
        finite(f"autoencoder b{i + 1}", b, (1, dims[i + 1]))


def algo_paths(m: int) -> list:
    """The four dense algorithms' main paths at m rows (the autoencoder
    at AE_ROWS): regions, data, run and checks."""
    from repro_torch.algos import autoencoder, glm, kmeans, mlogreg
    n, k = N_MAIN, MLR_K
    X, col = meta(m, n), meta(m, 1)
    Xb = meta(AE_BATCH, AE_N)
    h1, h2 = AE_H1, AE_H2
    weights = (meta(AE_N, h1), meta(1, h1), meta(h1, h2), meta(1, h2),
               meta(h2, h1), meta(1, h1), meta(h1, AE_N), meta(1, AE_N))
    return [
        AlgoPath(
            "mlogreg", f"k = {k}, lambda {LAM:g}, {MLR_OUTER} outer x "
            f"{MLR_INNER} CG iterations (reference: 10 x 20)",
            [(mlogreg._probs, (X, meta(n, k)), False),
             (mlogreg._nll_obj_reg, (X, meta(n, k), meta(m, k), meta(1, 1)),
              ("B",)),
             (mlogreg._hvp, (X, meta(n, k), meta(m, k)), False)],
            lambda: mlogreg_data(m),
            lambda ops, **kw: mlogreg.run(*ops, lam=LAM, max_outer=MLR_OUTER,
                                          max_inner=MLR_INNER, **kw),
            lambda ops, B: finite("mlogreg B", B, (n, k))),
        AlgoPath(
            "glm", f"binomial probit, lambda {LAM:g}, {GLM_OUTER} outer x "
            f"{GLM_INNER} CG iterations (reference: 8 x 10)",
            [(glm._link_chain, (col, col), False),
             (glm._deviance, (col, col), False),
             (glm._wz, (X, col, col), False),
             (glm._wxv, (X, col, meta(n, 1)), False)],
            lambda: glm_data(m),
            lambda ops, **kw: glm.run(*ops, lam=LAM, max_outer=GLM_OUTER,
                                      max_inner=GLM_INNER, **kw),
            lambda ops, beta: finite("glm beta", beta, (n, 1))),
        AlgoPath(
            "kmeans", f"k = {KM_K}, C0 = X's first {KM_K} rows, "
            f"{KM_ITERS} iterations (reference: 20)",
            [(kmeans._sq_rowsums, (X,), False),
             (kmeans._min_dist, (meta(m, KM_K), col, meta(1, KM_K)), False)],
            lambda: kmeans_data(m),
            lambda ops, **kw: kmeans.run(*ops, max_iter=KM_ITERS, **kw),
            check_kmeans),
        AlgoPath(
            "autoencoder", f"X {AE_ROWS} x {AE_N}, H1 {h1}, H2 {h2}, batch "
            f"{AE_BATCH}, {AE_STEPS} SGD steps (reference: one epoch)",
            [(autoencoder._recon_loss, (Xb, *weights),
              ("W1", "b1", "W2", "b2", "W3", "b3", "W4", "b4"))],
            lambda: images_data(AE_ROWS),
            lambda ops, **kw: autoencoder.run(
                ops[0][:AE_STEPS * AE_BATCH], h1=h1, h2=h2, batch=AE_BATCH,
                **kw),
            check_autoencoder),
    ]


def cell_checks(label, cp, env, fault: bool = False) -> list[str]:
    """A main-path Cell CPlan on the card: a reducing one gives the same
    bits twice; with ``fault``, its planted group fault (vector walk) must
    fail the kernel check.  Returns what failed."""
    import torch
    from repro_torch.kernels import ops
    failed = []
    if cp.variant != "no_agg":
        a = ops.execute(cp, env, kernels="cuda")
        same = bool(torch.equal(a, ops.execute(cp, env, kernels="cuda")))
        log(f"[check] main path {label} {cp.variant}: two runs "
            f"{'bit-identical' if same else 'DIFFER'}")
        if not same:
            failed.append(f"{label} {cp.variant}: reruns differ")
    if fault and layout_name(cp) == "vec":
        with planted_fault(group=True):
            got = ops.execute(cp, env, kernels="cuda")
        err, share = measure(cp, env, got, f"planted group {label}")
        del got
        log(f"[check] planted fault (one cell of every group dropped) main "
            f"path {label} {cp.variant}: max|kernel-plain| {err:.3e} = "
            f"{share:.3g} x limit")
        if not share > 1.0:
            failed.append(f"planted group fault in {label} passed the "
                          f"kernel check")
    return failed


def cell_sweep_card_checks(planned, gen) -> None:
    """Every reducing Cell sweep CPlan at M_SWEEP rows gives the same bits
    twice (one launch, the fold in CTA order); a vector-walk operand that
    is not 16-byte aligned raises."""
    import torch
    from repro_torch.kernels import ops
    for c, m, n, cp, _names in planned:
        if c.template != "cell" or cp.variant == "no_agg" or m != M_SWEEP:
            continue
        env = random_env(cp, gen)
        same = bool(torch.equal(ops.execute(cp, env, kernels="cuda"),
                                ops.execute(cp, env, kernels="cuda")))
        log(f"[check] {c.name} ({layout_name(cp)}) at {m}x{n}: two runs "
            f"{'bit-identical' if same else 'DIFFER'}")
        if not same:
            raise AssertionError(f"{c.name}: reruns differ")
    c, m, n, cp, _names = next(p for p in planned
                               if p[0].name == "cell/no_agg_row_side"
                               and p[1] == M_SWEEP)
    env = random_env(cp, gen)
    X = env[cp.main.nid]
    shifted = torch.empty(X.numel() + 1, device="cuda")[1:].view(X.shape)
    shifted.copy_(X)
    try:
        ops.execute(cp, {**env, cp.main.nid: shifted}, kernels="cuda")
    except ValueError as e:
        log(f"[check] {c.name}: an operand 4 bytes off a 16-byte boundary "
            f"raises: {e}")
    else:
        raise AssertionError("a misaligned vector-walk operand ran")


def path_cplans(path) -> list:
    return region_cplans(path.regions, path.name + " ")


def algo_phase(path, cps, counters, launches, main_err, per_kernel) -> list:
    """One dense algorithm at the main path's width: the run with
    ``kernels="cuda"`` (counters set to 0 just before it and read just
    after, added into ``launches``), its checks, its trace against
    ``kernels="never"``, a planted fault and the hand baseline, a profile,
    then its CPlans against plain and timed (into ``main_err`` and
    ``per_kernel``); returns the ``kernels="cuda"`` trace."""
    import torch
    name = path.name
    t_phase = time.perf_counter()
    ops = path.data()
    torch.cuda.synchronize()
    shapes = [tuple(t.shape) for t in ops]
    log(f"[{name}] data {shapes} fp32 drawn on the card in "
        f"{time.perf_counter() - t_phase:.1f} s; {path.depth}")
    run = lambda **kw: path.run(ops, **kw)
    for mod in counters.values():
        mod.launches = 0
    t0 = time.perf_counter()
    params, trace = run(kernels="cuda")
    torch.cuda.synchronize()
    t_cuda = time.perf_counter() - t0
    counts = {k: mod.launches for k, mod in counters.items()}
    for k, c in counts.items():
        launches[k] += c
    log(f"[{name}] run kernels=cuda: {t_cuda:.2f} s host clock (planning "
        f"included); launches {json.dumps(counts)}")
    log(f"[{name}] trace (kernels=cuda): {trace}")
    needed = sorted({kernel_name(cp) for _l, cp in cps})
    missing = [k for k in needed if counts[k] == 0]
    if missing:
        raise AssertionError(f"{name} main path never launched: {missing}")
    path.check(ops, params)
    del params
    t0 = time.perf_counter()
    _p, trace_plain = run(kernels="never")
    torch.cuda.synchronize()
    log(f"[{name}] kernels=never: {time.perf_counter() - t0:.2f} s; trace "
        f"{trace_plain}")
    with planted_fault():
        _p, trace_fault = run(kernels="cuda")
    _p, trace_hand = run(mode="hand")
    del _p
    rel, rel_fault = trace_rel(trace, trace_plain), trace_rel(trace_fault,
                                                              trace_plain)
    rel_hand = trace_rel(trace_hand, trace_plain)
    log(f"[{name}] planted fault (one partial dropped in every reducing "
        f"kernel): trace {trace_fault}")
    log(f"[{name}] hand torch baseline trace {trace_hand}")
    log(f"[{name}] max relative trace difference vs never: kernels "
        f"{rel:.3e}, planted {rel_fault:.3e} (tolerance {TRACE_RTOL:g}); "
        f"hand {rel_hand:.3e} (tolerance {HAND_RTOL:g})")
    failed = []
    if not rel <= TRACE_RTOL:
        failed.append(f"{name}: traces of kernels=cuda and never disagree")
    if not rel_fault > TRACE_RTOL:
        failed.append(f"planted fault passed the {name} trace check")
    if not rel_hand <= HAND_RTOL:
        failed.append(f"{name}: the hand baseline disagrees")
    profile_run(f"{name} kernels=cuda, {path.depth}",
                lambda: run(kernels="cuda"))

    # the path's CPlans at its shapes, against plain, then timed
    gen = torch.Generator(device="cuda").manual_seed(2468)
    shared = {tuple(ops[0].shape): ops[0]}     # X: the path's data matrix
    envs = []
    for label, cp in cps:
        env = random_env(cp, gen, shared)
        kname = kernel_name(cp)
        err, share = compare(cp, env, f"main-path {label} {cp.ttype.name} "
                                      f"{cp.variant}")
        main_err[kname] = max(main_err[kname], err)
        envs.append(env)
        log(f"[check] main path {label:28s} {kname:4s} "
            f"{layout_name(cp):4s} {cp.variant:9s} "
            f"binds {[tuple(b.shape) for b in cp.binds]} "
            f"max|kernel-plain| {err:.3e} = {share:.3g} x limit")
        if kname == "cell":
            failed += cell_checks(label, cp, env, fault=name == "glm")
    dense_times(cps, envs, per_kernel)
    del ops, envs, shared
    torch.cuda.empty_cache()
    log(f"[{name}] phase wall {time.perf_counter() - t_phase:.1f} s")
    if failed:
        raise AssertionError("; ".join(failed))
    return trace


# --------------------------------------------------------------------------
# the request axis, CLA, serving and chaos (phases 12-16)
# --------------------------------------------------------------------------

#: request counts and (class rows, width) the request-axis kernels are held
#: to plain at, every Cell, Row and MAgg sweep case; each request's real
#: rows are fewer than the class's (the rows past them zero in every
#: operand with the class's rows), as the server stacks them
BATCH_SIZES = (1, 3, 8)
BATCH_SHAPES = ((1_031, 7), (200_003, N_MAIN))
#: the main path's widths: hinge and probs (and the pad-safe sum regions
#: the serving phase also runs) at 8 requests of a 1,048,576-row class
WIDE_BATCH, WIDE_ROWS = 8, 1_048_576
#: sweep cases whose batched form, with every request reading request 0's
#: side input (its stride set to 0), must fail the kernel check
PLANTED_STRIDE = ("cell/no_agg", "row/no_agg_mm1", "magg/k2_sum_max")
#: the request-axis forms' records in the result line
BATCHED = {"cell_batched": "cell", "row_batched": "row",
           "magg_batched": "magg"}
#: the reference's serving harness, verbatim (benchmarks/serving.py:52-63)
SERVE_CLIENTS, SERVE_REQS = 32, 8
SERVE_ROWS, SERVE_FEATURES, SERVE_CLASSES = (115, 240, 490), 64, 5
SERVE_PAD_TO, SERVE_MAX_BATCH, SERVE_WORKERS = 128, 8, 2
#: the serving load at the main path's width
WIDE_SERVE_ROWS, WIDE_SERVE_PAD_TO = (250_000, 500_000, 1_000_000), 262_144
WIDE_SERVE_CLIENTS, WIDE_SERVE_REQS = 8, 4
#: the wide load runs this many times: one round of 32 requests lasts
#: about 50 ms, too short for a rate or a p99 on its own
WIDE_SERVE_ROUNDS = 10
#: CLA: X 10^7 x 100 with 64 levels per column
CLA_ROWS, CLA_LEVELS = 10_000_000, 64


def batch_regions():
    """The regions the serving phases and the main-width batched checks
    run: the reference harness's hinge and softmax scoring regions
    (``algos.l2svm._hinge``, ``algos.mlogreg._probs``) and two pad-safe
    aggregates, a sum of squares (Cell) and two sums (MAgg)."""
    from repro_torch.algos import l2svm, mlogreg
    from repro_torch.core import fused, ir
    sum_sq = fused(lambda X: (X * X).sum())
    two_sums = fused(lambda X, Y: ((X * Y).sum(), (X ** 2).sum()))
    return {"hinge": l2svm._hinge, "probs": mlogreg._probs,
            "sum_sq": sum_sq, "two_sums": two_sums}


def batch_region_shapes(name: str, m: int, n: int, k: int = MLR_K) -> dict:
    return {"hinge": {"X": (m, n), "w": (n, 1), "y": (m, 1)},
            "probs": {"X": (m, n), "B": (n, k)},
            "sum_sq": {"X": (m, n)},
            "two_sums": {"X": (m, n), "Y": (m, n)}}[name]


def batch_region_cplans(n: int, k: int = MLR_K, m: int = 128):
    """[(region name, cplan)] of the batch regions at (m, n) (their
    sources do not depend on m)."""
    out = []
    for name, region in batch_regions().items():
        args = tuple(meta(*s) for s in
                     batch_region_shapes(name, m, n, k).values())
        out += [(name, cp) for _l, cp in
                region_cplans([(region, args, False)])]
    return out


def ragged_rows(m: int, nreq: int) -> list[int]:
    """Each request's real rows inside an m-row class (request 0 fills
    it)."""
    return [max(1, m - (q * 7919) % max(m // 3, 1)) for q in range(nreq)]


def batch_env(cplan, nreq: int, gen):
    """(stacked operands, real rows): every bind (nreq, *shape) on the
    card in the server's stacked layout, random, with the rows past each
    request's real rows zero in every operand that has the main's rows."""
    import torch
    from repro_torch.kernels import build
    m = cplan.main.shape[0]
    real = ragged_rows(m, nreq)
    env = {}
    for b in cplan.binds:
        shape = tuple(b.shape)
        t = build.batch_empty(nreq, shape, "cuda")
        t.copy_(0.3 * torch.randn((nreq,) + shape, generator=gen,
                                  device="cuda"))
        if shape[0] == m and m > 1:
            for q, r in enumerate(real):
                t[q, r:] = 0.0
        env[b.nid] = t
    return env, real


def request_env(env, q: int) -> dict:
    return {nid: t[q] for nid, t in env.items()}


def batch_measure(cplan, env, got, label: str) -> tuple[float, float, float]:
    """(max |error|, largest and smallest per-request share of the
    limit) of a batched output against the plain version per request."""
    err, hi, lo = 0.0, 0.0, math.inf
    for q in range(got.shape[0]):
        e, sh = measure(cplan, request_env(env, q), got[q],
                        f"{label} request {q}")
        err, hi, lo = max(err, e), max(hi, sh), min(lo, sh)
    return err, hi, lo


@contextlib.contextmanager
def planted_stride():
    """Every batched launch inside reads request 0's side inputs: the
    per-request stride of every bind but the main is set to 0."""
    from repro_torch.kernels import build
    orig = build.cuda_batched_operands

    def zeroed(cplan, env):
        binds, strides, nreq = orig(cplan, env)
        return binds, [s if b.nid == cplan.main.nid else 0
                       for b, s in zip(cplan.binds, strides)], nreq

    build.cuda_batched_operands = zeroed
    try:
        yield
    finally:
        build.cuda_batched_operands = orig


def batch_bound_ms(cplan, env, out, nreq: int) -> tuple[float, str]:
    """:func:`bound_ms` of a batched call: the stacked operands' and
    outputs' bytes, and ``nreq`` times one request's operations."""
    t_bytes = (out.numel() + sum(t.numel() for t in env.values())) * 4 \
        / HBM_BW * 1e3
    t_flops = nreq * program_flops(cplan, out[0]) / FP32_PEAK * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_flops else \
        (t_flops, "operations")


def _batched_sum_sq_call(cp, env):
    import torch
    ((_n, op, args, *_r),) = cp.prog
    if not (op == "pow2" or op == "mul" and args[0] == args[1]
            == ("b", cp.main.nid)) or cp.agg_op != "sum":
        raise AssertionError(f"{cp.prog}: not a sum of squares")
    X = env[cp.main.nid]
    return lambda: torch.einsum("bij,bij->b", X, X)


#: batched CPlans that one PyTorch call also computes: (region, kernel,
#: variant) -> that call on the stacked operands (Σx² per request)
BATCH_LIBRARY_CALLS = {
    ("sum_sq", "cell", "full_agg"): _batched_sum_sq_call,
}


def batched_time(label, cp, env, nreq: int) -> dict:
    """One batched call's times at the main path's width: the request-axis
    kernel (CUDA events, device), its plain version (the oracle per
    request), one PyTorch call of the same function where there is one
    (``BATCH_LIBRARY_CALLS``), the bound; a ``[time]`` line."""
    import torch
    from repro_torch.kernels import ops, ref
    kernel = lambda: ops.execute_batched(cp, env, kernels="cuda")
    plain = lambda: ref.execute_dense_batched(cp, env)
    kname = kernel_name(cp)
    library = BATCH_LIBRARY_CALLS.get((label, kname, cp.variant))
    traced = []
    ms, plain_ms = time_ms(kernel, reps=5, rounds=3), \
        time_ms(plain, reps=2, rounds=3)
    dev_ms = device_ms(kernel, reps=5, names=traced)
    b_ms, b_by = batch_bound_ms(cp, env, kernel(), nreq)
    part = {"region": label, "variant": cp.variant, "requests": nreq,
            "layout": layout_name(cp), "ms": ms, "plain_ms": plain_ms,
            "device_ms": dev_ms, "bound_ms": b_ms, "bound_by": b_by,
            "device_kernels": [[k[:60], c] for k, c in traced]}
    lib = ""
    if library is not None:
        # the library call must compute the same function: within 1e-2 of
        # the plain version (a different function is off by far more; its
        # own rounding over 10^8 terms a request is logged, not held)
        call = library(cp, env)
        want = plain().reshape(-1).double()
        rel = lambda v: float(((v.reshape(-1).double() - want).abs()
                               / want.abs()).max())
        lib_rel, ker_rel = rel(call()), rel(kernel())
        if not lib_rel <= 1e-2:
            raise AssertionError(f"batched {label}: the library call is "
                                 f"{lib_rel:.3e} off the plain version")
        part["library_ms"] = time_ms(call, reps=5, rounds=3)
        part["library_device_ms"] = device_ms(call, reps=5)
        lib = (f" library {part['library_ms']:.4f} ms (device "
               f"{part['library_device_ms']}; relative to plain: library "
               f"{lib_rel:.3e}, kernel {ker_rel:.3e})")
    log(f"[time] batched {label:14s} {kname:4s} {layout_name(cp):4s} "
        f"{cp.variant:9s} B={nreq} kernel {ms:.4f} ms (device {dev_ms}) "
        f"plain {plain_ms:.4f} ms{lib} bound {b_ms:.4f} ms ({b_by}); per "
        f"call on the card: " + " + ".join(f"{k.split('(')[0][:40]} x{c:g}"
                                           for k, c in traced))
    return part


def batch_phase(planned_batch, wide_cps, batch_err, per_kernel) -> None:
    """[batch]: every Cell, Row and MAgg sweep case's request-axis form
    against plain, request by request (16 eps); reducing cases twice for
    the same bits; the two planted faults (a side stride of 0, a per-
    request fold that drops its middle partial) must fail; then the
    main path's widths, timed."""
    import torch
    from repro_torch.kernels import ops
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(97)
    n_checked = 0
    worst = {k: 0.0 for k in BATCHED}
    for c, m, n, cp in planned_batch:
        bname = {v: k for k, v in BATCHED.items()}[kernel_name(cp)]
        for nreq in BATCH_SIZES:
            env, real = batch_env(cp, nreq, gen)
            got = ops.execute_batched(cp, env, kernels="cuda")
            err, share, _lo = batch_measure(cp, env, got,
                                            f"batched {c.name}")
            if not share <= 1.0:
                raise AssertionError(f"batched {c.name} B={nreq}: "
                                     f"{share:.3g} x its limit")
            worst[bname] = max(worst[bname], share)
            n_checked += nreq
            same = "-"
            if cp.variant != "no_agg":
                again = ops.execute_batched(cp, env, kernels="cuda")
                same = "bit-identical" if torch.equal(got, again) \
                    else "DIFFER"
                if same != "bit-identical":
                    raise AssertionError(f"batched {c.name}: reruns differ")
            log(f"[batch] {c.name:30s} B={nreq} {m:>7d}x{n:<3d} rows "
                f"{real} {layout_name(cp):4s} {cp.variant:9s} "
                f"max|kernel-plain| {err:.3e} = {share:.3g} x limit; "
                f"rerun {same}")
            del env, got
        if m == BATCH_SHAPES[-1][0] and c.name in PLANTED_STRIDE:
            env, _real = batch_env(cp, 3, gen)
            with planted_stride():
                got = ops.execute_batched(cp, env, kernels="cuda")
            err, share, _lo = batch_measure(cp, env, got,
                                            f"planted stride {c.name}")
            log(f"[batch] planted fault (side stride 0: every request "
                f"reads request 0's side) {c.name}: max|kernel-plain| "
                f"{err:.3e} = {share:.3g} x limit")
            if not share > 1.0:
                raise AssertionError(f"planted stride fault in {c.name} "
                                     f"passed the kernel check")
        if m == BATCH_SHAPES[-1][0] and c.name in PLANTED:
            env, _real = batch_env(cp, 3, gen)
            with planted_fault():
                got = ops.execute_batched(cp, env, kernels="cuda")
            err, share, lo = batch_measure(cp, env, got,
                                           f"planted fold {c.name}")
            log(f"[batch] planted fault (each request's fold drops its "
                f"middle partial) {c.name}: max|kernel-plain| {err:.3e} "
                f"= {share:.3g} x limit, every request >= {lo:.3g}")
            if not lo > 1.0:
                raise AssertionError(f"planted fold fault in {c.name} "
                                     f"passed the kernel check for a "
                                     f"request")
    log(f"[batch] sweep passed: {n_checked} requests, limit {KERNEL_ULPS} "
        f"x eps32 x error scale per request; largest share "
        + json.dumps(worst))
    # the main path's widths: one batch of WIDE_BATCH requests each
    for label, cp in wide_cps:
        bname = {v: k for k, v in BATCHED.items()}[kernel_name(cp)]
        env, real = batch_env(cp, WIDE_BATCH, gen)
        got = ops.execute_batched(cp, env, kernels="cuda")
        err, share, _lo = batch_measure(cp, env, got, f"batched {label}")
        if not share <= 1.0:
            raise AssertionError(f"batched {label}: {share:.3g} x its "
                                 f"limit")
        batch_err[bname] = max(batch_err[bname], err)
        log(f"[batch] main-path width {label} {cp.variant} B={WIDE_BATCH} "
            f"x {cp.main.shape[0]} x {cp.main.shape[1]} rows {real}: "
            f"max|kernel-plain| {err:.3e} = {share:.3g} x limit")
        del got
        rec = per_kernel.setdefault(bname, new_record())
        add_part(rec, batched_time(label, cp, env, WIDE_BATCH))
        del env
        torch.cuda.empty_cache()
    log(f"[batch] phase wall {time.perf_counter() - t0:.1f} s")


def cla_phase(counters) -> None:
    """[cla]: X 10^7 x 100 quantized to CLA_LEVELS levels per column,
    compressed on the card; a qualifying full_agg region (the CLA path,
    no kernel) against the same region on the dense X (the Cell kernel);
    a non-qualifying one (a side matrix) through todense() and the dense
    kernels, launches counted, equal to the dense call bit for bit."""
    import torch
    from repro_torch.core import fused, ir
    from repro_torch.kernels.blocksparse import DictCompressed
    t0 = time.perf_counter()
    g = torch.Generator(device="cuda").manual_seed(5)
    levels = torch.randint(0, CLA_LEVELS, (CLA_ROWS, N_MAIN), generator=g,
                           device="cuda", dtype=torch.int32)
    scale = 0.05 + torch.rand((1, N_MAIN), generator=g, device="cuda")
    X = (levels.float() - CLA_LEVELS / 2) * scale / 8
    del levels
    w = torch.randn((N_MAIN, 1), generator=g, device="cuda")
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    C = DictCompressed.from_dense(X)
    torch.cuda.synchronize()
    t_comp = time.perf_counter() - t1
    log(f"[cla] X {CLA_ROWS}x{N_MAIN} fp32, {CLA_LEVELS} levels a column, "
        f"compressed on the card in {t_comp:.2f} s: values "
        f"{tuple(C.values.shape)}, ratio {C.compression_ratio:.2f}")
    sq = fused(lambda X: (X * X).sum())
    side = fused(lambda X, w: ((X @ w) ** 2).sum())
    want = sq(X)
    for mod in counters.values():
        mod.launches = 0
    got = sq(C)
    torch.cuda.synchronize()
    counts = {k: mod.launches for k, mod in counters.items()}
    rel = abs(float(got) - float(want)) / abs(float(want))
    log(f"[cla] qualifying sum(X*X): CLA {float(got):.9g} vs dense kernel "
        f"{float(want):.9g}, relative {rel:.3e} (tolerance {TRACE_RTOL:g}); "
        f"launches {json.dumps(counts)}")
    if not rel <= TRACE_RTOL or any(counts.values()):
        raise AssertionError("CLA: the qualifying region disagrees or "
                             "launched a kernel")
    ms_cla, ms_dense = time_ms(lambda: sq(C)), time_ms(lambda: sq(X))
    log(f"[cla] sum(X*X) per call: CLA path {ms_cla:.4f} ms, dense Cell "
        f"kernel {ms_dense:.4f} ms (CUDA events, host included)")
    want = side(X, w)
    for mod in counters.values():
        mod.launches = 0
    got = side(C, w)
    torch.cuda.synchronize()
    counts = {k: mod.launches for k, mod in counters.items()}
    same = bool(torch.equal(got, want))
    log(f"[cla] non-qualifying sum((X@w)^2): todense + dense kernels "
        f"{float(got):.9g} vs dense {float(want):.9g} "
        f"({'bit-identical' if same else 'DIFFER'}); launches "
        f"{json.dumps(counts)}")
    if not same or not any(counts.values()):
        raise AssertionError("CLA: the densified region disagrees or "
                             "launched no kernel")
    del X, C, w
    torch.cuda.empty_cache()
    log(f"[cla] phase wall {time.perf_counter() - t0:.1f} s")


def serve_cases(rows, n_features, n_classes, seed: int, card: bool):
    """The reference harness's cases (``benchmarks/serving.py``
    ``harness_regions``): the hinge and softmax regions at every row
    count, X shared by the two; numpy draws (``card`` False: the
    reference's own generator and seed) or draws on the card."""
    import numpy as np
    import torch
    from repro_torch.algos import l2svm, mlogreg
    cases = []
    if card:
        g = torch.Generator(device="cuda").manual_seed(seed)
        draw = lambda *s: torch.randn(s, generator=g, device="cuda")
        sign = lambda m: torch.where(draw(m, 1) >= 0, 1.0, -1.0)
    else:
        rng = np.random.default_rng(seed)
        to = lambda a: torch.as_tensor(np.asarray(a, np.float32),
                                       device="cuda")
        draw = lambda *s: to(rng.standard_normal(s))
        sign = lambda m: to(rng.choice([-1.0, 1.0], (m, 1)))
    for m in rows:
        X = draw(m, n_features)
        w = draw(n_features, 1)
        y = sign(m)
        cases.append((f"l2svm_hinge_m{m}", l2svm._hinge,
                      {"X": X, "w": w, "y": y}))
        B = draw(n_features, n_classes)
        cases.append((f"mlogreg_probs_m{m}", mlogreg._probs,
                      {"X": X, "B": B}))
    return cases


def aggregate_cases(rows, n_features, seed: int):
    """The pad-safe aggregates (Cell sum of squares, MAgg two sums) at
    every row count, drawn on the card."""
    import torch
    regs = batch_regions()
    g = torch.Generator(device="cuda").manual_seed(seed)
    cases = []
    for m in rows:
        X = torch.randn((m, n_features), generator=g, device="cuda")
        Y = torch.randn((m, n_features), generator=g, device="cuda")
        cases.append((f"sum_sq_m{m}", regs["sum_sq"], {"X": X}))
        cases.append((f"two_sums_m{m}", regs["two_sums"], {"X": X, "Y": Y}))
    return cases


def _close(got, want) -> float:
    """max |got - want| of a result (tensor or tuple); raises beyond
    rtol 1e-5 and atol 1e-5 (the reference harness's parity rule)."""
    import torch
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    err = 0.0
    for a, b in zip(got, want):
        if tuple(a.shape) != tuple(b.shape):
            raise AssertionError(f"served shape {tuple(a.shape)} != direct "
                                 f"{tuple(b.shape)}")
        if not torch.allclose(a, b, rtol=1e-5, atol=1e-5):
            raise AssertionError(f"served result diverges from the direct "
                                 f"call: max |d| {float((a - b).abs().max())}")
        err = max(err, float((a - b).abs().max()) if a.numel() else 0.0)
    return err


def check_parity(server, cases) -> float:
    """Every case served against its direct call (1e-5); the largest
    difference."""
    futs = [(label, server.submit(region, **ops), region(**ops))
            for label, region, ops in cases]
    return max(_close(f.result(timeout=600), want)
               for _label, f, want in futs)


def run_load(server, cases, n_clients: int, reqs: int,
             seed: int = 10_000) -> dict:
    """``n_clients`` threads x ``reqs`` requests, each a seeded random
    case (the reference harness's ``run_load``); the latencies are this
    load's own (``latency_values``, the server's reservoir past its count
    before the load)."""
    import threading
    import numpy as np
    from repro_torch.serve import percentiles
    errors = []
    lock = threading.Lock()
    seen = server.metrics.latency_us.count

    def client(k: int) -> None:
        rng = np.random.default_rng(seed + k)
        futs = []
        for _ in range(reqs):
            _label, region, ops = cases[int(rng.integers(len(cases)))]
            futs.append(server.submit(region, **ops))
        for f in futs:
            try:
                f.result(timeout=600)
            except Exception as e:         # noqa: BLE001 - asserted on
                with lock:
                    errors.append(e)

    threads = [threading.Thread(target=client, args=(k,), daemon=True)
               for k in range(n_clients)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    elapsed = time.perf_counter() - t0
    total = n_clients * reqs
    snap = server.metrics.snapshot()
    lat = server.metrics.latency_us.values()
    lat = lat[len(lat) - (server.metrics.latency_us.count - seen):]
    return {"requests": total, "elapsed_s": elapsed,
            "throughput_rps": total / elapsed,
            "us_per_req": elapsed / total * 1e6,
            "latency_values": lat, "latency_us": percentiles(lat),
            "occupancy_mean": snap["batches"]["occupancy_mean"],
            "failed": snap["requests"]["failed"] + len(errors),
            "rejected": snap["requests"]["rejected"], "errors": errors}


def pooled(runs) -> dict:
    """The :func:`run_load` results of several rounds as one load: summed
    requests and time, percentiles over every round's latencies."""
    from repro_torch.serve import percentiles
    if len(runs) == 1:
        return runs[0]
    total = sum(r["requests"] for r in runs)
    elapsed = sum(r["elapsed_s"] for r in runs)
    lat = [v for r in runs for v in r["latency_values"]]
    return {"requests": total, "elapsed_s": elapsed,
            "throughput_rps": total / elapsed,
            "us_per_req": elapsed / total * 1e6,
            "latency_values": lat, "latency_us": percentiles(lat),
            "occupancy_mean": runs[-1]["occupancy_mean"],
            "failed": sum(r["failed"] for r in runs),
            "rejected": runs[-1]["rejected"],
            "errors": [e for r in runs for e in r["errors"]]}


def spread(runs) -> str:
    """Each round's rate and percentiles, least to most."""
    def span(vals, fmt):
        return f"{fmt.format(min(vals))}-{fmt.format(max(vals))}"
    return (f"req/s {span([r['throughput_rps'] for r in runs], '{:.1f}')}, "
            + ", ".join(
                f"{q} {span([r['latency_us'][q] for r in runs], '{:.1f}')}"
                for q in ("p50", "p95", "p99"))
            + " us across rounds; per round req/s "
            + json.dumps([r["throughput_rps"] for r in runs])
            + ", p99 us " + json.dumps([r["latency_us"]["p99"]
                                        for r in runs]))


def serve_arm(label, cases, counters, bcounters, *, max_batch: int,
              pad_to: int, n_clients: int, reqs: int,
              batch_sizes=(1, 2, 4, 8), profile_rows: int = 0,
              rounds: int = 1) -> dict:
    """One load run of the reference harness's shape: warm at every batch
    size, parity of every case against its direct call, then counters
    set to 0 just before the load and read just after: request-axis
    launches must equal the batches dispatched times the fused CPlans of
    their plan, single-request launches likewise when unbatched; no
    request fails and no runtime fallback is recorded.  With ``rounds``
    > 1 the load runs that many times (seeds apart): the rate and the
    percentiles are over all of them, beside each round's spread.  With
    ``profile_rows``, one batched dispatch of the hinge entry at that
    class is profiled."""
    import torch
    from repro_torch.serve import FusionServer
    regions = [(region, ops) for _l, region, ops in cases]
    sizes = tuple(b for b in batch_sizes if b <= max_batch)
    with FusionServer(workers=SERVE_WORKERS, max_batch=max_batch,
                      pad_to=pad_to) as server:
        t0 = time.perf_counter()
        server.warm(regions, batch_sizes=sizes)
        t_warm = time.perf_counter() - t0
        err = check_parity(server, cases)
        before = {b["bucket"]: b["batches"]
                  for b in server.metrics.snapshot()["buckets"]}
        for mod in counters.values():
            mod.launches = 0
        for mod in bcounters.values():
            mod.batched_launches = 0
        runs = [run_load(server, cases, n_clients, reqs,
                         seed=10_000 + 1_000 * r) for r in range(rounds)]
        torch.cuda.synchronize()
        res = pooled(runs)
        single = {k: mod.launches for k, mod in counters.items()}
        batched = {k: mod.batched_launches for k, mod in bcounters.items()}
        snap = server.metrics.snapshot()
        per_digest = {}
        for e in server._entries.values():
            per_digest[e.digest] = (len(e.compiled._cplan.cplans()),
                                    e.batchable)
        want_b = want_s = 0
        for b in snap["buckets"]:
            n_cp, batchable = per_digest[b["bucket"]]
            d = b["batches"] - before.get(b["bucket"], 0)
            if batchable:
                want_b += d * n_cp
            else:
                want_s += d * n_cp
        got_b, got_s = sum(batched.values()), sum(single.values())
        log(f"[{label}] warm {t_warm:.2f} s at batch sizes {sizes}; parity "
            f"of {len(cases)} cases vs direct calls: max |d| {err:.3e}")
        log(f"[{label}] {res['requests']} requests from {n_clients} "
            f"clients, max_batch {max_batch}, pad_to {pad_to}: "
            f"{res['throughput_rps']:.1f} req/s "
            f"({res['us_per_req']:.1f} us/request), latency p50 "
            f"{res['latency_us']['p50']:.1f} p95 "
            f"{res['latency_us']['p95']:.1f} p99 "
            f"{res['latency_us']['p99']:.1f} us, mean occupancy "
            f"{res['occupancy_mean']:.2f}; batches {snap['batches']}")
        if rounds > 1:
            log(f"[{label}] {rounds} rounds of {n_clients} x {reqs}: "
                + spread(runs))
        log(f"[{label}] launches in the load: request-axis "
            f"{json.dumps(batched)} (want {want_b}), single "
            f"{json.dumps(single)} (want {want_s}); runtime fallbacks "
            f"{snap['runtime_fallbacks']}")
        failed = []
        if res["failed"] or res["rejected"]:
            failed.append(f"{res['failed']} failed, {res['rejected']} "
                          f"rejected ({res['errors'][:3]})")
        if got_b != want_b or got_s != want_s:
            failed.append(f"launches {got_b}/{got_s} != {want_b}/{want_s}")
        if snap["runtime_fallbacks"]:
            failed.append("a runtime fallback was recorded")
        if profile_rows:
            entry = next(e for e in server._entries.values()
                         if e.label.startswith("_hinge")
                         and e.class_shapes["X"][0] == profile_rows)
            profile_batch(label, server, entry)
        if failed:
            raise AssertionError(f"[{label}] " + "; ".join(failed))
    res.update(single=single, batched=batched, parity_err=err)
    return res


def profile_batch(label, server, entry) -> None:
    """One batched dispatch of ``entry`` at max_batch requests under
    torch.profiler: busy, idle share, and the Row kernel's device time
    beside its bound (each stacked operand read once, the output written
    once)."""
    import torch
    from repro_torch.kernels import build
    nreq = server.max_batch
    g = torch.Generator(device="cuda").manual_seed(31)
    stacked = []
    for name in entry.call_order:
        t = build.batch_empty(nreq, entry.class_shapes[name], "cuda")
        t.copy_(torch.randn(t.shape, generator=g, device="cuda"))
        stacked.append(t)
    run = lambda: entry.batched_fn(*stacked)
    out = run()
    nbytes = sum(t.numel() for t in stacked + list(out)) * 4
    profile_run(f"{label} one batched dispatch {entry.label} x {nreq}", run)
    traced = []
    dev = device_ms(run, reps=5, names=traced)
    log(f"[{label}] batched dispatch {entry.label} x {nreq}: device "
        f"{dev} ms, bound {nbytes / HBM_BW * 1e3:.4f} ms (bytes "
        f"{nbytes / 1e9:.3f} GB); kernels {traced}")


def host_costs(label, case, nreq: int = SERVE_MAX_BATCH,
               reps: int = 100) -> None:
    """The host time of one batch of ``nreq`` requests of one case through
    the server's public API, no worker threads and no clients
    (``workers=0``, ``start()``, ``drain()``): the ``nreq`` submits
    (canonicalization, routing, enqueue) and the drain (stacking, the
    batched plan function, the event wait, slicing, resolving the
    futures), beside one direct call of the region with a synchronize;
    all on the host clock."""
    import torch
    from repro_torch.serve import FusionServer
    _l, region, ops = case
    server = FusionServer(workers=0, max_batch=nreq, pad_to=SERVE_PAD_TO)
    server.warm([(region, ops)], batch_sizes=(nreq,))
    server.start()

    def one_batch() -> tuple[float, float]:
        t0 = time.perf_counter()
        futs = [server.submit(region, **ops) for _ in range(nreq)]
        t1 = time.perf_counter()
        n = server.drain()
        t2 = time.perf_counter()
        if n != 1 or not all(f.done() and f.exception() is None
                             for f in futs):
            raise AssertionError(f"[{label}] host cost: {n} batches for "
                                 f"{nreq} requests of one class")
        return t1 - t0, t2 - t1

    def direct() -> float:
        t0 = time.perf_counter()
        region(**ops)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    for _ in range(10):
        one_batch(), direct()
    batches = [one_batch() for _ in range(reps)]
    submit_us = sum(b[0] for b in batches) / reps * 1e6
    drain_us = sum(b[1] for b in batches) / reps * 1e6
    direct_us = sum(direct() for _ in range(reps)) / reps * 1e6
    plan = server.warmed_plans()[0][0]
    server.close()
    log(f"[{label}] host time, no clients, no worker threads: a batch of "
        f"{nreq} {plan}: {nreq} submits {submit_us:.1f} us, drain "
        f"{drain_us:.1f} us ({(submit_us + drain_us) / nreq:.1f} us a "
        f"request); one direct call with a synchronize {direct_us:.1f} us")


def serve_phase(counters, bcounters, serve_launches) -> dict:
    """[serve]: the reference harness verbatim, batched and at max_batch
    1; then the pad-safe aggregates at the same row buckets, so that the
    Cell and MAgg request-axis kernels serve too."""
    t0 = time.perf_counter()
    cases = serve_cases(SERVE_ROWS, SERVE_FEATURES, SERVE_CLASSES, 0,
                        card=False)
    out = {}
    out["batched"] = serve_arm("serve", cases, counters, bcounters,
                               max_batch=SERVE_MAX_BATCH,
                               pad_to=SERVE_PAD_TO,
                               n_clients=SERVE_CLIENTS, reqs=SERVE_REQS)
    out["unbatched"] = serve_arm("serve max_batch 1", cases, counters,
                                 bcounters, max_batch=1, pad_to=0,
                                 n_clients=SERVE_CLIENTS, reqs=SERVE_REQS)
    speed = out["unbatched"]["us_per_req"] / out["batched"]["us_per_req"]
    log(f"[serve] batched vs max_batch 1: {speed:.2f}x the throughput")
    host_costs("serve", cases[-2])
    out["aggregates"] = serve_arm(
        "serve aggregates", aggregate_cases(SERVE_ROWS, SERVE_FEATURES, 7),
        counters, bcounters, max_batch=SERVE_MAX_BATCH, pad_to=SERVE_PAD_TO,
        n_clients=SERVE_CLIENTS // 4, reqs=SERVE_REQS)
    for arm in ("batched", "aggregates"):
        for k, c in out[arm]["batched"].items():
            serve_launches[k] += c
    log(f"[serve] phase wall {time.perf_counter() - t0:.1f} s")
    return out


def serve_wide_phase(counters, bcounters, serve_launches) -> dict:
    """[serve-wide]: the same regions at the main path's width, rows 250k
    / 500k / 1M in classes of 262,144, 8 clients x 4 requests in each of
    WIDE_SERVE_ROUNDS rounds, one batched dispatch profiled."""
    import torch
    t0 = time.perf_counter()
    cases = serve_cases(WIDE_SERVE_ROWS, N_MAIN, MLR_K, 11, card=True)
    res = serve_arm("serve-wide", cases, counters, bcounters,
                    max_batch=SERVE_MAX_BATCH, pad_to=WIDE_SERVE_PAD_TO,
                    n_clients=WIDE_SERVE_CLIENTS, reqs=WIDE_SERVE_REQS,
                    rounds=WIDE_SERVE_ROUNDS,
                    profile_rows=-(-WIDE_SERVE_ROWS[-1] // WIDE_SERVE_PAD_TO)
                    * WIDE_SERVE_PAD_TO)
    for k, c in res["batched"].items():
        serve_launches[k] += c
    del cases
    torch.cuda.empty_cache()
    log(f"[serve-wide] phase wall {time.perf_counter() - t0:.1f} s")
    return res


def chaos_phase() -> None:
    """[chaos]: a seeded schedule over serve.batch_dispatch (error,
    nonfinite) and serve.worker (crash) on the card, check_finite on:
    every future resolves, every result equals the direct call, and the
    counters show the bisections, respawns and degradations."""
    import torch
    from repro_torch import faults
    from repro_torch.serve import FusionServeError, FusionServer
    t0 = time.perf_counter()
    cases = serve_cases(SERVE_ROWS, SERVE_FEATURES, SERVE_CLASSES, 3,
                        card=True)
    want = {label: region(**ops) for label, region, ops in cases}
    sched = faults.FaultSchedule([
        faults.FaultRule("serve.batch_dispatch", kind="error", at=(0, 5)),
        faults.FaultRule("serve.batch_dispatch", kind="nonfinite",
                         at=(2, 7)),
        faults.FaultRule("serve.batch_dispatch", kind="error", p=0.1,
                         count=3),
        faults.FaultRule("serve.worker", kind="crash", at=(1,)),
        faults.FaultRule("serve.worker", kind="crash", p=0.05, count=2),
    ], seed=17)
    import numpy as np
    rng = np.random.default_rng(99)
    picks = [cases[int(rng.integers(len(cases)))] for _ in range(64)]
    with FusionServer(workers=SERVE_WORKERS, max_batch=SERVE_MAX_BATCH,
                      pad_to=SERVE_PAD_TO, check_finite=True,
                      retry_budget=4) as server:
        server.warm([(r, o) for _l, r, o in cases],
                    batch_sizes=(1, 2, 4, 8))
        with faults.inject(sched):
            futs = [(label, server.submit(region, **ops))
                    for label, region, ops in picks]
            ok = typed = 0
            for label, f in futs:
                try:
                    _close(f.result(timeout=600), want[label])
                    ok += 1
                except FusionServeError:
                    typed += 1
        lost = sum(1 for _l, f in futs if not f.done())
        alive = sum(1 for t in server._threads if t.is_alive())
        snap = server.metrics.snapshot()
    res = snap["resilience"]
    log(f"[chaos] {len(futs)} requests under {len(sched.events())} "
        f"injected faults {sched.events()}: {ok} results equal to the "
        f"direct call, {typed} typed errors, {lost} lost; workers alive "
        f"{alive}/{SERVE_WORKERS}; bisections {res['bisections']}, "
        f"respawns {res['workers']['respawns']}, requeued "
        f"{res['workers']['requeued_requests']}, degraded "
        f"{res['degraded']}, nonfinite detected "
        f"{res['nonfinite_detected']}, failed dispatches "
        f"{snap['batches']['failed_dispatches']}")
    if lost or ok + typed != len(futs) or alive != SERVE_WORKERS:
        raise AssertionError("chaos: a request was lost or a worker died")
    if not (res["workers"]["respawns"] >= 1 and sum(res["degraded"].values())
            >= 1 and snap["batches"]["failed_dispatches"] >= 1):
        raise AssertionError("chaos: the schedule's faults were not all "
                             "handled by the ladder")
    del cases, want
    torch.cuda.empty_cache()
    log(f"[chaos] phase wall {time.perf_counter() - t0:.1f} s")


# --------------------------------------------------------------------------
# [dist]: distributed segments on a mesh of rank processes (phase 17)
# --------------------------------------------------------------------------

#: rank processes of the [dist] phase, all on the one card
DIST_RANKS = 4
#: the reference's segment program (tests/test_pallas_segments.py:164-200)
#: at six (m, 64) operands: 6.1 GB a rank
DIST_SEG_SHAPE = (4_000_000, 64)
#: iterations of the L2SVM run with the planted Row fold under the mesh
DIST_FAULT_ITERS = 2
#: seconds the rank processes may take together; then they are killed
DIST_TIMEOUT_S = 600
#: the process group's timeout: a collective whose peer is gone fails
DIST_PG_TIMEOUT_S = 120
#: the sizes a rank takes from the phase that starts it (a run at reduced
#: sizes reduces its ranks' too)
#: the [dist] paths each rank runs, counted and checked one by one
DIST_PATHS = ("l2svm", "mlogreg", "segment", "outer")
#: the fused loss under ``TrainConfig(fusion_layout=mesh)``: logits of
#: [lm-train-sharded]'s global batch (4 x 128 tokens) over minitron-4b's
#: vocabulary, 128 rows a rank
DIST_LOSS_SHAPE = (512, 256000)
#: its loss and gradient against local planning's and kernels="never"'s
#: (the gradient relative to its largest element)
DIST_LOSS_RTOL = 1e-5
DIST_SIZES = ("M_MAIN", "ITERS", "MLR_OUTER", "MLR_INNER", "DIST_SEG_SHAPE",
              "ALS_SHAPE", "DIST_FAULT_ITERS", "DIST_LOSS_SHAPE")


def dist_segment_expr(ir):
    """The reference's 6-operand segment program: A materialized once and
    read by three aggregates (one segment of ≥ 2 operators), and a
    w-space aggregate."""
    def segment(X1, X2, X3, X4, X5, X6, w):
        A = ir.sigmoid(X1 + X2 + X3 + X4 + X5 + X6)
        return ((A * X1 + X2).sum(), (A - X3).rowsums(),
                (A * A + X4).sum(), (w ** 2).sum())
    return segment


def dist_regions(m: int):
    """The L2SVM and MLogReg regions at m rows (region, meta args,
    backward: the weights ``l2svm.run`` and ``mlogreg.run``
    differentiate), as the [dist] ranks run them."""
    from repro_torch.algos import l2svm, mlogreg
    n, k = N_MAIN, MLR_K
    X, col, lam = meta(m, n), meta(m, 1), meta(1, 1)
    return [(l2svm._hinge, (X, meta(n, 1), col), False),
            (l2svm._search_terms, (col, col), False),
            (l2svm._objective_full, (X, meta(n, 1), col, lam), ("w",)),
            (mlogreg._probs, (X, meta(n, k)), False),
            (mlogreg._nll_obj_reg, (X, meta(n, k), meta(m, k), lam),
             ("B",)),
            (mlogreg._hvp, (X, meta(n, k), meta(m, k)), False)]


def dist_sources() -> list:
    """Every kernel source the [dist] ranks launch, sound and planted: the
    CPlans of their regions planned under an abstract mesh of the ranks'
    shape (a rank's panel CPlan generates the source of its whole CPlan:
    ``tests/test_torch_layout.py``), the segment program's and the ALS
    ``right_mm``'s."""
    from repro_torch.algos import als_cg
    from repro_torch.core import FusionContext, fused, ir
    from repro_torch.core.codegen import compile_plan
    from repro_torch.dist import LogicalMesh
    from repro_torch.kernels import cuda_src
    mesh = LogicalMesh({"data": DIST_RANKS})
    m, n = DIST_SEG_SHAPE
    cps = [cp for _l, cp in region_cplans(
        dist_regions(M_MAIN) + [(fused(dist_segment_expr(ir)),
                                 [meta(m, n)] * 6 + [meta(10, 1)], False)],
        layout=mesh)]
    srcs = [cuda_src.source_for(cp) for cp in cps]
    shape = padded(ALS_SHAPE)
    with FusionContext(layout=mesh):
        (cp,) = compile_plan(als_cg._wsq_mm.trace(
            meta_bcsr(shape), meta(shape[0], ALS_RANK),
            meta(shape[1], ALS_RANK)).plan().eplan).cplans()
    srcs.append(cuda_src.source_for(cp, ALS_BS))
    return srcs + [planted(s) for s in srcs]


def one_rank_at_a_time(mesh, fn):
    """``fn()`` on each rank in turn, the others waiting at a barrier: the
    card serves one rank's checks or timings at a time."""
    import torch.distributed as dist
    out = None
    for r in range(mesh.n):
        dist.barrier(group=mesh.group)
        if mesh.part == r:
            out = fn()
    dist.barrier(group=mesh.group)
    return out


class LaunchRows:
    """(kernel, main rows) of every kernel launch while recording: the
    port's two launchers (``build.launch``, ``build.launch_outer``) wrapped
    in this process."""

    def __init__(self):
        import collections
        from repro_torch.kernels import build
        self.counts = collections.Counter()
        self.on = False
        launch, launch_outer = build.launch, build.launch_outer

        def rec(src, binds, out, part, m, *a, **kw):
            if self.on:
                self.counts[f"{src.template}@{int(m)}"] += 1
            return launch(src, binds, out, part, m, *a, **kw)

        def rec_outer(src, binds, xdata, cols, rowptr, pieces, closer, out,
                      part, m, *a, **kw):
            if self.on:
                self.counts[f"outer@{int(m)}"] += 1
            return launch_outer(src, binds, xdata, cols, rowptr, pieces,
                                closer, out, part, m, *a, **kw)

        build.launch, build.launch_outer = rec, rec_outer

    @contextlib.contextmanager
    def recording(self):
        self.counts.clear()
        self.on = True
        try:
            yield self.counts
        finally:
            self.on = False


class PanelCalls:
    """The first call of each panel CPlan (``ops.execute`` with
    ``shard_rows``, under ``kernels="cuda"``) while recording, kept with
    its operands to be checked and timed after the run."""

    def __init__(self):
        import torch
        from repro_torch.kernels import ops
        self.calls: dict = {}
        self.on = False
        self.execute = execute = ops.execute

        def rec(cplan, env, *, kernels="never", shard_rows=None):
            if self.on and shard_rows is not None and kernels == "cuda":
                # detached: a backward plan's operands may carry autograd
                self.calls.setdefault(id(cplan), (cplan, {
                    k: v.detach() if isinstance(v, torch.Tensor) else v
                    for k, v in env.items()}, shard_rows))
            return execute(cplan, env, kernels=kernels,
                           shard_rows=shard_rows)

        ops.execute = rec


def panel_checks(mesh, calls: PanelCalls, label: str,
                 library=None) -> list:
    """Each recorded panel call again, one rank at a time, as the CPlan of
    its panel (``panel_cplan``) on its panel operands, aligned once
    before: its CUDA output held to its plain version on the same panel
    within the kernel limit per element (:func:`measure`) and timed
    beside the panel's bound three ways: device ms from CUDA events
    queued behind a spin kernel (:func:`queued_ms`: the host's launch
    path and the panel's preparation are outside it), the profiler's
    device ms (:func:`device_ms`, kept to compare: in a rank process it
    has read panels under their HBM bound) and the call's CUDA-event ms
    (:func:`time_ms`, the host's launch path included).  With
    ``library`` (``(label, panel cplan, operands) -> callable``) the
    plain version's and that library call's device ms (queued events)
    are taken too."""
    import torch
    from repro_torch.core.cplan import panel_cplan
    from repro_torch.kernels import cuda_src
    from repro_torch.kernels.blocksparse import BCSR
    from repro_torch.kernels.ops import _aligned

    def checked():
        parts = []
        for cplan, env, rows in calls.calls.values():
            panels = frozenset(b.nid for b in cplan.binds
                               if tuple(env[b.nid].shape)[0] != b.shape[0])
            pcp = panel_cplan(cplan, rows, panels)
            penv = {k: _aligned(v) if k in panels else v
                    for k, v in env.items()}
            kname = "outer" if isinstance(penv[pcp.main.nid], BCSR) else \
                cuda_src.source_for(pcp).template
            fn = lambda: calls.execute(pcp, penv, kernels="cuda")
            out = fn()
            torch.cuda.synchronize()
            err, share = measure(pcp, penv, out, f"[dist] {label} {kname}")
            ms = time_ms(fn)
            dev = queued_ms(fn)
            prof = device_ms(fn)
            b_ms, b_by = bound_ms(pcp, penv, out)
            part = {"region": label, "kernel": kname,
                    "variant": pcp.variant, "rows": rows,
                    "binds": [list(b.shape) for b in pcp.binds],
                    "max_abs_err": err, "share": share, "ms": ms,
                    "device_ms": dev, "profiler_ms": prof,
                    "bound_ms": b_ms, "bound_by": b_by}
            if kname != "outer":
                part["layout"] = layout_name(pcp)
            lib = ""
            if library is not None:
                call = library(label, pcp, penv)
                part["plain_device_ms"] = queued_ms(
                    lambda: calls.execute(pcp, penv, kernels="never"))
                part["library_device_ms"] = queued_ms(call)
                lib = (f", plain {part['plain_device_ms']} ms, library "
                       f"{part['library_device_ms']} ms (device)")
            elif kname == "cell" and sum_of_squares(pcp):
                # Σw² on the panel: torch.dot of the panel with itself
                call = _sum_sq_call(pcp, penv)
                part["library_ms"] = time_ms(call)
                part["library_device_ms"] = queued_ms(call)
                lib = (f", library torch.dot {part['library_ms']:.4f} ms "
                       f"(device {part['library_device_ms']})")
            parts.append(part)
            dev_s, prof_s = ("not measured" if v is None else f"{v:.4f} ms"
                             for v in (dev, prof))
            log(f"[dist] rank {mesh.rank} {label} panel {kname:5s} "
                f"{pcp.variant:9s} binds {part['binds']}: against plain "
                f"{err:.3e} = {share:.3g} x limit; device {dev_s} (queued "
                f"events), profiler {prof_s}, call {ms:.4f} ms (CUDA "
                f"events), bound {b_ms:.4f} ms ({b_by}){lib}")
            del out
        return parts

    return one_rank_at_a_time(mesh, checked)


def mesh_report(regions, mesh) -> dict:
    """Distributed operators and recorded fallbacks over every Compiled
    the regions' call sugar built under this mesh (forward and every
    backward plan it ran)."""
    n_dist, fbs = 0, []
    for region in regions:
        for compiled in region._staged.values():
            if getattr(compiled.planned.context.layout, "mesh", None) \
                    is not mesh:
                continue
            rep = compiled.explain()
            n_dist += rep["distributed"]["n_fused_distributed"]
            fbs += rep["execution"]["fallbacks"]
            n_dist += sum(len(sp.items) for cp in
                          compiled._bwd_plans.values()
                          for sp in cp._seg_plans)
    return {"n_fused_distributed": n_dist, "fallbacks": fbs}


def dist_counters():
    from repro_torch.kernels import cellwise, multiagg, outerprod, rowwise
    return {"cell": cellwise, "magg": multiagg, "row": rowwise,
            "outer": outerprod}


@contextlib.contextmanager
def dist_run(mesh, rows: LaunchRows, calls: PanelCalls, rec: dict):
    """Launch counters set to 0 just before the block and read just after
    into ``rec``, with the launches' row counts, the collectives and their
    wall time, and the panel calls recorded."""
    import torch
    counters = dist_counters()
    torch.cuda.synchronize()
    for mod in counters.values():
        mod.launches = 0
    c0, s0 = mesh.collectives, mesh.collective_s
    calls.calls.clear()
    calls.on = True
    t0 = time.perf_counter()
    with rows.recording() as counts:
        yield
        torch.cuda.synchronize()
    calls.on = False
    rec["wall_s"] = time.perf_counter() - t0
    rec["launches"] = {k: mod.launches for k, mod in counters.items()}
    rec["launch_rows"] = dict(counts)
    rec["collectives"] = mesh.collectives - c0
    rec["collective_ms"] = (mesh.collective_s - s0) * 1e3


def dist_algo(mesh, rows, calls, name: str, data, run, regions,
              fault_kw=None) -> dict:
    """One algorithm under the mesh: ``kernels="cuda"`` (counted), the same
    run with ``kernels="never"``, with ``fault_kw`` a planted-fault run,
    then its panel calls checked and timed (:func:`panel_checks`)."""
    import torch
    ops_ = data()
    rec = {}
    with dist_run(mesh, rows, calls, rec):
        _params, trace = run(ops_, kernels="cuda", layout=mesh)
    rec["trace"] = trace
    rec.update(mesh_report(regions, mesh))
    rec["trace_never"] = run(ops_, kernels="never", layout=mesh)[1]
    if fault_kw is not None:
        with planted_fault():
            rec["trace_fault"] = run(ops_, kernels="cuda", layout=mesh,
                                     **fault_kw)[1]
    log(f"[dist] rank {mesh.rank} {name}: trace {trace}, never "
        f"{rec['trace_never']}, planted {rec.get('trace_fault')}; launches "
        f"{rec['launches']} by rows {rec['launch_rows']}; "
        f"{rec['collectives']} collectives, {rec['collective_ms']:.1f} ms; "
        f"wall {rec['wall_s']:.2f} s")
    rec["panels"] = panel_checks(mesh, calls, name)
    calls.calls.clear()
    del ops_, _params
    torch.cuda.empty_cache()
    return rec


def segment_shares(compiled, sp, args, outs, label: str) -> list:
    """Each exported member of segment step ``sp`` held to its plain
    version on whole operands (the members run in order on the whole
    values): [(max |error|, share of the kernel limit)]."""
    from repro_torch.kernels import ops
    import torch
    graph = compiled.planned.eplan.graph
    bound = dict(zip(compiled.planned.traced.in_names, args))
    genv = {n.nid: bound[n.name] for n in graph.inputs()}
    genv.update(compiled._cplan._literals())
    out_pos = {o.nid: i for i, o in enumerate(graph.outputs)}
    shares = []
    for k, it in enumerate(sp.items):
        venv = {b.nid: genv[b.nid] for b in it.cplan.binds}
        whole = ops.execute(it.cplan, venv, kernels="never")
        if it.export:
            got = torch.cat([outs[out_pos[r]].reshape(1, 1) for r in
                             it.roots]) if len(it.roots) > 1 \
                else outs[out_pos[it.roots[0]]]
            shares.append(measure(it.cplan, venv, got,
                                  f"{label} member {k}"))
        if len(it.roots) > 1:
            for j, r in enumerate(it.roots):
                genv[r] = whole[j].reshape(1, 1)
        else:
            genv[it.roots[0]] = whole
    return shares


def dist_segment(mesh, rows, calls) -> dict:
    """The segment program at DIST_SEG_SHAPE under the mesh: one segment
    step of ≥ 2 members, every exported output held to its member's plain
    version on whole operands, and the planted collective faults (an
    all-reduce skipped, rank 1's panel dropped from the all-gather)."""
    import torch
    from repro_torch.core import FusionContext, fused, ir
    m, n = DIST_SEG_SHAPE
    g = torch.Generator(device="cuda").manual_seed(11)
    args = [torch.randn((m, n), generator=g, device="cuda")
            for _ in range(6)] + [torch.randn((10, 1), generator=g,
                                              device="cuda")]
    with FusionContext(layout=mesh, device=str(mesh.device)):
        compiled = fused(dist_segment_expr(ir)).trace(*args).plan() \
            .compile()
    rec = {}
    with dist_run(mesh, rows, calls, rec):
        outs = compiled(*args)
    sps = compiled._cplan._seg_plans
    rec["members"] = [len(sp.items) for sp in sps]
    rec["fallbacks"] = compiled.explain()["execution"]["fallbacks"]
    if len(sps) != 1 or len(sps[0].items) < 2 or rec["fallbacks"]:
        raise AssertionError(f"segment program: steps {rec['members']}, "
                             f"fallbacks {rec['fallbacks']}")
    rec["shares"] = one_rank_at_a_time(mesh, lambda: segment_shares(
        compiled, sps[0], args, outs, "segment"))

    # planted collective faults: each must fail the same check
    mesh.all_reduce = lambda t, epilogue: t.clone()      # psum skipped
    try:
        bad = compiled(*args)
    finally:
        del mesh.all_reduce
    rec["shares_psum_skipped"] = one_rank_at_a_time(
        mesh, lambda: segment_shares(compiled, sps[0], args, bad,
                                     "segment, psum skipped"))
    gather = mesh.all_gather

    def drop_rank1(panel, dim=0, over="row"):
        out = gather(panel, dim, over)
        out[panel.shape[0]:2 * panel.shape[0]] = 0.0
        return out

    mesh.all_gather = drop_rank1
    try:
        bad = compiled(*args)
    finally:
        del mesh.all_gather
    rec["shares_gather_dropped"] = one_rank_at_a_time(
        mesh, lambda: segment_shares(compiled, sps[0], args, bad,
                                     "segment, rank 1's panel dropped"))
    log(f"[dist] rank {mesh.rank} segment program {m}x{n}: members "
        f"{rec['members']}, launches {rec['launches']} by rows "
        f"{rec['launch_rows']}, {rec['collectives']} collectives "
        f"{rec['collective_ms']:.1f} ms; shares of the kernel limit "
        f"{rec['shares']}; psum skipped {rec['shares_psum_skipped']}; "
        f"rank 1's panel dropped {rec['shares_gather_dropped']}")
    rec["panels"] = panel_checks(mesh, calls, "segment")
    calls.calls.clear()
    del args, outs, bad, compiled
    torch.cuda.empty_cache()
    return rec


def dist_outer(mesh, rows, calls) -> dict:
    """ALS's ``right_mm`` over the Netflix-shaped BCSR under the mesh (938
    block rows a rank), held to the single-device Outer kernel over the
    whole matrix."""
    import torch
    from repro_torch.algos import als_cg
    from repro_torch.core import FusionContext
    from repro_torch.kernels import ops
    X = netflix_like(ALS_SHAPE, seed=0)
    m, n = X.shape
    g = torch.Generator(device="cuda").manual_seed(8)
    U = 0.1 * torch.randn((m, ALS_RANK), generator=g, device="cuda")
    V = 0.1 * torch.randn((n, ALS_RANK), generator=g, device="cuda")
    with FusionContext(layout=mesh, device=str(mesh.device)):
        compiled = als_cg._wsq_mm.trace(X, U, V).plan().compile()
    rec = {"nblocks": X.nblocks}
    with dist_run(mesh, rows, calls, rec):
        out = compiled(X, U, V)
    sps = compiled._cplan._seg_plans
    rec["fallbacks"] = compiled.explain()["execution"]["fallbacks"]
    if len(sps) != 1 or rec["fallbacks"]:
        raise AssertionError(f"outer: {len(sps)} segment steps, "
                             f"fallbacks {rec['fallbacks']}")
    cp = sps[0].items[0].cplan
    env = {b.nid: {"main": X, "factor_u": U, "factor_v": V}[b.kind]
           for b in cp.binds}

    def check():
        whole = ops.execute(cp, env, kernels="cuda")   # one device
        diff = (out - whole).abs()
        limit = KERNEL_ULPS * EPS32 * bcsr_error_scale(cp, env).clamp_min(
            torch.finfo(torch.float32).tiny)
        return {"max_abs_err": float(diff.max()),
                "share": float((diff / limit).max()),
                "bit_identical": bool(torch.equal(out, whole))}

    rec.update(one_rank_at_a_time(mesh, check))
    log(f"[dist] rank {mesh.rank} outer right_mm {m}x{n} ({X.nblocks} "
        f"blocks): launches {rec['launches']} by rows "
        f"{rec['launch_rows']}, {rec['collectives']} collectives "
        f"{rec['collective_ms']:.1f} ms; against the single-device kernel "
        f"max |diff| {rec['max_abs_err']:.3e} = {rec['share']:.3g} x limit, "
        f"bit-identical {rec['bit_identical']}")
    rec["panels"] = panel_checks(mesh, calls, "_wsq_mm")
    calls.calls.clear()
    del X, U, V, out, compiled, env
    torch.cuda.empty_cache()
    return rec


def dist_fuse_exprs(mesh, rows, calls) -> dict:
    """``fuse_exprs`` of the hand-built hinge under
    ``fusion_mode(layout=mesh)`` over the main path's X and y (w from a
    seed): its Row launches on the rank's M_MAIN / DIST_RANKS-row panel,
    its output equal to the staged ``_hinge.trace(...).plan(layout=mesh)``
    path's bit for bit, its panel call held to plain and timed
    (:func:`panel_checks`), and rank 1's panel dropped from the
    all-gather, which must fail the kernel limit on those rows."""
    import torch
    from repro_torch.algos import l2svm
    from repro_torch.core import fuse_exprs, fusion_mode
    X, y = l2svm_data(M_MAIN)
    g = torch.Generator(device="cuda").manual_seed(7)
    binds = {"X": X, "w": 0.1 * torch.randn((N_MAIN, 1), generator=g,
                                            device="cuda"), "y": y}
    expr = hand_built(l2svm._hinge, {k: tuple(v.shape)
                                     for k, v in binds.items()})
    rec = {}
    with fusion_mode(layout=mesh), captured_plans() as seen:
        with dist_run(mesh, rows, calls, rec):
            got = fuse_exprs(expr, binds)
        staged = l2svm._hinge.trace(**binds).plan(layout=mesh).compile()(
            **binds)
    rec["same_bits"] = bool(torch.equal(got, staged))
    rec["fallbacks"] = seen[0].fallbacks
    rec["seg_steps"] = len(seen[0]._seg_plans)
    (cp,) = seen[0].cplans()
    names = {nd.nid: nd.name for nd in seen[0].plan.graph.inputs()}
    env = {b.nid: binds[names[b.nid]] for b in cp.binds}
    panel = M_MAIN // DIST_RANKS
    one = slice(panel, panel + min(panel, MEASURE_ROWS))   # rank 1's rows
    sub = {k: (v[one] if v.shape[0] == M_MAIN else v) for k, v in env.items()}
    gather = mesh.all_gather

    def drop_rank1(p, dim=0, over="row"):
        out = gather(p, dim, over)
        out[p.shape[0]:2 * p.shape[0]] = 0.0
        return out

    mesh.all_gather = drop_rank1
    try:
        with fusion_mode(layout=mesh):
            bad = fuse_exprs(expr, binds)
    finally:
        del mesh.all_gather
    # rank 1's rows (a million of them) of the sound and the planted
    # output, each held to the whole CPlan's plain version on those rows
    rec["share"], rec["planted_share"] = one_rank_at_a_time(
        mesh, lambda: (
            _measure(cp, sub, got[one], "[dist] fuse_exprs")[1],
            _measure(cp, sub, bad[one], "[dist] fuse_exprs, rank 1's "
                                        "panel dropped")[1]))
    log(f"[dist] rank {mesh.rank} fuse_exprs hinge {M_MAIN}x{N_MAIN} under "
        f"the mesh: {rec['seg_steps']} segment steps, launches "
        f"{rec['launches']} by rows {rec['launch_rows']}, "
        f"{rec['collectives']} collectives; = the staged path bit for bit "
        f"{rec['same_bits']}; rank 1's rows {rec['share']:.3g} x limit, "
        f"with rank 1's panel dropped {rec['planted_share']:.3g} x limit; "
        f"wall {rec['wall_s']:.2f} s")
    rec["panels"] = panel_checks(mesh, calls, "fuse_exprs")
    calls.calls.clear()
    del X, y, binds, got, staged, bad, env, sub
    torch.cuda.empty_cache()
    return rec


def loss_panel_library(label, pcp, penv):
    """The library call of a loss panel: the forward's
    ``torch.logsumexp``, the backward's ``softmax`` then ``mul_``."""
    return loss_library("_lse:vjp" if len(pcp.binds) > 1 else "_lse",
                        penv, pcp)


def dist_loss(mesh, rows, calls) -> dict:
    """The fused softmax-CE loss (``launch.train._ce``) under
    ``TrainConfig(fusion="gen", fusion_layout=mesh)`` over DIST_LOSS_SHAPE
    logits N(0, 2²) and random targets, with its gradient: each rank runs
    the log-sum-exp Row plan and its planned backward on its own rows
    (one segment step each way, the Row kernel's staged layout), counted;
    the loss and gradient within DIST_LOSS_RTOL of local planning's and of
    ``kernels="never"``'s under the mesh; the planted staged-chunk fault
    must leave that bound; each panel call held to plain and timed beside
    its bound, the plain version and the library call."""
    import torch
    from repro_torch.core import fusion_mode
    from repro_torch.launch import train
    R, V = DIST_LOSS_SHAPE
    g = torch.Generator(device="cuda").manual_seed(13)
    L = 2.0 * torch.randn((R, V), generator=g, device="cuda")
    t = torch.randint(0, V, (R,), generator=g, device="cuda")

    def loss_grad(tc, **ctx):
        with fusion_mode(**ctx):
            x = L.detach().requires_grad_(True)
            loss = train._ce(x, t, tc)
            (gx,) = torch.autograd.grad(loss, x)
        return float(loss.detach()), gx

    def errs(a, b):
        return (abs(a[0] - b[0]) / max(abs(b[0]), 1e-30),
                float((a[1] - b[1]).abs().max())
                / max(float(b[1].abs().max()), 1e-30))

    tc = train.TrainConfig(fusion="gen", fusion_layout=mesh)
    train._LSE_OPS.clear()
    rec = {}
    with dist_run(mesh, rows, calls, rec):
        got = loss_grad(tc)
    (op,) = train._LSE_OPS.values()
    (bwd,) = op._bwd_plans.values()
    rec["seg_steps"] = [len(op._cplan._seg_plans), len(bwd._seg_plans)]
    rec["fallbacks"] = op.explain()["execution"]["fallbacks"]
    rec["loss"] = got[0]
    rec["err_local"] = errs(got, loss_grad(train.TrainConfig(fusion="gen")))
    rec["err_never"] = errs(got, loss_grad(tc, kernels="never"))
    with planted_fault():
        bad = loss_grad(tc)
    rec["err_planted"] = [e if math.isfinite(e) else math.inf
                          for e in errs(bad, got)]
    log(f"[dist] rank {mesh.rank} fused loss {R}x{V} under "
        f"fusion_layout=mesh: loss {got[0]!r}; segment steps (forward, "
        f"backward) {rec['seg_steps']}; launches {rec['launches']} by rows "
        f"{rec['launch_rows']}, {rec['collectives']} collectives "
        f"{rec['collective_ms']:.1f} ms; relative (loss, gradient) error vs "
        f"local planning {rec['err_local']}, vs never {rec['err_never']}; "
        f"planted chunk fault {rec['err_planted']}; wall "
        f"{rec['wall_s']:.2f} s")
    rec["panels"] = panel_checks(mesh, calls, "loss",
                                 library=loss_panel_library)
    calls.calls.clear()
    del L, t, got, bad, op
    train._LSE_OPS.clear()
    torch.cuda.empty_cache()
    return rec


def dist_rank(rank: int, world: int, init: str, outdir: str,
              sizes: str) -> None:
    """One rank of the [dist] phase (``--dist-rank``): takes the phase's
    ``sizes`` (JSON of DIST_SIZES), joins the gloo process group, builds
    ``Mesh({"data": world})`` on the card and runs L2SVM, MLogReg, the
    segment program and the Outer ``right_mm`` under it, writing its
    readings to ``outdir/rank<rank>.json``."""
    import datetime
    import torch
    import torch.distributed as dist
    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is False")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.set_device(0)
    globals().update({k: tuple(v) if isinstance(v, list) else v
                      for k, v in json.loads(sizes).items()})
    dist.init_process_group(
        "gloo", init_method=init, world_size=world, rank=rank,
        timeout=datetime.timedelta(seconds=DIST_PG_TIMEOUT_S))
    try:
        from repro_torch.algos import l2svm, mlogreg
        from repro_torch.dist import Mesh
        mesh = Mesh({"data": world}, device="cuda:0")
        rows, calls = LaunchRows(), PanelCalls()
        res = {"rank": rank, "part": mesh.part, "walls": {}}
        paths = {
            "l2svm": lambda: dist_algo(
                mesh, rows, calls, "l2svm", lambda: l2svm_data(M_MAIN),
                lambda ops_, max_iter=ITERS, **kw: l2svm.run(
                    *ops_, max_iter=max_iter, **kw),
                [l2svm._hinge, l2svm._search_terms, l2svm._objective_full],
                fault_kw={"max_iter": DIST_FAULT_ITERS}),
            "mlogreg": lambda: dist_algo(
                mesh, rows, calls, "mlogreg", lambda: mlogreg_data(M_MAIN),
                lambda ops_, **kw: mlogreg.run(
                    *ops_, lam=LAM, max_outer=MLR_OUTER,
                    max_inner=MLR_INNER, **kw),
                [mlogreg._probs, mlogreg._nll_obj_reg, mlogreg._hvp]),
            "segment": lambda: dist_segment(mesh, rows, calls),
            "outer": lambda: dist_outer(mesh, rows, calls),
            "fuse_exprs": lambda: dist_fuse_exprs(mesh, rows, calls),
            "loss": lambda: dist_loss(mesh, rows, calls)}
        for name, path in paths.items():
            # each path's wall on this rank, its checks and timings in
            t0 = time.perf_counter()
            res[name] = path()
            res["walls"][name] = round(time.perf_counter() - t0, 2)
        (Path(outdir) / f"rank{rank}.json").write_text(json.dumps(res))
    finally:
        dist.destroy_process_group()


def dist_phase(traces: dict) -> dict:
    """[dist]: DIST_RANKS rank processes on the one card over gloo, each
    running the [dist] paths under ``Mesh({"data": DIST_RANKS})``; checks
    their readings: traces against this process's single-device
    ``kernels="cuda"`` traces (``traces``) and the mesh's
    ``kernels="never"`` ones, Row and MAgg launches on
    M_MAIN / DIST_RANKS-row panels, distributed operators and no
    fallback, the segment program, the Outer and every panel call within
    the kernel limit, every kernel launched, and every planted fault
    failing.  Returns each kernel's [dist] record, which holds the ranks'
    launches (the single-device paths keep their own)."""
    import tempfile
    import torch
    from repro_torch.dist.launch import rank_env, run_ranks
    t0 = time.perf_counter()
    log(f"[dist] {DIST_RANKS} rank processes on the one card over gloo: "
        f"NCCL refuses two ranks on one device, and gloo takes CUDA "
        f"tensors through host memory; the readings are contention-bound "
        f"(the ranks share the card, collectives go through the host)")
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_dist_") as tmp:
        init = f"file://{Path(tmp) / 'rendezvous'}"
        sizes = json.dumps({k: globals()[k] for k in DIST_SIZES})
        outs = run_ranks(
            lambda r: [sys.executable, str(Path(__file__).resolve()),
                       "--dist-rank", str(r), str(DIST_RANKS), init, tmp,
                       sizes],
            DIST_RANKS, timeout=DIST_TIMEOUT_S,
            env=rank_env(threads=max(1, 8 // DIST_RANKS)), cwd=str(ROOT))
        ranks = [json.loads((Path(tmp) / f"rank{r}.json").read_text())
                 for r in range(DIST_RANKS)]
    for r, text in enumerate(outs):
        for line in text.splitlines():
            if line.startswith("[dist]"):
                log(line)
    dist_rec = dist_check(ranks, traces)
    log("[dist] rank walls s a path, checks and timings in: " + json.dumps(
        {res["rank"]: res["walls"] for res in ranks}))
    log(f"[dist] phase wall {time.perf_counter() - t0:.1f} s")
    return dist_rec


def dist_check(ranks: list, traces: dict) -> dict:
    """The [dist] ranks' readings checked (see :func:`dist_phase`); returns
    each kernel's [dist] record."""
    failed = []
    panel = M_MAIN // DIST_RANKS
    for res in ranks:
        r = res["rank"]
        for name in ("l2svm", "mlogreg"):
            rec = res[name]
            rel_dev = trace_rel(rec["trace"], traces[name])
            rel_never = trace_rel(rec["trace"], rec["trace_never"])
            log(f"[dist] rank {r} {name}: max relative trace difference vs "
                f"the single-device kernels {rel_dev:.3e}, vs the mesh's "
                f"never {rel_never:.3e} (tolerance {TRACE_RTOL:g})")
            if not (rel_dev <= TRACE_RTOL and rel_never <= TRACE_RTOL):
                failed.append(f"rank {r} {name}: traces disagree")
            # every Row and MAgg launch on a panel of X's rows (L2SVM
            # runs both kernels, MLogReg's plans run no MAgg kernel)
            rows = rec["launch_rows"]
            for k in ("row", "magg"):
                on_panel = rows.get(f"{k}@{panel}", 0)
                if on_panel != rec["launches"][k] or (
                        on_panel == 0 and (name, k) != ("mlogreg", "magg")):
                    failed.append(f"rank {r} {name}: {k} launches "
                                  f"{rec['launches'][k]}, on {panel}-row "
                                  f"panels {on_panel}")
            if rec["n_fused_distributed"] < 1 or rec["fallbacks"]:
                failed.append(f"rank {r} {name}: distributed operators "
                              f"{rec['n_fused_distributed']}, fallbacks "
                              f"{rec['fallbacks']}")
        fault = res["l2svm"]["trace_fault"]
        rel_fault = trace_rel(fault, res["l2svm"]["trace"][:len(fault)])
        log(f"[dist] rank {r} planted Row fold under the mesh: relative "
            f"trace difference {rel_fault:.3e}")
        if not rel_fault > TRACE_RTOL:
            failed.append(f"rank {r}: the planted Row fold passed")
        seg = res["segment"]
        worst = max(s for _e, s in seg["shares"])
        if not worst <= 1.0:
            failed.append(f"rank {r} segment program: {worst:.3g} x limit")
        for key in ("shares_psum_skipped", "shares_gather_dropped"):
            if not max(s for _e, s in seg[key]) > 1.0:
                failed.append(f"rank {r}: planted {key[7:]} passed")
        if not res["outer"]["share"] <= 1.0:
            failed.append(f"rank {r} outer: {res['outer']['share']:.3g} x "
                          f"limit")

    # fuse_exprs of the hinge and the fused loss under the mesh
    loss_rows = DIST_LOSS_SHAPE[0] // DIST_RANKS
    for res in ranks:
        r, fe, lo = res["rank"], res["fuse_exprs"], res["loss"]
        on_panel = fe["launch_rows"].get(f"row@{panel}", 0)
        if not (fe["same_bits"] and fe["seg_steps"] == 1
                and not fe["fallbacks"] and fe["share"] <= 1.0
                and on_panel == fe["launches"]["row"] >= 1):
            failed.append(f"rank {r} fuse_exprs: bit-equal "
                          f"{fe['same_bits']}, segment steps "
                          f"{fe['seg_steps']}, fallbacks {fe['fallbacks']}, "
                          f"{fe['share']:.3g} x limit, row launches "
                          f"{fe['launches']['row']} ({on_panel} on panels)")
        if not fe["planted_share"] > 1.0:
            failed.append(f"rank {r}: the fuse_exprs panel dropped passed")
        on_panel = lo["launch_rows"].get(f"row@{loss_rows}", 0)
        layouts = {t.get("layout") for t in lo["panels"]}
        worst = max(lo["err_local"] + lo["err_never"])
        log(f"[dist] rank {r} fused loss under the mesh: largest relative "
            f"error vs local planning and never {worst:.3e} (tolerance "
            f"{DIST_LOSS_RTOL:g}); planted {lo['err_planted']}; row "
            f"launches {lo['launches']['row']} ({on_panel} on "
            f"{loss_rows}-row panels), layouts {sorted(layouts)}")
        if not (worst <= DIST_LOSS_RTOL and lo["seg_steps"] == [1, 1]
                and not lo["fallbacks"]
                and on_panel == lo["launches"]["row"] == 2
                and layouts == {"staged"}):
            failed.append(f"rank {r} fused loss: error {worst:.3e}, segment "
                          f"steps {lo['seg_steps']}, fallbacks "
                          f"{lo['fallbacks']}, row launches "
                          f"{lo['launches']['row']} ({on_panel} on panels), "
                          f"layouts {sorted(layouts)}")
        if not max(lo["err_planted"]) > DIST_LOSS_RTOL:
            failed.append(f"rank {r}: the planted loss fault passed")
        for t in fe["panels"] + lo["panels"]:
            if not t["share"] <= 1.0:
                failed.append(f"rank {r} {t['region']} panel: "
                              f"{t['share']:.3g} x limit")

    # every panel call held to its plain version, on every rank
    for res in ranks:
        for p in DIST_PATHS:
            for t in res[p]["panels"]:
                if not t["share"] <= 1.0:
                    failed.append(f"rank {res['rank']} {p} {t['kernel']} "
                                  f"{t['variant']} panel: {t['share']:.3g} "
                                  f"x limit")
    # every kernel launched on the [dist] paths (their own counts: the
    # kernels line's top-level launches are the single-device paths')
    n_launch = {k: sum(res[p]["launches"][k] for res in ranks
                       for p in DIST_PATHS) for k in KERNELS}
    failed += [f"{k} never launched on the [dist] paths"
               for k, n in n_launch.items() if n == 0]
    failed += [f"{k}: no panel call recorded on rank {res['rank']}"
               for res in ranks for k in KERNELS
               if not any(t["kernel"] == k for p in DIST_PATHS
                          for t in res[p]["panels"])]
    if failed:
        raise AssertionError("[dist]: " + "; ".join(failed))

    # every kernel's [dist] record: launches over the ranks' counted runs,
    # the worst panel check over every rank, rank 0's panel times (one
    # rank on the card at a time)
    dist_rec = {}
    for k in KERNELS:
        parts = [t for p in DIST_PATHS for t in ranks[0][p]["panels"]
                 if t["kernel"] == k]
        checks = [t for res in ranks for p in DIST_PATHS
                  for t in res[p]["panels"] if t["kernel"] == k]
        dev = [t["device_ms"] for t in parts]
        prof = [t["profiler_ms"] for t in parts]
        dist_rec[k] = {
            "launches": n_launch[k],
            "max_abs_err": max(t["max_abs_err"] for t in checks),
            "max_share": max(t["share"] for t in checks),
            "panel_ms": sum(t["ms"] for t in parts),
            "panel_device_ms": None if None in dev else sum(dev),
            "panel_profiler_ms": None if None in prof else sum(prof),
            "panel_bound_ms": sum(t["bound_ms"] for t in parts),
            "parts": parts}
        dev_s, prof_s = ("not measured" if None in v else f"{sum(v):.4f} ms"
                         for v in (dev, prof))
        log(f"[dist] {k}: {n_launch[k]} panel-path launches over "
            f"{DIST_RANKS} ranks; {len(checks)} panel calls against plain, "
            f"worst {dist_rec[k]['max_share']:.3g} x limit; rank 0's "
            f"{len(parts)}: device {dev_s} (queued events), profiler "
            f"{prof_s}, calls {dist_rec[k]['panel_ms']:.4f} ms (CUDA "
            f"events), bound {dist_rec[k]['panel_bound_ms']:.4f} ms")
    log(f"[dist] collective wall ms per rank (l2svm, mlogreg, segment, "
        f"outer): " + json.dumps([[round(res[p]["collective_ms"], 1)
                                   for p in DIST_PATHS] for res in ranks]))
    # the fused loss's rank panels, forward and backward: rank 0's
    # readings (one rank on the card at a time), the worst check and the
    # launches over every rank's counted run (one each way a rank)
    dist_rec["loss_panels"] = {}
    for name, nbinds in (("row_loss_panel", 1), ("row_loss_vjp_panel", 2)):
        (part,) = [t for t in ranks[0]["loss"]["panels"]
                   if len(t["binds"]) == nbinds]
        checks = [t for res in ranks for t in res["loss"]["panels"]
                  if len(t["binds"]) == nbinds]
        dist_rec["loss_panels"][name] = dict(
            part, launches=sum(res["loss"]["launches"]["row"] // 2
                               for res in ranks),
            max_abs_err=max(t["max_abs_err"] for t in checks))
    return dist_rec


# --------------------------------------------------------------------------
# [lm], [lm-moe], [lm-hybrid], [lm-xlstm]: the LM serving path on the
# card, one phase a model (phases 18-21)
# --------------------------------------------------------------------------

#: [lm]'s model, minitron-4b (src/repro_torch/configs/minitron_4b.py), and
#: the seed every phase draws its weights from (bf16, then fp32 of the
#: same draws)
LM_ARCH = "minitron-4b"
LM_SEED = 19
#: the engine's slots, and the decode steps timed without the profiler
LM_SLOTS, LM_STEPS = 4, 8
#: the sequence of the rmsnorm and of [lm]'s checks, and the positions
#: decoded at the end of a decode check
LM_SEQ, LM_TAIL = 2048, 8
#: fp32 decode_step logits against the full forward's at the same
#: positions, of max |logit|: one query against the cache vs the prefill's
#: products, summed in other orders (TF32 off)
LM_DECODE_RTOL = 1e-4
#: a decode check held in fp64 holds its fp32 reading to this multiple of
#: the fp32 rounding floor (:func:`forward_floor`), or to LM_DECODE_RTOL
#: where that is larger, and its planted faults must exceed it there too
LM_FLOOR_X = 2.0
#: a routing flip (a decode token whose own top-k differs from the full
#: forward's, which the check pins) is allowed only at a near-tie: the full
#: forward's k-th probability at most this far above its (k+1)-th
LM_TIE = 1e-5
#: one layer's attention, chunked (attn_chunk 1,024) against dense scores,
#: fp32, of max |out|: online softmax vs one softmax
LM_CHUNK_RTOL = 1e-5
BF16_PEAK = 989e12           # H100 SXM bf16 dense tensor cores, FLOP/s
#: [attn]: the LM benchmark cell whose shapes the attention kernel is
#: checked and timed at, the seed of its operands, and kernel vs block
#: loop (fp32 both, sums in another order and block size), of max |x|
ATTN_CELL = "portbench/configs/mellum2-12b-ep8.json"
ATTN_SEED = 23
ATTN_RTOL = 2e-5
#: [attn]'s checks: (label, query heads, KV heads, head size, tokens,
#: window) on one sequence
ATTN_CHECKS = (("cell window", 32, 4, 128, 8192, 1024),
               ("cell full", 32, 4, 128, 8192, 0),
               ("gemma3-27b window", 32, 16, 168, 2048, 1024),
               ("gemma3-27b full", 32, 16, 168, 2048, 0))


def lm_norm_cplans(d: int = 0):
    """The fused rmsnorm's CPlans over LM_SEQ rows of width ``d`` ([lm]'s
    model's width by default), planned on shapes alone."""
    from repro_torch.configs import get_config
    from repro_torch.models import layers
    d = d or get_config(LM_ARCH).d_model
    return region_cplans([(layers._rms, (meta(LM_SEQ, d), meta(1, d),
                                         meta(1, 1)), False)])


def lm_tokens(gen, n: int, vocab: int):
    import torch
    return torch.randint(0, vocab, (n,), generator=gen, device="cuda")


def lm_direct(model, prompt, max_new: int, max_len: int) -> list:
    """Greedy tokens of one prompt from ``LM.apply`` + ``decode_step``
    directly, fed in the engine's order: the prompt's last token again at
    position P first."""
    import torch
    cache = model.init_cache(1, max_len)
    with torch.no_grad():
        model.apply(prompt[None], caches=cache)
        out, pos, cur = [], len(prompt), int(prompt[-1])
        for _ in range(max_new):
            logits, cache = model.decode_step(cache, [[cur]], pos)
            cur = int(torch.argmax(logits[0, -1]))
            out.append(cur)
            pos += 1
    return out


@contextlib.contextmanager
def planted_cache_write():
    """A fault planted in decode: every layer writes the token's K/V at
    pos + 1 instead of pos."""
    from repro_torch.models import attention
    orig = attention._write_decode
    attention._write_decode = lambda cache, k, v, pos: orig(cache, k, v,
                                                            pos + 1)
    try:
        yield
    finally:
        attention._write_decode = orig


def lm_norm(x, s):
    """``layers.norm(x, s, fusion="gen")`` on the card with
    ``kernels="cuda"``, every launch counter set to 0 just before it and
    read just after: (out, launches by kernel, the Compiled operator)."""
    import torch
    from repro_torch.core import fusion_mode
    from repro_torch.kernels import cellwise, multiagg, outerprod, rowwise
    from repro_torch.models import layers
    counters = {"cell": cellwise, "magg": multiagg, "row": rowwise,
                "outer": outerprod}
    torch.cuda.synchronize()
    for mod in counters.values():
        mod.launches = 0
    with fusion_mode(kernels="cuda"):
        out = layers.norm(x, s, fusion="gen")
    torch.cuda.synchronize()
    launches = {k: mod.launches for k, mod in counters.items()}
    rows = math.prod(x.shape[:-1])
    compiled = next(
        c for c in layers._rms._staged.values()
        if c.device.type == x.device.type
        and c.planned.context.kernels == "cuda"
        and c.planned.traced.in_meta["X"]["shape"] == (rows, x.shape[-1]))
    return out, launches, compiled


def lm_norm_check(x, s) -> dict:
    """The fused rmsnorm on the Row kernel: one Row launch and nothing
    else, no fallback recorded, every element within the kernel limit of
    the plain version on the same operands, the same bits from a second
    call, and the planted fault (the staged layout never copies the
    middle chunk of a row) over it.  Returns the CPlan, its operands, the
    output and the errors."""
    import torch
    from repro_torch.kernels import ops
    out, launches, compiled = lm_norm(x, s)
    want = {k: int(k == "row") for k in launches}
    if launches != want:
        raise AssertionError(f"rmsnorm launched {launches}, not one Row "
                             f"kernel")
    fbs = compiled.explain()["execution"]["fallbacks"]
    if fbs:
        raise AssertionError(f"rmsnorm recorded fallbacks {fbs}")
    (cp,) = compiled._cplan.cplans()
    d = x.shape[-1]
    by_name = {"X": x.reshape(-1, d).float(), "s": s.float().reshape(1, d),
               "eps_s": torch.full((1, 1), 1e-6, device=x.device)}
    names = {n.nid: n.name for n in compiled.planned.eplan.graph.inputs()}
    env = {b.nid: by_name[names[b.nid]] for b in cp.binds}
    got = out.reshape(-1, d)
    err, share = measure(cp, env, got, "rmsnorm")
    if not share <= 1.0:
        raise AssertionError(f"rmsnorm: max |kernel - plain| = {err:.3e}, "
                             f"{share:.3g} x its limit")
    if not bool(torch.equal(ops.execute(cp, env, kernels="cuda"), got)):
        raise AssertionError("rmsnorm: a second call gave other bits")
    with planted_fault():
        bad = ops.execute(cp, env, kernels="cuda")
    planted_share = fault_share(cp, env, bad, "planted rmsnorm")
    if not planted_share > 1.0:
        raise AssertionError("planted fault in the rmsnorm passed the "
                             "kernel check")
    return {"cplan": cp, "env": env, "out": got, "launches": launches,
            "err": err, "share": share, "fault_share": planted_share}


def ptxas_lines(src) -> list:
    """The ptxas register and spill lines of a built kernel source (its
    nvcc log under kernels/_build)."""
    from repro_torch.kernels import build
    log_path = build.library_path(src).with_suffix(".log")
    if not log_path.exists():
        return [f"no build log at {log_path.name}"]
    return [ln.strip() for ln in log_path.read_text().splitlines()
            if "registers" in ln or "spill" in ln]


def lm_norm_record(tag: str, m16, toks, gen) -> dict:
    """``[tag]``: the fused rmsnorm of layer 0's input (the embeddings of
    ``toks``, cast to fp32 as norm does) on the Row kernel: held to its
    plain version with its planted fault (:func:`lm_norm_check`), timed
    beside its bound and ``F.rms_norm`` (CUDA events, the profiler and
    events queued behind a spin kernel), with the build's ptxas lines.
    The model's own ln1 scale is 0 at init, which would hide a misread
    side, so the scale is drawn.  Returns the kernel record."""
    import torch
    from repro_torch.kernels import cuda_src, ref, rowwise
    d = m16.cfg.d_model
    x = m16._embed(toks).float()
    s = 0.1 * torch.randn((d,), generator=gen, device="cuda")
    chk = lm_norm_check(x, s)
    cp, env = chk["cplan"], chk["env"]
    src = cuda_src.source_for(cp)
    log(f"[{tag}] fused rmsnorm {tuple(x.shape)} -> one ROW "
        f"{cp.variant} CPlan ({layout_name(cp)} layout, {src.threads} "
        f"threads, {src.stages} row stages, {src.smem} B of shared memory "
        f"a CTA), launches {json.dumps(chk['launches'])}; max|kernel-plain| "
        f"{chk['err']:.3e} = {chk['share']:.3g} x limit, the same bits "
        f"twice; planted fault {chk['fault_share']:.3g} x limit")
    spill = ptxas_lines(src)
    log(f"[{tag}] rmsnorm kernel build (ptxas): {' | '.join(spill)}")
    weight = 1.0 + s
    x2 = env[cp.main.nid]
    calls = {"kernel": lambda: rowwise.row(cp, env),
             "plain": lambda: ref.execute_dense(cp, env),
             "library": lambda: torch.nn.functional.rms_norm(
                 x2, (d,), weight=weight, eps=1e-6)}
    part = time_part(f"{tag} rmsnorm", "row", cp, env, calls["kernel"],
                     calls["plain"], chk["out"], calls["library"])
    # device time a second way, without the profiler: CUDA events queued
    # behind a spin kernel, so the host's launch path is outside them
    queued = {k: queued_ms(fn) for k, fn in calls.items()}
    part["queued_ms"] = queued
    part["ptxas"] = spill
    part["layout"] = layout_name(cp)
    log(f"[{tag}] rmsnorm device ms by CUDA events queued behind a spin "
        f"kernel: {json.dumps(queued)}; bound {part['bound_ms']:.4f} ms")
    rec = new_record()
    add_part(rec, part)
    rec.update(launches=chk["launches"]["row"], max_abs_err=chk["err"])
    del x, s, chk, env, x2
    torch.cuda.empty_cache()
    return rec


class LMArch(NamedTuple):
    """One model of the LM phases and how it is cut to run: ``n_layers``
    0 keeps the configuration's depth; the engine's requests through 4
    slots, the last repeating the second prompt, so it is served in a slot
    another request used before; the decode check over ``seq`` tokens
    (its last LM_TAIL decoded); ``faults`` planted at one decode step of
    that check: "kv" (every attention layer writes the token's K/V at
    pos + 1), "state" (every Mamba / mLSTM layer leaves its state
    unwritten) and "gate" (every MoE layer zeroes the token's top gate),
    held to LM_DECODE_RTOL in ``check_dtype``; prefill lengths timed,
    ``(reps, rounds)`` of each; ``counted``: the parameters besides the
    final norm equal the configuration's count; ``attn_checks``: layer
    0's attention chunked against dense, and bf16 against fp32 logits
    (:func:`lm_attn_checks`)."""
    tag: str
    arch: str
    n_layers: int
    prompts: tuple
    max_new: int
    max_len: int
    seq: int
    faults: tuple
    check_dtype: str
    prefill_times: tuple
    prefill_reps: tuple
    cut: str
    counted: bool = False
    attn_checks: bool = False


LM_ARCHS = (
    # prompts of 2,048 tokens (chunked attention: over attn_chunk 1,024 and
    # a multiple of it), 777 and 512 (dense scores), 33 and 1
    LMArch("lm", LM_ARCH, 8, (2048, 777, 512, 33, 1, 777), 32, 2304,
           LM_SEQ, ("kv",), "float32", (2048, 512), (3, 3),
           "full width, 8 of its 32 layers (cut to pay for "
           "[lm-train-sharded]; [lm-sharded] serves it and [lm-train] and "
           "[lm-train-sharded] train it at full depth)", counted=True,
           attn_checks=True),
    LMArch("lm-moe", "olmoe-1b-7b", 4, (2048, 777, 512, 33, 777), 32, 2304,
           2048, ("gate",), "float32", (2048, 512), (3, 3),
           "full width, 4 of its 16 layers (cut as [lm]'s; "
           "[lm-sharded] serves it at full depth)",
           counted=True),
    LMArch("lm-hybrid", "jamba-v0.1-52b", 8, (2048, 777, 512, 33, 777), 32,
           2304, 2048, ("state", "gate"), "float32", (2048, 512), (3, 3),
           "full width, one period of 8 of its 32 layers: all 32 are "
           "51.5e9 parameters, 103 GB in bf16, more than one card holds "
           "(the sharded engine would spread them over four cards)"),
    LMArch("lm-xlstm", "xlstm-1.3b", 4, (512, 129, 33, 1, 129), 16, 640,
           136, ("state",), "float64", (512, 129), (1, 2),
           "full width, 4 of its 48 layers (cut so that the script's "
           "wall stays near 775 s with [lm-sharded], [lm-train-sharded] "
           "and [examples]; every layer is the same mLSTM block); "
           "prompts of 512 / 129 / "
           "33 / 1 tokens (16 new each) and a 136-token decode check, "
           "shorter than [lm]'s: the mLSTM recurrence is a loop of ~20 "
           "eager ops a step per layer; the decode check is held to its "
           "limit in fp64, and in fp32 to LM_FLOOR_X x its rounding "
           "floor"),
)
#: the MoE forms: one full-width MoE layer in fp32 over LM_SEQ tokens,
#: ragged and capacity (a factor of E/k: nothing drops) against dense, of
#: max |out|: the same products summed in other orders (TF32 off)
LM_MOE_RTOL = 1e-5


def lm_norm_widths() -> list:
    """The widths the fused rmsnorm runs at: each LM_ARCHS model's."""
    from repro_torch.configs import get_config
    return sorted({get_config(m.arch).d_model for m in LM_ARCHS})


def lm_arch_model(run: LMArch, dtype: str, **change):
    """The run's model on the card in ``dtype`` (and the configuration's
    ``change``), drawn from a generator seeded with LM_SEED (the same
    draws in either dtype, cast)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import LM
    cfg = dataclasses.replace(get_config(run.arch), dtype=dtype, **change)
    if run.n_layers:
        cfg = dataclasses.replace(cfg, n_layers=run.n_layers)
    gen = torch.Generator(device="cuda").manual_seed(LM_SEED)
    model = LM(cfg, device="cuda").init(gen).requires_grad_(False)
    torch.cuda.synchronize()
    return model


def lm_weight_counts(model) -> dict:
    """Parameters and bytes: all of them; those one decode token reads
    with the model's MoE implementation (the embedding table but one
    row; dense MoE reads every expert); and those it reads with only the
    top-k experts of each MoE layer (the active weights)."""
    cfg = model.cfg
    n = sum(p.numel() for p in model.parameters())
    el = model.embed.element_size()
    emb = model.embed.numel() - cfg.d_model * cfg.n_codebooks
    idle = 0
    for spec, layer in zip(model.specs, model.layers):
        if spec.use_moe:
            experts = sum(layer["mlp"][w].numel() for w in ("w1", "w2", "w3")
                          if w in layer["mlp"])
            idle += experts * (cfg.n_experts - cfg.top_k) // cfg.n_experts
    read = n - (0 if model.head is None else emb)
    return {"params": n, "bytes": n * el, "read": read * el,
            "read_params": read, "active": (read - idle) * el,
            "active_params": read - idle}


def lm_state_bytes(cache) -> tuple[int, int]:
    """(recurrent-state bytes, K/V bytes) of a cache: every leaf but an
    attention layer's ``k`` / ``v`` is recurrent state."""
    st = kv = 0
    for layer in cache["blocks"] + cache["rest"]:
        for k, v in layer.items():
            nbytes = v.numel() * v.element_size()
            if k in ("k", "v"):
                kv += nbytes
            else:
                st += nbytes
    return st, kv


def recurrence_flops(model, S: int) -> int:
    """fp32 operations of the Mamba and mLSTM recurrences over S tokens
    (the projections around them are counted with the weights): Mamba
    ~7 per (d_inner, N) state element a step (dA, dBx, the update, y);
    mLSTM ~6 per (hd, hd) element of each head's C a step (v kᵀ, the
    gated update, C q)."""
    cfg = model.cfg
    di = cfg.ssm_expand * cfg.d_model
    per = {"mamba": 7 * di * cfg.ssm_state,
           "mlstm": 6 * di * di // max(cfg.n_heads, 1), "attn": 0}
    return S * sum(per[spec.kind] for spec in model.specs)


@contextlib.contextmanager
def planted_state_skip():
    """A fault planted in decode: every Mamba / mLSTM layer leaves its
    recurrent state unwritten."""
    from repro_torch.models import mamba, xlstm
    orig = mamba._write_state
    mamba._write_state = xlstm._write_state = lambda state, new: None
    try:
        yield
    finally:
        mamba._write_state = xlstm._write_state = orig


@contextlib.contextmanager
def planted_gate_zero():
    """A fault planted in decode: every MoE layer zeroes each token's top
    gate."""
    from repro_torch.models import moe
    orig = moe._gates

    def gates(x, router, k, with_aux=True, sh=None):
        g, topv, topi, aux = orig(x, router, k, with_aux, sh)
        g = g.scatter(1, topi[:, :1], 0.0)
        topv = topv.clone()
        topv[:, 0] = 0.0
        return g, topv, topi, aux
    moe._gates = gates
    try:
        yield
    finally:
        moe._gates = orig


PLANTS = {"kv": (planted_cache_write, "K/V written at pos + 1"),
          "state": (planted_state_skip, "recurrent state left unwritten"),
          "gate": (planted_gate_zero, "top gate zeroed")}


class Routing:
    """Stands in for ``models.moe._gates`` to record or pin the MoE
    layers' top-k experts.  Recording (no ``pins``): each call's experts
    and each token's margin (its k-th probability less its (k+1)-th) are
    kept, in call order (a forward calls the MoE layers in layer order).
    Pinned (``pins``: one (experts (S, k), margins (S,)) pair per MoE
    layer, from a recorded forward over S tokens): each call takes, for
    its rows ``offset`` ..., the pinned experts instead of its own top-k,
    their probabilities renormalized as ``_gates`` does, and keeps the
    recorded margin of each token whose own top-k differs (a flip)."""

    def __init__(self, pins=None):
        self.pins, self.taken, self.calls = pins, [], 0
        self.offset, self.margins = 0, []

    def __call__(self, x, router, k, with_aux=True, sh=None):
        import torch
        g, topv, topi, aux = self.orig(x, router, k, with_aux, sh)
        if self.pins is None:
            probs = torch.softmax((x @ router).float(), dim=-1)
            top = torch.topk(probs, k + 1, dim=-1).values
            self.taken.append((topi, top[:, k - 1] - top[:, k]))
            return g, topv, topi, aux
        pin, margin = (t[self.offset:self.offset + x.shape[0]]
                       for t in self.pins[self.calls % len(self.pins)])
        self.calls += 1
        flipped = (topi.sort(-1).values != pin.sort(-1).values).any(-1)
        self.margins += margin[flipped].tolist()
        probs = torch.softmax((x @ router).float(), dim=-1)
        topv = probs.gather(1, pin)
        topv = topv / torch.sum(topv, dim=-1, keepdim=True)
        g = torch.zeros_like(probs).scatter(1, pin, topv).to(x.dtype)
        return g, topv, pin, aux

    @contextlib.contextmanager
    def installed(self):
        from repro_torch.models import moe
        self.orig = moe._gates
        moe._gates = self
        try:
            yield self
        finally:
            moe._gates = self.orig


def full_forward(model, toks):
    """(logits of one forward over ``toks``, its MoE layers' top-k
    experts in layer order)."""
    import torch
    rec = Routing()
    with torch.no_grad(), rec.installed():
        full = model.apply(toks)[0]
    return full, rec.taken


def decode_share(model, toks, full, pins, plant=None) -> tuple:
    """Worst |decode_step logits - full forward logits| over the last
    LM_TAIL positions of ``toks`` (prefill of the rest, from a zero
    state), as a share of the full forward's max |logit| there, with every
    MoE layer pinned to the full forward's experts (``pins``; None: each
    takes its own top-k).  Top-k routing is discontinuous: a near-tie
    that the rounding of two matmul shapes resolves differently moves a
    token to another expert.  Returns the share and the full forward's
    margins of the tokens that flipped; ``plant`` (a context manager
    factory) is entered around the first decode step only."""
    import torch
    S = toks.shape[1]
    P = S - LM_TAIL
    cache = model.init_cache(1, S + 1)     # room for a planted pos + 1
    worst = 0.0
    pin = Routing(pins)
    with torch.no_grad(), pin.installed():
        model.apply(toks[:, :P], caches=cache)
        for t in range(P, S):
            pin.offset = t
            with plant() if plant is not None and t == P else \
                    contextlib.nullcontext():
                logits, cache = model.decode_step(cache, toks[:, t:t + 1],
                                                  t)
            worst = max(worst, float((logits[0, 0] - full[0, t]).abs()
                                     .max()))
    return worst / float(full[0, P:].abs().max()), pin.margins


def forward_floor(model, toks, full, pins) -> float:
    """The rounding floor of the decode check: a forward over all but the
    last LM_TAIL tokens against the full forward at the LM_TAIL positions
    before them (the same model and tokens, only the matmul shapes
    differ; MoE routing pinned), as a share of max |logit| there."""
    import torch
    P = toks.shape[1] - LM_TAIL
    with torch.no_grad(), Routing(pins).installed():
        pre = model.apply(toks[:, :P])[0]
    want = full[0, P - LM_TAIL:P]
    return float((pre[0, P - LM_TAIL:] - want).abs().max()
                 / want.abs().max())


def lm_engine_check(tag: str, run: LMArch, model, prompts) -> None:
    """The engine (4 slots) serves the run's requests through its queue;
    each request's tokens equal a direct run of LM.apply + decode_step
    from a zero state fed the engine's way, and the last, served in a slot
    another request used before, equals the second (the same prompt on a
    fresh slot)."""
    import torch
    from repro_torch.serve import Engine, Request
    engine = Engine(model, batch_slots=LM_SLOTS, max_len=run.max_len)
    reqs = [Request(prompt=p, max_new=run.max_new) for p in prompts]
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    for r in reqs:
        engine.submit(r)
    seen = {}                     # request index -> slots it sat in
    for _ in range(10_000):
        if engine._queue.empty() and all(x is None for x in engine.slots):
            break
        engine.step()
        for i, x in enumerate(engine.slots):
            for j, r in enumerate(reqs):
                if x is r:
                    seen.setdefault(j, set()).add(i)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t1
    last = len(reqs) - 1
    (slot,) = seen[last]
    before = [j for j in range(last) if slot in seen.get(j, ())]
    if not before:
        raise AssertionError(f"[{tag}] the last request's slot {slot} was "
                             f"not used before")
    direct = {}
    for p, r in zip(prompts, reqs):
        if len(p) not in direct:
            direct[len(p)] = lm_direct(model, p, run.max_new, run.max_len)
        if not (r.done and r.error is None and r.out == direct[len(p)]):
            raise AssertionError(
                f"[{tag}] engine tokens of the {len(p)}-token prompt "
                f"{r.out} != direct decode {direct[len(p)]}")
    if reqs[last].out != reqs[1].out:
        raise AssertionError(f"[{tag}] the reused slot's tokens "
                             f"{reqs[last].out} != the fresh slot's "
                             f"{reqs[1].out}")
    log(f"[{tag}] engine ({LM_SLOTS} slots x {run.max_len} positions, "
        f"bf16): {len(reqs)} requests of {list(run.prompts)} tokens, "
        f"{run.max_new} new each, equal to direct LM.apply + decode_step "
        f"from a zero state token for token; the last served in slot "
        f"{slot} after request {before} there, equal to the same prompt "
        f"on a fresh slot; wall {wall:.2f} s for "
        f"{sum(len(r.out) for r in reqs)} tokens (prefills included)")


def lm_times(tag: str, run: LMArch, model, gen, prompt) -> dict:
    """Prefill and decode ms (CUDA events, bf16) beside their bounds, and
    Engine.step() with 4 slots decoding: LM_STEPS steps' walls (host
    clock) and the calling thread's CPU time, the aten ops of one step,
    and the host share of one profiled step."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.launch.serve import make_prefill_step, make_serve_step
    from repro_torch.serve import Engine, Request
    cfg = model.cfg
    w = lm_weight_counts(model)
    prefill, decode = make_prefill_step(model), make_serve_step(model)
    cache = model.init_cache(1, run.max_len)
    st_bytes, kv_bytes = lm_state_bytes(cache)
    out = {}
    for S in run.prefill_times:
        t = lm_tokens(gen, S, cfg.vocab)[None]
        reps, rounds = run.prefill_reps
        ms = time_ms(lambda: prefill(t, cache), reps=reps, rounds=rounds)
        rec_ms = recurrence_flops(model, S) / FP32_PEAK * 1e3
        bound = {}
        for k in ("read", "active"):
            ops_ms = 2 * w[f"{k}_params"] * S / BF16_PEAK * 1e3 + rec_ms
            bytes_ms = (w[k] + st_bytes) / HBM_BW * 1e3
            bound[k] = max(ops_ms, bytes_ms)
        out[f"prefill_{S}"] = {"ms": ms, "bound_ms": bound}
        log(f"[{tag}] prefill {S} tokens: {ms:.3f} ms (CUDA events); bound "
            f"{bound['read']:.3f} ms for the weights the implementation "
            f"multiplies ({w['read_params']:,}), {bound['active']:.3f} ms "
            f"for the active weights ({w['active_params']:,}): the larger "
            f"of 2 x weights x S FLOP at the bf16 peak + {rec_ms:.3f} ms of "
            f"fp32 recurrence ({recurrence_flops(model, S):,} FLOP at "
            f"{FP32_PEAK / 1e12:g} TFLOP/s) and the weights and state once "
            f"at {HBM_BW / 1e12:g} TB/s")
    S = run.prefill_times[-1]
    tok = t[:, -1:]
    ms = time_ms(lambda: decode(cache, tok, S), reps=10, rounds=3)
    kv = kv_bytes * (S + 1) // run.max_len
    moved = {k: w[k] + 2 * st_bytes + kv for k in ("read", "active")}
    bound = {k: v / HBM_BW * 1e3 for k, v in moved.items()}
    out["decode"] = {"ms": ms, "bound_ms": bound, "position": S}
    log(f"[{tag}] decode one token of one slot at position {S}: {ms:.3f} "
        f"ms (CUDA events); bound {bound['read']:.3f} ms for the weights "
        f"the implementation reads ({w['read'] / 1e9:.2f} GB) and "
        f"{bound['active']:.3f} ms for the active weights "
        f"({w['active'] / 1e9:.2f} GB), each + the state read and written "
        f"({2 * st_bytes / 1e6:.1f} MB) and K/V of {S + 1} positions "
        f"({kv / 1e6:.1f} MB), at {HBM_BW / 1e12:g} TB/s")
    del cache
    engine = Engine(model, batch_slots=LM_SLOTS, max_len=run.max_len)
    for _ in range(LM_SLOTS):
        engine.submit(Request(prompt=prompt, max_new=run.max_new))
    engine.step()                     # admits (prefills) all four slots
    steps, cpu = [], []
    for _ in range(LM_STEPS):
        t0, c0 = time.perf_counter(), time.thread_time()
        engine.step()
        torch.cuda.synchronize()
        steps.append((time.perf_counter() - t0) * 1e3)
        cpu.append((time.thread_time() - c0) * 1e3)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        engine.step()
    n_ops = sum(e.name.startswith("aten::") for e in prof.events())
    wall_ms, busy_ms = profile_run(
        f"[{tag}] Engine.step(), {LM_SLOTS} slots decoding one token each",
        engine.step)
    out["engine_step"] = {"wall_ms": wall_ms, "busy_ms": busy_ms,
                          "host_share": 1 - busy_ms / wall_ms,
                          "step_ms": steps, "thread_cpu_ms": cpu,
                          "aten_ops": n_ops}
    log(f"[{tag}] Engine.step() wall, {LM_STEPS} steps without the "
        f"profiler: median {statistics.median(steps):.2f} ms (host clock; "
        f"{', '.join(f'{v:.2f}' for v in steps)}), the calling thread's "
        f"CPU time median {statistics.median(cpu):.2f} ms; {n_ops} aten "
        f"ops a step (the host profiler's); host share of one "
        f"profiled step: {1 - busy_ms / wall_ms:.3f} (wall {wall_ms:.2f} "
        f"ms, device busy {busy_ms:.2f} ms)")
    return out


def lm_moe_forms(tag: str, model, toks) -> None:
    """One full-width MoE layer in fp32 (the model's first) over the
    tokens' embeddings normed by its ln2: ragged and capacity (factor E/k,
    nothing dropped) against dense within LM_MOE_RTOL of max |out|, each
    timed; the pairs a capacity factor of 1.0 drops."""
    import torch
    from repro_torch.models import layers, moe
    cfg = model.cfg
    i = next(j for j, spec in enumerate(model.specs) if spec.use_moe)
    p = model.layers[i]["mlp"]
    with torch.no_grad():
        x = layers.apply_norm(model._embed(toks), model.layers[i]["ln2"],
                              cfg)[0]
        cf = cfg.n_experts / cfg.top_k
        forms = {"dense": lambda: moe.moe_dense(x, p, cfg)[0],
                 "ragged": lambda: moe.moe_ragged(x, p, cfg)[0],
                 "capacity": lambda: moe.moe_capacity(x, p, cfg, cf)[0]}
        outs = {k: fn() for k, fn in forms.items()}
        scale = float(outs["dense"].abs().max())
        rel = {k: float((v - outs["dense"]).abs().max()) / scale
               for k, v in outs.items() if k != "dense"}
        dropped_all = moe.capacity_dropped(x, p, cfg, cf)
        dropped = moe.capacity_dropped(x, p, cfg, 1.0)
        ms = {k: time_ms(fn, reps=3, rounds=3) for k, fn in forms.items()}
    log(f"[{tag}] MoE layer {i} in fp32 over {x.shape[0]} tokens "
        f"({cfg.n_experts} experts, top-{cfg.top_k}, d_ff {cfg.d_ff}): "
        f"ragged {rel['ragged']:.3e}, capacity (factor {cf:g}, "
        f"{dropped_all} pairs dropped) {rel['capacity']:.3e} of max |out| "
        f"off dense (limit {LM_MOE_RTOL:g}); capacity at factor 1.0 drops "
        f"{dropped} of {x.shape[0] * cfg.top_k} (token, slot) pairs; ms "
        f"(CUDA events) {json.dumps({k: round(v, 4) for k, v in ms.items()})}")
    if dropped_all or not max(rel.values()) <= LM_MOE_RTOL:
        raise AssertionError(f"[{tag}] the MoE forms disagree: {rel}")


def lm_decode_check(tag: str, run: LMArch, model, toks) -> dict:
    """decode_step logits against the full forward's over the last
    LM_TAIL of ``toks``'s positions (MoE routing pinned, a flip allowed
    only at a near-tie, LM_TIE), the forward's rounding floor, and each
    planted fault, in the model's dtype.  Returns the readings."""
    full, pins = full_forward(model, toks)
    share, margins = decode_share(model, toks, full, pins)
    floor = forward_floor(model, toks, full, pins)
    faults = {f: decode_share(model, toks, full, pins, PLANTS[f][0])[0]
              for f in run.faults}
    free = ""
    if pins:      # the same without pinning: recorded, no limit
        unpinned = decode_share(model, toks, full, None)[0]
        free = (f"; the full forward's margins (k-th - (k+1)-th "
                f"probability) of the flipped tokens "
                f"{[float(f'{m:.3e}') for m in sorted(margins)]} (limit "
                f"{LM_TIE:g}); unpinned {unpinned:.3e}, recorded")
    log(f"[{tag}] {str(model.dtype).split('.')[-1]} decode_step vs the full "
        f"forward over the last {LM_TAIL} of {toks.shape[1]} positions: "
        f"worst {share:.3e} of max |logit| with {len(margins)} routing "
        f"flips pinned{free}; rounding floor (a forward {LM_TAIL} tokens "
        f"shorter vs the full one) {floor:.3e}; planted at the first decode "
        f"step: "
        + "; ".join(f"{PLANTS[f][1]} {v:.3e}" for f, v in faults.items()))
    wide = [m for m in margins if not m <= LM_TIE]
    if wide:
        raise AssertionError(f"[{tag}] {len(wide)} routing flips away from "
                             f"a near-tie: margins {wide}")
    return {"share": share, "flips": len(margins), "floor": floor,
            "faults": faults}


def lm_held(tag: str, got: dict, limit: float, what: str) -> None:
    """The decode check's reading within ``limit`` and each planted fault
    past it."""
    if not got["share"] <= limit:
        raise AssertionError(f"[{tag}] prefill -> decode logits disagree: "
                             f"{got['share']:.3e} > {what} {limit:.3e}")
    passed = [f for f, v in got["faults"].items() if not v > limit]
    if passed:
        raise AssertionError(f"[{tag}] planted faults {passed} passed the "
                             f"prefill -> decode check ({what})")


def lm_fp32_checks(tag: str, run: LMArch, model, gen) -> None:
    """The decode check (:func:`lm_decode_check`) in fp32, held to
    LM_DECODE_RTOL; for a run whose check is in fp64, the fp32 reading is
    held to LM_FLOOR_X x its rounding floor instead (LM_DECODE_RTOL where
    that is larger: a floor can read 0), and the check is made
    again on the model converted to fp64 (the Mamba / mLSTM recurrences
    stay fp32, as the port runs them) and held to LM_DECODE_RTOL.  Its
    planted faults must exceed each limit.  Then the MoE forms in fp32
    where the model has MoE layers."""
    import torch
    cfg = model.cfg
    toks = lm_tokens(gen, run.seq, cfg.vocab)[None]
    got = lm_decode_check(tag, run, model, toks)
    if cfg.n_experts:
        lm_moe_forms(tag, model, lm_tokens(gen, LM_SEQ, cfg.vocab)[None])
    if run.check_dtype == "float64":
        limit = max(LM_FLOOR_X * got["floor"], LM_DECODE_RTOL)
        log(f"[{tag}] fp32: {got['share']:.3e} against the larger of "
            f"{LM_FLOOR_X:g} x its rounding floor and {LM_DECODE_RTOL:g}, "
            f"{limit:.3e}; the limit {LM_DECODE_RTOL:g} applies in fp64 "
            f"below")
        lm_held(tag, got, limit, "the fp32 limit")
        model.double()
        model.dtype = torch.float64
        got = lm_decode_check(tag, run, model, toks)
    lm_held(tag, got, LM_DECODE_RTOL, "the limit")


def lm_attn_checks(tag: str, m32, toks, full16) -> None:
    """Layer 0's attention over ``toks`` in fp32, chunked against dense
    within LM_CHUNK_RTOL; bf16 logits (``full16``) against fp32 over the
    same tokens, recorded."""
    import torch
    from repro_torch.models import attention, layers
    S = toks.shape[1]
    layer = m32.layers[0]
    with torch.no_grad():
        h = layers.apply_norm(m32._embed(toks), layer["ln1"], m32.cfg)
        pos = torch.arange(S, device=toks.device)[None]
        chunked, dense = (attention.attention(
            h, layer["inner"], dataclasses.replace(m32.cfg, attn_chunk=c),
            positions=pos, window=m32.specs[0].window)[0]
            for c in (m32.cfg.attn_chunk, 0))
    rel = float((chunked - dense).abs().max() / dense.abs().max())
    log(f"[{tag}] layer 0 attention at S = {S}, fp32: chunked "
        f"({m32.cfg.attn_chunk}) vs dense, {rel:.3e} of max |out| (limit "
        f"{LM_CHUNK_RTOL:g})")
    if not rel <= LM_CHUNK_RTOL:
        raise AssertionError(f"[{tag}] chunked and dense attention "
                             f"disagree")
    del chunked, dense, h
    with torch.no_grad():
        full32 = m32.apply(toks)[0]
    diff = float((full16.float() - full32).abs().max())
    top1 = float((full16.argmax(-1) == full32.argmax(-1)).float().mean())
    log(f"[{tag}] bf16 vs fp32 prefill logits over {S} positions: worst "
        f"{diff / float(full32.abs().max()):.3e} of max |logit|, top-1 "
        f"token equal at {top1:.4f} of positions (recorded, no limit)")


def attn_phase() -> dict:
    """``[attn]``: the attention kernel against the torch block loop at
    ATTN_CHECKS, with a planted fault, and its device times at the LM
    cell's micro-batch beside ``portbench.lmwork``'s bound; the kernel's
    launch counters set to 0 at the end.  Returns the kernel's record for
    the result line."""
    import torch
    from portbench import lmwork, work
    from repro_torch.kernels import attention as kattn
    from repro_torch.models.attention import _chunked_attention, _expand
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(ATTN_SEED)

    def operands(B, S, H, KV, D):
        return [torch.randn(shape, generator=gen, device="cuda")
                for shape in ((B, S, H, D), (B, S, KV, D), (B, S, KV, D),
                              (B, S, H, D))]

    def plain(q, k, v, window):
        rep = q.shape[2] // k.shape[2]
        pos = torch.arange(q.shape[1], device="cuda")[None]
        return _chunked_attention(q, _expand(k, rep, None),
                                  _expand(v, rep, None), pos, window)

    def grads(fn, q, k, v, do, window):
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
        out = fn(*leaves, window)
        out.backward(do)
        return [out.detach()] + [t.grad for t in leaves]

    worst, parts = 0.0, []
    for label, H, KV, D, S, window in ATTN_CHECKS:
        q, k, v, do = operands(1, S, H, KV, D)
        got = grads(kattn.flash, q, k, v, do, window)
        want = grads(plain, q, k, v, do, window)
        rel = [float((a - b).abs().max() / b.abs().max())
               for a, b in zip(got, want)]
        bad = got[0].clone()
        bad[:, -kattn.BLOCK:] = 0.0
        fault = float((bad - want[0]).abs().max() / want[0].abs().max())
        log(f"[attn] {label} ({H} / {KV} heads x {D}, {S} tokens, window "
            f"{window}): kernel vs block loop, of max |x|: out "
            f"{rel[0]:.3e}, dq {rel[1]:.3e}, dk {rel[2]:.3e}, dv "
            f"{rel[3]:.3e} (limit {ATTN_RTOL:g}); planted (the last query "
            f"block's output left out) {fault:.3e}")
        if not max(rel) <= ATTN_RTOL:
            raise AssertionError(f"[attn] {label}: kernel and block loop "
                                 f"disagree")
        if not fault > ATTN_RTOL:
            raise AssertionError(f"[attn] {label}: the planted fault passed")
        worst = max(worst, *rel)
        parts.append({"check": label, "rel": rel, "fault": fault})
        del q, k, v, do, got, want, bad
        torch.cuda.empty_cache()

    cfg = json.loads((ROOT / ATTN_CELL).read_text())
    s = lmwork.shapes(cfg)
    q, k, v, do = operands(s["B"], s["S"], s["H"], s["KV"], s["hd"])
    ms = bound = 0.0
    for window in sorted(set(s["windows"])):
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]

        def fwd_bwd():
            for t in leaves:
                t.grad = None
            kattn.flash(*leaves, window).backward(do)
        with torch.no_grad():
            f_ms = device_ms(lambda: kattn.flash(q, k, v, window), reps=3)
        fb_ms = device_ms(fwd_bwd, reps=3)
        flops = lmwork.attn_flops(cfg, window)
        f_bound = work.least_ms(0, flops[0])
        fb_bound = work.least_ms(0, sum(flops))
        log(f"[attn] cell micro-batch {s['B']} x {s['S']} tokens, window "
            f"{window}: forward {f_ms:.3f} ms device (bound {f_bound:.3f} "
            f"ms, {100 * f_bound / f_ms:.1f} %), forward + backward "
            f"{fb_ms:.3f} ms device (bound {fb_bound:.3f} ms, "
            f"{100 * fb_bound / fb_ms:.1f} %)")
        ms += fb_ms * s["windows"].count(window)
        bound += fb_bound * s["windows"].count(window)
        parts.append({"window": window, "fwd_ms": f_ms,
                      "fwd_bound_ms": f_bound, "fwd_bwd_ms": fb_ms,
                      "fwd_bwd_bound_ms": fb_bound})
        del leaves
    del q, k, v, do
    torch.cuda.empty_cache()
    for D in sorted({c[3] for c in ATTN_CHECKS}):
        for line in ptxas_lines(kattn.source(D)):
            log(f"[attn] head {D} ptxas: {line}")
    kattn.launches = kattn.backward_launches = 0
    log(f"[attn] phase wall {time.perf_counter() - t0:.1f} s")
    return {"max_abs_err": worst, "ms": ms, "bound_ms": bound,
            "parts": parts}


def lm_phases() -> tuple[dict, dict]:
    """[attn], then the serving phases of LM_ARCHS with the attention
    kernel's launches counted over them: ([attn]'s record with the
    launches, each phase's rmsnorm record by tag)."""
    from repro_torch.kernels import attention as kattn
    attn_rec = attn_phase()
    arch_recs = {run.tag: lm_arch_phase(run) for run in LM_ARCHS}
    attn_rec["launches"] = kattn.launches
    attn_rec["backward_launches"] = kattn.backward_launches
    log(f"[attn] launches over [lm], [lm-moe], [lm-hybrid] and "
        f"[lm-xlstm]: {kattn.launches} forward, {kattn.backward_launches} "
        f"backward")
    if not kattn.launches:
        raise AssertionError("the LM phases never launched the attention "
                             "kernel")
    return attn_rec, arch_recs


def attn_row(rec: dict) -> dict:
    """The attention kernel's entry of the result line's kernels."""
    return {
        "name": "attn", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/attn.cuh",
        "replaces": "none (the reference's attention is einsums)",
        "launches": rec["launches"],
        "backward_launches": rec["backward_launches"],
        "max_abs_err": rec["max_abs_err"], "ms": rec["ms"],
        "bound_ms": rec["bound_ms"], "bound_by": "operations",
        "per": ("forward + backward device time of the LM cell's four "
                "layers (3 window, 1 full) over one micro-batch of 8 x "
                "8,192 tokens, bound from portbench.lmwork; max_abs_err "
                "the worst of [attn]'s checks, relative to max |x|; "
                "launches over [lm], [lm-moe], [lm-hybrid] and "
                "[lm-xlstm]"),
        "parts": rec["parts"]}


def lm_arch_phase(run: LMArch) -> dict:
    """``[run.tag]``: the run's model at full width on the card.  bf16:
    the engine's tokens equal direct runs from a zero state, and a reused
    slot's equal a fresh one's; the fused rmsnorm of layer 0's input on
    the Row kernel; prefill and decode times beside their bounds and the
    engine's host share.  Then, the bf16 model freed, fp32 of the same
    draws: the run's attention checks, decode against the full forward
    with planted faults, and the MoE forms.  Returns the rmsnorm's kernel
    record."""
    import numpy as np
    import torch
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    m16 = lm_arch_model(run, "bfloat16")
    cfg = m16.cfg
    w = lm_weight_counts(m16)
    log(f"[{run.tag}] {cfg.name} ({run.cut}): {cfg.n_layers} layers "
        f"{[s.kind + ('+moe' if s.use_moe else '') for s in m16.pattern]} "
        f"a period, d_model {cfg.d_model}, {cfg.n_heads} / "
        f"{cfg.n_kv_heads} heads, d_ff {cfg.d_ff} ({cfg.mlp_type}), "
        f"experts {cfg.n_experts} top-{cfg.top_k}, vocab {cfg.vocab}; "
        f"{w['params']:,} parameters drawn on the card (seed {LM_SEED}) as "
        f"bf16 ({w['bytes'] / 1e9:.2f} GB), {w['active_params']:,} read a "
        f"token with the active weights (MoE: the top-k experts); set-up "
        f"{time.perf_counter() - t0:.1f} s")
    if run.counted:
        counted = w["params"] - sum(p.numel()
                                    for p in m16.final_norm.parameters())
        if counted != cfg.total_params:
            raise AssertionError(f"{counted} parameters besides the final "
                                 f"norm, the config counts "
                                 f"{cfg.total_params}")
    gen = torch.Generator(device="cuda").manual_seed(LM_SEED + 1)
    prompts = [lm_tokens(gen, n, cfg.vocab).cpu().numpy().astype(np.int32)
               for n in run.prompts[:-1]]
    prompts.append(prompts[1])
    lm_engine_check(run.tag, run, m16, prompts)
    toks = lm_tokens(gen, LM_SEQ, cfg.vocab)[None]
    rec = lm_norm_record(run.tag, m16, toks, gen)
    rec["times"] = lm_times(run.tag, run, m16, gen, prompts[3])
    full16 = None
    if run.attn_checks:
        with torch.no_grad():
            full16 = m16.apply(toks)[0]
    log(f"[{run.tag}] bf16 part: peak device memory "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB, wall "
        f"{time.perf_counter() - t0:.1f} s")
    del m16
    torch.cuda.empty_cache()
    t1 = time.perf_counter()
    m32 = lm_arch_model(run, "float32")
    log(f"[{run.tag}] fp32 model of the same draws "
        f"({sum(p.numel() for p in m32.parameters()) * 4 / 1e9:.2f} GB) "
        f"drawn in {time.perf_counter() - t1:.1f} s")
    if run.attn_checks:
        lm_attn_checks(run.tag, m32, toks, full16)
        del full16
    lm_fp32_checks(run.tag, run, m32, gen)
    del m32
    torch.cuda.empty_cache()
    log(f"[{run.tag}] peak device memory "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB; phase wall "
        f"{time.perf_counter() - t0:.1f} s")
    return rec


# --------------------------------------------------------------------------
# [lm-train]: LM training on the card (phase 22)
# --------------------------------------------------------------------------

#: the fused loss's vocabulary widths: every configuration's (musicgen's
#: 2,048, x 4 codebooks) and the CLI's 100m preset's 32,000
LOSS_WIDTHS = (2048, 32000, 49152, 50304, 64000, 65536, 131072, 256000,
               262144)
#: token rows of each fused-loss check, and the width whose CPlans are also
#: built and run with the planted fault (the middle column slice of the
#: last fold pass dropped)
LOSS_ROWS = 2048
LOSS_PLANTED = 256000
#: the fused loss over rows wider than a cluster's shared memory holds
#: (4 MB): the streaming layout, held to plain with its planted fault
LOSS_STREAM_SHAPE = (256, 1_048_576)
#: widths of the rmsnorm whose warp-layout builds' ptxas lines [lm-train]
#: prints: the readings cuda_src.WARP_FLOATS_MAX is set from
WARP_PROBE_WIDTHS = (256, 512, 768, 1024, 1536, 2048, 3072, 4096)
#: the trace check: minitron-4b at full width in fp32 with its depth cut to
#: TRAIN_TRACE_LAYERS, and the full-size run (bf16, full depth): steps of
#: TRAIN_BATCH x TRAIN_SEQ tokens, the fused loss (fusion "gen")
TRAIN_TRACE_LAYERS = 2
TRAIN_STEPS = 3
TRAIN_BATCH, TRAIN_SEQ = 2, 128
#: the CLI run at examples/train_lm.py's configuration, its checkpoint
#: step, and the resumed run's losses against the uninterrupted run's
CLI_ARGS = ("--arch", "minitron-4b", "--preset", "100m", "--batch", "8",
            "--seq", "512", "--fusion", "gen", "--steps", "10",
            "--ckpt-every", "5")
CLI_RESUME_STEP = 5
CLI_RTOL = 1e-6
#: the fused loss's (rows, V) on the main paths, also held to plain and
#: timed: the trace check's and full-size run's steps over minitron-4b's
#: vocabulary, and the CLI's steps over the 100m preset's
LOSS_MAIN_SHAPES = (
    (TRAIN_BATCH * TRAIN_SEQ, 256000),
    (int(CLI_ARGS[CLI_ARGS.index("--batch") + 1])
     * int(CLI_ARGS[CLI_ARGS.index("--seq") + 1]), 32000))
#: the full-size step's bound: 6 N T bf16 FLOP at the tensor cores' peak
#: and AdamW's bytes a parameter (bf16 p and g read, p written; fp32 m and
#: v read and written) once at HBM bandwidth
ADAMW_BYTES = 22


def loss_cplans(V: int, rows: int = LOSS_ROWS):
    """The fused loss's CPlans over (rows, V): the log-sum-exp forward
    and its planned backward (``launch.train._lse``), planned on shapes
    alone."""
    from repro_torch.launch import train
    return region_cplans([(train._lse, (meta(rows, V),), True)])


def loss_shapes() -> list:
    """Every (rows, V) [lm-train] holds the fused loss at: each width over
    LOSS_ROWS rows, the main paths' shapes, and rows wider than a
    cluster."""
    return ([(LOSS_ROWS, V) for V in LOSS_WIDTHS] + list(LOSS_MAIN_SHAPES)
            + [LOSS_STREAM_SHAPE])


def loss_sources() -> list:
    """Every fused-loss kernel source [lm-train] launches: each shape's
    forward and backward (:func:`loss_shapes`), the planted builds at
    LOSS_PLANTED (the chunk never copied, the rank left out of the cluster
    fold) and at LOSS_STREAM_SHAPE (the streaming layout's), each text
    once (the row count is a launch argument, so a main path's shape
    shares its width's source)."""
    from repro_torch.kernels import cuda_src
    out = []
    for rows, V in loss_shapes():
        for _l, cp in loss_cplans(V, rows):
            src = cuda_src.source_for(cp)
            out.append(src)
            if (rows, V) in ((LOSS_ROWS, LOSS_PLANTED), LOSS_STREAM_SHAPE):
                out.append(planted(src))
            if (rows, V) == (LOSS_ROWS, LOSS_PLANTED):
                out.append(planted(src, rank=True))
    return list({s.key: s for s in out}.values())


def warp_probe_sources() -> list:
    """The rmsnorm's CPlan at WARP_PROBE_WIDTHS built in the warp layout
    (built only, for their ptxas lines)."""
    from repro_torch.kernels import cuda_src
    return [cuda_src._warp_source(cp) for d in WARP_PROBE_WIDTHS
            for _l, cp in lm_norm_cplans(d)]


def warp_readings() -> list:
    """[lm-train]'s log of :func:`warp_probe_sources`: each width's
    register floats a lane and its ptxas register and spill line."""
    out = []
    for d, src in zip(WARP_PROBE_WIDTHS, warp_probe_sources()):
        lines = ptxas_lines(src)
        log(f"[lm-train] warp-layout rmsnorm at {d} columns, {src.floats} "
            f"register floats a lane (ptxas): {' | '.join(lines)}")
        out.append({"width": d, "floats": src.floats, "ptxas": lines})
    return out


def loss_library(label: str, env, cp):
    """One PyTorch call computing the fused loss's CPlan (the forward's
    ``torch.logsumexp``), or two (the backward: ``torch.softmax`` then a
    multiply by the cotangent)."""
    import torch
    L = env[cp.main.nid]
    if not label.endswith(":vjp"):
        return lambda: torch.logsumexp(L, 1, keepdim=True)
    (g,) = [env[b.nid] for b in cp.binds if b.nid != cp.main.nid]
    return lambda: torch.softmax(L, 1).mul_(g)


def loss_checks(gen) -> dict:
    """The fused loss alone at every LOSS_WIDTHS width over LOSS_ROWS rows
    of logits N(0, 2²) (and a cotangent N(0, 1) a row for the backward),
    then at the main paths' LOSS_MAIN_SHAPES and at LOSS_STREAM_SHAPE:
    each CPlan on the Row kernel held to its plain version on the same
    CUDA tensors within the kernel limit, run twice for the same bits, its
    layout named and its build's ptxas line printed; the planted faults at
    LOSS_PLANTED and LOSS_STREAM_SHAPE must fail; the kernel's, plain
    version's and library call's device times (CUDA events queued behind a
    spin kernel) beside the bound (bytes once over HBM bandwidth, or the
    program's fp32 operations, the larger).  Then the warp layout's ptxas
    readings (:func:`warp_readings`).  Returns {label: [part per shape]}
    and, under "warp", those readings."""
    import torch
    parts = {}
    for rows, V in loss_shapes():
        for label, part in loss_shape_checks(gen, rows, V).items():
            parts.setdefault(label, []).append(part)
        torch.cuda.empty_cache()
    parts["warp"] = warp_readings()
    return parts


def loss_shape_checks(gen, rows: int, V: int) -> dict:
    """:func:`loss_checks` at one (rows, V); the planted faults where that
    is (LOSS_ROWS, LOSS_PLANTED) (a staged chunk never copied, and a
    cluster rank's partial left out) or LOSS_STREAM_SHAPE (the streaming
    layout's).  Returns {label: part}."""
    import torch
    from repro_torch.kernels import cuda_src, ops, ref, rowwise
    L = 2.0 * torch.randn((rows, V), generator=gen, device="cuda")
    g = torch.randn((rows, 1), generator=gen, device="cuda")
    main = (rows, V) in LOSS_MAIN_SHAPES
    faults = {(LOSS_ROWS, LOSS_PLANTED): ({}, {"rank": True}),
              LOSS_STREAM_SHAPE: ({},)}.get((rows, V), ())
    out_parts = {}
    for label, cp in loss_cplans(V, rows):
        src = cuda_src.source_for(cp)
        env = {b.nid: (L if b.nid == cp.main.nid else g) for b in cp.binds}
        err, share = compare(cp, env, f"[lm-train] {label} {rows} x {V}")
        out = rowwise.row(cp, env)
        if not bool(torch.equal(rowwise.row(cp, env), out)):
            raise AssertionError(f"loss {label} at {rows} x {V}: a second "
                                 f"call gave other bits")
        planted_shares = {}
        for kw in faults:
            with planted_fault(**kw):
                bad = ops.execute(cp, env, kernels="cuda")
            what = "rank" if kw else "chunk" if src.layout == "staged" \
                else "slice"
            planted_shares[what] = fault_share(cp, env, bad,
                                               f"planted {what} loss")
            del bad
            if not planted_shares[what] > 1.0:
                raise AssertionError(f"planted {what} fault in the loss's "
                                     f"{label} at {V} passed the kernel "
                                     f"check")
        calls = {"kernel": lambda: rowwise.row(cp, env),
                 "plain": lambda: ref.execute_dense(cp, env),
                 "library": loss_library(label, env, cp)}
        dev = {k: queued_ms(fn) for k, fn in calls.items()}
        b_ms, b_by = bound_ms(cp, env, out)
        spill = ptxas_lines(src)
        part = {"region": label, "width": V, "rows": rows,
                "main_path": main,
                "variant": cp.variant, "layout": layout_name(cp),
                "cluster": src.cluster, "threads": src.threads,
                "smem": src.smem,
                "binds": [list(b.shape) for b in cp.binds],
                "max_abs_err": err, "share": share,
                "planted_share": planted_shares or None, "ms": dev["kernel"],
                "plain_ms": dev["plain"], "library_ms": dev["library"],
                "bound_ms": b_ms, "bound_by": b_by, "ptxas": spill}
        out_parts[label] = part
        fmt = lambda v: "not measured" if v is None else f"{v:.4f} ms"
        geo = (f"K {src.cluster} x {src.threads} thr"
               if src.layout == "staged" else "")
        log(f"[lm-train] loss {label:8s} {rows:>4d} x {V:<7d} "
            f"{part['layout']:6s} {geo}{' (main path)' if main else ''} "
            f"max|kernel-plain| {err:.3e} = {share:.3g} x limit, same bits "
            f"twice"
            + "".join(f"; planted {k} {v:.3g} x limit"
                      for k, v in planted_shares.items())
            + f"; device: kernel {fmt(dev['kernel'])}, plain "
            f"{fmt(dev['plain'])}, library {fmt(dev['library'])} "
            f"({'logsumexp' if label == '_lse' else 'softmax, mul_'}); "
            f"bound {b_ms:.4f} ms ({b_by}); ptxas: {' | '.join(spill)}")
        del out
    return out_parts


def train_model(n_layers: int, dtype: str):
    """minitron-4b at full width in ``dtype`` (``n_layers`` 0: its full
    depth), drawn on the card from a generator seeded with LM_SEED."""
    return lm_arch_model(LM_ARCHS[0]._replace(n_layers=n_layers), dtype)


def train_batches(cfg, steps: int = TRAIN_STEPS, start: int = 0) -> list:
    """The batches of ``steps`` steps from the port's loader (seed 0),
    TRAIN_BATCH x TRAIN_SEQ tokens."""
    from repro_torch.data import DataConfig, ShardedLoader
    loader = ShardedLoader(DataConfig(seq_len=TRAIN_SEQ,
                                      global_batch=TRAIN_BATCH,
                                      vocab=cfg.vocab), start_step=start)
    out = [next(loader) for _ in range(steps)]
    loader.close()
    return [{k: v for k, v in b.items() if k != "step"} for b in out]


def train_trace(model, batches, kernels: str) -> tuple[list, list, int]:
    """``make_train_step`` (fusion "gen", AdamW, updated in place) over
    ``batches`` from the model's parameters (copied), under ``kernels``,
    the Row launch counter set to 0 just before and read just after:
    (losses, grad norms, Row launches)."""
    import torch
    from repro_torch.core import fusion_mode
    from repro_torch.kernels import cellwise, multiagg, outerprod, rowwise
    from repro_torch.launch import train
    from repro_torch.optim import adamw
    params = {k: v.detach().clone() for k, v in model.named_parameters()}
    tc = train.TrainConfig(fusion="gen")
    opt = adamw.init(params, tc.opt)
    step = train.make_train_step(model, model.cfg, tc)
    losses, norms = [], []
    torch.cuda.synchronize()
    for mod in (cellwise, multiagg, outerprod, rowwise):
        mod.launches = 0
    with fusion_mode(kernels=kernels):
        for b in batches:
            params, opt, m = step(params, opt, b)
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
    torch.cuda.synchronize()
    others = cellwise.launches + multiagg.launches + outerprod.launches
    if others:
        raise AssertionError(f"the train step launched {others} kernels "
                             f"besides the Row kernel")
    launches = rowwise.launches
    del params, opt
    torch.cuda.empty_cache()
    return losses, norms, launches


def train_trace_check() -> dict:
    """minitron-4b at full width in fp32, its depth cut to
    TRAIN_TRACE_LAYERS: TRAIN_STEPS steps with ``kernels="cuda"`` against
    ``kernels="never"``: loss and grad-norm traces within TRACE_RTOL
    relative, 2 Row launches a step; the planted fault must fail the same
    check."""
    import torch
    t0 = time.perf_counter()
    model = train_model(TRAIN_TRACE_LAYERS, "float32")
    cfg = model.cfg
    batches = train_batches(cfg)
    log(f"[lm-train] trace check: {cfg.name} at full width (d_model "
        f"{cfg.d_model}, vocab {cfg.vocab}) in fp32, depth cut to "
        f"{cfg.n_layers} of 32 layers (fp32 parameters, AdamW moments and "
        f"gradients of all 32 would be 67 GB besides the activations); "
        f"{TRAIN_STEPS} steps of {TRAIN_BATCH} x {TRAIN_SEQ} tokens, "
        f"fusion gen")
    got = train_trace(model, batches, "cuda")
    want = train_trace(model, batches, "never")
    with planted_fault():
        bad = train_trace(model, batches, "cuda")
    rel = trace_rel(got[0] + got[1], want[0] + want[1])
    rel_bad = trace_rel(bad[0] + bad[1], want[0] + want[1])
    log(f"[lm-train] losses kernels=cuda {got[0]}, never {want[0]}; grad "
        f"norms cuda {got[1]}, never {want[1]}; max relative difference "
        f"{rel:.3e} (tolerance {TRACE_RTOL:g}); Row launches {got[2]} "
        f"({got[2] / TRAIN_STEPS:g} a step); planted fault: losses "
        f"{bad[0]}, max relative difference {rel_bad:.3e}")
    if not rel <= TRACE_RTOL:
        raise AssertionError("[lm-train]: kernels=cuda and never traces "
                             "disagree")
    if got[2] != 2 * TRAIN_STEPS or want[2] != 0:
        raise AssertionError(f"[lm-train]: {got[2]} Row launches in "
                             f"{TRAIN_STEPS} steps, not 2 a step (never: "
                             f"{want[2]})")
    if not rel_bad > TRACE_RTOL:
        raise AssertionError("[lm-train]: the planted fault passed the "
                             "trace check")
    del model
    torch.cuda.empty_cache()
    log(f"[lm-train] trace check wall {time.perf_counter() - t0:.1f} s")
    return {"losses": got[0], "grad_norms": got[1], "rel": rel,
            "planted_rel": rel_bad, "launches": got[2]}


def train_full() -> dict:
    """minitron-4b at full width and depth in bf16 with fp32 AdamW
    moments: TRAIN_STEPS steps through ``run_loop`` and ``ShardedLoader``
    (fusion "gen", updated in place), the counters set to 0 just before
    and read just after; finite losses, 2 Row launches a step; the median
    step of steps 2.. beside its bound, tokens a second, peak memory; one
    more step profiled for the host share."""
    import torch
    from repro_torch.core import fusion_mode
    from repro_torch.data import DataConfig, ShardedLoader
    from repro_torch.kernels import cellwise, multiagg, outerprod, rowwise
    from repro_torch.launch import train
    from repro_torch.optim import adamw
    from repro_torch.train import LoopConfig, run_loop
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model = train_model(0, "bfloat16")
    cfg = model.cfg
    params = dict(model.named_parameters())
    n = sum(p.numel() for p in params.values())
    tc = train.TrainConfig(fusion="gen")
    opt = adamw.init(params, tc.opt)
    step = train.make_train_step(model, cfg, tc)
    loader = ShardedLoader(DataConfig(seq_len=TRAIN_SEQ,
                                      global_batch=TRAIN_BATCH,
                                      vocab=cfg.vocab))
    set_up = time.perf_counter() - t0
    torch.cuda.synchronize()
    for mod in (cellwise, multiagg, outerprod, rowwise):
        mod.launches = 0
    with fusion_mode(kernels="cuda"):
        params, opt, st = run_loop(step, params, opt, loader,
                                   LoopConfig(total_steps=TRAIN_STEPS,
                                              checkpoint_every=10 ** 9))
    torch.cuda.synchronize()
    launches = {"row": rowwise.launches, "cell": cellwise.launches,
                "magg": multiagg.launches, "outer": outerprod.launches}
    batch = {k: v for k, v in next(loader).items() if k != "step"}
    loader.close()
    if len(st.losses) != TRAIN_STEPS or not all(
            math.isfinite(v) for v in st.losses):
        raise AssertionError(f"[lm-train] full size: losses {st.losses}")
    if launches != {"row": 2 * TRAIN_STEPS, "cell": 0, "magg": 0,
                    "outer": 0}:
        raise AssertionError(f"[lm-train] full size launched {launches}, "
                             f"not 2 Row launches a step")
    step_ms = statistics.median(st.step_times[1:]) * 1e3
    tokens = TRAIN_BATCH * TRAIN_SEQ
    flops_ms = 6 * n * tokens / BF16_PEAK * 1e3
    bytes_ms = ADAMW_BYTES * n / HBM_BW * 1e3
    peak = torch.cuda.max_memory_allocated()
    with fusion_mode(kernels="cuda"):
        wall_ms, busy_ms = profile_run(
            f"[lm-train] one more step of {cfg.name} at full size",
            lambda: step(params, opt, batch))
    out = {"params": n, "layers": cfg.n_layers, "losses": st.losses,
           "step_ms": [v * 1e3 for v in st.step_times],
           "median_step_ms": step_ms, "bound_ms": flops_ms + bytes_ms,
           "bound_flops_ms": flops_ms, "bound_adamw_ms": bytes_ms,
           "tokens_per_s": tokens / (step_ms / 1e3), "peak_gb": peak / 1e9,
           "launches": launches, "host_share": 1 - busy_ms / wall_ms,
           "profiled_wall_ms": wall_ms, "profiled_busy_ms": busy_ms}
    log(f"[lm-train] full size: {cfg.name}, {cfg.n_layers} layers, "
        f"{n:,} parameters in bf16, AdamW moments fp32; set-up "
        f"{set_up:.1f} s; {TRAIN_STEPS} steps of {TRAIN_BATCH} x "
        f"{TRAIN_SEQ} tokens through run_loop: losses {st.losses}; "
        f"launches {json.dumps(launches)}; step ms "
        f"{[round(v * 1e3, 2) for v in st.step_times]} (host clock), "
        f"median of steps 2-{TRAIN_STEPS} {step_ms:.2f} ms, bound "
        f"{flops_ms + bytes_ms:.2f} ms (6 N T = {6 * n * tokens:.3e} bf16 "
        f"FLOP at {BF16_PEAK / 1e12:g} TFLOP/s: {flops_ms:.2f} ms; "
        f"AdamW's {ADAMW_BYTES} bytes a parameter at {HBM_BW / 1e12:g} "
        f"TB/s: {bytes_ms:.2f} ms); {out['tokens_per_s']:.0f} tokens/s; "
        f"peak device memory {peak / 1e9:.2f} GB; host share of one "
        f"profiled step {out['host_share']:.3f}")
    del model, params, opt, batch
    torch.cuda.empty_cache()
    log(f"[lm-train] full-size wall {time.perf_counter() - t0:.1f} s")
    return out


def train_cli(tmp: Path) -> dict:
    """``python -m repro_torch.launch.train`` (CLI_ARGS) on the card for
    its steps with a checkpoint every CLI_RESUME_STEP; the later
    checkpoint removed (as if the run had stopped after the first); a
    second process with ``--resume``: its losses for the steps after
    CLI_RESUME_STEP against the uninterrupted run's, bit for bit or within
    CLI_RTOL (which one is logged)."""
    import os
    import shutil
    ckpt = tmp / "ckpt"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))

    def cli(*extra):
        t0 = time.perf_counter()
        r = subprocess.run([sys.executable, "-m", "repro_torch.launch.train",
                            *CLI_ARGS, "--ckpt-dir", str(ckpt), *extra],
                           capture_output=True, text=True, timeout=300,
                           env=env, cwd=str(ROOT))
        if r.returncode != 0:
            raise AssertionError(f"train CLI {extra} failed:\n"
                                 f"{r.stderr[-3000:]}")
        line = [ln for ln in r.stdout.splitlines()
                if ln.startswith("losses ")][-1]
        rec = json.loads(line[len("losses "):])
        for ln in r.stdout.splitlines():
            if ln.startswith(("step", "done", "resumed")):
                log(f"[lm-train] cli{' ' + ' '.join(extra) if extra else ''}"
                    f": {ln}")
        return ({rec["first_step"] + i: v
                 for i, v in enumerate(rec["losses"])},
                time.perf_counter() - t0)

    full, t_full = cli()
    steps = sorted(p.name for p in ckpt.iterdir())
    last = int(CLI_ARGS[CLI_ARGS.index("--steps") + 1])
    shutil.rmtree(ckpt / f"step_{last}")
    again, t_again = cli("--resume")
    if sorted(again) != list(range(CLI_RESUME_STEP + 1, last + 1)):
        raise AssertionError(f"resumed run's steps {sorted(again)}")
    rel = max(abs(again[s] - full[s]) / abs(full[s]) for s in again)
    exact = all(again[s] == full[s] for s in again)
    log(f"[lm-train] cli {' '.join(CLI_ARGS)}: checkpoints {steps}; "
        f"losses {[full[s] for s in sorted(full)]}; resumed from step "
        f"{CLI_RESUME_STEP}: {[again[s] for s in sorted(again)]}: "
        f"{'bit for bit' if exact else f'max relative {rel:.3e}'} against "
        f"the uninterrupted run (tolerance {CLI_RTOL:g}); process walls "
        f"{t_full:.1f} s and {t_again:.1f} s")
    if not rel <= CLI_RTOL:
        raise AssertionError("[lm-train]: the resumed CLI run's losses "
                             "differ from the uninterrupted run's")
    shutil.rmtree(ckpt, ignore_errors=True)
    return {"losses": full, "resumed": again, "bit_for_bit": exact,
            "max_rel": rel}


def lm_train_phase() -> dict:
    """[lm-train] (see the module docstring); returns the loss kernels'
    records for the result line."""
    import tempfile
    import torch
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    gen = torch.Generator(device="cuda").manual_seed(LM_SEED + 2)
    parts = loss_checks(gen)
    log(f"[lm-train] loss checks wall {time.perf_counter() - t0:.1f} s")
    trace = train_trace_check()
    full = train_full()
    with tempfile.TemporaryDirectory() as tmp:
        cli = train_cli(Path(tmp))
    log(f"[lm-train] phase wall {time.perf_counter() - t0:.1f} s")
    recs = {"warp": parts.pop("warp")}
    for label, name in (("_lse", "row_loss"), ("_lse:vjp", "row_loss_vjp")):
        main = next(p for p in parts[label]
                    if (p["rows"], p["width"]) == (LOSS_ROWS, 256000))
        recs[name] = {"ms": main["ms"], "plain_ms": main["plain_ms"],
                      "bound_ms": main["bound_ms"],
                      "bound_by": main["bound_by"],
                      "library_ms": main["library_ms"],
                      "max_abs_err": max(p["max_abs_err"]
                                         for p in parts[label]),
                      "launches": full["launches"]["row"] // 2,
                      "parts": parts[label]}
    recs["train"] = {"trace": trace, "full": full, "cli": cli}
    return recs


# --------------------------------------------------------------------------
# [lm-sharded]: the sharded LM Engine over gloo ranks on the one card
# --------------------------------------------------------------------------

#: the mesh of the [lm-sharded] ranks (all on the one card, over gloo)
SHARDED_MESH = {"data": 2, "model": 2}
SHARDED_SEED = 23
#: six requests through four slots (the last two reuse one); the first
#: is two of minitron's and olmoe's 1,024-token attention chunks, so its
#: prefill takes the chunked path on the rank's heads
SHARDED_PROMPTS = (2048, 96, 33, 17, 5, 33)
SHARDED_SLOTS, SHARDED_NEW, SHARDED_MAX_LEN = 4, 8, 2112
#: the prompt whose prefill (last position) and four teacher-forced
#: decode logits are held, and planted with the fault; each prompt that
#: takes the chunked path is held too
SHARDED_TEACHER = 33
#: decode logits of the sharded engine against the one-rank engine's, of
#: max |logit| (fp32, TF32 off: the products summed in other orders); a
#: token may differ only where the one-rank engine's top-2 margin is
#: within twice this
SHARDED_RTOL = 1e-5
#: the weights' tiles a dim (a block of the layout is a union of tiles)
SHARDED_TILES = 4
#: decode walls taken in one slot, and Engine.step() walls with every
#: slot decoding (the fixed layout's)
SHARDED_DECODES, SHARDED_STEPS = 5, 3
#: the sampled serve of a fixed run: its requests (SHARDED_PROMPTS from
#: the third), new tokens each and temperature; both engines are seeded
#: SHARDED_SEED, and every rank draws for every slot, so the tokens must
#: be the one-rank engine's
SHARDED_SAMPLED, SHARDED_SAMPLED_NEW, SHARDED_TEMPERATURE = 2, 4, 1.0
SHARDED_TIMEOUT_S = 900
SHARDED_PG_TIMEOUT_S = 300


class ShardedRun(NamedTuple):
    """One model of [lm-sharded].  ``n_layers`` 0 keeps its depth;
    ``layout`` "fixed" is ``Engine(layout="fixed")``, timed and planted
    with the fault; "fsdp" is ``Engine(layout="auto")`` with the
    planner's ``serve_params`` forced off, so that every FSDP-sharded
    leaf is gathered over ``data`` before each use and a data block runs
    a forward for each slot its peer serves."""
    tag: str
    arch: str
    n_layers: int
    layout: str
    prompts: tuple
    new: int
    cut: str


SHARDED_RUNS = (
    ShardedRun("minitron", "minitron-4b", 0, "fixed", SHARDED_PROMPTS,
               SHARDED_NEW, "full width and depth (32 layers), fp32: 16.8 GB "
               "whole, 8.4 GB a rank"),
    ShardedRun("olmoe", "olmoe-1b-7b", 0, "fixed", SHARDED_PROMPTS,
               SHARDED_NEW, "full width and depth (16 layers, 64 experts, "
               "expert-parallel over model 2), fp32: 27.7 GB whole, 13.9 GB "
               "a rank"),
    ShardedRun("xlstm-fsdp", "xlstm-1.3b", 2, "fsdp", (33, 17, 5), 4,
               "full width, 2 of its 48 layers, fp32: 1.4 GB whole, 0.36 GB "
               "a rank stored; each forward gathers every FSDP-sharded leaf "
               "through host memory, the embedding and head included (the "
               "same run of minitron-4b at 2 layers, 6.9 GB, took 4.6 s a "
               "forward on the card), so its cost grows with the forwards"),
)


def sharded_config(run: ShardedRun):
    from repro_torch.configs import get_config
    cfg = dataclasses.replace(get_config(run.arch), dtype="float32")
    if run.n_layers:
        cfg = dataclasses.replace(cfg, n_layers=run.n_layers)
    return cfg


def sharded_prompts(cfg, lens) -> list:
    import numpy as np
    rng = np.random.default_rng(SHARDED_SEED)
    return [rng.integers(0, cfg.vocab, size=p).astype(np.int32)
            for p in lens]


def sharded_teachers(cfg, run: ShardedRun, prompts) -> list:
    """The prompts of the logits checks: the SHARDED_TEACHER-token one,
    then each that takes the chunked path."""
    C = cfg.attn_chunk
    return [prompts[run.prompts.index(SHARDED_TEACHER)]] + [
        p for p in prompts if C and len(p) > C and len(p) % C == 0]


def sharded_block(cfg, key: str, shape, index):
    """Block ``index`` (a slice a dim) of parameter ``key`` of the
    [lm-sharded] weights, drawn on the card in fp32.  The whole leaf is
    N(0, 1) times its scale (embedding and head d^-1/2, a projection
    fan-in^-1/2; rmsnorm scales 0), drawn tile by tile: each dim cut into
    gcd(dim, SHARDED_TILES) tiles, each tile from a CUDA generator seeded
    by (SHARDED_SEED, key, tile), so a rank draws only the tiles of its
    block and the one-rank reference, drawing them all, gets the same
    values."""
    import itertools
    import zlib
    import torch
    name = key.rsplit(".", 1)[-1]
    out = torch.empty(tuple(s.stop - s.start for s in index), device="cuda")
    if name == "scale" and cfg.norm_type == "rmsnorm":
        return out.zero_()
    if len(shape) < 2:
        raise ValueError(f"{key}: no draw rule for a {len(shape)}-d leaf")
    scale = (cfg.d_model if name in ("embed", "head") else shape[-2]) ** -0.5
    parts = [math.gcd(n, SHARDED_TILES) for n in shape]
    gen = torch.Generator(device="cuda")
    for t in itertools.product(*(range(p) for p in parts)):
        lo = [ti * n // p for ti, n, p in zip(t, shape, parts)]
        hi = [(ti + 1) * n // p for ti, n, p in zip(t, shape, parts)]
        a = [max(l, s.start) for l, s in zip(lo, index)]
        b = [min(h, s.stop) for h, s in zip(hi, index)]
        if any(x >= y for x, y in zip(a, b)):
            continue
        gen.manual_seed(zlib.crc32(f"{SHARDED_SEED}/{key}/{t}".encode()))
        vals = torch.randn(tuple(h - l for l, h in zip(lo, hi)),
                           generator=gen, device="cuda")
        out[tuple(slice(x - s.start, y - s.start)
                  for x, y, s in zip(a, b, index))] = vals[tuple(
                      slice(x - l, y - l) for x, y, l in zip(a, b, lo))]
        del vals
    return out.mul_(scale)


def sharded_logits(engine, prompt, teacher=None) -> tuple:
    """Prefill ``prompt`` into the engine's first own slot (its recurrent
    state zeroed) and decode four steps fed ``teacher``'s tokens (default:
    the argmax); returns (the five logits on the host, the fed tokens)."""
    import torch
    from repro_torch.serve.engine import RECURRENT_LEAVES
    cache = engine._slot_cache(engine.slot0)
    for layer in cache["blocks"] + cache["rest"]:
        for k in RECURRENT_LEAVES:
            if k in layer:
                layer[k].zero_()
    dev = engine.model.device
    out, _ = engine._prefill(torch.as_tensor(prompt, dtype=torch.int64,
                                             device=dev)[None], cache)
    outs, fed = [out.float().cpu()], []
    for s in range(4):
        tok = int(torch.argmax(outs[-1][0, -1])) if teacher is None \
            else teacher[s]
        fed.append(tok)
        _n, lg, _ = engine._decode(cache, torch.full(
            (1, 1), tok, dtype=torch.int64, device=dev), len(prompt) + s)
        outs.append(lg.float().cpu())
    return outs, fed


def sharded_serve(engine, prompts, new: int,
                  temperature: float = 0.0) -> tuple[list, float]:
    """Every prompt through the engine's queue: (tokens, wall s)."""
    import torch
    from repro_torch.serve import Request
    reqs = [Request(prompt=p, max_new=new, temperature=temperature)
            for p in prompts]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for r in reqs:
        engine.submit(r)
    engine.run_until_done()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if not all(r.done and r.error is None for r in reqs):
        raise AssertionError("a request did not finish")
    return [r.out for r in reqs], wall


def sharded_margins(model, prompts, tokens) -> list:
    """Each request's top-2 margin of max |logit| at every decode step of
    a direct run fed its own tokens the engine's way."""
    import torch
    out = []
    for p, toks in zip(prompts, tokens):
        cache = model.init_cache(1, SHARDED_MAX_LEN)
        feed = [int(p[-1])] + toks[:-1]
        m = []
        with torch.no_grad():
            model.apply(torch.as_tensor(p, dtype=torch.int64,
                                        device="cuda")[None], caches=cache)
            for s, tok in enumerate(feed):
                lg, _ = model.decode_step(cache, [[tok]], len(p) + s)
                top = torch.topk(lg[0, -1].float(), 2).values
                m.append(float((top[0] - top[1]) / lg.abs().max()))
        out.append(m)
        del cache
    return out


def sharded_reference(run: ShardedRun, tmp: Path) -> dict:
    """The one-rank Engine on the card with the same weights (drawn whole
    on the card): its tokens, each step's top-2 margin, of a fixed run the
    sampled serve's tokens, and the teacher logits of
    :func:`sharded_logits` with the MoE layers' top-k experts and margins
    of each call (:class:`Routing`; written to ``tmp``)."""
    import torch
    from repro_torch.models import LM
    from repro_torch.serve import Engine
    cfg = sharded_config(run)
    t0 = time.perf_counter()
    model = LM(cfg, device="cuda").requires_grad_(False)
    with torch.no_grad():
        for key, p in model.state_dict(keep_vars=True).items():
            full = tuple(slice(0, n) for n in p.shape)
            p.copy_(sharded_block(cfg, key, tuple(p.shape), full))
    n_params = sum(p.numel() for p in model.parameters())
    draw_s = time.perf_counter() - t0
    prompts = sharded_prompts(cfg, run.prompts)
    engine = Engine(model, batch_slots=SHARDED_SLOTS,
                    max_len=SHARDED_MAX_LEN, seed=SHARDED_SEED)
    tokens, wall = sharded_serve(engine, prompts, run.new)
    sampled = sharded_serve(engine, prompts[SHARDED_SAMPLED:],
                            SHARDED_SAMPLED_NEW, SHARDED_TEMPERATURE)[0] \
        if run.layout == "fixed" else None
    teach = []
    for p in sharded_teachers(cfg, run, prompts):
        rec = Routing()
        with rec.installed():
            logits, fed = sharded_logits(engine, p)
        teach.append((logits, fed, [(i.cpu(), m.cpu()) for i, m in rec.taken]))
    torch.save(teach, tmp / f"{run.tag}.pt")
    del teach
    margins = sharded_margins(model, prompts, tokens)
    log(f"[lm-sharded] {run.tag}: one-rank Engine on the card, "
        f"{n_params:,} parameters ({run.cut}), drawn in {draw_s:.1f} s; "
        f"{len(prompts)} requests of {list(run.prompts)} tokens, "
        f"{run.new} new each, served in {wall:.2f} s")
    del engine, model
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return {"tokens": tokens, "margins": margins, "params": n_params,
            "sampled": sampled}


@contextlib.contextmanager
def planted_partial_sums(rank: int):
    """A fault planted in one rank: ``rank`` keeps its partial sums of
    layer 0's attention output (the all-reduce still runs, so no rank
    waits on it)."""
    from repro_torch.models import sharded
    real = sharded.Scope.reduce

    def reduce(self, y):
        out = real(self, y)
        if self.mesh.rank == rank and self.prefix == "layers.0.inner.":
            return y
        return out
    sharded.Scope.reduce = reduce
    try:
        yield
    finally:
        sharded.Scope.reduce = real


@contextlib.contextmanager
def planner_serve_params_off():
    """``planner.plan_layout`` answers its layout with ``serve_params``
    off (the "fsdp" run of :class:`ShardedRun`)."""
    from repro_torch.dist import planner
    real = planner.plan_layout
    planner.plan_layout = lambda *a, **k: dataclasses.replace(
        real(*a, **k), serve_params=False)
    try:
        yield
    finally:
        planner.plan_layout = real


def sharded_readings(engine, mesh, cfg, run, prompts, ref,
                     timed: bool) -> dict:
    """One rank's readings of one sharded engine: its tokens, its logits
    against the one-rank engine's, its stored bytes against the
    planner's, and with ``timed`` its sampled tokens, the logits with
    the planted fault and its times."""
    import torch
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.dist import LogicalMesh, planner
    from repro_torch.serve import Request
    res = {"slot0": engine.slot0, "n_local": engine.n_local,
           "layout": engine.layout.to_dict() if engine.layout else None,
           "fsdp": engine.model.shard.fsdp}
    c0, s0 = mesh.collectives, mesh.collective_s
    res["tokens"], res["serve_s"] = sharded_serve(engine, prompts, run.new)
    res["serve_collectives"] = mesh.collectives - c0
    res["serve_collective_s"] = mesh.collective_s - s0
    if timed:
        res["sampled"] = sharded_serve(
            engine, prompts[SHARDED_SAMPLED:], SHARDED_SAMPLED_NEW,
            SHARDED_TEMPERATURE)[0]
    teachers = sharded_teachers(cfg, run, prompts)

    def rel(p, want, fed, pins=()):
        # MoE layers pinned to the one-rank engine's experts (``pins``):
        # the flipped tokens' margins are kept
        route = Routing([(i.to(mesh.device), m.to(mesh.device))
                         for i, m in pins]) if pins else None
        with route.installed() if route else contextlib.nullcontext():
            got = sharded_logits(engine, p, fed)[0]
        return max(float((g - w).abs().max() / w.abs().max())
                   for g, w in zip(got, want)), \
            (route.margins if route else [])
    res["rel_errs"], res["flip_margins"], res["unpinned_rel_errs"] = \
        [], [], []
    for p, (want, fed, pins) in zip(teachers, ref):
        err, margins = rel(p, want, fed, pins)
        res["rel_errs"].append(err)
        res["flip_margins"] += margins
        if pins:
            res["unpinned_rel_errs"].append(rel(p, want, fed)[0])
    res["rel_err"] = max(res["rel_errs"])
    if timed:
        with planted_partial_sums(1):
            res["fault_rel_err"] = rel(teachers[0], *ref[0][:2])[0]
    shape = ShapeConfig("engine_decode", SHARDED_MAX_LEN, SHARDED_SLOTS,
                        "decode")
    lm = LogicalMesh(mesh.shape)
    params, cache = planner._abstract_state(cfg, shape)
    res["stored"] = engine.stored_bytes()
    res["planner_stored"] = {
        "params": planner._tree_accounting(lm, engine.param_specs,
                                           params)["stored"],
        "cache": planner._tree_accounting(lm, engine.cache_specs,
                                          cache)["stored"]}
    if not timed:
        return res

    # times: prefills (the longest prompt once, the second three times)
    # and decode steps in the rank's first slot, then Engine.step() with
    # every slot decoding
    cache_ = engine._slot_cache(engine.slot0)
    walls = []
    for p in (prompts[0],) + (prompts[1],) * 3:
        toks = torch.as_tensor(p, dtype=torch.int64, device=mesh.device)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        engine._prefill(toks[None], cache_)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    res["long_prefill_ms"], res["prefill_ms"] = walls[0], walls[1:]
    tok = toks[None, -1:]
    walls, colls, coll_ms = [], [], []
    for s in range(SHARDED_DECODES):
        c0, s0 = mesh.collectives, mesh.collective_s
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        nxt, _lg, _ = engine._decode(cache_, tok, len(toks) + s)
        int(nxt.reshape(-1)[0])
        walls.append((time.perf_counter() - t0) * 1e3)
        colls.append(mesh.collectives - c0)
        coll_ms.append((mesh.collective_s - s0) * 1e3)
    res["decode_ms"], res["decode_collectives"] = walls, colls
    res["decode_collective_ms"] = coll_ms
    teacher = prompts[run.prompts.index(SHARDED_TEACHER)]
    for _ in range(SHARDED_SLOTS):
        engine.submit(Request(prompt=teacher, max_new=SHARDED_STEPS + 3))
    engine.step()                     # admits (prefills) every slot
    steps, colls, coll_ms = [], [], []
    for _ in range(SHARDED_STEPS):
        c0, s0 = mesh.collectives, mesh.collective_s
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        engine.step()
        torch.cuda.synchronize()
        steps.append((time.perf_counter() - t0) * 1e3)
        colls.append(mesh.collectives - c0)
        coll_ms.append((mesh.collective_s - s0) * 1e3)
    wall_ms, busy_ms = profile_run(
        f"[lm-sharded] rank {mesh.rank}: Engine.step(), "
        f"{SHARDED_SLOTS} slots decoding ({engine.n_local} on this rank)",
        engine.step)
    engine.run_until_done()
    res["step_ms"], res["step_collectives"] = steps, colls
    res["step_collective_ms"] = coll_ms
    res["host_share"] = 1 - busy_ms / wall_ms
    res["profiled_step"] = {"wall_ms": wall_ms, "busy_ms": busy_ms}
    res["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    return res


def sharded_rank_run(run: ShardedRun, mesh, outdir: Path) -> dict:
    """One model on one rank: ``Engine(mesh=..., layout="fixed")``, or
    for an "fsdp" run ``layout="auto"`` with the planner's
    ``serve_params`` forced off; the model built on the meta device and
    each block drawn on demand; returns the rank's readings (a fixed
    run's with the planner's own layout for this decode cell)."""
    import torch
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.dist import planner, sharding as sh
    from repro_torch.models import LM
    from repro_torch.serve import Engine
    cfg = sharded_config(run)
    prompts = sharded_prompts(cfg, run.prompts)
    ref = torch.load(outdir / f"{run.tag}.pt")
    shapes = {k: tuple(v.shape) for k, v in
              planner._abstract_state(cfg)[0].items()}

    def weights(key, index):
        return sharded_block(cfg, key, shapes[key], index)
    fixed = run.layout == "fixed"
    model = LM(cfg, device="meta")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with contextlib.nullcontext() if fixed else planner_serve_params_off():
        eng = Engine(model, batch_slots=SHARDED_SLOTS,
                     max_len=SHARDED_MAX_LEN, mesh=mesh,
                     layout="fixed" if fixed else "auto", weights=weights,
                     seed=SHARDED_SEED)
    torch.cuda.synchronize()
    res = {"place_s": time.perf_counter() - t0}
    res["readings"] = sharded_readings(eng, mesh, cfg, run, prompts, ref,
                                       timed=fixed)
    if fixed:
        # the planner's own choice for this cell, and whether it would
        # serve the fixed layout's blocks
        shape = ShapeConfig("engine_decode", SHARDED_MAX_LEN, SHARDED_SLOTS,
                            "decode")
        lay = planner.plan_layout(mesh, cfg, shape)
        res["planner_layout"] = lay.to_dict()
        res["planner_same_blocks"] = sh.param_specs(
            mesh, cfg, planner._abstract_state(cfg)[0],
            serve=lay.serve_params) == eng.param_specs
    del eng, model
    torch.cuda.empty_cache()
    res["wall_s"] = time.perf_counter() - t0
    return res


def sharded_rank(rank: int, world: int, init: str, outdir: str) -> None:
    """One rank of [lm-sharded] (``--lm-sharded-rank``): joins the gloo
    process group, builds ``Mesh(SHARDED_MESH)`` on the card and runs
    every model of SHARDED_RUNS in turn (:func:`sharded_rank_run`);
    writes ``outdir/rank<rank>.json``."""
    import datetime
    import torch
    import torch.distributed as dist
    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is False")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.set_device(0)
    dist.init_process_group(
        "gloo", init_method=init, world_size=world, rank=rank,
        timeout=datetime.timedelta(seconds=SHARDED_PG_TIMEOUT_S))
    try:
        from repro_torch.dist import Mesh
        mesh = Mesh(SHARDED_MESH, device="cuda:0")
        res = {"rank": rank, "coords": mesh.coords}
        for run in SHARDED_RUNS:
            res[run.tag] = sharded_rank_run(run, mesh, Path(outdir))
        (Path(outdir) / f"rank{rank}.json").write_text(json.dumps(res))
    finally:
        dist.destroy_process_group()


def sharded_check(run: ShardedRun, ref: dict, ranks: list) -> dict:
    """The ranks' readings of one model held to the one-rank engine's and
    the planner's (see :func:`sharded_phase`); returns the phase record."""
    card = card_line()
    tol = SHARDED_RTOL
    lay = run.layout
    rs = [r["readings"] for r in ranks]
    for r, rd in enumerate(rs):
        if rd["tokens"] != rs[0]["tokens"]:
            raise AssertionError(f"[lm-sharded] {run.tag} {lay}: rank "
                                 f"{r}'s tokens differ from rank 0's")
        if rd["rel_err"] > tol:
            raise AssertionError(
                f"[lm-sharded] {run.tag} {lay}: rank {r}'s logits "
                f"{rd['rel_err']:.3e} of max |logit| from the one-rank "
                f"engine's, above {tol:g}")
        for k in ("params", "cache"):
            if rd["stored"][k] != rd["planner_stored"][k]:
                raise AssertionError(
                    f"[lm-sharded] {run.tag} {lay}: rank {r} stores "
                    f"{rd['stored'][k]} {k} bytes, the planner "
                    f"{rd['planner_stored'][k]}")
        if rd["fsdp"] is not (lay == "fsdp"):
            raise AssertionError(f"[lm-sharded] {run.tag} {lay}: rank {r} "
                                 f"gathers FSDP leaves: {rd['fsdp']}")
        wide = [m for m in rd["flip_margins"] if not m <= LM_TIE]
        if wide:
            raise AssertionError(
                f"[lm-sharded] {run.tag} {lay}: rank {r}'s MoE routing "
                f"flipped {len(wide)} tokens away from a near-tie (the "
                f"one-rank engine's margins {wide}, limit {LM_TIE:g})")
    flips = []
    for q, (got, want, m) in enumerate(zip(rs[0]["tokens"], ref["tokens"],
                                           ref["margins"])):
        s = next((i for i, (a, b) in enumerate(zip(got, want)) if a != b),
                 None)
        if s is None:
            continue
        if m[s] > 2 * tol:
            raise AssertionError(
                f"[lm-sharded] {run.tag} {lay}: request {q}'s tokens {got} "
                f"!= the one-rank engine's {want} from step {s}, where its "
                f"top-2 margin {m[s]:.3e} of max |logit| is above "
                f"{2 * tol:g}")
        flips.append((q, s, m[s]))
    errs = [rd["rel_err"] for rd in rs]
    cfg = sharded_config(run)
    held = [len(p) for p in
            sharded_teachers(cfg, run, sharded_prompts(cfg, run.prompts))]
    margins = sorted({m for rd in rs for m in rd["flip_margins"]})
    unpinned = [max(e) for e in zip(*(rd["unpinned_rel_errs"] for rd in rs))]
    out = {"layout": lay, "rel_err": max(errs), "flips": flips,
           "rel_errs": [max(e) for e in zip(*(rd["rel_errs"] for rd in rs))],
           "flip_margins": margins, "unpinned_rel_errs": unpinned,
           "rank_wall_s": max(r["wall_s"] for r in ranks),
           "engine_layout": rs[0]["layout"],
           "serve_s": max(rd["serve_s"] for rd in rs),
           "serve_collectives": rs[0]["serve_collectives"],
           "serve_collective_s": max(rd["serve_collective_s"] for rd in rs)}
    log(f"[lm-sharded] {run.tag} {lay}: tokens of {len(rs)} ranks equal to "
        f"each other and to the one-rank engine's"
        + (f" but at near-ties {flips}" if flips else "")
        + f"; logits {out['rel_errs']} of max |logit| (limit {tol:g}) for "
        f"prompts of {held} tokens"
        + (f" with the MoE layers pinned to the one-rank engine's experts, "
           f"{len(margins)} routing flips at its margins "
           f"{[float(f'{m:.3e}') for m in margins]} (limit {LM_TIE:g}); "
           f"unpinned {unpinned}, recorded" if unpinned else "") + "; "
        f"stored bytes a rank equal to the planner's "
        f"({rs[0]['stored']['params']:,} parameter, "
        f"{rs[0]['stored']['cache']:,} cache); layout {rs[0]['layout']}; "
        f"{len(run.prompts)} requests served in {out['serve_s']:.2f} s "
        f"with {out['serve_collectives']} collectives a rank "
        f"({out['serve_collective_s']:.2f} s of them, {card})")
    out["place_s"] = max(r["place_s"] for r in ranks)
    log(f"[lm-sharded] {run.tag} {lay}: blocks placed in "
        f"{out['place_s']:.1f} s a rank; the run's rank wall "
        f"{out['rank_wall_s']:.1f} s")
    if lay != "fixed":                # sampling, the fault, times: fixed's
        return out
    for r, rd in enumerate(rs):
        if rd["sampled"] != ref["sampled"]:
            raise AssertionError(
                f"[lm-sharded] {run.tag}: rank {r}'s sampled tokens "
                f"{rd['sampled']} != the one-rank engine's {ref['sampled']}")
    log(f"[lm-sharded] {run.tag}: sampled at temperature "
        f"{SHARDED_TEMPERATURE:g} (seed {SHARDED_SEED}), every rank's "
        f"tokens equal the one-rank engine's: {ref['sampled']}")
    worst = max(rd["fault_rel_err"] for rd in rs)
    if not worst > tol:
        raise AssertionError(f"[lm-sharded] {run.tag}: the planted "
                             f"fault passed ({worst:.3e})")
    log(f"[lm-sharded] {run.tag}: planted fault (rank 1 keeps its "
        f"partial sums of layer 0's attention output): logits "
        f"{worst:.3e} of max |logit|, above {tol:g}: rejected")
    med = statistics.median
    rec = {
        "long_prefill_ms": med(rd["long_prefill_ms"] for rd in rs),
        "prefill_ms": med(v for rd in rs for v in rd["prefill_ms"]),
        "decode_ms": med(v for rd in rs for v in rd["decode_ms"]),
        "decode_collectives": med(v for rd in rs
                                  for v in rd["decode_collectives"]),
        "decode_collective_ms": med(v for rd in rs
                                    for v in rd["decode_collective_ms"]),
        "step_ms": med(v for rd in rs for v in rd["step_ms"]),
        "step_collectives": med(v for rd in rs
                                for v in rd["step_collectives"]),
        "step_collective_ms": med(v for rd in rs
                                  for v in rd["step_collective_ms"]),
        "host_share": med(rd["host_share"] for rd in rs),
        "peak_gb": max(rd["peak_gb"] for rd in rs),
        "fault_rel_err": worst}
    pred = sharded_prediction(run)
    if any(v != pred for rd in rs for v in rd["decode_collectives"]):
        raise AssertionError(
            f"[lm-sharded] {run.tag}: decode collectives a token "
            f"{[rd['decode_collectives'] for rd in rs]}, the dry-run's "
            f"{pred}")
    rec["predicted_decode_collectives"] = pred
    log(f"[lm-sharded] {run.tag} {lay}: the dry-run (launch.dryrun_lib on "
        f"meta under RecordingMesh({SHARDED_MESH}), this decode step) "
        f"predicts {pred} collectives a token; every rank measured {pred}")
    log(f"[lm-sharded] {run.tag} {lay} ({card}): prefill of "
        f"{run.prompts[0]} tokens {rec['long_prefill_ms']:.2f} ms (once), "
        f"of {run.prompts[1]} tokens {rec['prefill_ms']:.2f} ms; decode "
        f"{rec['decode_ms']:.2f} ms a token (one slot, host clock, "
        f"median over ranks), {rec['decode_collectives']:g} collectives "
        f"a token, {rec['decode_collective_ms']:.2f} ms of them; "
        f"Engine.step() with {SHARDED_SLOTS} slots decoding "
        f"{rec['step_ms']:.2f} ms, {rec['step_collectives']:g} "
        f"collectives a step, {rec['step_collective_ms']:.2f} ms of "
        f"them; host share of a profiled step {rec['host_share']:.3f}; "
        f"peak {rec['peak_gb']:.2f} GB a rank")
    out.update(rec)
    out["planner_layout"] = ranks[0]["planner_layout"]
    out["planner_same_blocks"] = ranks[0]["planner_same_blocks"]
    log(f"[lm-sharded] {run.tag}: the planner's layout for this decode "
        f"cell {out['planner_layout']} "
        + ("serves the fixed layout's blocks" if out["planner_same_blocks"]
           else "shards otherwise than the fixed layout"))
    return out


def sharded_prediction(run: ShardedRun) -> int:
    """The collectives of one decode token the dry-run records for the
    run's engine: rank 0's decode step of its configuration (the fixed
    layout: ``serve_params``) over SHARDED_SLOTS slots of
    SHARDED_MAX_LEN, on ``meta`` under a RecordingMesh of SHARDED_MESH."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.dist import RecordingMesh
    from repro_torch.launch import dryrun_lib
    rec = dryrun_lib.measure_cell(
        run.arch, "engine_decode", RecordingMesh(SHARDED_MESH),
        cfg=sharded_config(run),
        shape=ShapeConfig("engine_decode", SHARDED_MAX_LEN, SHARDED_SLOTS,
                          "decode"),
        variant={"serve_params": True})
    return sum(rec["collective_bytes_per_device"]["counts"].values())


def sharded_phase() -> dict:
    """[lm-sharded]: each model of SHARDED_RUNS served first by a one-rank
    Engine on the card, then by ``Engine(mesh=Mesh(SHARDED_MESH))`` with
    the run's layout in rank processes on the same card over gloo (one
    spawn for every model); returns each model's record."""
    import tempfile
    import torch
    from repro_torch.dist.launch import rank_env, run_ranks
    t0 = time.perf_counter()
    world = math.prod(SHARDED_MESH.values())
    log(f"[lm-sharded] Engine(mesh=Mesh({SHARDED_MESH})) in {world} rank "
        f"processes on the one card over gloo (NCCL refuses two ranks on one "
        f"device; collectives go through host memory); {card_line()}")
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_sharded_") as tmp:
        refs = {run.tag: sharded_reference(run, Path(tmp))
                for run in SHARDED_RUNS}
        t1 = time.perf_counter()
        init = f"file://{Path(tmp) / 'rendezvous'}"
        outs = run_ranks(
            lambda r: [sys.executable, str(Path(__file__).resolve()),
                       "--lm-sharded-rank", str(r), str(world), init, tmp],
            world, timeout=SHARDED_TIMEOUT_S,
            env=rank_env(threads=max(1, 8 // world)), cwd=str(ROOT))
        ranks = [json.loads((Path(tmp) / f"rank{r}.json").read_text())
                 for r in range(world)]
    for text in outs:
        for line in text.splitlines():
            if line.startswith("[profile]"):
                log(line)
    log(f"[lm-sharded] references' wall {t1 - t0:.1f} s, ranks' wall "
        f"{time.perf_counter() - t1:.1f} s")
    recs = {}
    for run in SHARDED_RUNS:
        recs[run.tag] = sharded_check(run, refs[run.tag],
                                      [r[run.tag] for r in ranks])
    log(f"[lm-sharded] phase wall {time.perf_counter() - t0:.1f} s")
    return recs


# --------------------------------------------------------------------------
# [lm-train-sharded]: the sharded train step over gloo ranks on the one card
# --------------------------------------------------------------------------

#: the mesh of the [lm-train-sharded] ranks (all on the one card, over gloo)
TS_MESH = {"data": 2, "model": 2}
#: global batch of every run (each data block's rank takes 2 x 128 tokens:
#: the fused loss's rows on a rank are LOSS_MAIN_SHAPES' first shape)
TS_BATCH, TS_SEQ = 4, 128
#: (a) parity: minitron-4b at full width, TS_LAYERS layers, fp32, fusion
#: "gen", TS_STEPS steps against the one-rank step on the card
TS_LAYERS, TS_STEPS = 2, 3
#: (b) expert parallelism: olmoe-1b-7b at full width, TS_LAYERS layers,
#: moe_impl "a2a" (32 experts a rank), fp32, TS_MOE_STEPS steps against a
#: one-rank run that dispatches each data block with its own capacity
TS_MOE_STEPS = 2
#: (c) full depth: minitron-4b, bf16 weights, fp32 AdamW moments, fusion
#: "gen", TS_FULL_STEPS steps (the last profiled)
TS_FULL_STEPS = 2
TS_RTOL = 1e-5
#: the blocks after (a)'s steps are held to the one-rank run's within
#: TS_RTOL of max |p| where the rank's first moment is at least this share
#: of its leaf's largest (the one-rank run's); below it AdamW's step
#: m / (sqrt(v) + eps) is decided by rounding, and those entries are held
#: to the bound such a step allows (:func:`ts_masked_bound`)
TS_MOMENT_FLOOR = 1e-3
TS_TIMEOUT_S = 900
TS_PG_TIMEOUT_S = 300


def ts_batches(cfg, steps: int) -> list:
    """``steps`` global batches of TS_BATCH x TS_SEQ tokens from the port's
    loader (seed 0)."""
    from repro_torch.data import DataConfig, ShardedLoader
    loader = ShardedLoader(DataConfig(seq_len=TS_SEQ, global_batch=TS_BATCH,
                                      vocab=cfg.vocab))
    out = [next(loader) for _ in range(steps)]
    loader.close()
    return [{k: v for k, v in b.items() if k != "step"} for b in out]


def ts_moe_model(moe_impl: str):
    """olmoe-1b-7b at full width, TS_LAYERS layers, fp32, ``moe_impl``,
    drawn on the card from a generator seeded with LM_SEED (the draws do
    not depend on ``moe_impl``)."""
    return lm_arch_model(LM_ARCHS[1]._replace(n_layers=TS_LAYERS),
                         "float32", moe_impl=moe_impl)


def ts_run(step, params, opt, batches) -> tuple[list, list]:
    """The steps' losses and grad norms (fusion under kernels="cuda")."""
    from repro_torch.core import fusion_mode
    losses, norms = [], []
    with fusion_mode(kernels="cuda"):
        for b in batches:
            params, opt, m = step(params, opt, b)
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
    return losses, norms


def ts_reference(tmp: Path) -> dict:
    """The one-rank runs on the card: (a) minitron-4b, TS_LAYERS layers,
    fp32, fusion "gen", TS_STEPS steps (its final parameters saved to
    ``tmp`` for the ranks' blocks to be held to, with each leaf's largest
    first moment); (b) olmoe-1b-7b,
    TS_LAYERS layers, the capacity dispatch over each data block (two
    microbatches, one a data block: the reference's ``shard_map``
    dispatches a block's tokens at a capacity of its own)."""
    import torch
    from repro_torch.kernels import rowwise
    from repro_torch.launch import train
    from repro_torch.optim import adamw
    t0 = time.perf_counter()
    model = train_model(TS_LAYERS, "float32")
    cfg = model.cfg
    params = {k: v.detach().clone() for k, v in model.named_parameters()}
    tc = train.TrainConfig(fusion="gen")
    opt = adamw.init(params, tc.opt)
    torch.cuda.synchronize()
    rowwise.launches = 0
    losses, norms = ts_run(train.make_train_step(model, cfg, tc), params,
                           opt, ts_batches(cfg, TS_STEPS))
    torch.cuda.synchronize()
    launches = rowwise.launches
    top = max(float(v.abs().max()) for v in params.values())
    m_top = {k: float(v.abs().max()) for k, v in opt["m"].items()}
    torch.save({k: v.cpu() for k, v in params.items()}, tmp / "ts_a.pt")
    del model, params, opt
    torch.cuda.empty_cache()
    moe = ts_moe_model("capacity")
    p = {k: v.detach().clone() for k, v in moe.named_parameters()}
    tcm = train.TrainConfig(n_microbatches=TS_MESH["data"])
    moe_losses, moe_norms = ts_run(
        train.make_train_step(moe, moe.cfg, tcm), p, adamw.init(p, tcm.opt),
        ts_batches(moe.cfg, TS_MOE_STEPS))
    del moe, p
    torch.cuda.empty_cache()
    log(f"[lm-train-sharded] one-rank references on the card: minitron-4b "
        f"at full width, {TS_LAYERS} layers, fp32, fusion gen, "
        f"{TS_STEPS} steps of {TS_BATCH} x {TS_SEQ} tokens: losses "
        f"{losses}, grad norms {norms}, Row launches {launches}; "
        f"olmoe-1b-7b, {TS_LAYERS} layers, capacity dispatch a data block: "
        f"losses {moe_losses}; wall {time.perf_counter() - t0:.1f} s")
    if launches != 2 * TS_STEPS:
        raise AssertionError(f"[lm-train-sharded] the one-rank step "
                             f"launched {launches} Row kernels in "
                             f"{TS_STEPS} steps, not 2 a step")
    return {"losses": losses, "norms": norms, "top": top, "m_top": m_top,
            "moe_losses": moe_losses, "moe_norms": moe_norms}


def ts_full_config():
    """(c)'s configuration: minitron-4b at full width and depth, bf16."""
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config(LM_ARCH), dtype="bfloat16")


def ts_prediction() -> dict:
    """The dry-run of (c) on the CPU: rank 0's step of minitron-4b (bf16,
    full depth, batch TS_BATCH x TS_SEQ, one microbatch) on ``meta`` under
    a RecordingMesh of TS_MESH; the fused loss off, which issues no
    collective."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.dist import RecordingMesh
    from repro_torch.launch import dryrun_lib
    t0 = time.perf_counter()
    rec = dryrun_lib.measure_cell(
        LM_ARCH, "lm-train-sharded", RecordingMesh(TS_MESH),
        cfg=ts_full_config(),
        shape=ShapeConfig("lm-train-sharded", TS_SEQ, TS_BATCH, "train"),
        variant={"n_mb": 1})
    rec["wall_s"] = time.perf_counter() - t0
    return rec


def ts_weights(cfg, shapes: dict, mesh):
    """``weights(key, index)`` for (c): each block drawn on the card from
    a generator seeded by its key and its rank's coordinates (N(0, 1)
    times the leaf's scale; rmsnorm scales 0): a rank draws its blocks
    only (no run is held to another's weights)."""
    import zlib
    import torch

    def draw(key, index):
        name = key.rsplit(".", 1)[-1]
        shape = tuple(s.stop - s.start for s in index)
        if name == "scale":
            return torch.zeros(shape, device=mesh.device)
        full = shapes[key]
        scale = (cfg.d_model if name in ("embed", "head")
                 else full[-2]) ** -0.5
        gen = torch.Generator(device=mesh.device).manual_seed(zlib.crc32(
            f"{LM_SEED}/{key}/{[s.start for s in index]}".encode()))
        return torch.randn(shape, generator=gen,
                           device=mesh.device).mul_(scale)
    return draw


def ts_masked_bound(cfg, steps: int) -> float:
    """The most that AdamW can move one entry apart in two runs of
    ``steps`` steps where its gradient is decided by rounding: step t moves
    p by lr_t · m̂ / (sqrt(v̂) + eps), whose size is at most c_t =
    sqrt(sum_s w1_s² / w2_s) over the bias-corrected moments' weights
    (Cauchy-Schwarz; 1 at t = 1), so the two runs' steps differ by at
    most 2 · lr_t · c_t, and weight decay carries the difference so far
    by 1 + lr_t · wd."""
    from repro_torch.optim import adamw
    b1, b2, bound = cfg.b1, cfg.b2, 0.0
    for t in range(1, steps + 1):
        w1 = [(1 - b1) * b1 ** (t - s) / (1 - b1 ** t)
              for s in range(1, t + 1)]
        w2 = [(1 - b2) * b2 ** (t - s) / (1 - b2 ** t)
              for s in range(1, t + 1)]
        c = math.sqrt(sum(a * a / b for a, b in zip(w1, w2)))
        lr = float(adamw.schedule(t, cfg))
        bound = bound * (1 + lr * cfg.weight_decay) + 2 * lr * c
    return bound


def ts_blocks(mesh, specs, params, opt, want, m_top: dict, b2: float,
              steps: int) -> dict:
    """The rank's blocks against ``want`` (the one-rank run's whole
    leaves), leaf by leaf: the largest |difference| where the rank's first
    moment is at least TS_MOMENT_FLOOR of the leaf's largest (``held``)
    and below it (``masked``), the masked share of each leaf, and the
    entries of the largest difference overall and among the held ones,
    with their |m| and sqrt(v̂) (v̂ = v / (1 - b2^steps), the gradient's
    scale; AdamW's eps is 1e-8)."""
    import torch
    from repro_torch.dist import sharding as sh
    held = masked = 0.0
    shares, worst, worst_held = {}, None, None

    def entry(k, d, i, small):
        m = opt["m"][k].reshape(-1)[i]
        v = opt["v"][k].reshape(-1)[i]
        return {"leaf": k, "diff": float(d[i]), "masked": bool(small[i]),
                "m": float(m.abs()),
                "g_scale": float((v / (1 - b2 ** steps)).sqrt())}
    for k, p in params.items():
        w = sh.local_shard(mesh, specs[k], want[k]).to(p.device)
        d = (p - w).abs().reshape(-1)
        small = (opt["m"][k].abs() < TS_MOMENT_FLOOR * m_top[k]).reshape(-1)
        shares[k] = float(small.float().mean())
        dh = torch.where(small, 0.0, d)
        dm = torch.where(small, d, 0.0)
        held, masked = max(held, float(dh.max())), max(masked, float(dm.max()))
        i = int(d.argmax())
        if worst is None or float(d[i]) > worst["diff"]:
            worst = entry(k, d, i, small)
        i = int(dh.argmax())
        if worst_held is None or float(dh[i]) > worst_held["diff"]:
            worst_held = entry(k, d, i, small)
        del w, d, small, dh, dm
    return {"held": held, "masked": masked, "masked_share": shares,
            "worst": worst, "worst_held": worst_held}


def ts_rank_parity(mesh, tmp: Path, top: float, m_top: dict) -> dict:
    """(a) on one rank: the sharded step from the one-rank run's weights;
    its losses, grad norms and Row launches, its blocks after the steps
    against the one-rank run's (:func:`ts_blocks`), and the planted
    fault's first step (rank 1 leaves its part out of the first FSDP
    reduce-scatter)."""
    import torch
    from repro_torch.dist import sharding as sh
    from repro_torch.kernels import rowwise
    from repro_torch.launch import train
    from repro_torch.optim import adamw
    model = train_model(TS_LAYERS, "float32")
    cfg = model.cfg
    specs = sh.param_specs(mesh, cfg, model.state_dict())
    model.shard_(mesh, specs)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    init = {k: v.detach().clone() for k, v in model.named_parameters()}
    tc = train.TrainConfig(fusion="gen")
    step = train.make_train_step(model, cfg, tc, mesh=mesh)
    batches = ts_batches(cfg, TS_STEPS)
    params = {k: v.detach().clone() for k, v in init.items()}
    opt = adamw.init(params, tc.opt)
    torch.cuda.synchronize()
    rowwise.launches = 0
    c0, s0, t0 = mesh.collectives, mesh.collective_s, time.perf_counter()
    losses, norms = ts_run(step, params, opt, batches)
    torch.cuda.synchronize()
    launches, colls = rowwise.launches, mesh.collectives - c0
    walls = {"steps": time.perf_counter() - t0,
             "collectives": mesh.collective_s - s0}
    t0 = time.perf_counter()
    want = torch.load(tmp / "ts_a.pt", mmap=True)
    blocks = ts_blocks(mesh, specs, params, opt, want, m_top, tc.opt.b2,
                       TS_STEPS)
    del want
    walls["compare"] = time.perf_counter() - t0
    # the planted fault: rank 1's part of one reduce-scatter left out
    real = mesh.reduce_scatter
    state = {"left": mesh.rank == 1}

    def reduce_scatter(t, dim=0, over="row"):
        if state["left"]:
            state["left"] = False
            t = torch.zeros_like(t)
        return real(t, dim, over)
    params = {k: v.detach().clone() for k, v in init.items()}
    opt = adamw.init(params, tc.opt)
    mesh.reduce_scatter = reduce_scatter
    try:
        bad_losses, bad_norms = ts_run(step, params, opt, batches[:1])
    finally:
        del mesh.reduce_scatter
    del params, opt, init, model
    torch.cuda.empty_cache()
    return {"losses": losses, "norms": norms, "launches": launches,
            "collectives": colls, "param_err": blocks["held"] / top,
            "masked_err": blocks["masked"], "blocks": blocks,
            "bad_losses": bad_losses, "bad_norms": bad_norms,
            "walls_s": walls}


def ts_rank_moe(mesh) -> dict:
    """(b) on one rank: olmoe-1b-7b with ``moe_impl="a2a"`` inside
    ``activation_rules(mesh, "dp")``: its losses and all-to-alls."""
    import torch
    from repro_torch.dist import sharding as sh
    from repro_torch.launch import train
    from repro_torch.optim import adamw
    model = ts_moe_model("a2a")
    cfg = model.cfg
    model.shard_(mesh, sh.param_specs(mesh, cfg, model.state_dict()))
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    params = dict(model.named_parameters())
    tc = train.TrainConfig()
    opt = adamw.init(params, tc.opt)
    mesh.log.reset()
    with sh.activation_rules(mesh, "dp"):
        losses, norms = ts_run(train.make_train_step(model, cfg, tc,
                                                     mesh=mesh),
                               params, opt, ts_batches(cfg, TS_MOE_STEPS))
    a2a = mesh.log.record()["counts"]["all-to-all"]
    del model, params, opt
    torch.cuda.empty_cache()
    return {"losses": losses, "norms": norms, "all_to_all": a2a}


def ts_rank_full(mesh) -> dict:
    """(c) on one rank: minitron-4b at full width and depth, bf16, fp32
    AdamW moments, fusion "gen": stored bytes, TS_FULL_STEPS steps (walls,
    collectives and their seconds, Row launches; the last step under the
    profiler, for its host share), peak memory."""
    import torch
    from repro_torch.dist import sharding as sh
    from repro_torch.kernels import rowwise
    from repro_torch.launch import train
    from repro_torch.models import LM
    from repro_torch.optim import adamw
    cfg = ts_full_config()
    model = LM(cfg, device="meta").requires_grad_(False)
    shapes = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    specs = sh.param_specs(mesh, cfg, model.state_dict())
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model.shard_(mesh, specs, weights=ts_weights(cfg, shapes, mesh))
    params = dict(model.named_parameters())
    tc = train.TrainConfig(fusion="gen")
    opt = adamw.init(params, tc.opt)
    torch.cuda.synchronize()
    place_s = time.perf_counter() - t0
    batches = ts_batches(cfg, TS_FULL_STEPS)
    local = train.batch_block(mesh, cfg, batches[0], model)

    def nbytes(ts):
        return sum(t.numel() * t.element_size() for t in ts)
    stored = (nbytes(params.values()) + nbytes(opt["m"].values())
              + nbytes(opt["v"].values()) + nbytes([opt["count"]])
              + nbytes(local.values()))
    step = train.make_train_step(model, cfg, tc, mesh=mesh)
    from repro_torch.core import fusion_mode
    rowwise.launches = 0
    walls, colls, coll_s, losses = [], [], [], []
    with fusion_mode(kernels="cuda"):
        for i, b in enumerate(batches):
            c0, s0 = mesh.collectives, mesh.collective_s
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            if i < len(batches) - 1:
                m = step(params, opt, b)[2]
            else:                     # the last step under the profiler
                got = []
                wall_ms, busy_ms = profile_run(
                    f"[lm-train-sharded] rank {mesh.rank}: step {i + 1} of "
                    f"{cfg.name} at full size",
                    lambda: got.append(step(params, opt, b)[2]))
                m = got[0]
            losses.append(float(m["loss"]))
            walls.append((time.perf_counter() - t1) * 1e3)
            colls.append(mesh.collectives - c0)
            coll_s.append(mesh.collective_s - s0)
        torch.cuda.synchronize()
        launches = rowwise.launches
        peak = torch.cuda.max_memory_allocated()
    del model, params, opt
    torch.cuda.empty_cache()
    return {"losses": losses, "step_ms": walls, "collectives": colls,
            "collective_ms": [v * 1e3 for v in coll_s],
            "launches": launches, "stored": stored, "peak": peak,
            "place_s": place_s, "host_share": 1 - busy_ms / wall_ms,
            "profiled": {"wall_ms": wall_ms, "busy_ms": busy_ms}}


def ts_rank(rank: int, world: int, init: str, outdir: str) -> None:
    """One rank of [lm-train-sharded] (``--lm-train-sharded-rank``): joins
    the gloo group, builds ``Mesh(TS_MESH)`` on the card and runs (a),
    (b) and (c); writes ``outdir/ts<rank>.json``."""
    import datetime
    import torch
    import torch.distributed as dist
    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is False")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.set_device(0)
    dist.init_process_group(
        "gloo", init_method=init, world_size=world, rank=rank,
        timeout=datetime.timedelta(seconds=TS_PG_TIMEOUT_S))
    try:
        from repro_torch.dist import Mesh
        mesh = Mesh(TS_MESH, device="cuda:0")
        tmp = Path(outdir)
        tops = json.loads((tmp / "ts_top.json").read_text())
        res = {"rank": rank, "coords": mesh.coords}
        t0 = time.perf_counter()
        res["parity"] = ts_rank_parity(mesh, tmp, tops["top"],
                                       tops["m_top"])
        t1 = time.perf_counter()
        res["moe"] = ts_rank_moe(mesh)
        t2 = time.perf_counter()
        res["full"] = ts_rank_full(mesh)
        t3 = time.perf_counter()
        res["walls_s"] = {"parity": t1 - t0, "moe": t2 - t1,
                          "full": t3 - t2}
        res["wall_s"] = t3 - t0
        (tmp / f"ts{rank}.json").write_text(json.dumps(res))
    finally:
        dist.destroy_process_group()


def ts_check(ref: dict, pred: dict, ranks: list) -> dict:
    """The ranks' readings held to the one-rank runs and the dry-run."""
    from repro_torch.launch import train
    card = card_line()
    tol = TS_RTOL
    bound = ts_masked_bound(train.TrainConfig().opt, TS_STEPS)
    for r, rd in enumerate(ranks):
        blk = rd["parity"]["blocks"]
        shares = blk["masked_share"]
        log(f"[lm-train-sharded] (a) rank {r}'s blocks: held entries "
            f"{rd['parity']['param_err']:.3e} of max |p| (limit {tol:g}), "
            f"masked entries {blk['masked']:.3e} (limit {bound:.3e}, "
            f"{bound / ref['top']:.3e} of max |p|); largest difference "
            f"{json.dumps(blk['worst'])}; largest held "
            f"{json.dumps(blk['worst_held'])}; masked share by leaf: "
            + ", ".join(f"{k} {v:.2e}" for k, v in shares.items() if v))
    for r, rd in enumerate(ranks):
        a = rd["parity"]
        rel = trace_rel(a["losses"] + a["norms"], ref["losses"]
                        + ref["norms"])
        if not rel <= tol:
            raise AssertionError(f"[lm-train-sharded] (a) rank {r}: traces "
                                 f"{a['losses']} / {a['norms']} against the "
                                 f"one-rank {ref['losses']} / "
                                 f"{ref['norms']}: {rel:.3e} > {tol:g}")
        if not a["param_err"] <= tol:
            raise AssertionError(f"[lm-train-sharded] (a) rank {r}: blocks "
                                 f"{a['param_err']:.3e} of max |p| from "
                                 f"the one-rank run's")
        if not a["masked_err"] <= bound:
            raise AssertionError(f"[lm-train-sharded] (a) rank {r}: masked "
                                 f"entries {a['masked_err']:.3e} apart, "
                                 f"more than AdamW's rounding allows "
                                 f"({bound:.3e})")
        if a["launches"] != 2 * TS_STEPS:
            raise AssertionError(f"[lm-train-sharded] (a) rank {r}: "
                                 f"{a['launches']} Row launches in "
                                 f"{TS_STEPS} steps, not 2 a step")
        a["rel"] = rel
        a["bad_rel"] = trace_rel(a["bad_losses"] + a["bad_norms"],
                                 ref["losses"][:1] + ref["norms"][:1])
    bad = max(rd["parity"]["bad_rel"] for rd in ranks)
    if not bad > tol:
        raise AssertionError(f"[lm-train-sharded] (a): the planted fault "
                             f"passed ({bad:.3e})")
    rel = max(rd["parity"]["rel"] for rd in ranks)
    err = max(rd["parity"]["param_err"] for rd in ranks)
    masked = max(rd["parity"]["masked_err"] for rd in ranks)
    log(f"[lm-train-sharded] (a) minitron-4b, full width, {TS_LAYERS} "
        f"layers, fp32, fusion gen, {TS_STEPS} steps on {len(ranks)} ranks "
        f"of {TS_MESH}: losses {ranks[0]['parity']['losses']} and grad "
        f"norms {ranks[0]['parity']['norms']}, {rel:.3e} relative from the "
        f"one-rank step's (limit {tol:g}); every rank's updated blocks "
        f"{err:.3e} of max |p| from the one-rank run's where the first "
        f"moment is at least {TS_MOMENT_FLOOR:g} of its leaf's largest "
        f"(limit {tol:g}), {masked:.3e} apart below it (limit "
        f"{bound:.3e}, AdamW's rounding-decided steps); 2 Row launches a "
        f"step on each rank; {ranks[0]['parity']['collectives']} "
        f"collectives a rank in {TS_STEPS} steps; planted fault (rank 1 "
        f"leaves its part out of one FSDP reduce-scatter): the first "
        f"step's loss and grad norm {bad:.3e} relative: rejected; rank 0's "
        f"{TS_STEPS} steps {ranks[0]['parity']['walls_s']['steps']:.1f} s "
        f"(collectives "
        f"{ranks[0]['parity']['walls_s']['collectives']:.1f} s), the blocks' "
        f"comparison {ranks[0]['parity']['walls_s']['compare']:.1f} s")
    for r, rd in enumerate(ranks):
        b = rd["moe"]
        rel_b = trace_rel(b["losses"], ref["moe_losses"])
        if not rel_b <= tol:
            raise AssertionError(f"[lm-train-sharded] (b) rank {r}: losses "
                                 f"{b['losses']} against the one-rank "
                                 f"{ref['moe_losses']}: {rel_b:.3e}")
        b["rel"] = rel_b
    moe_rel = max(rd["moe"]["rel"] for rd in ranks)
    log(f"[lm-train-sharded] (b) olmoe-1b-7b, full width, {TS_LAYERS} "
        f"layers, moe_impl a2a (32 experts a rank), fp32, {TS_MOE_STEPS} "
        f"steps: losses {ranks[0]['moe']['losses']}, {moe_rel:.3e} "
        f"relative from the one-rank capacity dispatch a data block "
        f"({ref['moe_losses']}); {ranks[0]['moe']['all_to_all']} "
        f"all-to-alls a rank")
    counts = sum(pred["collective_bytes_per_device"]["counts"].values())
    args = pred["memory"]["argument_bytes"]
    temp = pred["memory"]["temp_bytes"]
    for r, rd in enumerate(ranks):
        c = rd["full"]
        if not all(math.isfinite(v) for v in c["losses"]):
            raise AssertionError(f"[lm-train-sharded] (c) rank {r}: losses "
                                 f"{c['losses']}")
        if c["stored"] != args:
            raise AssertionError(f"[lm-train-sharded] (c) rank {r} stores "
                                 f"{c['stored']:,} bytes, the dry-run's "
                                 f"arguments {args:,}")
        if any(n != counts for n in c["collectives"]):
            raise AssertionError(f"[lm-train-sharded] (c) rank {r}: "
                                 f"{c['collectives']} collectives a step, "
                                 f"the dry-run {counts}")
        if c["launches"] != 2 * TS_FULL_STEPS:
            raise AssertionError(f"[lm-train-sharded] (c) rank {r}: "
                                 f"{c['launches']} Row launches")
    med = statistics.median
    full = {"losses": ranks[0]["full"]["losses"],
            # step 1 (the last step ran under the profiler)
            "step_ms": med(rd["full"]["step_ms"][0] for rd in ranks),
            "collective_ms": med(rd["full"]["collective_ms"][0]
                                 for rd in ranks),
            "profiled_step_ms": med(rd["full"]["step_ms"][-1]
                                    for rd in ranks),
            "collectives": counts,
            "host_share": med(rd["full"]["host_share"] for rd in ranks),
            "peak_gb": [rd["full"]["peak"] / 1e9 for rd in ranks],
            "stored_gb": ranks[0]["full"]["stored"] / 1e9,
            "predicted_args_gb": args / 1e9,
            "predicted_temp_gb": temp / 1e9,
            "place_s": max(rd["full"]["place_s"] for rd in ranks),
            "launches": sum(rd["full"]["launches"] for rd in ranks)}
    log(f"[lm-train-sharded] (c) minitron-4b, full width and depth, bf16 "
        f"weights, fp32 AdamW moments, fusion gen, {TS_FULL_STEPS} steps "
        f"({card}): losses {full['losses']} (finite); stored "
        f"{full['stored_gb']:.3f} GB a rank = the dry-run's arguments "
        f"({args:,} bytes); {counts} collectives a step = the dry-run's "
        f"({json.dumps(pred['collective_bytes_per_device']['counts'])}); "
        f"step 1 {full['step_ms']:.1f} ms (host clock, median over "
        f"ranks), collectives {full['collective_ms']:.1f} ms of it; step "
        f"{TS_FULL_STEPS} under the profiler {full['profiled_step_ms']:.1f} "
        f"ms, host share {full['host_share']:.3f}; peak "
        f"{[round(v, 2) for v in full['peak_gb']]} GB a rank against the "
        f"dry-run's arguments + temporaries "
        f"{full['predicted_args_gb'] + full['predicted_temp_gb']:.2f} GB "
        f"({full['predicted_temp_gb']:.2f} GB temporaries, dry-run "
        f"{pred['wall_s']:.1f} s on the CPU); blocks drawn in "
        f"{full['place_s']:.1f} s")
    return {"parity": {"rel": rel, "param_err": err, "masked_err": masked,
                       "masked_bound": bound, "planted_rel": bad,
                       "ranks": [rd["parity"] for rd in ranks]},
            "moe": {"rel": moe_rel, "losses": ranks[0]["moe"]["losses"],
                    "reference": ref["moe_losses"]},
            "full": full, "prediction": {
                "counts": pred["collective_bytes_per_device"]["counts"],
                "argument_bytes": args, "temp_bytes": temp}}


def train_sharded_phase() -> dict:
    """[lm-train-sharded]: the one-rank references on the card, the
    fused loss's Row kernel held to its plain version at a rank's shape,
    then (a), (b), (c) in TS_MESH's rank processes on the card over gloo
    (one spawn), the dry-run of (c) on the CPU meanwhile; returns the
    phase's record, with the loss kernels' parts at a rank's shape."""
    import concurrent.futures
    import tempfile
    import torch
    from repro_torch.dist.launch import rank_env, run_ranks
    t0 = time.perf_counter()
    world = math.prod(TS_MESH.values())
    log(f"[lm-train-sharded] make_train_step(mesh=Mesh({TS_MESH})) in "
        f"{world} rank processes on the one card over gloo; "
        f"{card_line()}")
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    gen = torch.Generator(device="cuda").manual_seed(LM_SEED + 3)
    rows = TS_BATCH // TS_MESH["data"] * TS_SEQ
    parts = loss_shape_checks(gen, rows, 256000)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ts_") as tmp, \
            concurrent.futures.ThreadPoolExecutor(1) as ex:
        tmp = Path(tmp)
        ref = ts_reference(tmp)
        (tmp / "ts_top.json").write_text(json.dumps(
            {"top": ref["top"], "m_top": ref["m_top"]}))
        pred = ex.submit(ts_prediction)
        t1 = time.perf_counter()
        init = f"file://{tmp / 'rendezvous'}"
        outs = run_ranks(
            lambda r: [sys.executable, str(Path(__file__).resolve()),
                       "--lm-train-sharded-rank", str(r), str(world), init,
                       str(tmp)],
            world, timeout=TS_TIMEOUT_S,
            env=rank_env(threads=max(1, 8 // world)), cwd=str(ROOT))
        ranks = [json.loads((tmp / f"ts{r}.json").read_text())
                 for r in range(world)]
        pred = pred.result()
    for text in outs:
        for line in text.splitlines():
            if line.startswith("[profile]"):
                log(line)
    log(f"[lm-train-sharded] ranks' wall {time.perf_counter() - t1:.1f} s "
        f"(each {max(r['wall_s'] for r in ranks):.1f} s: "
        + ", ".join(f"{k} {max(r['walls_s'][k] for r in ranks):.1f} s"
                    for k in ranks[0]["walls_s"]) + ")")
    log(json.dumps({"lm_train_sharded_ranks": [
        {k: v for k, v in r.items()} for r in ranks]}, default=str))
    rec = ts_check(ref, pred, ranks)
    rec["parts"] = parts
    rec["wall_s"] = time.perf_counter() - t0
    log(f"[lm-train-sharded] phase wall {rec['wall_s']:.1f} s")
    return rec


# --------------------------------------------------------------------------
# [examples]: the port's examples on the card
# --------------------------------------------------------------------------

#: the examples [examples] runs at their default sizes (train_lm_torch's
#: configuration is [lm-train]'s CLI run)
EXAMPLES = ("quickstart_torch.py", "als_recommender_torch.py",
            "serve_lm_torch.py")
EXAMPLE_TIMEOUT_S = 300


def example_sources() -> list:
    """The kernels the [examples] processes launch, built with the rest
    (the libraries are cached on disk by their text): quickstart's ALS
    update over its BCSR, its squared loss and that loss's planned
    backward, planned on its own operands; als_recommender's ALS CPlans
    at its shape."""
    import torch
    from repro_torch.core import FusionContext, fused
    from repro_torch.configs.als_paper import CONFIG as ALS_PAPER
    from repro_torch.core.codegen import compile_plan
    from repro_torch.core.templates import TType
    from repro_torch.kernels import cuda_src
    from repro_torch.kernels.blocksparse import BCSR
    sys.path.insert(0, str(ROOT / "examples"))
    try:
        import quickstart_torch as qs
    finally:
        sys.path.pop(0)
    data = qs.operands()
    binds = {k: torch.from_numpy(v) for k, v in data.items() if k != "X"}
    binds["X"] = BCSR.from_dense(data["X"], bs=128)
    with FusionContext(mode="gen", device="cpu"):
        update = fused(qs.als_expr, sparsity={"X": 0.1}).trace(
            **binds).plan(mode="gen")
        loss = fused(qs.sq_loss_expr).trace(binds["U"], binds["V"]).plan()
        cps = [cp for p in (update, loss, loss.backward())
               for cp in compile_plan(p.eplan).cplans()]
    out = [cuda_src.source_for(cp, 128 if cp.ttype == TType.OUTER else None)
           for cp in cps]
    shape = (2048, 1536)
    out += [cuda_src.source_for(cp, ALS_BS) for _l, cp in als_cplans(
        meta_bcsr(shape), meta_bcsr(shape[::-1]), rank=ALS_PAPER.rank)]
    return out


def examples_phase() -> None:
    """[examples]: each of EXAMPLES in a process of its own on the card,
    all started together (each builds its kernels with nvcc at first use;
    none is timed), each ending in its own asserts; a non-zero exit fails
    the phase, and every process still running is then killed."""
    import os
    import tempfile
    t0 = time.perf_counter()
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    with tempfile.TemporaryDirectory(prefix="chip_smoke_examples_") as tmp:
        procs = {}
        try:
            for name in EXAMPLES:
                log_f = open(Path(tmp) / f"{name}.log", "w+")
                procs[name] = (subprocess.Popen(
                    [sys.executable, str(ROOT / "examples" / name)],
                    cwd=str(ROOT), env=env, stdout=log_f,
                    stderr=subprocess.STDOUT), log_f, time.perf_counter())
            for name, (p, log_f, t1) in procs.items():
                code = p.wait(timeout=max(
                    1.0, EXAMPLE_TIMEOUT_S - (time.perf_counter() - t0)))
                wall = time.perf_counter() - t1
                log_f.seek(0)
                text = log_f.read()
                if code != 0:
                    raise AssertionError(f"[examples] {name} exited {code}:"
                                         f"\n{text[-3000:]}")
                tail = text.strip().splitlines()[-3:]
                log(f"[examples] {name}: exit 0, done {wall:.1f} s into "
                    f"the phase ({card_line()}); " + " | ".join(tail))
        finally:
            for p, log_f, _t in procs.values():
                if p.poll() is None:
                    p.kill()
                p.wait()
                log_f.close()
    log(f"[examples] phase wall {time.perf_counter() - t0:.1f} s")


def sharded_only() -> None:
    """``--lm-sharded``: [lm-sharded] and [examples] alone (no result
    line)."""
    import torch
    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is False")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"[env] {ROOT} torch {torch.__version__}; nvidia-smi: "
        f"{card_line()}")
    recs = sharded_phase()
    examples_phase()
    log(json.dumps({"lm_sharded": recs}, default=str))


def train_sharded_only() -> None:
    """``--lm-train-sharded``: [lm-train-sharded] alone (the loss kernels
    built first; no result line)."""
    import torch
    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is False")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.kernels import build
    log(f"[env] {ROOT} torch {torch.__version__}; nvidia-smi: "
        f"{card_line()}")
    t0 = time.perf_counter()
    build.build_all({s.key: s for s in loss_sources()}.values())
    log(f"[build] loss kernels {time.perf_counter() - t0:.1f} s")
    rec = train_sharded_phase()
    rec.pop("parts")
    log(json.dumps({"lm_train_sharded": rec}, default=str))


def lm_times_only() -> None:
    """``--lm-times``: [lm]'s times alone (minitron-4b in bf16, no
    checks, no result line): prefill and decode ms and the host share of
    one profiled ``Engine.step()``, then one JSON line of them.  Copied
    into an older checkout of the port, it reads that checkout's package:
    to compare two trees on one card, run it in each in turn within one
    call."""
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is False")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    run = LM_ARCHS[0]
    log(f"[env] {ROOT} torch {torch.__version__}; nvidia-smi: "
        f"{card_line()}")
    m16 = lm_arch_model(run, "bfloat16")
    gen = torch.Generator(device="cuda").manual_seed(LM_SEED + 1)
    prompt = lm_tokens(gen, run.prompts[3], m16.cfg.vocab)
    out = lm_times(run.tag, run, m16, gen,
                   prompt.cpu().numpy().astype(np.int32))
    log(json.dumps({"lm_times": out, "root": str(ROOT)}))


# --------------------------------------------------------------------------
# phases
# --------------------------------------------------------------------------

def run() -> None:
    import torch
    m_main = M_MAIN

    # 1. environment ---------------------------------------------------------
    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is False: this smoke "
                           "run needs the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import repro_torch
    from repro_torch.algos import l2svm
    from repro_torch.kernels import (build, cellwise, cuda_src, multiagg,
                                     ops, outerprod, rowwise, sweep)
    from repro_torch.kernels.blocksparse import BCSR
    counters = {"cell": cellwise, "magg": multiagg, "row": rowwise,
                "outer": outerprod}
    card = card_line()
    log(f"[env] python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda} repro_torch {repro_torch.__version__}")
    log(f"[env] device {torch.cuda.get_device_name(0)} x "
        f"{torch.cuda.device_count()}; nvidia-smi: {card}")
    log(f"[env] allow_tf32 matmul={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn={torch.backends.cudnn.allow_tf32}")

    # 2. build ---------------------------------------------------------------
    t0 = time.perf_counter()
    sweep_runs = []        # (case, m, n)
    for c in sweep.cases():
        for (m, n) in ((33, 7), (33, 1), (M_SWEEP, N_MAIN)):
            if n >= c.min_n:
                sweep_runs.append((c, m, n))
    planned = [(c, m, n, *sweep.fused_cplan(c, m, n))
               for c, m, n in sweep_runs]
    # the Cell kernel over (m,1) domains (and (m,4) ones for the (1,n)
    # side cases) at the row counts that reach every part of its walk:
    # CPlans of (33, n) resized, so their sources are those of (33, n)
    tails = []
    for c in sweep.cases():
        if c.template != "cell" or c.min_n > 1:
            continue
        for n in (1, 4) if c.name in PLANTED_GROUP else (1,):
            cp33, names = sweep.fused_cplan(c, 33, n)
            tails += [(c, m, n, sweep.with_rows(cp33, m), names)
                      for m in TAIL_ROWS]
    main_cps = main_path_cplans(m_main, N_MAIN)
    fuse_cps = fuse_exprs_cplans(m_main, N_MAIN)
    # the request-axis checks: the sweep at BATCH_SHAPES (the sources of
    # the plain sweep: m is a run-time argument), the batch regions at the
    # main path's width and at the serving harness's
    planned_batch = [(c, m, n, sweep.fused_cplan(c, m, n)[0])
                     for c in sweep.cases() if c.template in BATCHED.values()
                     for m, n in BATCH_SHAPES if n >= c.min_n]
    wide_cps = batch_region_cplans(N_MAIN, m=WIDE_ROWS)
    serve_cps = batch_region_cplans(SERVE_FEATURES, SERVE_CLASSES)
    paths = algo_paths(m_main)
    path_cps = {path.name: path_cplans(path) for path in paths}
    dense_cps = [cp for _r, cp in main_cps + fuse_cps] + [
        cp for cps in path_cps.values() for _r, cp in cps]
    sources = {}
    for cp in [p[3] for p in planned + tails + planned_batch] + dense_cps \
            + [cp for _r, cp in wide_cps + serve_cps]:
        src = cuda_src.source_for(cp)
        sources[src.key] = src
    # the planted-fault builds: the planted sweep cases and the main paths
    for cp in [p[3] for p in planned if p[0].name in PLANTED
               and p[1] == M_SWEEP] + dense_cps:
        src = planted(cuda_src.source_for(cp))
        sources[src.key] = src
    for cp in [p[3] for p in planned if p[0].name in PLANTED_GROUP
               and p[1] == M_SWEEP] + [cp for _r, cp in path_cps["glm"]]:
        src = planted(cuda_src.source_for(cp), group=True)
        sources[src.key] = src
    # the Outer kernel: its sweep, the ALS CPlans at the main path's shape
    # and at the hand baseline's, each sound and planted
    outer_planned = []
    for i, c in enumerate(sweep.outer_cases()):
        vals = sweep.outer_values(c, seed=100 + i)
        sp = BCSR.from_dense(vals["X"], c.bs).block_sparsity
        outer_planned.append((c, vals, *sweep.fused_cplan(
            c, *c.shape, sparsity={"X": sp})))
    outer_srcs = [(c.name, cp, c.bs) for c, _v, cp, _n in outer_planned]
    for shape in (padded(ALS_SHAPE), padded(ALS_HAND_SHAPE)):
        Xm = meta_bcsr(shape)
        outer_srcs += [(label, cp, ALS_BS)
                       for label, cp in als_cplans(Xm, meta_bcsr(shape[::-1]))]
    for name, cp, bs in outer_srcs:
        src = cuda_src.source_for(cp, bs)
        sources[src.key] = src
        if name in PLANTED or not name.startswith("outer/"):
            sources[planted(src).key] = planted(src)
        if name in PLANTED_FOLD or name == "_wsq_mm V-update":
            sources[planted(src, True).key] = planted(src, True)
    # [dist]: the ranks launch these, built here before they start
    for src in dist_sources():
        sources[src.key] = src
    # [lm], [lm-moe], [lm-hybrid], [lm-xlstm]: the fused rmsnorm at each
    # model's width, sound and planted
    for d in lm_norm_widths():
        for _r, cp in lm_norm_cplans(d):
            src = cuda_src.source_for(cp)
            sources[src.key] = src
            sources[planted(src).key] = planted(src)
    # [lm-train]: the fused loss at every vocabulary width, forward and
    # backward, and its planted builds; the warp layout's ptxas readings;
    # [examples]: what the examples' processes launch
    for src in loss_sources() + warp_probe_sources() + example_sources():
        sources[src.key] = src
    t_plan = time.perf_counter() - t0
    build.build_all(sources.values())
    t_build = time.perf_counter() - t0 - t_plan
    log(f"[build] {len(sources)} kernel sources (planning {t_plan:.1f} s), "
        f"nvcc {t_build:.1f} s in parallel, set-up "
        f"{time.perf_counter() - t0:.1f} s")

    # 3. kernels vs plain: the sweep ---------------------------------------
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(1234)
    worst = {k: 0.0 for k in KERNELS}
    for c, m, n, cp, _names in planned:
        kname = kernel_name(cp)
        if kname != c.template:
            raise AssertionError(f"{c.name}: routed to {kname}")
        err, share = compare(cp, random_env(cp, gen), f"{c.name} at {m}x{n}")
        worst[kname] = max(worst[kname], share)
        log(f"[check] {c.name:30s} {m:>9d}x{n:<3d} {cp.ttype.name:4s} "
            f"{layout_name(cp):4s} {cp.variant:9s} max|kernel-plain| "
            f"{err:.3e} = {share:.3g} x limit")
    for c, m, n, cp, _names in tails:
        err, share = compare(cp, random_env(cp, gen), f"{c.name} at {m}x{n}")
        worst["cell"] = max(worst["cell"], share)
        log(f"[check] {c.name:30s} {m:>9d}x{n:<3d} CELL {layout_name(cp):4s} "
            f"{cp.variant:9s} max|kernel-plain| {err:.3e} = {share:.3g} x "
            f"limit")
    log(f"[check] sweep passed: {len(planned) + len(tails)} CPlans, limit "
        f"{KERNEL_ULPS} x eps32 x error scale; largest share of the limit "
        f"per kernel " + json.dumps(worst))
    for c, m, n, cp, _names in planned:
        faults = [f for f, names in (("partial", PLANTED),
                                     ("group", PLANTED_GROUP))
                  if c.name in names and m == M_SWEEP]
        for fault in faults:
            env = random_env(cp, gen)
            with planted_fault(group=fault == "group"):
                got = ops.execute(cp, env, kernels="cuda")
            err, share = measure(cp, env, got, f"planted {c.name}")
            log(f"[check] planted fault ({layout_name(cp)}, {fault}) "
                f"{c.name} at {m}x{n}: max|kernel-plain| {err:.3e} = "
                f"{share:.3g} x limit")
            if not share > 1.0:
                raise AssertionError(f"planted {fault} fault in {c.name} "
                                     f"passed the kernel check")
    cell_sweep_card_checks(planned, gen)

    for c, vals, cp, names in outer_planned:
        env = outer_case_env(c, vals, names)
        err, share = compare(cp, env, c.name)
        worst["outer"] = max(worst["outer"], share)
        log(f"[check] {c.name:30s} {c.shape[0]:>5d}x{c.shape[1]:<5d} "
            f"bs {c.bs:<3d} r {c.r:<2d} {env[cp.main.nid].nblocks:>3d} "
            f"blocks {cp.variant:9s} max|kernel-plain| {err:.3e} = "
            f"{share:.3g} x limit")
        for fold in (False, True):
            if c.name not in (PLANTED_FOLD if fold else PLANTED):
                continue
            with planted_fault(fold):
                got = ops.execute(cp, env, kernels="cuda")
            err, share = measure(cp, env, got, f"planted {c.name}")
            what = ("middle pieces dropped in the fold" if fold else
                    "middle blocks skipped" if c.variant == "right_mm"
                    else "one partial dropped")
            log(f"[check] planted fault ({what}) {c.name}: "
                f"max|kernel-plain| {err:.3e} = {share:.3g} x limit")
            if not share > 1.0:
                raise AssertionError(f"planted fault in {c.name} passed "
                                     f"the kernel check")
    log(f"[check] outer sweep passed: {len(outer_planned)} CPlans; largest "
        f"share of the limit {worst['outer']:.3g}")
    log(f"[check] sweep phase wall {time.perf_counter() - t0:.1f} s")

    # 4. the main path's CPlans at the main path's shapes -------------------
    t0 = time.perf_counter()
    big = {(m_main, N_MAIN): 0.3 * torch.randn((m_main, N_MAIN),
                                               generator=gen, device="cuda")}
    main_err = {k: 0.0 for k in KERNELS}
    envs = []
    for region, cp in main_cps:
        env = random_env(cp, gen, big)
        kname = kernel_name(cp)
        err, share = compare(cp, env, f"main-path {region} "
                                      f"{cp.ttype.name} {cp.variant}")
        main_err[kname] = max(main_err[kname], err)
        envs.append(env)
        log(f"[check] main path {region:22s} {kname:4s} "
            f"{layout_name(cp):4s} {cp.variant:9s} "
            f"binds {[tuple(b.shape) for b in cp.binds]} "
            f"max|kernel-plain| {err:.3e} = {share:.3g} x limit")
        if kname == "cell":
            failed = cell_checks(region, cp, env)
            if failed:
                raise AssertionError("; ".join(failed))

    # 5. the main path -------------------------------------------------------
    log(f"[check] main-path CPlans phase wall {time.perf_counter() - t0:.1f} "
        f"s")
    t5 = time.perf_counter()
    X, y = l2svm_data(m_main)
    torch.cuda.synchronize()
    for mod in counters.values():
        mod.launches = 0
    t0 = time.perf_counter()
    w, objs = l2svm.run(X, y, max_iter=ITERS, kernels="cuda")
    torch.cuda.synchronize()
    t_cuda = time.perf_counter() - t0
    launches = {k: mod.launches for k, mod in counters.items()}
    log(f"[main] l2svm.run X {m_main}x{N_MAIN} fp32, {len(objs)} "
        f"iterations, kernels=cuda: {t_cuda:.2f} s host clock (planning "
        f"included); launches {json.dumps(launches)}")
    log(f"[main] objective trace (kernels=cuda): {objs}")
    missing = [k for k in ("cell", "magg", "row") if launches[k] == 0]
    if missing:
        raise AssertionError(f"main path never launched: {missing}")
    if tuple(w.shape) != (N_MAIN, 1) or not bool(torch.isfinite(w).all()):
        raise AssertionError("main path: w is not a finite (n,1) vector")
    t0 = time.perf_counter()
    _w2, objs_plain = l2svm.run(X, y, max_iter=ITERS, kernels="never")
    torch.cuda.synchronize()
    t_plain = time.perf_counter() - t0
    _w3, objs_hand = l2svm.run(X, y, max_iter=ITERS, mode="hand")
    log(f"[main] kernels=never: {t_plain:.2f} s; trace {objs_plain}")
    log(f"[main] hand torch baseline trace {objs_hand}")
    rel, rel_hand = trace_rel(objs, objs_plain), trace_rel(objs_hand,
                                                           objs_plain)
    log(f"[main] max relative trace difference: kernels vs never "
        f"{rel:.3e}, hand vs never {rel_hand:.3e} (tolerance "
        f"{TRACE_RTOL:g})")
    if not (len(objs_plain) == ITERS and rel <= TRACE_RTOL
            and rel_hand <= TRACE_RTOL):
        raise AssertionError("main path: objective traces disagree")
    with planted_fault():
        _w4, objs_fault = l2svm.run(X, y, max_iter=ITERS, kernels="cuda")
    rel_fault = trace_rel(objs_fault, objs_plain)
    log(f"[main] planted fault (one partial dropped in every reducing "
        f"kernel): trace {objs_fault}, max relative difference vs never "
        f"{rel_fault:.3e}")
    if not rel_fault > TRACE_RTOL:
        raise AssertionError("planted fault passed the trace check")
    profile_run(f"l2svm.run kernels=cuda, {ITERS} iterations",
                lambda: l2svm.run(X, y, max_iter=ITERS, kernels="cuda"))
    fuse_rec = fuse_exprs_main(X, y, w, counters)
    del X, y, w, _w2, _w3, _w4

    # 6. timing at the main path's shapes ----------------------------------
    per_kernel = dense_times(main_cps, envs)
    del big, envs
    torch.cuda.empty_cache()
    log(f"[main] l2svm run and timing phases wall "
        f"{time.perf_counter() - t5:.1f} s")

    # 7. ALS-CG on the Netflix-shaped BCSR -----------------------------------
    t0 = time.perf_counter()
    als = als_phase(counters, launches, main_err)
    per_kernel["outer"] = als
    log(f"[als] phase wall {time.perf_counter() - t0:.1f} s")

    # 8.-11. MLogReg, GLM, KMeans and the autoencoder ----------------------
    traces = {"l2svm": objs}
    for path in paths:
        traces[path.name] = algo_phase(path, path_cps[path.name], counters,
                                       launches, main_err, per_kernel)

    # 12.-16. the request axis, CLA, serving, chaos ----------------------
    bcounters = {"cell_batched": cellwise, "row_batched": rowwise,
                 "magg_batched": multiagg}
    batch_err = {k: 0.0 for k in BATCHED}
    batch_phase(planned_batch, wide_cps, batch_err, per_kernel)
    cla_phase(counters)
    serve_launches = {k: 0 for k in BATCHED}
    serve_phase(counters, bcounters, serve_launches)
    serve_wide_phase(counters, bcounters, serve_launches)
    log(f"[serve] request-axis launches over the fault-free serving runs "
        f"{json.dumps(serve_launches)}")
    missing = [k for k, c in serve_launches.items() if c == 0]
    if missing:
        raise AssertionError(f"serving never launched: {missing}")
    chaos_phase()

    # 17. [dist]: distributed segments on a mesh of 4 ranks on the card ----
    dist_rec = dist_phase(traces)

    # 18.-21. [attn], then [lm], [lm-moe], [lm-hybrid], [lm-xlstm]: the LM
    # serving path -------------------------------------------------------
    attn_rec, arch_recs = lm_phases()

    # 22. [lm-train]: the fused loss, the train step and the CLI ----------
    train_recs = lm_train_phase()

    # 23.-25. [lm-sharded]: the sharded Engine; [lm-train-sharded]: the
    # sharded train step; [examples] --------------------------------------
    sharded_phase()
    ts_rec = train_sharded_phase()
    examples_phase()

    # 23. result lines -------------------------------------------------------
    fuse_launches = dict(fuse_rec["launches"],
                         outer=als["fuse_exprs"]["launches"])
    log(f"[fuse_exprs] launches added by the fuse_exprs checks (main path "
        f"and [als]): {json.dumps(fuse_launches)}")
    rows = []
    for k, (src, replaces) in KERNELS.items():
        agg = per_kernel[k]
        rows.append({
            "name": k, "route": "cuda", "source": src, "replaces": replaces,
            "launches": launches[k], "max_abs_err": main_err[k],
            "ms": agg["ms"], "plain_ms": agg["plain_ms"],
            "bound_ms": agg["bound_ms"],
            "bound_by": max(agg["bound_by"], key=agg["bound_by"].get),
            "library_ms": library_ms(agg),
            "per": ("one call of each ALS-CG CPlan (sum over U update, V "
                    "update, loss)" if k == "outer" else
                    "one call of each main-path CPlan it runs, summed over "
                    "L2SVM, MLogReg, GLM, KMeans and the autoencoder"),
            "parts": agg["parts"], "dist": dist_rec[k],
            "fuse_exprs_launches": fuse_launches[k]})
    for bname, k in BATCHED.items():
        agg = per_kernel[bname]
        rows.append({
            "name": bname, "route": "cuda", "source": KERNELS[k][0],
            "replaces": KERNELS[k][1], "launches": serve_launches[bname],
            "max_abs_err": batch_err[bname], "ms": agg["ms"],
            "plain_ms": agg["plain_ms"], "bound_ms": agg["bound_ms"],
            "bound_by": max(agg["bound_by"], key=agg["bound_by"].get),
            "library_ms": library_ms(agg),
            "per": (f"one batched call of {WIDE_BATCH} requests x "
                    f"{WIDE_ROWS} x {N_MAIN} of each main-width batch "
                    f"region it runs; launches over the fault-free serving "
                    f"runs"),
            "parts": agg["parts"]})
    for run in LM_ARCHS:
        rec = arch_recs[run.tag]
        width = rec["parts"][0]["binds"][0][1]
        rows.append({
            "name": ("row_rmsnorm" if run.tag == "lm" else
                     f"row_rmsnorm_{run.tag.replace('-', '_')}"),
            "route": "cuda", "source": KERNELS["row"][0],
            "replaces": KERNELS["row"][1], "launches": rec["launches"],
            "max_abs_err": rec["max_abs_err"], "ms": rec["ms"],
            "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
            "bound_by": max(rec["bound_by"], key=rec["bound_by"].get),
            "library_ms": library_ms(rec),
            "layout": rec["parts"][0]["layout"],
            "skeleton": STAGED_SKELETON,
            "per": (f"one call of models.layers.norm(fusion='gen') over "
                    f"{run.arch}'s layer-0 input of {LM_SEQ} tokens x "
                    f"{width}, fp32; launches in the [{run.tag}] phase's "
                    f"call"),
            "parts": rec["parts"], "lm_times": rec["times"]})
    rows.append(attn_row(attn_rec))
    for name, what in (("row_loss", "forward: log-sum-exp rows"),
                       ("row_loss_vjp", "planned backward")):
        rec = train_recs[name]
        rows.append({
            "name": name, "route": "cuda", "source": KERNELS["row"][0],
            "replaces": KERNELS["row"][1], "launches": rec["launches"],
            "max_abs_err": rec["max_abs_err"], "ms": rec["ms"],
            "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
            "bound_by": rec["bound_by"], "library_ms": rec["library_ms"],
            "layout": "staged", "skeleton": STAGED_SKELETON,
            "per": (f"one call of the fused softmax-CE loss's {what} over "
                    f"{LOSS_ROWS} x 256,000 fp32 logits (minitron-4b's "
                    f"vocabulary); parts at every LOSS_WIDTHS width, at "
                    f"the main paths' LOSS_MAIN_SHAPES and at "
                    f"LOSS_STREAM_SHAPE (the streaming layout, "
                    f"{STREAM_SKELETON}); launches in [lm-train]'s "
                    f"full-size run"),
            "parts": rec["parts"]})
    for name, label, what in (
            ("row_loss_sharded", "_lse", "forward: log-sum-exp rows"),
            ("row_loss_vjp_sharded", "_lse:vjp", "planned backward")):
        part = ts_rec["parts"][label]
        rows.append({
            "name": name, "route": "cuda", "source": KERNELS["row"][0],
            "replaces": KERNELS["row"][1],
            "launches": ts_rec["full"]["launches"] // 2,
            "max_abs_err": part["max_abs_err"], "ms": part["ms"],
            "plain_ms": part["plain_ms"], "bound_ms": part["bound_ms"],
            "bound_by": part["bound_by"], "library_ms": part["library_ms"],
            "layout": part["layout"], "skeleton": STAGED_SKELETON,
            "per": (f"one call of the fused softmax-CE loss's {what} over "
                    f"a rank's {part['rows']} x 256,000 fp32 logits in "
                    f"[lm-train-sharded]; launches: every rank's in its "
                    f"full-depth run (c)"),
            "parts": [part]})
    for name, what in (("row_loss_panel", "forward: log-sum-exp rows"),
                       ("row_loss_vjp_panel", "planned backward")):
        part = dist_rec["loss_panels"][name]
        dev = part["device_ms"]
        rows.append({
            "name": name, "route": "cuda", "source": KERNELS["row"][0],
            "replaces": KERNELS["row"][1], "launches": part["launches"],
            "max_abs_err": part["max_abs_err"],
            "ms": dev if dev is not None else part["ms"],
            "ms_from": ("queued CUDA events" if dev is not None else
                        "the call's CUDA events"),
            "plain_ms": part["plain_device_ms"],
            "bound_ms": part["bound_ms"], "bound_by": part["bound_by"],
            "library_ms": part["library_device_ms"],
            "layout": part["layout"], "skeleton": STAGED_SKELETON,
            "per": (f"one call of the fused softmax-CE loss's {what} over "
                    f"a rank's row panel {part['binds'][0]} of "
                    f"{DIST_LOSS_SHAPE[0]} x {DIST_LOSS_SHAPE[1]} fp32 "
                    f"logits under TrainConfig(fusion_layout=mesh) in "
                    f"[dist]; launches: every rank's in its counted run"),
            "parts": [part]})
    log(json.dumps({"kernels": rows}))
    log(card_line())
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


def als_phase(counters, launches, main_err) -> dict:
    """ALS-CG at the main path's shape: its CPlans against plain, the run
    with ``kernels="cuda"`` (launch counts into ``launches``), its trace
    against ``kernels="never"`` and a planted fault, the hand baseline at
    the reduced shape, a profile, and per-CPlan times; returns the Outer
    kernel's timing record."""
    import torch
    from repro_torch.algos import als_cg
    from repro_torch.kernels import outerprod
    from repro_torch.kernels.blocksparse import PIECE_BLOCKS
    t0 = time.perf_counter()
    X = netflix_like(ALS_SHAPE, seed=0)
    torch.cuda.synchronize()
    m, n = X.shape
    log(f"[als] X {ALS_SHAPE[0]}x{ALS_SHAPE[1]} padded to {m}x{n}, bs "
        f"{X.bs}: {X.nblocks} blocks (block density "
        f"{X.block_sparsity:.4f}), {X.data.numel() * 4 / 1e9:.2f} GB; built "
        f"on the card in {time.perf_counter() - t0:.1f} s")

    # the main path
    run = lambda **kw: als_cg.run(X, rank=ALS_RANK, max_iter=ALS_ITERS,
                                  max_inner=ALS_INNER, **kw)
    torch.cuda.synchronize()
    for mod in counters.values():
        mod.launches = 0
    t0 = time.perf_counter()
    U, V, losses = run(kernels="cuda")
    torch.cuda.synchronize()
    t_cuda = time.perf_counter() - t0
    launches["outer"] = outerprod.launches
    log(f"[als] als_cg.run rank {ALS_RANK}, {ALS_ITERS} x {ALS_INNER} "
        f"iterations, kernels=cuda: {t_cuda:.2f} s host clock (planning "
        f"included); launches "
        + json.dumps({k: mod.launches for k, mod in counters.items()}))
    log(f"[als] loss trace (kernels=cuda): {losses}")
    if outerprod.launches == 0:
        raise AssertionError("ALS main path never launched the outer kernel")
    if tuple(U.shape) != (m, ALS_RANK) or tuple(V.shape) != (n, ALS_RANK) \
            or not bool(torch.isfinite(U).all() & torch.isfinite(V).all()):
        raise AssertionError("ALS main path: U, V not finite of their shape")
    del U, V
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    _u, _v, losses_plain = run(kernels="never")
    torch.cuda.synchronize()
    log(f"[als] kernels=never: {time.perf_counter() - t0:.2f} s, peak "
        f"device memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB "
        f"(X and X^T resident); trace {losses_plain}")
    del _u, _v
    with planted_fault():
        _u, _v, losses_fault = run(kernels="cuda")
    del _u, _v
    rel = trace_rel(losses, losses_plain)
    rel_fault = trace_rel(losses_fault, losses_plain)
    log(f"[als] planted fault (right_mm skips the middle block of every "
        f"block row, full_agg drops a partial): trace {losses_fault}")
    log(f"[als] max relative trace difference vs never: sound {rel:.3e}, "
        f"planted {rel_fault:.3e} (tolerance {TRACE_RTOL:g})")
    # checked at the end of the phase, so one run reports every reading
    failed = []
    if not (len(losses_plain) == ALS_ITERS and rel <= TRACE_RTOL):
        failed.append("ALS main path: loss traces disagree")
    if not rel_fault > TRACE_RTOL:
        failed.append("planted fault passed the ALS trace check")
    profile_run(f"als_cg.run kernels=cuda, rank {ALS_RANK}, {ALS_ITERS} x "
                f"{ALS_INNER} iterations", lambda: run(kernels="cuda"))

    # the dense-mask hand baseline, at the reduced shape
    Xh = netflix_like(ALS_HAND_SHAPE, seed=1)
    kw = dict(rank=ALS_RANK, max_iter=ALS_ITERS, max_inner=ALS_INNER)
    _u, _v, l_gen = als_cg.run(Xh, kernels="cuda", **kw)
    _u, _v, l_hand = als_cg.run(Xh, mode="hand", **kw)
    rel_hand = trace_rel(l_gen, l_hand)
    log(f"[als] reduced {Xh.shape[0]}x{Xh.shape[1]} ({Xh.nblocks} blocks): "
        f"gen (kernels=cuda) {l_gen}; hand {l_hand}; max relative "
        f"difference {rel_hand:.3e} (tolerance {ALS_HAND_RTOL:g})")
    if not rel_hand <= ALS_HAND_RTOL:
        failed.append("ALS hand baseline disagrees with gen")
    del Xh, _u, _v

    # the ALS CPlans at the main path's shapes against plain
    XT = X.T                # the runs above built and dropped their own
    log(f"[als] Outer grid: {X.pieces.table.shape[0]} pieces over X's "
        f"{m // X.bs} block rows, {XT.pieces.table.shape[0]} over X^T's "
        f"{n // X.bs} (at most {PIECE_BLOCKS} blocks each)")
    gen = torch.Generator(device="cuda").manual_seed(4321)
    cps = als_cplans(X, XT)
    envs = []
    for label, cp in cps:
        env = als_env(cp, XT if label.endswith("V-update") else X, gen)
        err, share = compare(cp, env, f"main-path {label}")
        main_err["outer"] = max(main_err["outer"], err)
        envs.append(env)
        log(f"[check] main path {label:22s} outer {cp.variant:9s} binds "
            f"{[tuple(b.shape) for b in cp.binds]} max|kernel-plain| "
            f"{err:.3e} = {share:.3g} x limit")
        if label.endswith("V-update"):
            with planted_fault(fold=True):
                got = outerprod.outer(cp, env)
            err, share = measure(cp, env, got, f"planted fold {label}")
            del got
            log(f"[check] planted fault (middle pieces dropped in the "
                f"fold) main path {label}: max|kernel-plain| {err:.3e} = "
                f"{share:.3g} x limit")
            if not share > 1.0:
                failed.append(f"planted fold fault in {label} passed the "
                              f"kernel check")

    rec = outer_times(cps, envs)
    del envs
    rec["fuse_exprs"] = als_fuse_exprs(X, failed)
    if failed:
        raise AssertionError("; ".join(failed))
    return rec


def als_fuse_exprs(X, failed: list) -> dict:
    """ALS's ``_wsq_mm`` hand-built with a BCSR leaf and run once through
    ``fuse_exprs`` on the Netflix-shaped X (U and V drawn from a seed),
    the Outer counter set to 0 just before and read just after: equal to
    the ``@fused`` path's on the same bindings bit for bit, within the
    kernel limit of its plain version, and with the planted fault
    (``right_mm`` skips the middle block of every block row) over it.
    Appends what failed to ``failed``; returns the launches and the
    reading."""
    import torch
    from repro_torch.algos import als_cg
    from repro_torch.core import fuse_exprs
    from repro_torch.kernels import outerprod
    t0 = time.perf_counter()
    m, n = X.shape
    g = torch.Generator(device="cuda").manual_seed(25)
    binds = {"X": X,
             "U": 0.1 * torch.randn((m, ALS_RANK), generator=g,
                                    device="cuda"),
             "V": 0.1 * torch.randn((n, ALS_RANK), generator=g,
                                    device="cuda")}
    shapes = {k: tuple(v.shape) for k, v in binds.items()}
    expr = hand_built(als_cg._wsq_mm, shapes, {"X": X.block_sparsity})
    torch.cuda.synchronize()
    outerprod.launches = 0
    with captured_plans() as seen:
        got = fuse_exprs(expr, binds)
    torch.cuda.synchronize()
    launches = outerprod.launches
    same = bool(torch.equal(got, als_cg._wsq_mm(**binds)))
    (cp,) = seen[0].cplans()
    names = {nd.nid: nd.name for nd in seen[0].plan.graph.inputs()}
    env = {b.nid: binds[names[b.nid]] for b in cp.binds}
    err, share = measure(cp, env, got, "[als] fuse_exprs _wsq_mm")
    with planted_fault():
        bad = fuse_exprs(expr, binds)
    planted_share = fault_share(cp, env, bad, "[als] planted fuse_exprs")
    log(f"[als] fuse_exprs _wsq_mm over the BCSR X {m}x{n}: launches "
        f"outer {launches}; = @fused bit for bit {same}; max|kernel-plain| "
        f"{err:.3e} = {share:.3g} x limit; planted fault (middle blocks "
        f"skipped) {planted_share:.3g} x limit; wall "
        f"{time.perf_counter() - t0:.1f} s")
    if not same:
        failed.append("fuse_exprs _wsq_mm differs from @fused")
    if not (launches >= 1 and share <= 1.0):
        failed.append(f"fuse_exprs _wsq_mm: launches {launches}, "
                      f"{share:.3g} x limit")
    if not planted_share > 1.0:
        failed.append("the planted fault passed the fuse_exprs _wsq_mm "
                      "check")
    return {"launches": launches, "max_abs_err": err, "share": share}


def dist_only() -> None:
    """``--dist``: [dist] alone (no result line): the kernels the ranks and
    the single-device L2SVM and MLogReg paths launch built first, those
    paths' ``kernels="cuda"`` traces, then the rank processes, checked
    against them as in the whole run."""
    import torch
    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is False")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.algos import l2svm
    from repro_torch.kernels import build, cuda_src
    log(f"[env] {ROOT} torch {torch.__version__}; nvidia-smi: "
        f"{card_line()}")
    t0 = time.perf_counter()
    (mlr,) = [p for p in algo_paths(M_MAIN) if p.name == "mlogreg"]
    srcs = [cuda_src.source_for(cp) for _r, cp in
            main_path_cplans(M_MAIN, N_MAIN) + path_cplans(mlr)]
    srcs += dist_sources() + loss_sources()
    build.build_all({s.key: s for s in srcs}.values())
    log(f"[build] {len(srcs)} kernel sources {time.perf_counter() - t0:.1f} "
        f"s")
    X, y = l2svm_data(M_MAIN)
    _w, objs = l2svm.run(X, y, max_iter=ITERS, kernels="cuda")
    del X, y, _w
    ops = mlr.data()
    _B, nlls = mlr.run(ops, kernels="cuda")
    del ops, _B
    torch.cuda.synchronize()
    log(f"[main] l2svm trace {objs}; mlogreg trace {nlls}")
    dist_phase({"l2svm": objs, "mlogreg": nlls})


def times_only() -> None:
    """``--times``: the readings of speed only, to compare two trees of the
    port on one card: the profiles of every main path and the times of
    their CPlans, with no checks and no result line.  Copied into an older
    checkout, the script reads that checkout's package the same way."""
    import torch
    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is False")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.algos import als_cg, l2svm
    from repro_torch.kernels import build, cuda_src
    log(f"[env] {ROOT} torch {torch.__version__}; nvidia-smi: "
        f"{card_line()}")
    main_cps = main_path_cplans(M_MAIN, N_MAIN)
    path_cps = [(path, path_cplans(path)) for path in algo_paths(M_MAIN)]
    shape = padded(ALS_SHAPE)
    als_meta = als_cplans(meta_bcsr(shape), meta_bcsr(shape[::-1]))
    srcs = [cuda_src.source_for(cp) for _r, cp in main_cps] + \
        [cuda_src.source_for(cp) for _p, cps in path_cps
         for _r, cp in cps] + \
        [cuda_src.source_for(cp, ALS_BS) for _l, cp in als_meta]
    build.build_all({s.key: s for s in srcs}.values())

    X, y = l2svm_data(M_MAIN)
    l2svm.run(X, y, max_iter=ITERS, kernels="cuda")       # plans cached
    profile_run(f"l2svm.run kernels=cuda, {ITERS} iterations",
                lambda: l2svm.run(X, y, max_iter=ITERS, kernels="cuda"))
    gen = torch.Generator(device="cuda").manual_seed(1234)
    envs = [random_env(cp, gen, {(M_MAIN, N_MAIN): X}) for _r, cp in main_cps]
    dense_times(main_cps, envs)
    del X, y, envs
    torch.cuda.empty_cache()

    Xs = netflix_like(ALS_SHAPE, seed=0)
    run = lambda: als_cg.run(Xs, rank=ALS_RANK, max_iter=ALS_ITERS,
                             max_inner=ALS_INNER, kernels="cuda")
    run()                                                   # plans cached
    profile_run(f"als_cg.run kernels=cuda, rank {ALS_RANK}, {ALS_ITERS} x "
                f"{ALS_INNER} iterations", run)
    XT = Xs.T
    gen = torch.Generator(device="cuda").manual_seed(4321)
    cps = als_cplans(Xs, XT)
    outer_times(cps, [als_env(cp, XT if label.endswith("V-update") else Xs,
                              gen) for label, cp in cps])
    del Xs, XT
    torch.cuda.empty_cache()

    for path, cps in path_cps:
        ops = path.data()
        path.run(ops, kernels="cuda")                       # plans cached
        profile_run(f"{path.name} kernels=cuda, {path.depth}",
                    lambda: path.run(ops, kernels="cuda"))
        gen = torch.Generator(device="cuda").manual_seed(2468)
        shared = {tuple(ops[0].shape): ops[0]}
        dense_times(cps, [random_env(cp, gen, shared) for _l, cp in cps])
        del ops, shared
        torch.cuda.empty_cache()
    log(card_line())


def lm_train_only() -> None:
    """``--lm-train``: [lm-train] alone (its kernels built, its checks and
    readings, no result line)."""
    import torch
    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is False")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.kernels import build
    log(f"[env] {ROOT} torch {torch.__version__}; nvidia-smi: "
        f"{card_line()}")
    t0 = time.perf_counter()
    build.build_all({s.key: s for s in loss_sources()
                     + warp_probe_sources()}.values())
    log(f"[build] loss kernels {time.perf_counter() - t0:.1f} s")
    recs = lm_train_phase()
    log(json.dumps({k: ({kk: vv for kk, vv in v.items() if kk != "parts"}
                        if isinstance(v, dict) else v)
                    for k, v in recs.items()}, default=str))


def attn_only() -> None:
    """``--attn``: [attn] alone (its checks and readings, no result
    line)."""
    import torch
    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is False")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"[env] {ROOT} torch {torch.__version__}; nvidia-smi: "
        f"{card_line()}")
    rec = attn_phase()
    log(json.dumps({"attn": {k: v for k, v in rec.items()
                             if k != "parts"}}))


def lm_only() -> None:
    """``--lm``: [attn] and the LM serving phases (18-21) alone, then the
    attention kernel's entry of the result line (no result line)."""
    import torch
    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is False")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"[env] {ROOT} torch {torch.__version__}; nvidia-smi: "
        f"{card_line()}")
    attn_rec, _arch_recs = lm_phases()
    log(json.dumps({"kernels": [attn_row(attn_rec)]}))
    log(card_line())


def main() -> int:
    args = sys.argv[1:]
    if args[:1] == ["--dist-rank"] and len(args) == 6:
        # one rank process of the [dist] phase, started by that phase
        dist_rank(int(args[1]), int(args[2]), args[3], args[4], args[5])
        return 0
    if args[:1] == ["--lm-sharded-rank"] and len(args) == 5:
        # one rank process of the [lm-sharded] phase, started by that phase
        sharded_rank(int(args[1]), int(args[2]), args[3], args[4])
        return 0
    if args[:1] == ["--lm-train-sharded-rank"] and len(args) == 5:
        # one rank process of [lm-train-sharded], started by that phase
        ts_rank(int(args[1]), int(args[2]), args[3], args[4])
        return 0
    modes = {(): run, ("--times",): times_only,
             ("--lm-times",): lm_times_only, ("--lm-train",): lm_train_only,
             ("--attn",): attn_only, ("--lm",): lm_only,
             ("--lm-sharded",): sharded_only,
             ("--lm-train-sharded",): train_sharded_only,
             ("--dist",): dist_only}
    if tuple(args) not in modes:
        print("usage: python3 chip_smoke.py [--times | --lm-times | "
              "--lm-train | --attn | --lm | --lm-sharded | "
              "--lm-train-sharded | --dist]",
              file=sys.stderr)
        return 2
    try:
        modes[tuple(args)]()
    except Exception:                 # noqa: BLE001 - report, exit non-zero
        traceback.print_exc()
        print("chip_smoke: FAILED", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
