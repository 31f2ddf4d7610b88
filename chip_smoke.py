#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py                  # from the repository root
    python3 chip_smoke.py --parent DIR     # also time DIR's collect build

Phases, one line each; any failure exits nonzero and nothing is caught:

1. device: the card's name and power limit (nvidia-smi), then the
   thirteen CUDA sources of ``src/repro_torch/csrc`` built with nvcc, one process
   per source, all at once, with each build's ptxas lines (and those of
   the flash-attention kernel's D-256 and D-512 instantiations, its
   sliced kernels and its float32 D-256 instantiation apart, failing on
   any spill of the last three, and those of the SSD scan's chunk
   kernels and the Jacobi-2D cluster kernel, and of Jacobi-2D's tiled
   kernel, streamcluster's kernel (16-bit and 3xTF32), pathfinder's strip
   and pyramid kernels and canneal's tile and row kernels, failing on any
   spill of these), and the count of tensor-core instructions (HGMMA,
   HMMA) in the flash-attention and streamcluster libraries' SASS where
   the toolkit has ``cuobjdump`` (failing if streamcluster's holds no
   HGMMA); and the engine scan's default instantiation's line (and
   whether it is the one before the collect build: 72 registers, 28,928
   bytes) and the collect build's scan and pre-pass lines apart (failing if
   either spills);
2. Black-Scholes at its PARSEC-large size (65,536 options x 100 runs =
   6,553,600 evaluations): kernel against the plain version on the card at
   rtol = atol = 3e-5, times and bound;
3. engine scan, kernels against the plain version on the card, bit for
   bit: the short-body RiVec apps x the 24 Table-10 configs, seeded random
   traces under ooo / crossbar / mshrs=1 / 1 MB LLC configs, and the
   study's own 168-lane launch, timed as its two kernels (the pre-pass and
   the scan) and their sum (against the kernel table's 2.5565 ms); then
   the collect build (``engine_scan.scan_collect``: the recurrence on one
   warp, the attribution on two more) against ``scan_plain(...,
   collect=True)`` bit for bit on the same three sets and on ragged lanes
   at B 1, 31 and 33 with lanes of no step (timing outputs, accumulators,
   timeline with its causes) with its timing outputs bit for bit the
   default kernel's, timed on the 168 lanes beside the default call, with
   its plain version's time, its bound and its share of it; with
   ``--parent DIR`` also DIR's collect build on the same records, timed
   beside it and bit for bit equal;
4. the study (the main path, with every launch counter set to 0 first):
   the Black-Scholes app on the card, ``suite.sweep_all`` over the seven
   RiVec apps x Table 10 checked against ``tests/golden_sweep.json`` at
   rtol 1e-2 (timed as in the earlier slices), the 11 §5 anchors, the
   README quickstart's two claims, the timed Fig-10 + MSHR study (504
   lanes), and the whole golden table: all ten apps and their ten ``:asm``
   variants x Table 10 (480 cells, cold and warm) at rtol 1e-2, and the
   warm 480-cell sweep taken apart: body lookup, packing, the H2D copy,
   the launch, the D2H copy and the runtime derivation; and the scalar
   baseline's fold over the 480 cells, cold, on the host;
5. the suite's kernel path (every launch counter set to 0 first): swaptions,
   streamcluster (float32 on 3xTF32, bfloat16 and float16 on wgmma, each
   route asserted), particle filter (Rodinia's
   monotone CDF, on the search path, and the same CDF shuffled, on the
   count path; the path each took read from the kernel's flags),
   canneal (PARSEC simlarge on the tile kernel; its first 65,536 rows
   padded to 128 slots on the row kernel), pathfinder (Rodinia's wall and
   its float32 copy with a row of +inf on the strip route, one cooperative
   launch each; its first 21 rows on the pyramid route, one launch with no
   scratch row), flash attention (float32, bfloat16, bfloat16 at
   llama3-8b's and at gemma-7b's attention width, the last on the wgmma
   kernel's D-256 instantiation, bfloat16 at D 512 on its D-512
   instantiation, float32 at gemma's width on the 3xTF32 kernel's D-256
   instantiation, bfloat16 and float16 at D 640 on the sliced kernel,
   float32 at D 512 on the 3xTF32 sliced kernel, and a call of mixed
   types), flash
   decoding (float32, a
   float16 cache, bfloat16 at D 512, and a call of mixed types; the split
   kernel and its combine) and the Mamba-2 SSD scan (its three passes, and
   states of N 512 and 1,024 on its N-panel route)
   through ``kernels.ops`` at their PARSEC / Rodinia / app input sizes, and
   Jacobi-2D: RiVec's 4,000 sweeps of 164 x 164 in float32 and bfloat16
   through ``ops.jacobi2d`` (one cluster launch each), PolyBench's 1,000
   sweeps of 2,800 x 2,800 in float32 and bfloat16 (the tiled route, 125
   launches each, timed on the host clock), one sweep of it (the loop
   route) and one through ``ops.jacobi2d_step`` (the one-sweep kernel's
   vector route), and one float16 sweep of the app's grid (its width-one
   route); each
   output checked on its own terms (shape, range, a float64 or numpy
   reference that shares no code with the port, and each Jacobi-2D route
   bit for bit against as many sweeps of the plain version);
6. those kernels against their plain versions on the card at the
   reference's bars (Jacobi-2D on a PolyBench EXTRALARGE grid), timed
   beside their plain versions, the nearest single PyTorch call and their
   bounds (pathfinder on its strip route beside the pyramid route on the
   same wall, canneal's tile kernel beside its row kernel; the pyramid and
   the row kernel also in device time behind a spin, with L2 flushed
   before each call and in host issue time, on those inputs and on their
   main-path calls, whose host time is also split piece by piece), and the input types and widths the reference computes beyond
   them: Jacobi-2D's one sweep in float32, bfloat16 and float16 on its
   vector route and on its width-one route (a 2,799 x 2,801 grid, a
   float16 view one point into its buffer), both routes bit for bit in the
   three types; flash attention in float16 at the app's width and in bfloat16 and
   float16 at gemma-7b's (D 256), bfloat16 at D 512 (``wgmma512``),
   float32 at gemma's width (S 1,024, ``3xtf32_256``), bfloat16 and
   float16 at D 640 (``wgmma_sliced``), float32 at D 512
   (``3xtf32_sliced``) and one call of mixed types,
   decoding from a bfloat16 and a float16 cache, at D 512 and of mixed
   types, and decoding's split and combine kernels each alone,
   streamcluster in float16 and on its plain-load route (a bfloat16 view
   off 16 bytes), each streamcluster row with its route and, for the
   16-bit types, ``torch.cdist`` on the same operands where it computes
   them, Jacobi-2D in bfloat16 and the SSD scan at P
   256 (each SSD row also timed pass by pass, beside its bytes bound and
   its operations bound at the 3xTF32 rate and on the FMA pipes); for flash
   attention also its load path, the wrapper's host time a call, its
   TFLOP/s and the exponential co-bound (float32: the 3xTF32 tensor-core
   bound beside the float32 SIMT one); for the particle filter the path
   each row took and, as for decoding, the device time behind a spin
   beside ``searchsorted``'s; Jacobi-2D's two routes and the SSD scan's
   N-panel route; and at the app's 164 x 164 the old 4,000-launch loop
   beside the cluster route (wall time, device time, launches), the route
   under each cluster size, one cluster barrier and the floor it sets, and
   the routes on the widest float32 and bfloat16 grids the cluster takes;
   and PolyBench's 1,000 sweeps in float32 and bfloat16 on the tiled route
   beside the old loop of 1,000 launches, each in device and wall time
   with its launches, beside the bound;
7. the scalar-scorecard gate (``scalar_pipeline.main(["--check",
   "--device", "cuda"])``, every line it prints, ending on
   ``scalar-scorecard: PASS``), then the study driver's full row list
   (``repro_torch.study``, benchmarks/run.py's row groups, each group's
   rows and wall time): the characterization equal to a host run's, every
   frontend, rvv and codegen row ok, the scalar anchors in their bands,
   every profile row's event-sum identity within 1e-4, every kernel row on
   its CUDA kernel (its launch counters), the 480-cell batched sweep
   against the sequential one (``max_rel_diff=0.00e+00``); then
   ``repro_torch.calibrate`` (the fit a fixed point of the committed
   profiles) and its ``--scorecard``, ``repro_torch.futurework_study`` and
   ``repro_torch.vector_engine_study``;
8. the code generator on the host: the ten apps emitted and held to
   ``src/repro_torch/asm`` after the 4-line header, and the emit-decode
   round trip at the six MVLs of ``rvv.CHECK_MVLS`` (60 of 60);
9. the profiler, the collect build's path (its launch counter set to 0
   first): ``telemetry.main(["--smoke", "--scorecard"])`` on the card
   (every app x the reference's two configs, bodies tiled 6 times: collect
   timings bitwise the default path's, the event-sum identity within 1e-4
   with the worst printed, blackscholes' Chrome trace, the histogram; the
   ten-app scorecard) and ``module_stress.main`` (last line
   ``CONSISTENT``), each collect call's device time with its T (CUDA events
   around the wrapper's call), their sum and median, the phase's wall and
   the host split of one ``simulate(collect_stats=True)`` (pack, copies,
   launch, records); with ``--parent DIR`` the same path of DIR's tree, in
   a process of its own;
10. design-space exploration at full width: ``SPACE_FULL`` (1,536
   configs) x the ten apps, 15,360 cells, cold through a JSONL cache in a
   temporary directory (one engine scan launch), then again through a
   fresh ``ResultCache`` re-reading the file (hit rate 1.0, nothing
   simulated, the same frontier fingerprint); its 240 Table-10 cells
   bitwise equal to ``suite.speedup_batch`` and within rtol 1e-2 of the
   golden table, 64 seeded cells bitwise equal to the plain scan on the
   card; the phases' rows (key, dispatch, derive), the cells simulated and
   the in-run dedup, and the cold pass's dispatch split on the host clock
   (body lookup, pack, H2D, launch, D2H, derivation) beside the launch's
   device time;
11. the surrogate-guided search at full width (the engine scan's launch
   counter set to 0 first): phase 10's cache file read back into its
   15,360 training rows (nothing simulated), four 2,000-step fits on the
   card (seed 0 twice, bitwise equal; seed 1, different; the hold-out
   model without the last app) with their walls, final losses and
   scorecards (p50, p90, p99, max, Spearman), ``SPACE_HUGE``'s 1,244,160
   points scored for one app (host time, CUDA events, the device time of a
   batch behind a spin, points/s, the operations bound; 64 seeded points
   against the row path and the exact area), the search of ``SPACE_HUGE``
   x the ten apps through the same cache (mode, points scored, the three
   phases' walls, each app's re-simulated, refined and simulated counts),
   every frontier point exact-verified, each app's recall of phase 10's
   exhaustive frontier (mean >= 0.9), a repeat search with the same
   frontier fingerprint, and ``search.main(["--smoke"])`` (exit 0);
12. the simulation service (the counter set to 0 first):
   ``sim_service.main(["--smoke"])`` (exit 0) and the full serving study
   (``serve_bench.serve_study``: 400 requests at 200 Hz in real time,
   ``max_batch`` 16, through a JSONL cache, then the same stream against
   it): its rows, prewarm's batch sizes and wall time, the build count
   before and after prewarm, each pass's throughput, p50 / p99 / p99.9,
   hits, coalesced, dispatched and batches; no rebuild after prewarm, no
   request shed, the repeat >= 99 % hits, bitwise;
13. the model server (the attention kernels' counters set to 0 first):
   llama3-8b whole at its published widths in bfloat16 (8.03 B
   parameters drawn on the card from seed 0) through ``ServeEngine``, the
   launcher's defaults (8 requests of 3-9 tokens, batch 4, 8 new tokens,
   ``max_seq`` 64) and a long-prompt round (4 requests of 1,024-2,048
   tokens, 16 new, ``max_seq`` 4,096): tokens/s, each prefill's and the
   decode steps' host times beside their bounds, the flash-attention and
   decoding launches of each round (failing at 0) and the peak memory;
   the nine other configs at their published widths, whole where weights
   and cache fit 60 GB and cut in depth only otherwise (each cut
   printed), 4 requests of 4 new tokens each, logits finite and tokens in
   the padded vocabulary; the kernel route against the plain route
   (llama3-8b at full width, 2 layers, float32: the card's prefill logits
   and four teacher-forced decode steps against the port's CPU path on
   the same weights, within 1e-4 of the largest logit); and the two
   kernels at the long round's shapes against their plain versions,
   timed beside SDPA and bounded;
14. the trainer (the suite's inputs freed first): what qwen2.5-3b's
   training should show, stated before the run (``TRAIN_EXPECT``), then
   qwen2.5-3b whole in bfloat16 with remat through
   ``trainstep.build_train_step`` and the port's AdamW at B 2 x S 4,096,
   three steps on one batch and one of two microbatches, each step's
   wall, tokens/s, loss, gradient norm, peak memory and flash launches
   (72 a batch, failing otherwise; losses finite); the step's time split
   (the loss forward, the block stack's forward, forward + backward and
   the optimizer by CUDA events, one forward + backward under the
   profiler: wall against kernel time); flash attention at the training
   shape held row by row to the float32 plain version on the same bf16
   inputs, timed beside its bf16 plain version and SDPA and bounded, and
   the forward with its row log-sum-exp beside it; the attention
   backward a layer: the backward kernel (``flash_attention_bwd``, what
   ``layers.FlashAttention``'s backward runs) held row by row to the
   float32 plain backward on the same bf16 inputs
   (``FLASH_BWD_ROW_TOL``), two calls bit for bit, timed beside its plain
   version, the plain route's VJP (the route before the kernel), SDPA's
   forward and backward, and its bound, and its three kernels timed apart
   under the profiler; the embedding gradient's segment sum at the step's
   shape against its plain version and float64, bit for bit against
   ``segment_sum_chunked`` (its two-level order in plain torch), twice bit
   for bit, timed beside ``index_put_`` with accumulate, its sort, chunk
   pass and write pass apart under the profiler; every
   gradient leaf through the kernel route (the flash kernel forward, the
   backward kernel) against the plain route's on the same weights
   (qwen2.5-3b's width at 2 layers in bf16 at S 4,096, lm-10m in float32;
   ``TRAIN_PARITY``'s bars, and the bf16 plain route's within the same bar
   of the float32 gradient; the attention weights' gradients nonzero);
   ``examples.train_lm`` (60 steps, the loss falls), a run stopped at 30
   and resumed to 60 against the uninterrupted one, an injected failure
   retried and an out-of-memory error raised past its retries,
   ``examples.quickstart --arch llama3-8b`` and ``launch.train --smoke``;
   the attention kernels', the backward kernel's and the segment sum's
   launches on the trained path (36 backward launches and one segment sum
   a step and microbatch, failing otherwise);
15. the device mesh, on a one-rank NCCL mesh (data 1, model 1): llama3-8b
   whole through ``build_prefill_step`` / ``build_decode_step`` in phase
   13's launcher round, the mesh steps' logits bit for bit the mesh=None
   steps' (every decode step through ``collectives.flash_decode_attention``
   on row 5's split and combine kernels), tokens/s and the decode step's
   median beside phase 13's; granite-moe-3b whole, a prefill through the
   MoE's ``shard_map`` branch against the local branch, bit for bit with
   torch's deterministic algorithms off (the combine and the dispatch
   gather's backward sum in slot order; the local branch's own
   call-to-call spread printed, bar 0); qwen2.5-3b whole,
   three sharded steps from phase 14's initial state against phase 14's
   steps (``TRAIN_PARITY``'s bf16 bar on the loss and every leaf, the
   gradient norm within ``MESH_GRAD_NORM_RTOL``; 72 flash launches a step;
   wall and peak beside phase 14's); two gloo ranks on
   the one card (``scripts/mesh_two_ranks.py``: which collective gloo ran
   on a CUDA tensor, then the decode over a sequence sharded over model 2,
   the MoE's expert parallelism and a two-stage pipeline against one
   rank, or by name the paths a refused collective keeps on the CPU
   tests; the tensor-parallel train jobs ``train_full``, qwen2.5-3b at full
   width cut to 2 layers in float32, two steps of 2 x 1,024 tokens, and
   ``mamba_full``, mamba2-130m whole in float32, a prefill, 8 decode steps
   and two train steps, each held on its rank to one rank at the
   reference's bars, each rank's parameter bytes and peak, and flash
   attention's, its backward's and the segment sum's launches on each
   rank); the dry run in subprocesses (qwen2.5-3b x train_4k on the 16 x
   16 fake mesh: its record, fit and roofline row; phase 14's step shape
   on one rank: its FLOPs beside ``train_flop`` and the prediction); the
   attention kernels' launches in the calls that went through the mesh
   (each counted around its call), and the train jobs' kernels' launches
   on each rank; the phase's wall;
16. the ``kernels`` JSON line (twenty-nine entries: the engine scan's
   collect build ``engine_scan_collect`` with its two kernels and launches
   a call, Jacobi-2D's cluster,
   loop and tiled routes and the one-sweep kernel's width-one route,
   pathfinder's pyramid route (its strip route is
   the ``pathfinder`` entry), canneal's row kernel (its tile kernel is the
   ``canneal`` entry; an entry timed on other inputs than its main-path
   call says so in ``timed_on``), streamcluster's 16-bit (its own entry) and
   float32 3xTF32 instantiations and the SSD scan's N-panel route; flash
   attention's D-256
   and D-512 wgmma instantiations, its sliced kernel, its float32 D-256
   instantiation and its float32 sliced kernel, the particle filter's
   shuffled row,
   and decoding's combine kernel, each their own; the attention backward
   kernel ``flash_attention_bwd`` and the embedding gradient's
   ``segment_sum``, launched on the trainer's path;
   the particle filter's rows name their path), launch counts from phases
   4, 5 and 9, the engine scan's also by path (``launches_by_path``: the
   study's, phase 11's and phase 12's), flash attention's, decoding's and
   its combine kernel's too (the suite's, phase 5, and the model
   server's, phase 13, the trainer's, phase 14, and the mesh's, phase
   15), flash attention's, the attention backward's and the segment sum's
   also the two-rank tensor-parallel train jobs' (phase 15,
   ``mesh_tensor_parallel_train``), the first two with
   their phase-13 row (``serve``), flash attention also with its phase-14
   row (``train``: the kernel at the training shape and the attention
   backward beside it; its forward with lse beside it);
17. the last line: ``{"ok": true, "device": {...}}``.

Exits nonzero, printing no result, when there is no CUDA device or when
the port's sources are not beside this script.
"""
from __future__ import annotations

import dataclasses
import json
import re
import statistics
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
GOLDEN = ROOT / "tests" / "golden_sweep.json"

# H100 SXM published peaks (NVIDIA data sheet, 700 W): HBM3 bandwidth and
# float32 outside the tensor cores.
PEAK_BYTES_S = 3.35e12
PEAK_F32_S = 67e12
# bfloat16 products with float32 sums are exact on the tensor cores (dense
# bf16 rate), so they bound the bfloat16 streamcluster distances.
PEAK_BF16_S = 989e12
# TF32 on the tensor cores (dense): float32 attention runs as 3xTF32, three
# TF32 products per product, which keeps float32's accuracy.
PEAK_TF32_S = 495e12
# The exponential unit (MUFU ex2): 16 results a clock per SM, 132 SMs; one
# exponential per (query, key) pair is a co-bound of attention at D 64.
MUFU_PER_CLOCK_SM, N_SM = 16, 132
# Latency bound of the scan: one lane is one serial chain of records.  The
# loop-carried dependent float ops of one record, counted from
# csrc/engine_scan.cu (vector: issue max, in-order max, + startup, + execute
# -> lane/VMU free; scalar block: the t_scalar add; NOP: none), each waits
# the FP32 dependent-issue latency (4 cycles on Hopper).
SCAN_CHAIN = {"vector": 4, "scalar": 1}
FP32_LATENCY_CYCLES = 4
# The collect build's 168-lane call in its first design (one warp a block;
# PERF.md's kernel table): the time the three-warp design is held against.
COLLECT_FIRST_DESIGN_MS = 4.7024
# The default scan's time on the study's 168 lanes in PERF.md §6's kernel
# table before the collect build existed (pre-pass + scan); the collect
# build must leave it within +-5 %.
SCAN_TABLE_MS = 2.5565

# Black-Scholes: operations per option as written (each sqrt/log/exp/erf
# counted as one), bytes per option (5 float32 + 1 int32 in, 1 float32 out).
BS_OPS, BS_BYTES = 40, 28
BS_OPTIONS, BS_RUNS = 65_536, 100
# The suite kernels' inputs (PERF.md gives the sources): swaptions at PARSEC
# simlarge (64 swaptions x 20,000 trials x 11 tenor points x 3 factors);
# streamcluster at simlarge (16,384 points of 128 dimensions, 4,096 centers
# drawn from them); particle filter at Rodinia -np 100000 (as many queries);
# canneal at simlarge (400,000 locations, 1,920,000 swaps, 22 fan slots,
# mean fan 10.15).
SW_N = 64 * 20_000 * 11 * 3
SC_M, SC_N, SC_D = 16_384, 4_096, 128
PF_N = PF_M = 100_000
CA_N, CA_B, CA_F, CA_MEAN_FAN = 400_000, 1_920_000, 22, 10.15
# and its first CA_WIDE_B swaps with each row padded (-1) to CA_WIDE_F
# slots, as a netlist whose widest element has that many pads every row:
# past the tile kernel's 96 slots, so the row kernel; the same costs
CA_WIDE_B, CA_WIDE_F = 65_536, 128
# Operations per element as written, each log/division/select one: the
# swaptions chain (central 17, tail 21, selects and clamps 8); canneal per
# valid fan entry (4 subtractions, 4 abs, 2 adds, 2 accumulations).
SW_OPS, CA_OPS = 46, 12
# Jacobi-2D at RiVec's own size: _J2_CHUNK8 / 4,000 sweeps x 8 elements =
# 26,112 points updated per sweep (tracegen.py:171-185); sqrt(26,112) =
# 161.6, so the updated interior is 162 x 162 (26,244 points) and the grid
# with its fixed boundary 164 x 164, swept 4,000 times.  Its timed row runs
# on PolyBench 4.2.1's EXTRALARGE grid (N = 2,800), since one sweep of the
# app's 105 KB grid takes far less than a launch.  5 float operations per
# interior point.
J2_N, J2_SWEEPS, J2_BIG, J2_OPS = 164, 4_000, 2_800, 5
# The app's sweeps run in one launch of a thread-block cluster (the grid in
# its shared memory, ``jacobi2d.route``); PolyBench's EXTRALARGE grid does
# not fit one and runs its 1,000 time steps (TSTEPS) on the tiled route, 8
# sweeps a launch, and one sweep of it on the loop route.  Phase 6 also
# times the cluster route on the widest float32 and bfloat16 grids it takes
# (J2_WIDEST sweeps each).
J2_BIG_SWEEPS, J2_WIDEST = 1_000, 1_000
# The one-sweep kernel's width-one route (one point a chunk) runs where C is
# no multiple of 16 bytes' points or a pointer is off 16 bytes: phase 6
# times it on a 2,799 x 2,801 grid and on a view one point into its buffer.
J2_ODD = (J2_BIG - 1, J2_BIG + 1)
# pathfinder: Rodinia's 100,000 columns (tracegen.py:317) x the rows that
# _PATH_CHUNK8 implies (20,054,016 x 8 / 100,000 = 1,604), wall
# rand() % 10; 3 operations per cell after the first row (2 min, 1 add).
# The main path also runs the same wall in float32 with row PATH_INF_ROW all
# +inf (the costs reach the ends' 3.0e38 from both sides after it) and its
# first PATH_SHORT rows (the pyramid route's walls).
PATH_R, PATH_C, PATH_OPS = 1_604, 100_000, 3
PATH_INF_ROW, PATH_SHORT = 1_504, 21
# flash attention at the app's scale (workloads_ml.py:46: B 4, S 2,048, H 8,
# D 64, causal) and at llama3-8b's attention width (configs/llama3_8b.py:9:
# 32 heads of 128) at S 4,096, B 1, with K/V given all 32 heads (the kernel
# has no GQA); [B, S, H, D].  4*D flops per (query, key) pair kept.
FA_APP, FA_LLAMA = (4, 2_048, 8, 64), (1, 4_096, 32, 128)
# and at gemma-7b's (google/gemma-7b config.json: 16 heads, head_dim 256):
# the wgmma kernel's D-256 instantiation in the 16-bit types, the 3xTF32
# kernel's in float32 (there at S 1,024, as the earlier slices timed it)
FA_GEMMA = (1, 4_096, 16, 256)
FA_GEMMA_F32 = (1, 1_024, 16, 256)
# heads of 512 columns: the wgmma kernel's D-512 instantiation; of 640,
# past it: its sliced kernel (two output slices of 320 columns, Q
# resident); and float32 heads of 512, on the 3xTF32 sliced kernel
FA_D512 = (1, 2_048, 8, 512)
FA_D640 = (1, 1_024, 4, 640)
FA_F32_D512 = (1, 1_024, 8, 512)
# flash decoding at the app's scale (workloads_ml.py:49: B 32, S 4,096, H 8,
# D 64, float32); kv_len uniform in [1, S] per batch, one batch at 0.
DA_B, DA_S, DA_H, DA_D = 32, 4_096, 8, 64
# and with heads of 512 columns, from a bfloat16 cache
DA_D512 = (8, 4_096, 8, 512)
# the Mamba-2 SSD scan at the app's scale (workloads_ml.py:52: B 8,
# S 65,536, H 16) with mamba2-130m's head dim and state (configs/
# mamba2_130m.py:11: P 64, N 128; a pair the app leaves open), chunk 256,
# float32; inputs drawn as tests/test_kernels.py:111-116 draws them.  The
# float64 recurrence of phase 5 runs over the whole sequence of two (b, h).
SSD_B, SSD_S, SSD_H, SSD_P, SSD_N, SSD_CHUNK = 8, 65_536, 16, 64, 128, 256
SSD_CHECK = ((0, 0), (SSD_B - 1, SSD_H - 1))
# and with a head of 256 columns, split on the card into two P-slices
SSD_WIDE = (2, 16_384, 16, 256, 128)
# states too wide for one block (N > 416 at P 128): the scan splits them
# into N-panels (two of 256, three of 344, 344 and 336), each (b, S, H, P,
# N) checked against the float64 recurrence over two (b, h)
SSD_PANELS = {"ssd_scan_n512": (2, 4_096, 8, 128, 512),
              "ssd_scan_n1024": (2, 4_096, 4, 128, 1_024)}
# flash attention's routes past D 128 in the kernels line: name -> the
# wrapper's launch counter
FA_ROUTES = {"flash_attention_wgmma256": "wgmma256_launches",
             "flash_attention_wgmma512": "wgmma512_launches",
             "flash_attention_sliced": "sliced_launches",
             "flash_attention_3xtf32_256": "tf32_256_launches",
             "flash_attention_3xtf32_sliced": "tf32_sliced_launches"}


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAIL: {msg}")


def nvidia_smi(query: str) -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip().splitlines()[0]


def cuda_ms(torch, fn, reps: int, per: int = 1, warmup: int = 2) -> float:
    """Median device time (ms) of one ``fn`` call: each of ``reps`` samples
    times ``per`` back-to-back calls between one pair of CUDA events and
    divides by ``per``, so the host work of a call overlaps the device work
    of the one before it."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(per):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / per)
    return statistics.median(times)


def kernel_split(torch, fn, reps: int = 5) -> dict:
    """Device ms a call of ``fn`` by kernel name, under ``torch.profiler``
    (warm: one call first; ``reps`` calls profiled)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    split = {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA and e.self_device_time_total:
            split[e.key] = split.get(e.key, 0.0) + \
                e.self_device_time_total / 1e3 / reps
    return split


def split_ms(split: dict, name: str) -> float:
    """The ms of the kernels in ``split`` whose names hold ``name``."""
    return sum(v for k, v in split.items() if name in k)


def kernel_pieces(torch, fn, names: dict, tries: int = 3) -> dict:
    """Device ms a call of ``fn`` in each kernel of ``names`` (a key, a
    part of the kernel's name) and in all its kernels (``all_ms``), under
    ``torch.profiler``.  The profiler has now and then returned no record
    of a kernel, so the split is taken again, up to ``tries`` times, until
    it sees each of them; a kernel it never saw is None, and so is
    ``all_ms``, which would leave that kernel out."""
    for _ in range(tries):
        split = kernel_split(torch, fn)
        pieces = {k: split_ms(split, n) for k, n in names.items()}
        if min(pieces.values()) > 0:
            return dict(pieces, all_ms=sum(split.values()))
    return dict({k: v or None for k, v in pieces.items()}, all_ms=None)


def ms_text(ms) -> str:
    """``ms`` to 4 places, or that it was not measured (None)."""
    return "not measured" if ms is None else f"{ms:.4f}"


def sass_counts(build, source: str = "flash_attention") -> str:
    """Tensor-core and copy instructions in the built library of
    ``source`` (``cuobjdump -sass``), or why they cannot be counted."""
    cuobjdump = Path(build.nvcc()).with_name("cuobjdump")
    if not cuobjdump.exists():
        return f"not counted: no {cuobjdump}"
    run = subprocess.run([str(cuobjdump), "-sass",
                          str(build.target(source))],
                         capture_output=True, text=True)
    if run.returncode != 0:
        return f"not counted: cuobjdump exited {run.returncode}"
    ops = [ln.split()[1].split(".")[0] for ln in run.stdout.splitlines()
           if ln.lstrip().startswith("/*") and len(ln.split()) > 1]
    return ", ".join(f"{op} {ops.count(op)}"
                     for op in ("HGMMA", "HMMA", "UTMALDG", "LDGSTS", "FFMA"))


def entry_lines(report, source: str, entry: str) -> str:
    """The ptxas register and spill lines of the entry functions of
    ``source`` whose mangled names hold ``entry``, from this run's build
    log (empty where the library was already built)."""
    lines, name = [], None
    for ln in report[source]["log"].splitlines():
        if "Compiling entry function" in ln:
            name = ln.split("'")[1] if "'" in ln else ln
        elif name and entry in name and ("spill" in ln or "Used" in ln):
            lines.append(f"{name[name.index(entry):][:40]}: {ln.strip()}")
    return " | ".join(lines) or "not in this run's build log"


def device_ms(torch, fn, reps: int, per: int, sm_clock_hz: float) -> float:
    """Median device time (ms) of one ``fn`` call where the host's issue
    time exceeds the kernel's: the stream first runs a spin of ~2 ms
    (``torch.cuda._sleep``) while the host enqueues the ``per`` calls, so
    the events around them see the device work alone."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(int(2e-3 * sm_clock_hz))
        start.record()
        for _ in range(per):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / per)
    return statistics.median(times)


def wall_clock_ms(torch, fn, reps: int) -> float:
    """Median host time (ms) of one ``fn`` call and a synchronize."""
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def cold_device_ms(torch, fn, reps: int, sm_clock_hz: float) -> float:
    """Median device time (ms) of one ``fn`` call with L2 flushed before
    it: behind a spin, each call follows a 128 MB write and sits between
    its own pair of events."""
    flush = torch.empty(32 * 1024 * 1024, dtype=torch.float32, device="cuda")
    fn()
    torch.cuda.synchronize()
    pairs = [(torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    torch.cuda._sleep(int(5e-3 * sm_clock_hz))
    for start, end in pairs:
        flush.fill_(1.0)
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs)


def host_us(torch, fn, n: int = 2_000) -> float:
    """Mean host time (us) of one ``fn`` call, synchronizing every 100."""
    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    total = 0.0
    for _ in range(n // 100):
        t0 = time.perf_counter()
        for _ in range(100):
            fn()
        total += time.perf_counter() - t0
        torch.cuda.synchronize()
    return total / n * 1e6


def call_times(torch, fn, sm_clock_hz: float, per: int = 25) -> dict:
    """One ``fn`` call's times (ms): back to back (``b2b``), the device's
    behind a spin (``device``), the device's with L2 flushed before each
    call (``cold``) and the host's issue (``issue``)."""
    return dict(b2b=cuda_ms(torch, fn, reps=10, per=per),
                device=device_ms(torch, fn, reps=10, per=per,
                                 sm_clock_hz=sm_clock_hz),
                cold=cold_device_ms(torch, fn, reps=25,
                                    sm_clock_hz=sm_clock_hz),
                issue=host_issue_ms(torch, fn, per=50))


def call_times_text(t: dict, bound_ms: float) -> str:
    """``call_times`` as "b2b [device] {cold}; issue", and the bound's
    share of the device times."""
    return (f"{t['b2b']:.4f} [{t['device']:.4f}] {{{t['cold']:.4f}}}; issue "
            f"{t['issue']:.4f}; bound {bound_ms / t['device']:.1%} of the "
            f"device time, {bound_ms / t['cold']:.1%} of the flushed one")


def host_issue_ms(torch, fn, per: int) -> float:
    """Host time (ms) to issue one ``fn`` call, from ``per`` back-to-back
    calls with no synchronization between them."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(per):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) * 1e3 / per


def random_trace(isa, seed: int, n_ops: int = 60):
    """A seeded random trace over every instruction kind."""
    rng = np.random.RandomState(seed)
    b = isa.TraceBuilder()
    reg = lambda: int(rng.randint(-1, 8))
    for _ in range(n_ops):
        k = rng.randint(8)
        vl = int((1, 8, 64, 200, 256)[rng.randint(5)])
        if k == 0:
            b.arith(vl, fu=int(rng.randint(4)), src1=reg(), src2=reg(),
                    dst=reg())
        elif k == 1:
            b.load(vl, dst=reg(), pattern=int(rng.randint(3)),
                   footprint_kb=float((8.0, 64.0, 2048.0)[rng.randint(3)]))
        elif k == 2:
            b.store(vl, src1=reg(), pattern=int(rng.randint(3)),
                    footprint_kb=float((8.0, 64.0, 2048.0)[rng.randint(3)]))
        elif k == 3:
            b.slide(vl, src1=reg(), dst=reg())
        elif k == 4:
            b.move(vl, src1=reg(), dst=reg())
        elif k == 5:
            b.reduce(vl, src1=reg(), dst=reg(), fu=int(rng.randint(4)))
        elif k == 6:
            b.mask_to_scalar(vl, src1=reg())
        else:
            b.scalar(int(rng.randint(1, 40)), fu=int(rng.randint(4)),
                     dep_scalar=bool(rng.randint(2)))
    return b.build()


def ragged_inputs(eng, isa, ve, B: int, dev):
    """Scan operands of B ragged lanes, as the card tests build them: seeded
    random traces, every seventh lane with no step, the rest 300 to 499
    steps over bodies of 5 to 54 records (the record ring wraps many
    times), tiny ROB and queue capacities, checkpoints at 0, at n_steps and
    half of it."""
    traces = [random_trace(isa, 100 + k % 40, 5 + k % 50) for k in range(B)]
    cfgs = [dataclasses.replace(
        ve.TABLE10[k % len(ve.TABLE10)], rob_entries=1 + k % 4,
        queue_entries=1 + k % 3, phys_regs=33 + k % 2,
        ooo_issue=bool(k % 2)) for k in range(B)]
    n = [0 if k % 7 == 3 else 300 + (37 * k) % 200 for k in range(B)]
    ck = [0 if k % 3 == 0 else n[k] if k % 3 == 1 else n[k] // 2
          for k in range(B)]
    return eng.pack(traces, cfgs, n, ck, dev)


def parent_collect(torch, _build, parent: Path, recs, args, out_like):
    """Another tree's collect build (``parent``: a checkout's root) on the
    same pre-pass records: its ``engine_scan.cu`` built with this tree's
    flags into ``build/parent_scan/``, its C entry point called with the
    same operands.  Returns ``(ms, outputs)``: device ms a scan (CUDA
    events, median of 10 samples of 3) and its ``(out, acc, rec)``."""
    import ctypes
    src = parent / "src" / "repro_torch" / "csrc" / "engine_scan.cu"
    lib = ROOT / "build" / "parent_scan" / "libengine_scan.so"
    lib.parent.mkdir(parents=True, exist_ok=True)
    subprocess.run([_build.nvcc(), *_build.flags("engine_scan"), "-o",
                    str(lib), str(src)], check=True, capture_output=True)
    so = ctypes.CDLL(str(lib))
    so.engine_steps_collect_launch.argtypes = [ctypes.c_void_p] * 10 + [
        ctypes.c_int, ctypes.c_void_p]
    params, period, n, ck = args
    out, acc, rec = (torch.empty_like(t) for t in out_like)

    def call():
        code = so.engine_steps_collect_launch(
            *(r.data_ptr() for r in recs), params.data_ptr(),
            period.data_ptr(), n.data_ptr(), ck.data_ptr(), out.data_ptr(),
            acc.data_ptr(), rec.data_ptr(), n.numel(),
            torch.cuda.current_stream().cuda_stream)
        if code:
            fail(f"the parent's collect build: CUDA error {code}")

    rec.zero_()
    call()
    torch.cuda.synchronize()
    outputs = (out.clone(), acc.clone(), rec.clone())
    return cuda_ms(torch, call, reps=10, per=3), outputs


def scan_bound(inp, sm_clock_hz: float,
               extra_bytes: int = 0) -> tuple[float, str]:
    """(bound_ms, bound_by) of one scan launch: the larger of the bytes
    bound and the latency bound.  The latency bound is the dependent
    operations on the longest lane's chain, one per FP32 latency, so it is
    reported as an operations bound.  ``extra_bytes`` are outputs beyond
    the [8, B] one (the collect build's timeline and accumulators)."""
    kind = inp.xi[0].cpu().numpy()                      # [P, B]
    period, n = inp.period.cpu().numpy(), inp.n_steps.cpu().numpy()
    per_kind = np.zeros(9, np.int64)
    per_kind[0] = SCAN_CHAIN["scalar"]
    per_kind[1:8] = SCAN_CHAIN["vector"]
    chain = 0
    for b in range(kind.shape[1]):
        ops = per_kind[kind[:period[b], b]]
        full, rem = divmod(int(n[b]), int(period[b]))
        chain = max(chain, full * int(ops.sum()) + int(ops[:rem].sum()))
    t_latency = chain * FP32_LATENCY_CYCLES / sm_clock_hz
    nbytes = sum(t.numel() * t.element_size() for t in inp.args())
    nbytes += 8 * inp.xf.shape[1] * 4 + extra_bytes       # the [8, B] output
    t_bytes = nbytes / PEAK_BYTES_S
    return (max(t_bytes, t_latency) * 1e3,
            "bytes" if t_bytes >= t_latency else "operations")


# The suite kernels, each with the Pallas kernel it replaces.
SUITE_REPLACES = {
    "swaptions": "src/repro/kernels/swaptions.py:42",
    "streamcluster": "src/repro/kernels/streamcluster.py:29",
    "particlefilter": "src/repro/kernels/particlefilter.py:31",
    "canneal": "src/repro/kernels/canneal.py:34",
    "jacobi2d": "src/repro/kernels/jacobi2d.py:32",
    "pathfinder": "src/repro/kernels/pathfinder.py:43",
    "flash_attention": "src/repro/kernels/flash_attention.py:65",
    "decode_attention": "src/repro/kernels/decode_attention.py:51",
    "ssd_scan": "src/repro/kernels/ssd_scan.py:56"}


def suite_inputs(torch, dev) -> dict:
    """The suite kernels' operands at full width, made with numpy from one
    seed; ``host`` keeps the numpy arrays for the host-side checks."""
    rng = np.random.RandomState(2111)
    u = rng.uniform(1e-5, 1 - 1e-5, SW_N).astype(np.float32)
    points = rng.uniform(size=(SC_M, SC_D)).astype(np.float32)
    # streamcluster opens its centers at points of the stream
    centers = points[rng.choice(SC_M, SC_N, replace=False)]
    # Rodinia: the CDF of normalized weights, u_j = u1 + j/N
    w = rng.uniform(size=PF_N)
    cdf = np.cumsum(w / w.sum()).astype(np.float32)
    q = (rng.uniform(0, 1 / PF_N) + np.arange(PF_M) / PF_N).astype(np.float32)
    # canneal: integer coordinates; each swap's fan (1 + a binomial, mean
    # CA_MEAN_FAN) first in its row, -1 padding after
    locs = rng.randint(0, 1000, (CA_N, 2)).astype(np.float32)
    fan_n = 1 + rng.binomial(CA_F - 1, (CA_MEAN_FAN - 1) / (CA_F - 1), CA_B)
    fan = rng.randint(0, CA_N, (CA_B, CA_F)).astype(np.int32)
    fan[np.arange(CA_F)[None, :] >= fan_n[:, None]] = -1
    ca, cb = (rng.randint(0, 1000, (CA_B, 2)).astype(np.float32)
              for _ in range(2))
    t = lambda a: torch.from_numpy(a).to(dev)
    sc = (t(points), t(centers))
    # the grid, wall and attention inputs, from a Generator on the same seed
    # (its float32 normals are fast at these sizes)
    gen = np.random.default_rng(2111)
    j2 = gen.uniform(size=(J2_N, J2_N)).astype(np.float32)
    j2_big = gen.uniform(size=(J2_BIG, J2_BIG)).astype(np.float32)
    wall = gen.integers(0, 10, (PATH_R, PATH_C), dtype=np.int32)
    normal = lambda shape: t(gen.standard_normal(shape, dtype=np.float32))
    fa = tuple(normal(FA_APP) for _ in range(3))
    fa_llama = tuple(normal(FA_LLAMA).to(torch.bfloat16) for _ in range(3))
    lens = gen.integers(1, DA_S, DA_B, endpoint=True).astype(np.int32)
    lens[DA_B // 2] = 0
    da = (normal((DA_B, DA_H, DA_D)), normal((DA_B, DA_S, DA_H, DA_D)),
          normal((DA_B, DA_S, DA_H, DA_D)), t(lens))
    # drawn last, so the earlier slices' inputs stay as they were
    fa_gemma = tuple(normal(FA_GEMMA).to(torch.bfloat16) for _ in range(3))
    ssd, ssd_host = ssd_inputs(torch, dev)
    ssd_wide, _ = ssd_inputs(torch, dev, *SSD_WIDE, check=())
    fa_gemma_f32 = tuple(normal(FA_GEMMA_F32) for _ in range(3))
    fa_d512 = tuple(normal(FA_D512).to(torch.bfloat16) for _ in range(3))
    b5, s5, h5, d5 = DA_D512
    lens5 = gen.integers(1, s5, b5, endpoint=True).astype(np.int32)
    lens5[b5 // 2] = 0
    da_d512 = (normal((b5, h5, d5)).to(torch.bfloat16),
               normal((b5, s5, h5, d5)).to(torch.bfloat16),
               normal((b5, s5, h5, d5)).to(torch.bfloat16), t(lens5))
    # the particle filter's CDF shuffled (its count path), then heads of 640
    cdf_shuffled = gen.permutation(cdf)
    fa_d640 = tuple(normal(FA_D640).to(torch.bfloat16) for _ in range(3))
    fa_f32_d512 = tuple(normal(FA_F32_D512) for _ in range(3))
    # pathfinder's float32 wall with a row of +inf (no new draw)
    path_inf = wall.astype(np.float32)
    path_inf[PATH_INF_ROW] = np.inf
    # the SSD scan on N-panels (its own seed, as every SSD input)
    panels = {key: ssd_inputs(torch, dev, *dims,
                              check=((0, 0), (dims[0] - 1, dims[2] - 1)))
              for key, dims in SSD_PANELS.items()}
    # Jacobi-2D's width-one route: a grid whose C is no multiple of 16
    # bytes' points, and a float16 copy of PolyBench's one point into its
    # buffer (drawn last)
    j2_odd = t(gen.uniform(size=J2_ODD).astype(np.float32))
    j2_buf = torch.empty(J2_BIG * J2_BIG + 1, dtype=torch.float16,
                         device=dev)
    j2_view = j2_buf[1:].view(J2_BIG, J2_BIG)
    j2_view.copy_(t(j2_big))
    return {"sw": t(u), "sc": sc,
            "j2_big_f16": t(j2_big).to(torch.float16),
            "j2_odd": j2_odd, "j2_odd_bf16": j2_odd.to(torch.bfloat16),
            "j2_odd_f16": j2_odd.to(torch.float16), "j2_view_f16": j2_view,
            "j2_bf16": t(j2).to(torch.bfloat16),
            "j2_f16": t(j2).to(torch.float16),
            **{key: args for key, (args, _) in panels.items()},
            "sc_bf16": tuple(x.to(torch.bfloat16) for x in sc),
            "sc_f16": tuple(x.to(torch.float16) for x in sc),
            "j2_big_bf16": t(j2_big).to(torch.bfloat16),
            "fa_f16": tuple(x.to(torch.float16) for x in fa),
            "fa_gemma": fa_gemma,
            "fa_gemma_f16": tuple(x.to(torch.float16) for x in fa_gemma),
            "fa_gemma_f32": fa_gemma_f32, "fa_d512": fa_d512,
            "fa_d640": fa_d640,
            "fa_d640_f16": tuple(x.to(torch.float16) for x in fa_d640),
            "fa_f32_d512": fa_f32_d512,
            "pf_shuffled": (t(cdf_shuffled), t(q)),
            # mixed types through ops: q bfloat16, k and v float32
            "fa_mixed": (fa[0].to(torch.bfloat16), fa[1], fa[2]),
            "da_bf16": (*(x.to(torch.bfloat16) for x in da[:3]), da[3]),
            "da_f16": (*(x.to(torch.float16) for x in da[:3]), da[3]),
            "da_d512": da_d512,
            # q float32, k bfloat16, v float16
            "da_mixed": (da[0], da[1].to(torch.bfloat16),
                         da[2].to(torch.float16), da[3]),
            "ssd_wide": ssd_wide,
            "pf": (t(cdf), t(q)), "ca": tuple(map(t, (locs, fan, ca, cb))),
            "ca_wide": (t(locs), torch.nn.functional.pad(
                t(fan[:CA_WIDE_B]), (0, CA_WIDE_F - CA_F), value=-1),
                t(ca[:CA_WIDE_B]), t(cb[:CA_WIDE_B])),
            "j2": t(j2), "j2_big": t(j2_big), "path": t(wall),
            "path_inf": t(path_inf), "fa": fa,
            "fa_bf16": tuple(x.to(torch.bfloat16) for x in fa),
            "fa_llama": fa_llama, "da": da, "ssd": ssd,
            "host": {"pf": (cdf, q), "pf_shuffled": cdf_shuffled,
                     "ca": (locs, fan, ca, cb), "j2": j2,
                     "path": wall, "path_inf": path_inf, "da_lens": lens,
                     "da_lens_d512": lens5,
                     "ssd": ssd_host,
                     **{key: host for key, (_, host) in panels.items()}}}


def ssd_inputs(torch, dev, b_=SSD_B, S=SSD_S, H=SSD_H, P=SSD_P, N=SSD_N,
               check=SSD_CHECK):
    """The SSD scan's operands x, dt, A, B, C on the card, drawn with numpy
    from seed 2111 as tests/test_kernels.py draws them (x, B, C: 0.5 N(0,1);
    dt: softplus N(0,1); A: -exp(0.3 N(0,1))), and float64 host copies of
    the (b, h) sequences the recurrence checks."""
    gen = np.random.default_rng(2111)
    f32 = np.float32
    normal = lambda shape: gen.standard_normal(shape, dtype=f32)
    x = normal((b_, S, H, P)) * f32(0.5)
    dt = np.logaddexp(f32(0), normal((b_, S, H)))
    A = -np.exp(normal(H) * f32(0.3))
    B = normal((b_, S, N)) * f32(0.5)
    C = normal((b_, S, N)) * f32(0.5)
    host = {(b, h): tuple(a.astype(np.float64) for a in
                          (x[b, :, h], dt[b, :, h], A[h], B[b], C[b]))
            for b, h in check}
    return tuple(torch.from_numpy(a).to(dev) for a in (x, dt, A, B, C)), host


def ssd_recurrence_f64(x, dt, a, B, C):
    """The SSD scan of one (b, h) in its recurrent form, float64 numpy:
    state = exp(dt a) state + dt x (x) B, y = state C, step by step over the
    whole sequence; written out here, it shares no code with the port."""
    state = np.zeros((x.shape[1], B.shape[1]))
    y = np.empty_like(x)
    decay = np.exp(dt * a)
    xdt = x * dt[:, None]
    for t in range(x.shape[0]):
        state *= decay[t]
        state += np.outer(xdt[t], B[t])
        y[t] = state @ C[t]
    return y


def attention_f64(torch, q, k, v, causal, rows):
    """Softmax attention of the query rows ``rows`` (an index tensor) of one
    head in float64, q, k, v ``[S, D]``; written out here, it shares no code
    with the port."""
    q, k, v = q.double(), k.double(), v.double()
    s = (q[rows] @ k.T) / np.sqrt(q.shape[-1])
    if causal:
        keys = torch.arange(k.shape[0], device=k.device)
        s = s.masked_fill(keys[None, :] > rows[:, None], float("-inf"))
    return s.softmax(dim=-1) @ v


def decode_f64(torch, q, k, v, lens):
    """Decoding in float64 over the keys below each kv_len, and the mean of
    V where kv_len <= 0; written out here, it shares no code with the
    port."""
    S, D = k.shape[1], k.shape[-1]
    s = torch.einsum("bhd,bshd->bhs", q.double(), k.double()) / np.sqrt(D)
    keys = torch.arange(S, device=q.device)
    s = s.masked_fill(keys[None, None, :] >= lens[:, None, None].long(),
                      float("-inf"))
    want = torch.einsum("bhs,bshd->bhd", s.softmax(-1), v.double())
    zero = lens <= 0
    want[zero] = v[zero].double().mean(1)       # every key weighs the same
    return want


def check_suite_outputs(torch, ref, data, outs) -> None:
    """Each suite kernel's main-path output on its own terms: type, shape,
    range, and a reference that shares no code with the port on a slice
    (float64 on the card, or numpy on the host)."""
    x = outs["swaptions"]
    if x.shape != (SW_N,) or not torch.isfinite(x).all():
        fail("swaptions: non-finite or misshapen output")
    # the reference's own check: the normal CDF of the result is u again
    back = 0.5 * (1 + torch.erf(x.double() / np.sqrt(2)))
    sw_back = float((back - data["sw"].double()).abs().max())
    if sw_back > 5e-4:
        fail(f"swaptions: cndf(inverse(u)) off u by {sw_back} > 5e-4")
    worst = {}
    for key, inputs, tol in (("streamcluster", "sc", 2e-4),
                             ("streamcluster_bf16", "sc_bf16", 1e-2),
                             ("streamcluster_f16", "sc_f16", 1e-2)):
        d = outs[key]
        if d.shape != (SC_M, SC_N) or d.dtype != torch.float32 \
                or not torch.isfinite(d).all() or float(d.min()) < 0:
            fail(f"{key}: output not finite non-negative float32 "
                 f"[{SC_M}, {SC_N}]")
        p, c = data[inputs]
        p, c = p[:128].double(), c.double()
        exact = ((p[:, None, :] - c[None]) ** 2).sum(-1)
        worst[key] = float((d[:128].double() - exact).abs().max())
        if not torch.allclose(d[:128].double(), exact, rtol=tol, atol=tol):
            fail(f"{key}: off the float64 distances by {worst[key]}")
    idx = outs["particlefilter"]
    cdf, q = data["host"]["pf"]
    want = np.minimum(np.searchsorted(cdf, q, side="left"), PF_N - 1)
    if idx.dtype != torch.int32 or not np.array_equal(idx.cpu().numpy(),
                                                      want):
        fail("particlefilter: differs from numpy's search of the CDF")
    # the shuffled CDF: numpy's count on 2,000 queries across the range
    every = PF_M // 2_000
    shuffled = data["host"]["pf_shuffled"]
    want = np.minimum((shuffled[None] < q[::every, None]).sum(1), PF_N - 1)
    got = outs["particlefilter_shuffled"]
    if got.dtype != torch.int32 or not np.array_equal(
            got[::every].cpu().numpy(), want):
        fail("particlefilter_shuffled: differs from numpy's count")
    locs, fan, ca, cb = (a[:20_000] if a.shape[0] == CA_B else a
                         for a in data["host"]["ca"])
    fl = locs[np.maximum(fan, 0)].astype(np.float64)
    for got, cand in zip(outs["canneal"], (ca, cb)):
        cost = np.where(fan >= 0, np.abs(fl - cand[:, None]).sum(-1),
                        0).sum(-1)
        if got.shape != (CA_B,) or not np.array_equal(
                got[:20_000].cpu().numpy().astype(np.float64), cost):
            fail("canneal: differs from the float64 host sums")
    for got, want in zip(outs["canneal_wide"], outs["canneal"]):
        if not torch.equal(got, want[:CA_WIDE_B]):
            fail(f"canneal: rows padded to {CA_WIDE_F} slots differ from "
                 f"the same rows at {CA_F}")
    print(f"phase 5 outputs: swaptions cndf round trip {sw_back:.3g} "
          f"(5e-4); streamcluster vs float64 on 128 rows "
          f"{worst['streamcluster']:.3g} (2e-4), bf16 "
          f"{worst['streamcluster_bf16']:.3g} (1e-2), f16 "
          f"{worst['streamcluster_f16']:.3g} (1e-2); particlefilter equal "
          f"to numpy searchsorted, shuffled equal to numpy's count on 2,000 "
          f"queries; canneal equal to float64 sums on 20,000 swaps, and "
          f"its first {CA_WIDE_B:,} rows padded to {CA_WIDE_F} slots (the "
          f"row kernel) equal to them at {CA_F}")

    # Jacobi-2D: the 4,000 sweeps again through numpy's float32 on the host
    # (same order of sums), then the plain version on the card
    grid = outs["jacobi2d"]
    if grid.shape != (J2_N, J2_N) or not torch.isfinite(grid).all():
        fail("jacobi2d: non-finite or misshapen output")
    a = data["host"]["j2"].copy()
    fifth = np.float32(0.2)
    for _ in range(J2_SWEEPS):
        a[1:-1, 1:-1] = fifth * (a[1:-1, 1:-1] + a[1:-1, :-2] + a[1:-1, 2:]
                                 + a[:-2, 1:-1] + a[2:, 1:-1])
    j2_err = float(np.abs(grid.cpu().numpy() - a).max())
    if j2_err > 1e-6:
        fail(f"jacobi2d: off numpy's {J2_SWEEPS} sweeps by {j2_err} > 1e-6")
    # each route against as many sweeps of the plain version, bit for bit:
    # the app in float32 and bfloat16 (one cluster launch each), PolyBench's
    # grid in float32 and bfloat16 (the tiled route) and one sweep of it
    # (the loop route), one float16 sweep
    for key, src, sweeps in (("jacobi2d", "j2", J2_SWEEPS),
                             ("jacobi2d_bf16", "j2_bf16", J2_SWEEPS),
                             ("jacobi2d_big", "j2_big", J2_BIG_SWEEPS),
                             ("jacobi2d_big_bf16", "j2_big_bf16",
                              J2_BIG_SWEEPS),
                             ("jacobi2d_big_step", "j2_big", 1),
                             ("jacobi2d_big_sweep", "j2_big", 1),
                             ("jacobi2d_f16_step", "j2_f16", 1)):
        plain = data[src]
        for _ in range(sweeps):
            plain = ref.jacobi2d(plain)
        if outs[key].dtype != plain.dtype or not torch.equal(outs[key],
                                                             plain):
            fail(f"{key}: {sweeps} kernel sweeps differ from the plain "
                 "version's")
    # pathfinder: numpy's row-by-row program on the host, the columns past
    # both ends at the Pallas kernel's float32 3.0e38; integer walls keep
    # every sum exact; the wall with a row of +inf, and the short wall
    for key, wall in (("pathfinder", data["host"]["path"]),
                      ("pathfinder_inf", data["host"]["path_inf"]),
                      ("pathfinder_short",
                       data["host"]["path"][:PATH_SHORT])):
        cost = wall[0].astype(np.float32)
        end = np.full(1, 3.0e38, np.float32)
        for row in wall[1:]:
            near = np.minimum(cost, np.minimum(
                np.concatenate([end, cost[:-1]]),
                np.concatenate([cost[1:], end])))
            cost = row.astype(np.float32) + near
        got = outs[key]
        if got.dtype != torch.float32 or not np.array_equal(
                got.cpu().numpy(), cost):
            fail(f"{key}: differs from numpy's row-by-row program")
    path_ends = int((outs["pathfinder_inf"] == 3.0e38).sum())
    if path_ends != 2 * (PATH_R - 1 - PATH_INF_ROW):
        fail(f"pathfinder_inf: {path_ends} columns at 3.0e38, not "
             f"{2 * (PATH_R - 1 - PATH_INF_ROW)}")
    # attention: float64 softmax on 64 query rows of the first and the last
    # (b, h); decoding: every (b, h) in float64, kv_len = 0 the mean of V
    att = {}
    for key, inputs, tol in (("flash_attention", "fa", 2e-4),
                             ("flash_attention_bf16", "fa_bf16", 2e-2),
                             ("flash_attention_llama", "fa_llama", 2e-2),
                             ("flash_attention_gemma", "fa_gemma", 2e-2),
                             ("flash_attention_gemma_f32", "fa_gemma_f32",
                              2e-4),
                             ("flash_attention_d512", "fa_d512", 2e-2),
                             ("flash_attention_d640", "fa_d640", 2e-2),
                             ("flash_attention_d640_f16", "fa_d640_f16",
                              2e-2),
                             ("flash_attention_f32_d512", "fa_f32_d512",
                              2e-4),
                             ("flash_attention_mixed", "fa_mixed", 2e-2)):
        q, k, v = data[inputs]
        o = outs[key]
        B, S, H, _ = q.shape
        if o.shape != q.shape or o.dtype != q.dtype \
                or not torch.isfinite(o).all():
            fail(f"{key}: output not finite {q.dtype} {tuple(q.shape)}")
        rows = torch.linspace(0, S - 1, 64, device=q.device).long()
        att[key] = 0.0
        for b, h in ((0, 0), (B - 1, H - 1)):
            want = attention_f64(torch, q[b, :, h], k[b, :, h], v[b, :, h],
                                 True, rows)
            got = o[b, rows, h].double()
            att[key] = max(att[key], float((got - want).abs().max()))
            if not torch.allclose(got, want, rtol=tol, atol=tol):
                fail(f"{key}: off float64 softmax attention by {att[key]}")
    da = {}
    for key, inputs, tol in (
            ("decode_attention", "da", 2e-4),
            ("decode_attention_f16", "da_f16", 2e-4 + 2.0 ** -10),
            ("decode_attention_d512", "da_d512", 2e-4 + 2.0 ** -7),
            ("decode_attention_mixed", "da_mixed", 2e-4)):
        q, k, v, lens = data[inputs]
        o = outs[key]
        if o.shape != q.shape or o.dtype != q.dtype \
                or not torch.isfinite(o).all():
            fail(f"{key}: non-finite or misshapen output")
        want = decode_f64(torch, q, k, v, lens)
        zero = lens <= 0
        da[key] = float((o.double() - want).abs().max())
        if key == "decode_attention":
            da_zero = float((o[zero].double() - want[zero]).abs().max())
        if not torch.allclose(o.double(), want, rtol=tol, atol=tol):
            fail(f"{key}: off float64 attention by {da[key]}")
    da_err = da["decode_attention"]
    print(f"phase 5 outputs: jacobi2d (cluster route, float32 and bfloat16; "
          f"tiled route at {J2_BIG} x {J2_BIG} x {J2_BIG_SWEEPS}, float32 and "
          "bfloat16; loop route, one sweep of it; the one-sweep kernel's "
          "vector route on it; its width-one route on a float16 sweep) equal "
          "to the plain version's sweeps; vs numpy's "
          f"{J2_SWEEPS} sweeps "
          f"{j2_err:.3g} (1e-6), equal to the plain version's sweeps; "
          f"pathfinder equal to numpy's row program (3.0e38 past the ends; "
          f"Rodinia's wall, its float32 copy with row {PATH_INF_ROW} all "
          f"+inf: {path_ends} columns at 3.0e38, the rest inf; its first "
          f"{PATH_SHORT} rows); flash attention vs "
          f"float64 on 2 x 64 rows {att['flash_attention']:.3g} (2e-4), "
          f"bf16 {att['flash_attention_bf16']:.3g} (2e-2), llama width "
          f"{att['flash_attention_llama']:.3g} (2e-2), gemma width (D 256) "
          f"{att['flash_attention_gemma']:.3g} (2e-2), in float32 "
          f"{att['flash_attention_gemma_f32']:.3g} (2e-4), D 512 "
          f"{att['flash_attention_d512']:.3g} (2e-2), D 640 "
          f"{att['flash_attention_d640']:.3g} (2e-2), D 640 in float16 "
          f"{att['flash_attention_d640_f16']:.3g} (2e-2), D 512 in float32 "
          f"{att['flash_attention_f32_d512']:.3g} (2e-4), mixed types "
          f"{att['flash_attention_mixed']:.3g} (2e-2); decoding vs float64 "
          f"{da_err:.3g} (2e-4), the kv_len = 0 batch vs the mean of V "
          f"{da_zero:.3g}, float16 cache "
          f"{da['decode_attention_f16']:.3g} (2e-4 + 2^-10), D 512 "
          f"{da['decode_attention_d512']:.3g} (2e-4 + 2^-7), mixed types "
          f"{da['decode_attention_mixed']:.3g} (2e-4)")

    # SSD scan: the float64 recurrence over the whole sequence of two (b, h)
    y = outs["ssd_scan"]
    x = data["ssd"][0]
    if y.shape != x.shape or y.dtype != x.dtype or not torch.isfinite(y).all():
        fail("ssd_scan: output not finite float32 [b, S, H, P]")
    ssd_err = 0.0
    t0 = time.perf_counter()
    for (b, h), args in data["host"]["ssd"].items():
        want = ssd_recurrence_f64(*args)
        got = y[b, :, h].double().cpu().numpy()
        ssd_err = max(ssd_err, float(np.abs(got - want).max()))
        if not np.allclose(got, want, rtol=4e-3, atol=4e-3):
            fail(f"ssd_scan: (b, h) = {(b, h)} off the float64 recurrence by "
                 f"{ssd_err}")
    print(f"phase 5 outputs: ssd_scan vs the float64 recurrence over all "
          f"{SSD_S} steps of (b, h) in {list(data['host']['ssd'])} "
          f"{ssd_err:.3g} (4e-3; |y| up to "
          f"{float(y.abs().max()):.3g}), {time.perf_counter() - t0:.1f} s")
    # the N-panel route: the plain version on the card and the float64
    # recurrence over two (b, h), 4e-3
    from repro_torch.kernels import ssd_scan as ssd_mod
    for key, dims in SSD_PANELS.items():
        y, args = outs[key], data[key]
        if y.shape != args[0].shape or not torch.isfinite(y).all():
            fail(f"{key}: output not finite float32 [b, S, H, P]")
        plain = ref.ssd_scan(*args, SSD_CHUNK)
        plain_err = float((y - plain).abs().max())
        f64_err = 0.0
        for (b, h), host in data["host"][key].items():
            want = ssd_recurrence_f64(*host)
            got = y[b, :, h].double().cpu().numpy()
            f64_err = max(f64_err, float(np.abs(got - want).max()))
            if not np.allclose(got, want, rtol=4e-3, atol=4e-3):
                fail(f"{key}: (b, h) = {(b, h)} off the float64 recurrence "
                     f"by {f64_err}")
        if not torch.allclose(y, plain, rtol=4e-3, atol=4e-3):
            fail(f"{key}: off the plain version by {plain_err}")
        pl = ssd_mod.plan(*dims[1:])
        print(f"phase 5 outputs: {key} (b, S, H, P, N = {dims}; "
              f"{-(-dims[4] // pl.panel)} N-panels of {pl.panel}) vs the "
              f"plain version {plain_err:.3g}, vs the float64 recurrence "
              f"over (b, h) in {list(data['host'][key])} {f64_err:.3g} "
              "(4e-3)")


def pyramid_host_split(torch, path_mod, wall) -> dict:
    """The pieces of a ``pathfinder.pyramid`` call on ``wall`` on the host:
    the wrapper whole, its checks, its plan, the output's allocation and
    the C entry's launch alone."""
    from repro_torch import _device
    R, C = wall.shape
    plan = path_mod.pyramid_plan(R, C)
    out = torch.empty(C, dtype=torch.float32, device=wall.device)
    lib = path_mod._lib()
    return {
        "wrapper": lambda: path_mod.pyramid(wall),
        "checks": lambda: path_mod._checked(wall, cuda=True),
        "plan": lambda: path_mod.pyramid_plan(R, C),
        "output": lambda: torch.empty(C, dtype=torch.float32,
                                      device=wall.device),
        "launch": lambda: _device.launch(
            lib.pathfinder_pyramid_launch, wall, wall.data_ptr(),
            int(wall.dtype == torch.int32), out.data_ptr(), None, R, C,
            plan.h, plan.ghost, plan.middle, plan.windows, plan.launches)}


def rows_host_split(torch, ca_mod, args) -> dict:
    """The pieces of a ``canneal.rows`` call on ``args`` on the host: the
    wrapper whole, its checks, its plan, the CTA count, the outputs'
    allocation and the C entry's launch alone."""
    from repro_torch import _device
    locs, fan = args[0], args[1]
    B, F = fan.shape
    plan = ca_mod.rows_plan(F)
    oa = torch.empty(B, dtype=torch.float32, device=locs.device)
    ob = torch.empty_like(oa)
    lib = ca_mod._lib()
    ptrs = [t.data_ptr() for t in args] + [oa.data_ptr(), ob.data_ptr()]
    ctas = ca_mod._ctas(locs.get_device())
    return {
        "wrapper": lambda: ca_mod.rows(*args),
        "checks": lambda: ca_mod._checked(*args),
        "plan": lambda: ca_mod.rows_plan(F),
        "CTA count": lambda: ca_mod._ctas(locs.get_device()),
        "outputs": lambda: (torch.empty(B, dtype=torch.float32,
                                        device=locs.device),
                            torch.empty(B, dtype=torch.float32,
                                        device=locs.device)),
        "launch": lambda: _device.launch(
            lib.swap_cost_rows_launch, locs, *ptrs, B, F, locs.shape[0],
            plan.tile, plan.chunk, plan.chunks, ctas)}


def suite_specs(torch, ref, data, mods):
    """What phase 6 runs for each suite kernel: the kernel, its plain
    version and the nearest single PyTorch call as closures, the bar, and
    the bytes and operations its bound counts (from these inputs)."""
    sw_k, sc_k, pf_k, ca_k, j2_k, path_k, fa_k, da_k, ssd_k = mods
    u = data["sw"]
    cdf, q = data["pf"]
    locs, fan, ca, cb = data["ca"]
    n_valid = int((fan >= 0).sum())
    specs = [dict(name="swaptions", kernel=lambda: sw_k(u),
                  plain=lambda: ref.cum_normal_inv(u),
                  library=lambda: torch.special.ndtri(u), tol=(1e-5, 1e-6),
                  peak=PEAK_F32_S, nbytes=SW_N * 8, ops=SW_N * SW_OPS,
                  per=25)]
    # streamcluster: float32 as 3xTF32 (three TF32 products a product, as
    # float32 attention is bounded), the 16-bit types on wgmma; the library
    # yardstick torch.cdist on the same operands, which returns the root
    # distance in the operands' type (TF32 off for float32)
    from repro_torch.kernels import streamcluster as sc_mod

    def cdist_or_reason(p, c):
        call = lambda: torch.cdist(p, c,
                                   compute_mode="use_mm_for_euclid_dist")
        try:
            call()
        except RuntimeError as e:
            return None, str(e).splitlines()[0][:120]
        return call, None

    for name, key, tol, peak in (
            ("streamcluster", "sc", 2e-4, PEAK_TF32_S / 3),
            ("streamcluster_bf16", "sc_bf16", 1e-2, PEAK_BF16_S),
            ("streamcluster_f16", "sc_f16", 1e-2, PEAK_BF16_S)):
        p, c = data[key]
        cdist, why = cdist_or_reason(p, c)
        specs.append(dict(
            name=name, kernel=lambda p=p, c=c: sc_k(p, c),
            plain=lambda p=p, c=c: ref.streamcluster_dist(p, c),
            library=cdist, library_none=why, tol=(tol, tol), peak=peak,
            nbytes=(SC_M + SC_N) * SC_D * p.element_size() + SC_M * SC_N * 4,
            ops=2 * SC_M * SC_N * SC_D + 2 * (SC_M + SC_N) * SC_D
            + 4 * SC_M * SC_N, per=10, route=sc_mod.path(p, c)))
    # and a bfloat16 view 3 elements into its buffer (no TMA: the plain-
    # load route), at the same shape
    p, c = data["sc_bf16"]
    p_off = torch.empty(p.numel() + 3, dtype=p.dtype,
                        device=p.device)[3:].view(p.shape).copy_(p)
    specs.append(dict(
        name="streamcluster_bf16_unaligned",
        kernel=lambda: sc_k(p_off, c),
        plain=lambda: ref.streamcluster_dist(p_off, c), library=None,
        library_none="the same call as streamcluster_bf16's",
        tol=(1e-2, 1e-2), peak=PEAK_BF16_S,
        nbytes=(SC_M + SC_N) * SC_D * 2 + SC_M * SC_N * 4,
        ops=2 * SC_M * SC_N * SC_D + 2 * (SC_M + SC_N) * SC_D
        + 4 * SC_M * SC_N, per=10, route=sc_mod.path(p_off, c)))
    # the particle filter: what these inputs need.  Rodinia's CDF is
    # monotone, so a search: the CDF read once, the queries read, the
    # indices written, and ceil(log2 N) compares a query; the shuffled CDF
    # is counted, N compares and adds a query (searchsorted does not
    # compute that function)
    from repro_torch.kernels import particlefilter as pf_mod
    took = lambda: ("search" if pf_mod.searched(pf_mod.find_index.last_flags)
                    else "count")
    shuffled = data["pf_shuffled"][0]
    specs.append(dict(
        name="particlefilter", kernel=lambda: pf_k(cdf, q),
        plain=lambda: ref.particlefilter_findindex(cdf, q),
        library=lambda: torch.searchsorted(cdf, q, out_int32=True),
        tol=None, peak=PEAK_F32_S, nbytes=(PF_N + 2 * PF_M) * 4,
        ops=PF_M * int(np.ceil(np.log2(PF_N))), per=10, device_time=True,
        took=took, want_path="search"))
    specs.append(dict(
        name="particlefilter_shuffled", kernel=lambda: pf_k(shuffled, q),
        plain=lambda: ref.particlefilter_findindex(shuffled, q),
        library=None, tol=None, peak=PEAK_F32_S,
        nbytes=(PF_N + 2 * PF_M) * 4, ops=2 * PF_N * PF_M, per=10,
        took=took, want_path="count"))
    # canneal on the route of its 22 slots (the tile kernel), and the row
    # kernel on the same inputs (the kernel the tile kernel replaced; the
    # main path's call to it is the rows padded to CA_WIDE_F slots)
    from repro_torch.kernels import canneal as ca_mod
    wide = data["ca_wide"]
    for name, fn in (("canneal", ca_k), ("canneal_rows", ca_mod.rows)):
        specs.append(dict(
            name=name, kernel=lambda fn=fn: fn(locs, fan, ca, cb),
            plain=lambda: ref.canneal_swap_cost(locs, fan, ca, cb),
            library=None, tol=(1e-6, 0.0), peak=PEAK_F32_S,
            nbytes=CA_N * 8 + CA_B * CA_F * 4 + 2 * CA_B * 8 + 2 * CA_B * 4,
            ops=n_valid * CA_OPS, per=25, device_time=fn is not ca_k,
            l2_flushed=fn is not ca_k,
            route=ca_mod.route(CA_F) if fn is ca_k else
            f"rows, {ca_mod.rows_plan(CA_F)}"))
    specs[-1].update(
        timed_on=f"PARSEC simlarge's {CA_B:,} swaps x {CA_F} slots (the "
        f"main path's call: its first {CA_WIDE_B:,} rows padded to "
        f"{CA_WIDE_F} slots, ms_wide, {ca_mod.rows_plan(CA_WIDE_F)})",
        also_timed={"ms_wide": lambda: ca_mod.rows(*wide)},
        host_split=rows_host_split(torch, ca_mod, wide),
        # the bound of that call: its inputs and outputs, its valid slots
        main_bound=("ms_wide",
                    CA_N * 8 + CA_WIDE_B * CA_WIDE_F * 4 + 2 * CA_WIDE_B * 8
                    + 2 * CA_WIDE_B * 4,
                    int((wide[1] >= 0).sum()) * CA_OPS))
    # Jacobi-2D's one sweep on its vector route (PolyBench's grid in three
    # types) and on its width-one route (the odd grid, and the float16 view
    # one point into its buffer)
    from repro_torch.kernels import jacobi2d as j2_mod
    for name, key in (("jacobi2d", "j2_big"),
                      ("jacobi2d_bf16", "j2_big_bf16"),
                      ("jacobi2d_f16", "j2_big_f16"),
                      ("jacobi2d_width1", "j2_odd"),
                      ("jacobi2d_width1_bf16", "j2_odd_bf16"),
                      ("jacobi2d_width1_view", "j2_view_f16")):
        g = data[key]
        width = j2_mod.step_width(g.shape[1], g.dtype, g.data_ptr())
        specs.append(dict(
            name=name, kernel=lambda g=g: j2_k(g),
            plain=lambda g=g: ref.jacobi2d(g), library=None, tol=None,
            peak=PEAK_F32_S, nbytes=g.numel() * 2 * g.element_size(),
            ops=J2_OPS * (g.shape[0] - 2) * (g.shape[1] - 2), per=25,
            route=f"{'vector' if width > 1 else 'width-one'} route, "
            f"{width} point(s) a chunk, {g.dtype}"))
        if name == "jacobi2d_width1":
            # its main-path call is RiVec's float16 164 x 164 sweep
            specs[-1].update(
                timed_on=f"a {J2_ODD[0]:,} x {J2_ODD[1]:,} float32 grid (the "
                f"main path's call: RiVec's float16 {J2_N} x {J2_N} sweep, "
                "ms_main)",
                also_timed={"ms_main": lambda: j2_k(data["j2_f16"])})
    # Jacobi-2D's many-sweep routes: the app's 4,000 sweeps of 164 x 164 on
    # the cluster route (one launch), PolyBench's 1,000 of 2,800 x 2,800 on
    # the tiled route (8 sweeps a launch) in float32 and bfloat16 and on the
    # loop route (one launch a sweep, the route the tiled one replaced); the
    # grid read once and written once, 5 operations an interior point a
    # sweep
    for name, key, sweeps, fn in (
            ("jacobi2d_cluster", "j2", J2_SWEEPS, j2_mod.jacobi2d),
            ("jacobi2d_tiled", "j2_big", J2_BIG_SWEEPS, j2_mod.jacobi2d),
            ("jacobi2d_tiled_bf16", "j2_big_bf16", J2_BIG_SWEEPS,
             j2_mod.jacobi2d),
            ("jacobi2d_loop", "j2_big", J2_BIG_SWEEPS, j2_mod.loop)):
        g = data[key]
        specs.append(dict(
            name=name, kernel=lambda g=g, k=sweeps, fn=fn: fn(g, k),
            plain=lambda g=g, k=sweeps: ref.jacobi2d(g, k), library=None,
            tol=None, peak=PEAK_F32_S, nbytes=g.numel() * 2 * g.element_size(),
            ops=J2_OPS * (g.shape[0] - 2) * (g.shape[1] - 2) * sweeps, per=1,
            plain_reps=1))
    # pathfinder on the plan's strip route, and the pyramid route on the
    # same wall in the same run (41 launches of 40 rows)
    from repro_torch.kernels import pathfinder as path_mod
    wall = data["path"]
    for name, fn in (("pathfinder", path_k), ("pathfinder_pyramid",
                                              path_mod.pyramid)):
        specs.append(dict(
            name=name, kernel=lambda fn=fn: fn(wall),
            plain=lambda: ref.pathfinder(wall), library=None, tol=None,
            peak=PEAK_F32_S, nbytes=PATH_R * PATH_C * 4 + PATH_C * 4,
            ops=PATH_OPS * (PATH_R - 1) * PATH_C, per=5, plain_reps=2,
            device_time=fn is not path_k, device_per=25,
            l2_flushed=fn is not path_k,
            route=(path_mod.route(PATH_R, PATH_C, *path_mod.card(wall.device))
                   if fn is path_k
                   else f"pyramid, {path_mod.pyramid_plan(PATH_R, PATH_C)}")))
    # the pyramid's main-path call is the wall's first PATH_SHORT rows
    specs[-1].update(
        timed_on=f"Rodinia's {PATH_R:,} x {PATH_C:,} wall, "
        f"{path_mod.pyramid_plan(PATH_R, PATH_C).launches} launches a call "
        f"(the main path's call: its first {PATH_SHORT} rows, "
        f"{path_mod.pyramid_plan(PATH_SHORT, PATH_C).launches} launch, "
        "ms_short)",
        also_timed={"ms_short": lambda: path_mod.pyramid(wall[:PATH_SHORT])},
        host_split=pyramid_host_split(torch, path_mod, wall[:PATH_SHORT]),
        main_bound=("ms_short", PATH_SHORT * PATH_C * 4 + PATH_C * 4,
                    PATH_OPS * (PATH_SHORT - 1) * PATH_C))
    # attention: 4 D flops a kept (query, key) pair on the tensor cores
    # (3 TF32 products each in float32, beside the float32 SIMT rate the
    # earlier slices bounded it by), and one exponential a pair
    from repro_torch.kernels import _promote
    from repro_torch.kernels import decode_attention as da_mod
    from repro_torch.kernels import flash_attention as fa_mod
    sdpa = torch.nn.functional.scaled_dot_product_attention

    def library_or_none(call):
        """``call`` where one PyTorch call computes the function at these
        operands (SDPA may refuse a width), else None."""
        try:
            call()
        except RuntimeError:
            return None
        return call

    # enough calls a sample that the wrapper's ~0.05 ms of host time a
    # call overlaps the device work of the call before (one call a sample
    # would time the host's issue gap too)
    for name, key, tol, per, plain_reps in (
            ("flash_attention", "fa", 2e-4, 20, 5),
            ("flash_attention_bf16", "fa_bf16", 2e-2, 20, 5),
            ("flash_attention_f16", "fa_f16", 2e-2, 20, 5),
            ("flash_attention_llama", "fa_llama", 2e-2, 5, 2),
            ("flash_attention_gemma", "fa_gemma", 2e-2, 5, 2),
            ("flash_attention_gemma_f16", "fa_gemma_f16", 2e-2, 5, 2),
            ("flash_attention_gemma_f32", "fa_gemma_f32", 2e-4, 5, 2),
            ("flash_attention_d512", "fa_d512", 2e-2, 5, 2),
            ("flash_attention_d640", "fa_d640", 2e-2, 10, 2),
            ("flash_attention_d640_f16", "fa_d640_f16", 2e-2, 10, 2),
            ("flash_attention_f32_d512", "fa_f32_d512", 2e-4, 2, 2),
            ("flash_attention_mixed", "fa_mixed", 2e-2, 20, 5)):
        fq, fk, fv = data[key]
        B, S, H, D = fq.shape
        pairs = B * H * S * (S + 1) // 2
        (pq, pk, pv), out_dtype = _promote.promote((fq, fk, fv),
                                                   fa_mod.DTYPES)
        f32 = pq.dtype == torch.float32
        same = fq.dtype == fk.dtype == fv.dtype
        specs.append(dict(
            name=name, kernel=lambda q=fq, k=fk, v=fv: fa_k(q, k, v, True),
            plain=lambda q=pq, k=pk, v=pv, t=out_dtype: _promote.restore(
                ref.flash_attention(q, k, v, True), t),
            library=None if not same else library_or_none(
                lambda q=fq, k=fk, v=fv: sdpa(
                    q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                    is_causal=True)),
            tol=(tol, tol), peak=PEAK_TF32_S / 3 if f32 else PEAK_BF16_S,
            nbytes=sum(t.numel() * t.element_size() for t in (fq, fk, fv))
            + fq.numel() * fq.element_size(),
            ops=4 * D * pairs, per=per, plain_reps=plain_reps,
            exps=pairs, path=fa_mod.path(pq, pk, pv),
            simt_ms=4 * D * pairs / PEAK_F32_S * 1e3 if f32 else None))
    # decoding: what these lengths need, the K and V rows below kv_len (4*D
    # flops a key), and at kv_len <= 0 the S rows of V alone (2*D flops a
    # key); float32, a bfloat16 and a float16 q and cache (2e-4 plus one
    # unit of the 16-bit type), bfloat16 at D 512, and mixed types (q
    # float32, k bfloat16, v float16: the cache widened to float32 first)
    def kv_rows_and_ops(lens, S, D):
        """(K rows, V rows, operations) a head of these lengths needs."""
        k_rows = v_rows = ops_ = 0
        for n in lens:
            if n > 0:
                k_rows += min(int(n), S)
                v_rows += min(int(n), S)
                ops_ += 4 * D * min(int(n), S)
            else:
                v_rows += S
                ops_ += 2 * D * S
        return k_rows, v_rows, ops_

    for name, key, lens_key, tol in (
            ("decode_attention", "da", "da_lens", 2e-4),
            ("decode_attention_bf16", "da_bf16", "da_lens", 2e-4 + 2.0 ** -7),
            ("decode_attention_f16", "da_f16", "da_lens", 2e-4 + 2.0 ** -10),
            ("decode_attention_d512", "da_d512", "da_lens_d512",
             2e-4 + 2.0 ** -7),
            ("decode_attention_mixed", "da_mixed", "da_lens", 2e-4)):
        dq, dk, dv, lens = data[key]
        B, S, H, D = dk.shape
        k_rows, v_rows, da_ops = kv_rows_and_ops(data["host"][lens_key], S,
                                                 D)
        mask = (torch.arange(S, device=dq.device)[None, :]
                < lens[:, None])[:, None, None, :]
        (pq,), out_dtype = _promote.promote((dq,), da_mod.DTYPES)
        (pk, pv), _ = _promote.promote((dk, dv), da_mod.DTYPES)
        same = dq.dtype == dk.dtype == dv.dtype
        specs.append(dict(
            name=name, kernel=lambda a=data[key]: da_k(*a),
            plain=lambda a=(pq, pk, pv, lens), t=out_dtype: _promote.restore(
                ref.decode_attention(*a), t),
            library=None if not same else library_or_none(
                lambda dq=dq, dk=dk, dv=dv, mask=mask: sdpa(
                    dq[:, :, None], dk.transpose(1, 2), dv.transpose(1, 2),
                    attn_mask=mask)),
            tol=(tol, tol), peak=PEAK_F32_S,
            nbytes=(k_rows * dk.element_size() + v_rows * dv.element_size())
            * H * D + 2 * dq.numel() * dq.element_size() + B * 4,
            ops=da_ops * H, per=10, device_time=True))
    # decoding's two kernels alone at the app's float32 shape: the split
    # kernel (the cache rows below kv_len, and its workspace written) and
    # the combine (the workspace's splits below kv_len read, the output
    # written)
    dq, dk, dv, lens = data["da"]
    pl = da_mod.plan_for(dq, dk, dv)
    ws = da_mod.split(dq, dk, dv, lens, pl)
    out = torch.empty_like(dq)
    k_rows, v_rows, da_ops = kv_rows_and_ops(data["host"]["da_lens"], DA_S,
                                             DA_D)
    n_valid = sum(-(-(DA_S if n <= 0 else min(int(n), DA_S)) // pl.len)
                  for n in data["host"]["da_lens"])
    specs.append(dict(
        name="decode_attention_split",
        kernel=lambda: da_mod.split(dq, dk, dv, lens, pl),
        plain=lambda: da_mod.split_plain(dq, dk, dv, lens, pl), library=None,
        tol=(2e-4, 2e-4), peak=PEAK_F32_S,
        nbytes=(k_rows + v_rows) * DA_H * DA_D * 4 + dq.numel() * 4
        + DA_B * 4 + ws.numel() * 4, ops=da_ops * DA_H, per=10,
        device_time=True))
    specs.append(dict(
        name="decode_attention_combine",
        kernel=lambda: da_mod.combine(ws, lens, pl, DA_S, out),
        plain=lambda: da_mod.combine_plain(ws, lens, pl, DA_S, dq.shape,
                                           dq.dtype), library=None,
        tol=(1e-6, 1e-6), peak=PEAK_F32_S,
        nbytes=n_valid * DA_H * (DA_D + 2) * 4 + DA_B * 4 + dq.numel() * 4,
        ops=n_valid * DA_H * (2 * DA_D + 4), per=20, device_time=True))
    # SSD scan: the chunked form at chunk length q does, per (b, chunk),
    # C.B^T on the causal triangle once (the heads share it) and per head
    # the decay block (one exp, one multiply a pair), its product with x dt,
    # the carried state's term and the state update (2 q P N each).  The
    # result depends on q only through rounding and the count falls with q
    # (to the recurrence's ~4 P N a step at q = 1), so the bound takes the
    # least count over the q that divide S, not the caller's chunk
    def ssd_ops_at(q, b, S, H, P, N):
        tri = q * (q + 1) // 2
        return b * (S // q) * (
            2 * tri * N + H * (2 * tri + 2 * tri * P + 4 * q * P * N))
    # The kernels run every product as 3xTF32 on the tensor cores, so the
    # operations bound is three TF32 products a product at 495 TFLOP/s, as
    # for float32 attention (phase 6 prints the FMA pipes' one beside it).
    # Each row also times the kernels' three passes alone: the chunk pass,
    # the state pass (in place on a buffer of start states: the same
    # traffic every call) and the output pass.
    from repro_torch.kernels import ssd_scan as ssd_mod
    for name, key in (("ssd_scan", "ssd"), ("ssd_scan_p256", "ssd_wide")):
        x, dt, A, B, C = args = data[key]
        dims = (*x.shape, B.shape[-1])
        ssd_ops = min(ssd_ops_at(q, *dims) for q in range(1, dims[1] + 1)
                      if dims[1] % q == 0)
        ssd_pl = ssd_mod.plan(*dims[1:])
        Z, seg = ssd_mod.chunk_states(x, dt, A, B, ssd_pl)
        ssd_mod.state_pass(Z, seg)
        specs.append(dict(
            name=name, kernel=lambda a=args: ssd_k(*a, SSD_CHUNK),
            plain=lambda a=args: ref.ssd_scan(*a, SSD_CHUNK), library=None,
            tol=(4e-3, 4e-3), peak=PEAK_TF32_S / 3,
            nbytes=2 * x.numel() * 4
            + sum(t.numel() * 4 for t in (dt, A, B, C)),
            ops=ssd_ops, per=1, plain_reps=2,
            passes=(("chunk pass", lambda a=args, pl=ssd_pl:
                     ssd_mod.chunk_states(*a[:4], pl)),
                    ("state pass", lambda Z=Z, seg=seg:
                     ssd_mod.state_pass(Z, seg)),
                    ("output pass", lambda a=args, Z=Z, pl=ssd_pl:
                     ssd_mod.output_pass(*a, Z, pl)))))
    # the N-panel route (its four passes in one call), bound as above
    for key in SSD_PANELS:
        x, dt, A, B, C = args = data[key]
        dims = (*x.shape, B.shape[-1])
        specs.append(dict(
            name=key, kernel=lambda a=args: ssd_k(*a, SSD_CHUNK),
            plain=lambda a=args: ref.ssd_scan(*a, SSD_CHUNK), library=None,
            tol=(4e-3, 4e-3), peak=PEAK_TF32_S / 3,
            nbytes=2 * x.numel() * 4
            + sum(t.numel() * 4 for t in (dt, A, B, C)),
            ops=min(ssd_ops_at(q, *dims) for q in range(1, dims[1] + 1)
                    if dims[1] % q == 0), per=2, plain_reps=2))
    return specs


SPLIT_STAGES = ("body lookup", "pack", "H2D copy", "launch", "D2H copy",
                "runtime derivation")


def warm_sweep_split(torch, eng, suite, tracegen, engine_scan, names, study,
                     dev, reps: int = 5) -> dict:
    """The warm ``sweep_all(names)`` taken apart into its stages, each on
    the host clock (median of ``reps`` passes, each beside one whole warm
    ``sweep_all`` call): the configs and the cached loop bodies, ``pack`` on
    the host, the operands' copy to the card, the scan launch (both
    kernels, synchronized), the copy back, and the runtime derivation
    (steady-state time, scalar baseline, speedup).  The stages are
    ``suite.speedup_batch``'s, called one by one; the cells must equal
    ``sweep_all``'s bit for bit."""
    grid = [(m, l) for m in (8, 16, 32, 64, 128, 256) for l in (1, 2, 4, 8)]
    times = {k: [] for k in SPLIT_STAGES}
    whole = []
    for _ in range(reps):
        t0 = time.perf_counter()
        suite.sweep_all(names)
        torch.cuda.synchronize()
        whole.append((time.perf_counter() - t0) * 1e3)
        t = [time.perf_counter()]
        pairs = [(a, eng.VectorEngineConfig(mvl=m, lanes=l))
                 for a in names for m, l in grid]
        bodies = [tracegen.body_for(a, suite.effective_mvl(a, c), c)
                  for a, c in pairs]
        t.append(time.perf_counter())
        host = eng.pack_steady_state(bodies, [c for _, c in pairs], 8, 24,
                                     torch.device("cpu"))
        t.append(time.perf_counter())
        inp = eng.ScanInputs(*(x.to(dev) for x in host.args()))
        torch.cuda.synchronize()
        t.append(time.perf_counter())
        out = engine_scan.scan(*inp.args())
        torch.cuda.synchronize()
        t.append(time.perf_counter())
        out = out.cpu().numpy()
        t.append(time.perf_counter())
        flat = []
        for b, ((a, c), body) in enumerate(zip(pairs, bodies)):
            steady = (float(out[0, b]) - float(out[5, b])) / 24
            flat.append(suite.scalar_runtime_ns(a, c)
                        / suite.vector_runtime_from_per_chunk(a, c, body,
                                                              steady))
        t.append(time.perf_counter())
        for k, t0, t1 in zip(SPLIT_STAGES, t, t[1:]):
            times[k].append((t1 - t0) * 1e3)
    want = [study[a][g] for a in names for g in grid]
    if flat != want:
        fail("warm sweep split: the stages' cells differ from sweep_all's")
    med = {k: statistics.median(v) for k, v in times.items()}
    print(f"phase 4 warm {len(want)}-cell sweep split (host ms, median of "
          f"{reps}): " + ", ".join(f"{k} {v:.3f}" for k, v in med.items())
          + f"; sum {sum(med.values()):.3f} against a whole warm sweep_all's "
          f"{statistics.median(whole):.3f} (median of {reps}: "
          + ", ".join(f"{w:.1f}" for w in whole) + ")")
    return med


def scalar_fold_time(sp, ve, names) -> None:
    """The scalar baseline's fold (the port of ``scalar_pipeline._scan_core``,
    plain torch on the host: six steps need no kernel) over the golden
    table's cells, cold: host time, folds and steps, beside one batched fold
    of every pair, which must give the same bits."""
    pairs = [(a, c) for a in names for c in ve.TABLE10]
    sp._runtime_cached.cache_clear()
    t0 = time.perf_counter()
    cold = [sp.scalar_runtime_ns(a, c) for a, c in pairs]
    cold_ms = (time.perf_counter() - t0) * 1e3
    folds = sp._runtime_cached.cache_info().misses
    t0 = time.perf_counter()
    batch = sp.scalar_runtime_ns_batch(*zip(*pairs))
    batch_ms = (time.perf_counter() - t0) * 1e3
    if batch != cold:
        fail("scalar baseline: the batched fold differs from the memoized one")
    steps = len(sp.SEG_CLASSES)
    print(f"phase 4 scalar baseline (the port of scalar_pipeline._scan_core, "
          f"host): {len(pairs)} cells in {cold_ms:.3f} ms cold, {folds} "
          f"folds x {steps} steps = {folds * steps} steps (memoized per app "
          f"and scalar core); one batched fold of all {len(pairs)} pairs "
          f"{batch_ms:.3f} ms")


def run_suite_kernel(torch, spec, sm_clock_hz: float,
                     label: str = "phase 6") -> dict:
    """Hold one suite kernel against its plain version on the card (exactly
    where ``tol`` is None; against ``want`` where the spec gives one, each
    row of the last axis within ``tol`` of that row's norm where ``rows``
    is set), then time the kernel, the plain version and the library call,
    and bound the kernel from its bytes and operations."""
    name = spec["name"]
    got, want = spec["kernel"](), spec.get("want", spec["plain"])()
    torch.cuda.synchronize()
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    err = max(float((g.double() - w.double()).abs().max())
              for g, w in zip(got, want))
    extra = {}
    if spec["tol"] is None:
        ok = all(torch.equal(g, w) for g, w in zip(got, want))
    elif spec.get("rows"):
        # each row's error over its norm, or over the median row's norm
        # where the spec floors the norms there (rows whose exact value is
        # ~0 by cancellation)
        def row_err(g, w):
            norms = w.double().norm(dim=-1)
            floor = norms.median() if spec.get("row_floor") else 1e-30
            return float(((g.double() - w.double()).norm(dim=-1)
                          / norms.clamp_min(floor)).max())
        extra["row_rel_err"] = max(row_err(g, w) for g, w in zip(got, want))
        ok = extra["row_rel_err"] <= spec["tol"]
        print(f"{label} {name}: worst row's error "
              f"{extra['row_rel_err']:.4g} of its norm (bar {spec['tol']:g})"
              f" against {spec['want_is']}")
    else:
        rtol, atol = spec["tol"]
        ok = all(torch.allclose(g, w, rtol=rtol, atol=atol)
                 for g, w in zip(got, want))
    if not ok:
        fail(f"{name} kernel vs plain: max abs err {err}, "
             + (f"worst row {extra['row_rel_err']} of its norm "
                if spec.get("rows") else "")
             + f"(bar {spec['tol'] or 'exact'})")
    if "took" in spec:
        # the particle filter's flags: which path that call took
        extra["path"] = spec["took"]()
        if extra["path"] != spec["want_path"]:
            fail(f"{name}: took the {extra['path']} path, not the "
                 f"{spec['want_path']} path")
    timed = lambda fn: cuda_ms(torch, fn, reps=10, per=spec["per"])
    ms = timed(spec["kernel"])
    plain_reps = spec.get("plain_reps", 5)
    plain_ms = cuda_ms(torch, spec["plain"], reps=plain_reps,
                       warmup=min(2, plain_reps - 1))
    lib_ms = timed(spec["library"]) if spec["library"] else None
    t_bytes = spec["nbytes"] / PEAK_BYTES_S
    t_ops = spec["ops"] / spec["peak"]
    # a second kind of operation, on its own unit: exponentials
    t_exp = spec.get("exps", 0) / (MUFU_PER_CLOCK_SM * N_SM * sm_clock_hz)
    bound_ms = max(t_bytes, t_ops, t_exp) * 1e3
    bound_by = "bytes" if t_bytes >= max(t_ops, t_exp) else "operations"
    lib = "none" if lib_ms is None else f"{lib_ms:.4f} ms"
    if lib_ms is None and spec.get("library_none"):
        lib += f" ({spec['library_none']})"
    bar = ("rows, above" if spec.get("rows")
           else spec["tol"] or "exact")
    print(f"{label} {name}: max_abs_err={err:.3g} (bar {bar}) kernel "
          f"{ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms, library {lib}, bound {bound_ms:.4f} ms "
          f"({bound_by}; {spec['nbytes'] / 1e6:.1f} MB, "
          f"{spec['ops'] / 1e9:.3f} G ops)")
    spun = lambda fn: device_ms(torch, fn, reps=10,
                                per=spec.get("device_per", spec["per"]),
                                sm_clock_hz=sm_clock_hz)
    if spec.get("device_time"):
        # a call whose host issue may exceed its device time: the times
        # above are back-to-back calls, as every row's; these are the
        # device's alone, behind a spin
        extra["device_ms"] = spun(spec["kernel"])
        lib_dev = spun(spec["library"]) if spec["library"] else None
        extra["library_device_ms"] = lib_dev
        print(f"{label} {name}: device time behind a spin: kernel "
              f"{extra['device_ms']:.4f} ms, library "
              + ("none" if lib_dev is None else f"{lib_dev:.4f} ms")
              + f"; host issue {host_issue_ms(torch, spec['kernel'], per=20):.4f}"
              " ms a call")
    cold = lambda fn: cold_device_ms(torch, fn, reps=25,
                                     sm_clock_hz=sm_clock_hz)
    if spec.get("l2_flushed"):
        # inputs that fit the 50 MB L2: back to back they are read from
        # it; these device times have it flushed before each call
        extra["cold_ms"] = cold(spec["kernel"])
        print(f"{label} {name}: device time with L2 flushed before each "
              f"call: kernel {extra['cold_ms']:.4f} ms")
    if "path" in extra:
        print(f"{label} {name}: path {extra['path']} (the kernel's flags)")
    if "route" in spec:
        print(f"{label} {name}: route {spec['route']}")
    if "timed_on" in spec:
        # what "ms" timed, where it is not the main path's call, and that
        # call's own time
        extra["timed_on"] = spec["timed_on"]
        for key, fn in spec["also_timed"].items():
            extra[key] = timed(fn)
            if spec.get("device_time"):
                # and that call's device time behind a spin, and its host
                # issue
                extra[f"{key}_device"] = spun(fn)
                extra[f"{key}_issue"] = host_issue_ms(torch, fn, per=20)
            if spec.get("l2_flushed"):
                extra[f"{key}_cold"] = cold(fn)
        print(f"{label} {name}: ms timed on {spec['timed_on']}; "
              + ", ".join(f"{k} {extra[k]:.4f}" + (
                  f" [device {extra[k + '_device']:.4f}; host issue "
                  f"{extra[k + '_issue']:.4f}]" if k + "_device" in extra
                  else "") + (
                  f" {{L2 flushed {extra[k + '_cold']:.4f}}}"
                  if k + "_cold" in extra else "")
                  for k in spec["also_timed"]))
    if "host_split" in spec:
        # the host time of the main path's call, piece by piece
        extra["host_split_us"] = {k: host_us(torch, fn)
                                  for k, fn in spec["host_split"].items()}
        print(f"{label} {name}: the main path's call on the host (us a "
              "call, mean of 2,000): " + ", ".join(
                  f"{k} {t:.2f}" for k, t in extra["host_split_us"].items()))
    if "main_bound" in spec:
        # bound_ms is for the inputs "ms" timed; this is the main path's
        # call's own (the same rule: bytes once, its operations)
        key, nbytes, n_ops = spec["main_bound"]
        mb, mo = nbytes / PEAK_BYTES_S, n_ops / spec["peak"]
        extra["bound_main_ms"] = max(mb, mo) * 1e3
        extra["bound_main_by"] = "bytes" if mb >= mo else "operations"
        dev, cold_dev = extra.get(f"{key}_device"), extra.get(f"{key}_cold")
        print(f"{label} {name}: the main path's call ({key} "
              f"{extra[key]:.4f} ms): bound {extra['bound_main_ms']:.4f} ms "
              f"({extra['bound_main_by']}; {nbytes / 1e6:.1f} MB, "
              f"{n_ops / 1e9:.4f} G ops), "
              f"{extra['bound_main_ms'] / extra[key]:.1%} of it"
              + ("" if dev is None else
                 f", {extra['bound_main_ms'] / dev:.1%} of its device time "
                 f"{dev:.4f} ms")
              + ("" if cold_dev is None else
                 f", {extra['bound_main_ms'] / cold_dev:.1%} of it with L2 "
                 f"flushed ({cold_dev:.4f} ms)"))
    if "passes" in spec:
        extra["pass_ms"] = {n: cuda_ms(torch, fn, reps=5)
                            for n, fn in spec["passes"]}
        print(f"{label} {name}: passes "
              + ", ".join(f"{n} {t:.4f} ms"
                          for n, t in extra["pass_ms"].items())
              + f" (sum {sum(extra['pass_ms'].values()):.4f} ms); bytes "
              f"bound {t_bytes * 1e3:.4f} ms, operations bound "
              f"{t_ops * 1e3:.4f} ms as 3xTF32 at 495 TFLOP/s, "
              f"{spec['ops'] / PEAK_F32_S * 1e3:.4f} ms on the FMA pipes "
              "at 67 TFLOP/s")
    if "path" in spec:
        simt = ("" if spec["simt_ms"] is None else
                f"; float32 SIMT bound {spec['simt_ms']:.4f} ms at 67 TFLOP/s")
        # the wrapper's host time a call (checks, path choice, tensor maps
        # on the TMA path, launch), which a lone call adds to its time
        issue_ms = host_issue_ms(torch, spec["kernel"], per=20)
        print(f"{label} {name}: path {spec['path']}, host issue "
              f"{issue_ms:.4f} ms a call, "
              f"{spec['ops'] / ms / 1e9:.1f} TFLOP/s, tensor bound "
              f"{t_ops * 1e3:.4f} ms, exponential co-bound "
              f"{t_exp * 1e3:.4f} ms ({spec['exps'] / 1e6:.1f} M exps at "
              f"{MUFU_PER_CLOCK_SM * N_SM * sm_clock_hz / 1e12:.2f} T/s)"
              f"{simt}")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": lib_ms,
            **extra}


def jacobi_routes(torch, j2_mod, ops, small, j2_app_s, sm_clock_hz) -> None:
    """Jacobi-2D at the app's 164 x 164: the old loop (4,000 one-sweep
    launches) beside the cluster route (one launch), each in wall and
    device time; the cluster route under every cluster size; one cluster
    barrier (a grid of no interior column: empty sweeps) and the floor it
    sets; the cluster route beside the loop route on float32 grids of 256
    to 512 rows, on the widest float32 and bfloat16 grids the plan gives
    the cluster and on a bfloat16 one past it."""
    def old_loop():
        g = small
        for _ in range(J2_SWEEPS):
            g = j2_mod.jacobi2d_step(g)
        return g

    launch_ms = device_ms(torch, lambda: j2_mod.jacobi2d_step(small),
                          reps=10, per=25, sm_clock_hz=sm_clock_hz)
    step_launches = lambda: (j2_mod.jacobi2d_step.launches
                             + j2_mod.jacobi2d_step.width1_launches)
    before = step_launches()
    old_wall = wall_clock_ms(torch, old_loop, reps=3)
    old_launches = (step_launches() - before) // 3
    route = lambda: ops.jacobi2d(small, iters=J2_SWEEPS)
    before = j2_mod.jacobi2d.launches
    new_wall = wall_clock_ms(torch, route, reps=5)
    new_launches = (j2_mod.jacobi2d.launches - before) // 5
    new_dev = cuda_ms(torch, route, reps=5)
    print(f"phase 6 jacobi2d app ({J2_N} x {J2_N}, {J2_SWEEPS} sweeps): "
          f"old loop {old_wall:.3f} ms wall, {launch_ms * J2_SWEEPS:.3f} ms "
          f"device ({launch_ms:.5f} ms a launch behind a spin), "
          f"{old_launches} launches; cluster route {new_wall:.3f} ms wall, "
          f"{new_dev:.3f} ms device, {new_launches} launch; phase 5's call "
          f"{j2_app_s * 1e3:.3f} ms wall")
    rt = j2_mod.route(*small.shape, small.dtype)
    sizes = {n: cuda_ms(torch, lambda n=n: j2_mod.cluster(
        small, J2_SWEEPS, n, j2_mod.route(J2_N, J2_N, small.dtype, n).k),
        reps=5) for n in (1, 2, 4, 8, 16)}
    print(f"phase 6 jacobi2d cluster sizes at the app's grid (the plan: "
          f"{rt.ctas} CTAs, k = {rt.k}): " + ", ".join(
              f"{n} CTAs {t:.3f} ms" for n, t in sizes.items()))
    ks = {k: cuda_ms(torch, lambda k=k: j2_mod.cluster(
        small, J2_SWEEPS, 16, k), reps=5) for k in (1, 2, 3, 4, 6, 8, 11)}
    print("phase 6 jacobi2d sweeps between cluster barriers at the app's "
          "grid, 16 CTAs: " + ", ".join(f"k = {k} {t:.3f} ms"
                                        for k, t in ks.items()))
    empty = torch.zeros(J2_N, 2, device=small.device)
    full = cuda_ms(torch, lambda: j2_mod.cluster(empty, J2_SWEEPS, 16, 1),
                   reps=5)
    none = cuda_ms(torch, lambda: j2_mod.cluster(empty, 0, 16, 1), reps=5)
    barrier_us = (full - none) / J2_SWEEPS * 1e3
    barriers = -(-J2_SWEEPS // rt.k)
    print(f"phase 6 jacobi2d one cluster barrier (16 CTAs, empty sweeps of "
          f"a {J2_N} x 2 grid, k = 1): {barrier_us:.4f} us ({full:.4f} ms "
          f"for {J2_SWEEPS} sweeps, {none:.4f} ms for none); the app's "
          f"dependency floor {barriers} barriers (k = {rt.k}) x "
          f"{barrier_us:.4f} us = {barrier_us * barriers / 1e3:.4f} ms")
    widest = {}
    for dtype in (torch.float32, torch.bfloat16):
        n = 3
        while j2_mod.route(n + 1, n + 1, dtype).name == "cluster":
            n += 1
        widest[dtype] = n
    for n, dtype in ((256, torch.float32), (384, torch.float32),
                     (512, torch.float32), (widest[torch.float32],
                                            torch.float32),
                     (widest[torch.bfloat16], torch.bfloat16),
                     (896, torch.bfloat16)):
        g = torch.rand(n, n, device=small.device).to(dtype)
        rt = j2_mod.route(n, n, dtype, 16)
        t_route = cuda_ms(torch, lambda: j2_mod.cluster(g, J2_WIDEST, 16,
                                                        rt.k), reps=3)
        t_loop = cuda_ms(torch, lambda: j2_mod.loop(g, J2_WIDEST), reps=3)
        if not torch.equal(j2_mod.cluster(g, J2_WIDEST, 16, rt.k),
                           j2_mod.loop(g, J2_WIDEST)):
            fail(f"jacobi2d {n} x {n} {dtype}: the routes differ")
        print(f"phase 6 jacobi2d {n} x {n} {dtype} (the plan: "
              f"{j2_mod.route(n, n, dtype).name} route): cluster route "
              f"(16 CTAs, k = {rt.k}) {t_route * 1e3 / J2_WIDEST:.4f} us a "
              "sweep, "
              f"loop route {t_loop * 1e3 / J2_WIDEST:.4f} us a sweep "
              f"({J2_WIDEST} sweeps, bit for bit alike)")


def jacobi_step_routes(torch, j2_mod, ref, data) -> None:
    """The one-sweep kernel's two routes bit for bit with the plain version
    in float32, bfloat16 and float16: the vector route on PolyBench's grid,
    the width-one route on the odd grid and on a view one point into a
    buffer holding PolyBench's grid."""
    checked = []
    for dtype in (torch.float32, torch.bfloat16, torch.float16):
        big = data["j2_big"].to(dtype)
        buf = torch.empty(big.numel() + 1, dtype=dtype, device=big.device)
        view = buf[1:].view(big.shape)
        view.copy_(big)
        for label, g, want in (("vector", big, 16 // big.element_size()),
                               ("odd", data["j2_odd"].to(dtype), 1),
                               ("view", view, 1)):
            width = j2_mod.step_width(g.shape[1], dtype, g.data_ptr())
            if width != want:
                fail(f"jacobi2d {label} {dtype}: width {width}, not {want}")
            if not torch.equal(j2_mod.jacobi2d_step(g), ref.jacobi2d(g)):
                fail(f"jacobi2d {label} {dtype}: the sweep differs from the "
                     "plain version's")
            checked.append(f"{label} {str(dtype)[6:]} (width {width})")
    print("phase 6 jacobi2d one sweep, both routes equal to the plain "
          "version bit for bit: " + ", ".join(checked))


def jacobi_polybench(torch, j2_mod, data, rows) -> None:
    """PolyBench's 1,000 sweeps of 2,800 x 2,800 in float32 and bfloat16:
    the tiled route (the plan) beside the old loop of one launch a sweep,
    each in device time (CUDA events around one call, median of 5) and
    wall time (the host clock around one call and a synchronize, median
    of 3), with its launches, beside the bound."""
    for key, tiled_row in (("j2_big", "jacobi2d_tiled"),
                           ("j2_big_bf16", "jacobi2d_tiled_bf16")):
        g = data[key]
        rt = j2_mod.route(*g.shape, g.dtype, iters=J2_BIG_SWEEPS)
        tiled = lambda: j2_mod.jacobi2d(g, J2_BIG_SWEEPS)
        old = lambda: j2_mod.loop(g, J2_BIG_SWEEPS)
        counts = []
        for fn, counter in ((tiled, "tiled_launches"),
                            (old, "loop_launches")):
            before = getattr(j2_mod.jacobi2d, counter)
            fn()
            counts.append(getattr(j2_mod.jacobi2d, counter) - before)
        dev = [cuda_ms(torch, fn, reps=5) for fn in (tiled, old)]
        wall = [wall_clock_ms(torch, fn, reps=3) for fn in (tiled, old)]
        bound = rows[tiled_row]["bound_ms"]
        print(f"phase 6 jacobi2d PolyBench {J2_BIG} x {J2_BIG} x "
              f"{J2_BIG_SWEEPS} {g.dtype}: tiled route (k {rt.k}, tile "
              f"{rt.tile[0]} x {rt.tile[1]}) {dev[0]:.4f} ms device, "
              f"{wall[0]:.4f} ms wall, {counts[0]} launches; old loop "
              f"{dev[1]:.4f} ms device, {wall[1]:.4f} ms wall, {counts[1]} "
              f"launches; bound {bound:.4f} ms "
              f"({rows[tiled_row]['bound_by']}), {bound / dev[0] * 100:.1f} % "
              "of it")


# Phase 7's kernel rows (study.kernel_microbench) -> the launch counters
# of the kernels each runs on the card (any route counts).
KERNEL_ROWS = {
    "kernel_blackscholes": ("blackscholes", ("launches",)),
    "kernel_jacobi2d": ("jacobi2d_step", ("launches", "width1_launches")),
    "kernel_pathfinder": ("pathfinder", ("launches", "pyramid_launches")),
    "kernel_streamcluster_dist": ("streamcluster",
                                  ("launches", "ld_launches",
                                   "tf32_launches")),
    "kernel_swaptions_cni": ("swaptions", ("launches",)),
    "kernel_canneal_swapcost": ("canneal", ("launches", "rows_launches")),
    "kernel_pf_findindex": ("particlefilter", ("launches",)),
    "kernel_flash_attention": ("flash_attention",
                               tuple(sorted({"launches",
                                             *FA_ROUTES.values()}))),
    "kernel_ssd_scan": ("ssd_scan", ("launches",)),
}


def scalar_gate_and_study(sp, wrappers: dict) -> None:
    """The scalar-scorecard gate (``python -m repro_torch.core.scalar_pipeline
    --check``, the anchors' speedups on the card), then the study driver's
    full row list (``python -m repro_torch.study``: run.py's row groups),
    each group's wall time and gate: the characterization equal to a host
    run's, every rvv and codegen row ``ok``, the scalar anchors in their
    bands, every profile row's identity within 1e-4, every kernel row on
    its CUDA kernel (``wrappers``: a name -> the kernel's wrapper, whose
    launch counters must rise), the 480-cell batched sweep equal to the
    sequential one; then ``python -m repro_torch.calibrate`` (the fit a
    fixed point of the committed profiles) and ``--scorecard``, and the
    future-work and vector-engine studies."""
    import tempfile
    from repro_torch import calibrate, futurework_study, study
    from repro_torch import vector_engine_study
    from repro_torch.core import anchors
    run_captured("phase 7 scalar gate", lambda: sp.main(["--check",
                                                         "--device", "cuda"]))
    counters = lambda: {row: sum(getattr(wrappers[k], c, 0) for c in cs)
                        for row, (k, cs) in KERNEL_ROWS.items()}
    before = counters()
    groups = {}
    with tempfile.TemporaryDirectory() as tmp:
        args = study.parse_args(["--device", "cuda", "--bench-json",
                                 f"{tmp}/bench.json", "--timeline",
                                 f"{tmp}/timeline.json"])
        study._BENCH.clear()
        print("phase 7 study: name,us_per_call,derived")
        for name, group in study.row_groups(args):
            t0 = time.perf_counter()
            rows = group()
            wall = time.perf_counter() - t0
            for r in rows:
                print(f"phase 7 study: {r[0]},{r[1]:.1f},{r[2]}")
            print(f"phase 7 study group {name}: {len(rows)} rows, "
                  f"{wall:.2f} s wall")
            groups[name] = rows
        study.write_bench(args.bench_json)
    after = counters()
    host = study.table_3_to_9_characterization()
    if [r[2] for r in groups["characterization"]] != [r[2] for r in host]:
        fail("study: the characterization differs from a host run's")
    bad = [r[0] for g in ("rvv", "codegen", "frontend") for r in groups[g]
           if "FAIL" in r[2] or "DIVERGED" in r[2]]
    if bad or not all(r[2].endswith("|ok") for r in groups["rvv"][:-1]
                      if r[0].startswith("rvv_crossval_")):
        fail(f"study: rvv / codegen / frontend rows not ok: {bad[:5]}")
    for r in groups["scalar"]:
        if r[0].startswith("scalar_anchor_"):
            f = dict(kv.split("=") for kv in r[2].split("|")[:2])
            model, paper = float(f["model"]), float(f["paper"])
            ok = (anchors.EQ_LO <= model / paper <= anchors.EQ_HI
                  if r[2].endswith("|eq") else
                  model <= paper * anchors.LT_SLACK)
            if not ok:
                fail(f"study: anchor out of its band: {r}")
    worst = max(float(r[2].rsplit("ident_err=", 1)[1])
                for r in groups["profile"][:-1])
    if worst > 1e-4:
        fail(f"study: a profile row's identity is {worst:.2e} (bar 1e-4)")
    idle = [row for row in KERNEL_ROWS if after[row] <= before[row]]
    if idle or [r[0] for r in groups["kernels"]] != list(KERNEL_ROWS):
        fail(f"study: kernel rows not run on their CUDA kernels: {idle}")
    sweep = groups["sweep"]
    if not (sweep[0][0] == "sweep_full_480cfg_batched"
            and sweep[-1][2].endswith("max_rel_diff=0.00e+00")):
        fail("study: the 480-cell sweep rows differ from the sequential "
             "ones or are missing")
    print(f"phase 7 study gates: characterization equal to the host run, "
          f"{sum(len(groups[g]) for g in ('rvv', 'codegen'))} rvv and "
          f"codegen rows ok, anchors in band, worst profile identity "
          f"{worst:.2e}, {len(KERNEL_ROWS)} kernel rows on the card "
          f"(launches {dict((k, after[k] - before[k]) for k in KERNEL_ROWS)})")
    lines = run_captured("phase 7 calibrate", lambda: calibrate.main(
        ["--device", "cuda"]))
    if not any("fixed point: committed values reproduce the fit" in ln
               for ln in lines):
        fail("calibrate: the fit is not a fixed point of the committed "
             "profiles")
    run_captured("phase 7 calibrate --scorecard", lambda: calibrate.main(
        ["--scorecard", "--device", "cuda"]))
    lines = run_captured("phase 7 futurework_study", lambda:
                         futurework_study.main(["--device", "cuda"]))
    if len(lines) != len(futurework_study.VARIANTS) + 3:
        fail("futurework_study: not one row a variant")
    lines = run_captured("phase 7 vector_engine_study", lambda:
                         vector_engine_study.main(["--device", "cuda"]))
    if sum(ln.startswith("  MVL=") for ln in lines) != 6 * 10:
        fail("vector_engine_study: not the 24-config table of every app")


def run_captured(label: str, run) -> list[str]:
    """``run()`` (a command's ``main``) with its standard output captured:
    every line printed under ``label``, then its exit code and wall time;
    fails on a nonzero exit.  Returns the lines."""
    import contextlib
    import io
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = run()
    lines = buf.getvalue().splitlines()
    for ln in lines:
        print(f"{label}: {ln.rstrip()}")
    print(f"{label}: exit {rc}, {time.perf_counter() - t0:.2f} s wall")
    if rc:
        fail(f"{label}: exit {rc}")
    return lines


def timed_collect_calls(torch, engine_scan, run):
    """``run()`` with every ``engine_scan.scan_collect`` call timed on the
    card: CUDA events on the current stream around the wrapper's call (its
    pre-pass, the zeroed timeline and its scan, with whatever the device
    idles between them).  Returns ``(run's result, [(T, B, ms), ...])`` in
    call order, T the call's longest lane.  The wrapper's launch counter
    counts as without the timing."""
    orig = engine_scan.scan_collect
    marks = []

    def timed(*args):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = orig(*args)
        end.record()
        marks.append((args[5], start, end))
        return out

    # the wrapper counts its launches through the module's name, so the
    # stand-in carries the counter while it is in place
    timed.launches = orig.launches
    engine_scan.scan_collect = timed
    try:
        res = run()
    finally:
        engine_scan.scan_collect = orig
        orig.launches = timed.launches
    torch.cuda.synchronize()
    return res, [(int(n.max()) if n.numel() else 0, n.numel(),
                  s.elapsed_time(e)) for n, s, e in marks]


def simulate_host_split(torch, eng, engine_scan, trace, cfg, dev,
                        reps: int = 5) -> dict:
    """One ``engine.simulate(trace, cfg, collect_stats=True)`` taken apart
    on the host clock, median ms of ``reps``: ``pack`` (the operands built
    on the host), ``h2d`` (copied to the card), ``launch`` (the wrapper's
    call until the card is done), ``d2h`` (the timing outputs and the
    accumulators to numpy) and ``records`` (the timeline's four views to
    numpy, their copies included), as ``engine.simulate`` runs them."""
    times = {k: [] for k in ("pack", "h2d", "launch", "d2h", "records")}
    for _ in range(reps + 1):
        t = [time.perf_counter()]
        inp = eng.pack([trace], [cfg], [len(trace)], [0], "cpu")
        t.append(time.perf_counter())
        inp = dataclasses.replace(inp, **{
            f.name: getattr(inp, f.name).to(dev)
            for f in dataclasses.fields(inp)})
        torch.cuda.synchronize()
        t.append(time.perf_counter())
        out, acc, rec = engine_scan.scan_collect(*inp.args())
        torch.cuda.synchronize()
        t.append(time.perf_counter())
        out, acc = out.cpu().numpy(), acc.cpu().numpy()
        t.append(time.perf_counter())
        {k: v[:, 0].cpu().numpy()
         for k, v in engine_scan.records(rec).items()}
        t.append(time.perf_counter())
        for k, a, b in zip(times, t, t[1:]):
            times[k].append((b - a) * 1e3)
    # the first pass is a warm-up (allocator, first launch)
    return {k: statistics.median(v[1:]) for k, v in times.items()}


def profiler_phase(torch, eng, engine_scan, dev, label="phase 9") -> dict:
    """The profiler on the card, the collect build's path: ``python -m
    repro_torch.core.telemetry --smoke --scorecard`` (every app at the
    reference's two configs, each body tiled 6 times: collect timings
    bitwise equal to the default path's, the event-sum identity within
    1e-4 with the worst printed, a Chrome trace of blackscholes, the
    histogram; then the ten-app scorecard) and ``python -m
    repro_torch.module_stress`` (last line CONSISTENT), with each collect
    call's device time and T (``timed_collect_calls``), their sum and
    median, and the host split of one ``simulate(collect_stats=True)`` of
    the smoke's first cell (``simulate_host_split``).  Returns the collect
    build's launches, counted from 0 over the phase, and the timings."""
    from repro_torch import module_stress
    from repro_torch.core import suite, telemetry, tracegen
    t0 = time.perf_counter()
    engine_scan.scan_collect.launches = 0

    def run():
        lines = run_captured(f"{label} profiler", lambda: telemetry.main(
            ["--smoke", "--scorecard", "--device", "cuda"]))
        ident = [ln for ln in lines if ln.startswith("identity:")]
        if (not ident or "10 apps x 2 cfgs" not in ident[0]
                or "profile-smoke: PASS" not in lines):
            fail("profiler: the smoke did not run every app at both configs")
        lines = run_captured(f"{label} module_stress",
                             lambda: module_stress.main(["--device", "cuda"]))
        if lines[-1] != "mechanistic <-> differential: CONSISTENT (10/10 apps)":
            fail(f"module_stress: {lines[-1]}")

    _, calls = timed_collect_calls(torch, engine_scan, run)
    wall = time.perf_counter() - t0
    launches = engine_scan.scan_collect.launches
    ms = [c[2] for c in calls]
    print(f"{label} collect calls (T, B, device ms from CUDA events around "
          f"the wrapper's call), in call order: "
          + " ".join(f"{T}/{B}/{m:.4f}" for T, B, m in calls))
    print(f"{label} collect calls: {len(calls)}, sum {sum(ms):.4f} ms, median "
          f"{statistics.median(ms):.4f} ms, sum of T {sum(c[0] for c in calls)}"
          f", {sum(ms) / 1e3 / wall:.1%} of the phase wall {wall:.3f} s")
    cfg = telemetry.SMOKE_CFGS[0]
    body = tracegen.body_for("blackscholes",
                             suite.effective_mvl("blackscholes", cfg), cfg)
    split = simulate_host_split(torch, eng, engine_scan, body.tile(6), cfg,
                                dev)
    print(f"{label} host split of one simulate(collect_stats=True) "
          f"(blackscholes {cfg.label()}, tiled 6: {len(body) * 6} records; "
          f"median of 5, ms): "
          + ", ".join(f"{k} {v:.4f}" for k, v in split.items()))
    print(f"{label} launches on the profiler's path: engine_scan_collect "
          f"{launches}; phase wall {wall:.2f} s")
    if launches <= 0 or launches != len(calls):
        fail(f"the collect build's launches on the profiler's path: "
             f"{launches}, calls timed {len(calls)}")
    return {"launches": launches, "calls": calls, "wall_s": wall,
            "split": split}


def dse_phase(torch, eng, suite, engine_scan, ve, golden, dev, tmp):
    """Design-space exploration at full width: ``SPACE_FULL`` (1,536
    configs) x the ten apps, cold through a JSONL cache in the directory
    ``tmp``, then again through a fresh ``ResultCache`` that re-reads
    the file (hit rate 1.0, nothing simulated, the same frontier
    fingerprint).  Checked two ways: the 240 Table-10 cells (every
    Table-10 config is a point of the space) against
    ``suite.speedup_batch`` bit for bit and the golden table at rtol 1e-2,
    and 64 seeded cells against the plain scan on the card bit for bit.
    Then the cold pass's dispatch taken apart on the host clock.  Returns
    the exploration and its cache file (phase 11's truth and rows)."""
    from repro_torch.core import dse
    t_phase = time.perf_counter()
    space = ve.SPACE_FULL
    suite.clear_caches()
    engine_scan.scan.launches = 0
    path = str(Path(tmp) / "dse.jsonl")
    t0 = time.perf_counter()
    res = dse.explore(space, cache=dse.ResultCache(path), device=dev)
    cold_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    res2 = dse.explore(space, cache=dse.ResultCache(path), device=dev)
    warm_s = time.perf_counter() - t0
    n_lines = len(Path(path).read_text().splitlines())
    launches = engine_scan.scan.launches
    st, st2 = res.stats, res2.stats
    fp, fp2 = dse._frontier_fingerprint(res), dse._frontier_fingerprint(res2)
    phases = lambda stats: "; ".join(
        f"{p['phase']} {p['wall_s']:.3f} s" for p in stats["phases"])
    print(f"phase 10 dse: {space.name} {res.n_configs} configs x "
          f"{len(res.apps)} apps = {len(res.records)} cells, cold "
          f"{cold_s:.2f} s: simulated {st['simulated']} lanes in {launches} "
          f"launch, in-run dedup {st['in_run_dedup']}, hit rate "
          f"{st['hit_rate']:.3f}, {n_lines} cache lines; phases "
          f"{phases(st)}; frontier_fp {fp}")
    for row in st["phases"]:
        print(f"phase 10 dse cold phase row: {json.dumps(row)}")
    print(f"phase 10 dse repeat (a fresh ResultCache re-reading the file): "
          f"{warm_s:.2f} s, simulated {st2['simulated']}, hit rate "
          f"{st2['hit_rate']:.3f}; phases {phases(st2)}; frontier_fp {fp2} "
          f"({'equal' if fp == fp2 else 'DIFFERENT'})")
    if (len(res.records) != 15_360 or launches != 1
            or st["simulated"] + st["in_run_dedup"] != 15_360
            or st2["hit_rate"] != 1.0 or st2["simulated"] != 0 or fp != fp2):
        fail("dse: not 15,360 cells in one launch, or the repeat pass missed "
             "the cache or moved the frontier")

    # the Table-10 configs are points of the space (unlisted knobs at
    # their defaults, dram_bw_bytes_cycle 4.0): 240 cells
    points = set(space.configs())
    t10 = set(ve.TABLE10)
    if not t10 <= points or any(c.dram_bw_bytes_cycle != 4.0 for c in t10):
        fail("dse: a Table-10 config is not a point of SPACE_FULL")
    cells = [r for r in res.records if r.cfg in t10]
    want = suite.speedup_batch([(r.app, r.cfg) for r in cells])
    worst, off = 0.0, []
    for r in cells:
        g = golden[r.app][f"{r.cfg.mvl}x{r.cfg.lanes}"]
        rel = abs(r.speedup - g) / abs(g)
        worst = max(worst, rel)
        if rel > 1e-2:
            off.append(f"{r.app} {r.label}: {r.speedup} vs {g}")
    same = [r.speedup for r in cells] == want
    print(f"phase 10 dse Table-10 cells: {len(cells)}, bitwise equal to "
          f"suite.speedup_batch {same}, worst rel vs golden {worst:.3g} "
          f"(rtol 1e-2, {len(cells) - len(off)}/{len(cells)})")
    if len(cells) != 240 or not same or off:
        fail(f"dse Table-10 cells: {len(cells)}, equal {same}, off {off[:5]}")

    # 64 seeded cells against the plain scan on the card
    rng = np.random.RandomState(2025)
    picked = [res.records[i] for i in
              sorted(rng.choice(len(res.records), 64, replace=False))]
    inp = eng.pack_steady_state([dse.cell_body(r.app, r.cfg)[0]
                                 for r in picked], [r.cfg for r in picked],
                                8, 24, dev)
    k = engine_scan.scan(*inp.args())
    t0 = time.perf_counter()
    p = engine_scan.scan_plain(*inp.args())
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    pc = p.cpu().numpy()
    steady = [(float(pc[0, b]) - float(pc[5, b])) / 24
              for b in range(len(picked))]
    same = torch.equal(k, p) and steady == [r.steady_ns for r in picked]
    print(f"phase 10 dse seeded cells: 64 (apps "
          f"{sorted({r.app for r in picked})}, T_max "
          f"{int(inp.n_steps.max())}), kernel and records bitwise equal to "
          f"the plain scan on the card {same} (plain {plain_s:.1f} s)")
    if not same:
        fail("dse seeded cells: the kernel or the records differ from the "
             "plain scan")

    # the cold pass's dispatch, stage by stage, on its lanes
    t = [time.perf_counter()]
    need = {}
    for app in res.apps:
        for cfg in space.configs():
            body, key = dse.cell_key(app, cfg)
            need.setdefault(key, (body, cfg))
    t.append(time.perf_counter())
    host = eng.pack_steady_state([b for b, _ in need.values()],
                                 [c for _, c in need.values()], 8, 24,
                                 torch.device("cpu"))
    t.append(time.perf_counter())
    inp = eng.ScanInputs(*(x.to(dev) for x in host.args()))
    torch.cuda.synchronize()
    t.append(time.perf_counter())
    out = engine_scan.scan(*inp.args())
    torch.cuda.synchronize()
    t.append(time.perf_counter())
    out.cpu().numpy()
    t.append(time.perf_counter())
    derived = []
    for r in res.records:
        body = dse.cell_body(r.app, r.cfg)[0]
        rt = suite.vector_runtime_from_per_chunk(r.app, r.cfg, body,
                                                 r.steady_ns)
        derived.append((r.cfg.label(), rt,
                        suite.scalar_runtime_ns(r.app, r.cfg) / rt,
                        dse.area_proxy_kb(r.cfg)))
    t.append(time.perf_counter())
    if derived != [(r.label, r.runtime_ns, r.speedup, r.area_kb)
                   for r in res.records]:
        fail("dse dispatch split: the derivation differs from explore's")
    split = dict(zip(("body lookup", "pack", "H2D", "launch", "D2H",
                      "derivation"),
                     ((b - a) * 1e3 for a, b in zip(t, t[1:]))))
    launch_ms = cuda_ms(torch, lambda: engine_scan.scan(*inp.args()), reps=3)
    P, B = inp.xf.shape
    print(f"phase 10 dse dispatch split (host ms, warm memos, {B} lanes x "
          f"P {P}, {sum(x.numel() * x.element_size() for x in host.args()) / 1e6:.0f}"
          f" MB of operands): " + ", ".join(f"{k} {v:.1f}"
                                            for k, v in split.items())
          + f"; the launch's device time {launch_ms:.4f} ms "
          f"({int(inp.n_steps.long().sum())} records, T_max "
          f"{int(inp.n_steps.max())}); largest stage "
          f"{max(split, key=split.get)}; phase wall "
          f"{time.perf_counter() - t_phase:.2f} s")
    return res, path


# The surrogate's MLP a point: 53 -> 64 -> 64 -> 1, two operations a
# multiply-add (phase 11's scoring bound); its bytes a point: the int64
# index in, the float32 prediction and area out.
SURR_FLOP_PER_POINT = 2 * (53 * 64 + 64 * 64 + 64)
SURR_BYTES_PER_POINT = 8 + 4 + 4


def surrogate_phase(torch, engine_scan, ve, truth, cache_path, dev,
                    sm_clock_hz) -> int:
    """Surrogate-guided search at full width: phase 10's ``SPACE_FULL`` x
    ten-apps cache file read back (all 15,360 cells present, nothing
    simulated) into the training rows; four 2,000-step fits (seed 0 twice,
    bitwise equal; seed 1, different; seed 0 without the last app, the
    hold-out model) with their scorecards; ``SPACE_HUGE`` scored for one
    app (host time, device time, points/s and the bound); the search of
    ``SPACE_HUGE`` for the ten apps through the same cache, every frontier
    point exact-verified, each app's recall of phase 10's exhaustive
    frontier (mean >= 0.9, run.py's acceptance), a repeat search with the
    same frontier fingerprint; then ``search.main(["--smoke"])``.  Returns
    the engine scan's launches on this path."""
    from repro_torch.core import dse, search, surrogate
    from repro_torch.kernels import ref
    t_phase = time.perf_counter()
    engine_scan.scan.launches = 0
    apps = truth.apps
    space, huge = ve.SPACE_FULL, ve.SPACE_HUGE
    cache = dse.ResultCache(cache_path)
    t0 = time.perf_counter()
    rows = cache.export_training_rows(apps, space)
    rows_s = time.perf_counter() - t0
    print(f"phase 11 search training rows: {len(rows)} of phase 10's "
          f"{len(apps)} apps x {space.size()} configs from its cache file "
          f"({len(cache)} entries, {cache.corrupt_lines} corrupt lines, "
          f"hits {cache.hits}, misses {cache.misses}; nothing simulated) in "
          f"{rows_s:.2f} s")
    if (len(rows) != len(apps) * space.size() or cache.corrupt_lines
            or engine_scan.scan.launches):
        fail("search: phase 10's cache file does not hold every cell")

    holdout = apps[-1]
    fits = {}
    for label, seed, rs in (("fit", 0, rows), ("repeat", 0, rows),
                            ("seed 1", 1, rows),
                            ("hold-out", 0, [r for r in rows
                                             if r["app"] != holdout])):
        t0 = time.perf_counter()
        m = surrogate.fit(rs, steps=2000, seed=seed, device=dev)
        fits[label] = (m, time.perf_counter() - t0)
    model = fits["fit"][0]
    same = all(torch.equal(model.params[k], fits["repeat"][0].params[k])
               for k in surrogate.PARAM_NAMES)
    differs = any(not torch.equal(model.params[k],
                                  fits["seed 1"][0].params[k])
                  for k in surrogate.PARAM_NAMES)
    print("phase 11 search fits (2,000 full-batch steps, host wall incl. "
          "the final loss's copy): " + "; ".join(
              f"{k} {w:.3f} s, {m.meta['n_rows']} rows, final loss "
              f"{m.meta['final_loss']:.4e}" for k, (m, w) in fits.items())
          + f"; seed 0 twice bitwise equal {same}, seed 1 differs {differs}")
    if not same or not differs:
        fail("search: the fit is not bitwise repeatable in its seed")
    fit_card = surrogate.scorecard(model, rows)
    ho_card = surrogate.scorecard(
        fits["hold-out"][0], [r for r in rows if r["app"] == holdout],
        holdout_app=holdout)
    for label, card in (("fit set", fit_card),
                        (f"hold-out {holdout}", ho_card)):
        print(f"phase 11 search scorecard {label}: n {card['n_rows']}, rel "
              f"err p50 {card['rel_err_p50']:.4f}, p90 "
              f"{card['rel_err_p90']:.4f}, p99 {card['rel_err_p99']:.4f}, "
              f"max {card['rel_err_max']:.4f}, spearman "
              f"{card['spearman_all']:.4f}")
    if ho_card["per_app"][holdout]["trained_on"]:
        fail("search: the hold-out model saw its hold-out app")

    # scoring one app over the whole search space
    scorer = surrogate.SpaceScorer(model, huge, apps[0])
    n = huge.size()
    idx = np.arange(n, dtype=np.int64)
    scorer.score(idx[:surrogate.SCORE_BATCH])          # warm
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    t0 = time.perf_counter()
    pred, area = scorer.score(idx)
    host_ms = (time.perf_counter() - t0) * 1e3
    end.record()
    end.synchronize()
    events_ms = start.elapsed_time(end)
    n_batches = -(-n // surrogate.SCORE_BATCH)
    batch = torch.arange(surrogate.SCORE_BATCH, device=dev)
    with ref._full_float32_matmul():
        busy_ms = device_ms(torch, lambda: scorer._score_batch(batch),
                            reps=5, per=1,
                            sm_clock_hz=sm_clock_hz) * n_batches
    bound_ms = max(n * SURR_FLOP_PER_POINT / PEAK_F32_S,
                   n * SURR_BYTES_PER_POINT / PEAK_BYTES_S) * 1e3
    picks = np.random.RandomState(11).randint(n, size=64)
    cfgs = [huge.config_at(int(i)) for i in picks]
    row_pred = model.predict_runtime_ns([{"app": apps[0], "cfg": c}
                                         for c in cfgs])
    pred_ok = (np.isfinite(pred).all() and (pred > 0).all()
               and np.allclose(pred[picks], row_pred, rtol=1e-5, atol=0)
               and np.allclose(area[picks],
                               [dse.area_proxy_kb(c) for c in cfgs],
                               rtol=1e-6, atol=0))
    print(f"phase 11 search score {huge.name} for {apps[0]}: {n} points in "
          f"{n_batches} batches of {surrogate.SCORE_BATCH}, host "
          f"{host_ms:.2f} ms (events around the call {events_ms:.2f} ms), "
          f"device busy {busy_ms:.3f} ms ({busy_ms / n_batches:.4f} ms a "
          f"batch behind a spin), {n / host_ms * 1e3:,.0f} points/s; bound "
          f"{bound_ms:.4f} ms (operations: {SURR_FLOP_PER_POINT} flop a "
          f"point at 67 TFLOP/s); 64 seeded points against the row path "
          f"and the exact area {pred_ok}")
    if not pred_ok:
        fail("search: the scorer disagrees with the row path or the area")

    launches0 = engine_scan.scan.launches
    t0 = time.perf_counter()
    res = search.search(huge, apps, model, cache=cache, device=dev)
    search_s = time.perf_counter() - t0
    search_launches = engine_scan.scan.launches - launches0
    n_checked = search._verify_exact(res, cache)
    tf = truth.frontiers()
    recall = {a: search.frontier_recall(res.frontiers[a], tf[a])
              for a in apps}
    rmean = float(np.mean(list(recall.values())))
    st = res.stats
    print(f"phase 11 search {huge.name} x {len(apps)} apps: {search_s:.2f} s"
          f", mode {st['mode']}, n_scored {st['n_scored']}, phases "
          + "; ".join(f"{p['phase']} {p['wall_s']:.3f} s"
                      for p in st["phases"])
          + f"; {search_launches} scan launches; {n_checked} frontier points "
          f"exact-verified; recall mean {rmean:.4f}, min "
          f"{min(recall.values()):.4f}")
    for a in apps:
        r = st["resim"][a]
        print(f"phase 11 search {a}: resim {r['resim']}, refined "
              f"{r['refined']}, simulated {r['simulated']}, frontier "
              f"{len(res.frontiers[a])} points, recall of the exhaustive "
              f"{space.name} frontier ({len(tf[a])} points) {recall[a]:.4f}")
    if st["mode"] != "exhaustive-score" or rmean < 0.9 or not n_checked:
        fail(f"search: mode {st['mode']}, recall mean {rmean}")
    fp = search.frontier_fingerprint(res)
    t0 = time.perf_counter()
    res2 = search.search(huge, apps, model, cache=cache, device=dev)
    fp2 = search.frontier_fingerprint(res2)
    print(f"phase 11 search repeat: {time.perf_counter() - t0:.2f} s, "
          f"simulated {sum(r['simulated'] for r in res2.stats['resim'].values())}"
          f", frontier_fp {fp} / {fp2} ({'equal' if fp == fp2 else 'DIFFERENT'})")
    if fp != fp2:
        fail("search: the repeat search moved the frontier")
    run_captured("phase 11 search --smoke",
                 lambda: search.main(["--smoke"]))
    launches = engine_scan.scan.launches
    print(f"phase 11 search: {launches} engine scan launches on this path; "
          f"phase wall {time.perf_counter() - t_phase:.2f} s")
    return launches


def serve_phase(engine_scan, tmp) -> int:
    """The simulation service on the card: ``sim_service.main(["--smoke"])``
    and the full serving study (``serve_bench.serve_study``: 400 requests
    at 200 Hz in real time over blackscholes, canneal, ssd_scan and
    pathfinder:asm x 32 configs of ``SPACE_QUICK``, ``max_batch`` 16,
    through a JSONL cache in ``tmp``, then the same stream against the
    persisted cache): no rebuild after prewarm, no request shed, the
    repeat pass >= 99 % hits with bitwise times.  Returns the engine scan's
    launches on this path."""
    from repro_torch import serve_bench
    from repro_torch.serve import sim_service
    t_phase = time.perf_counter()
    engine_scan.scan.launches = 0
    run_captured("phase 12 serve --smoke", lambda: sim_service.main(
        ["--smoke", "--cache", str(Path(tmp) / "serve_smoke.jsonl")]))
    rows, bench = serve_bench.serve_study(
        quick=False, cache_path=str(Path(tmp) / "serve.jsonl"))
    for name, us, derived in rows:
        print(f"phase 12 serve study: {name},{us:.1f},{derived}")
    p1, p2, b = bench["pass1"], bench["repeat"], bench["builds"]
    print(f"phase 12 serve prewarm: {bench['prewarmed_buckets']} batch sizes "
          f"in {bench['prewarm_s'] * 1e3:.1f} ms; builds before prewarm "
          f"{b['before_prewarm']}, after {b['after_prewarm']}, after the "
          f"repeat {b['after_repeat']}")
    for label, r in (("pass 1", p1), ("repeat", p2)):
        print(f"phase 12 serve {label}: {r['n']} requests in "
              f"{r['wall_s']:.3f} s, {r['throughput_rps']:.1f} req/s, p50 "
              f"{r['p50_ms']:.3f} ms, p99 {r['p99_ms']:.3f} ms, p99.9 "
              f"{r['p999_ms']:.3f} ms, mean {r['mean_ms']:.3f} ms; hits "
              f"{r['hits']}, coalesced {r['coalesced']}, dispatched "
              f"{r['dispatched']}, batches {r['batches']}, shed {r['shed']}, "
              f"recompiles {r['recompiles']}, hit fraction "
              f"{r['hit_fraction']:.3f}")
    launches = engine_scan.scan.launches
    print(f"phase 12 serve: ok {bench['ok']} (bitwise repeat "
          f"{bench['bitwise_repeat']}); {launches} engine scan launches on "
          f"this path; phase wall {time.perf_counter() - t_phase:.2f} s")
    if not (bench["ok"] and p1["recompiles"] == 0 and p1["shed"] == 0
            and p2["hit_fraction"] >= 0.99 and bench["bitwise_repeat"]):
        fail("serve: rebuilds after prewarm, a shed request, a repeat below "
             "99 % hits or times not bitwise")
    return launches


# ---- 13. the model server ---------------------------------------------------
# llama3-8b served whole at its published widths (configs/llama3_8b.py: 32
# layers, d 4,096, 32 heads, GQA 8, of 128, vocab 128,256) in bfloat16:
# first the launcher's defaults (launch/serve.py: 8 requests of 3-9 seeded
# tokens, batch 4, 8 new tokens, max_seq 64), then a long-prompt round (4
# requests of 1,024-2,048 seeded tokens, 16 new tokens, max_seq 4,096).
SERVE_ARCH = "llama3-8b"
SERVE_ROUNDS = (
    ("launcher defaults", dict(requests=8, batch=4, lo=3, hi=10, new=8,
                               max_seq=64, seed=0)),
    ("long prompts", dict(requests=4, batch=4, lo=1024, hi=2049, new=16,
                          max_seq=4096, seed=1)),
)
# every other config at its published widths, 4 requests of 4 new tokens:
# whole where weights and cache fit 60 GB, else cut in depth only (layers
# kept; jamba: one period of 8, every kind of layer in its ratio)
SERVE_OTHERS = (("qwen2.5-3b", None), ("mamba2-130m", None),
                ("granite-moe-3b-a800m", None), ("whisper-small", None),
                ("mistral-large-123b", 2), ("dbrx-132b", 2),
                ("qwen1.5-32b", 2), ("internvl2-76b", 2),
                ("jamba-v0.1-52b", 8))
SERVE_OTHERS_MAX_SEQ = 64
# the kernel route against the plain route: llama3-8b at full width, 2
# layers, float32 (weights from seed 2), a B 2 x S 64 prompt and four
# teacher-forced decode steps, the card's logits against the port's CPU
# path on the same weights within 1e-4 of the largest logit magnitude (the
# CPU tests' bar against the reference: products summed in other orders,
# attention in 3xTF32, no reduced-precision product anywhere)
SERVE_PARITY = dict(layers=2, B=2, S=64, steps=4, seed=2, tol=1e-4)


class TimedModel:
    """A model whose prefill and decode steps are timed on the host clock
    (a synchronize each side) and whose logits are checked finite."""

    def __init__(self, torch, model):
        self.torch, self.model, self.cfg = torch, model, model.cfg
        self.prefill_ms, self.decode_ms, self.shapes = [], [], []

    def _timed(self, times, fn, *args):
        self.torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = fn(*args)
        self.torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        if not bool(self.torch.isfinite(logits).all()):
            fail(f"serve {self.cfg.name}: logits not finite")
        return logits, cache

    def prefill(self, params, batch, max_seq):
        self.shapes.append(tuple(batch["tokens"].shape))
        return self._timed(self.prefill_ms, self.model.prefill, params,
                           batch, max_seq)

    def decode_step(self, params, cache, tokens, pos):
        return self._timed(self.decode_ms, self.model.decode_step, params,
                           cache, tokens, pos)


def _nbytes(tree) -> int:
    from repro_torch.models import layers as L
    return sum(t.numel() * t.element_size() for t in L.tree_leaves(tree))


def serve_requests(torch, model, params, r, extra=None):
    """Serve ``r["requests"]`` seeded requests through ``ServeEngine``;
    returns the engine, the timed model, the wall time and the tokens."""
    from repro_torch.serve.engine import Request, ServeEngine
    timed = TimedModel(torch, model)
    eng = ServeEngine(timed, params, r["batch"], r["max_seq"], extra=extra)
    rng = np.random.default_rng(r["seed"])
    for i in range(r["requests"]):
        eng.submit(Request(uid=i, prompt=rng.integers(
            0, model.cfg.vocab_size, rng.integers(r["lo"], r["hi"])).astype(
                np.int32), max_new_tokens=r["new"]))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    done = eng.run()
    wall = time.perf_counter() - t0
    toks = [t for q in done for t in q.out_tokens]
    if len(done) != r["requests"] or any(
            len(q.out_tokens) != r["new"] for q in done) or not all(
            0 <= t < model.cfg.padded_vocab for t in toks):
        fail(f"serve {model.cfg.name}: {len(done)} requests done, tokens "
             "missing or out of the vocabulary")
    return eng, timed, wall, len(toks)


def decode_step_split(torch, model, params, steps=3):
    """One decode step at the launcher's shapes (B 4, a 9-token prompt,
    max_seq 64), ``steps`` times: the host's issue time (the call's
    return, no synchronize) and the wall time to the synchronize, medians;
    then ``steps`` more under ``torch.profiler`` (CPU and CUDA activities):
    the device time of their kernels (the CUDA events' self times, summed)
    and the kernel launches (``cudaLaunchKernel`` / ``cuLaunchKernelEx``
    calls), each a step.  A step launches more kernels than the launch
    queue holds, so no spin ahead of it hides the host; the profiler's
    kernel sum is the device's busy time.  Returns (issue ms, wall ms,
    device ms, launches)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.serve.engine import params_device
    toks = torch.arange(36, device=params_device(params),
                        dtype=torch.int32).view(4, 9)
    logits, cache = model.prefill(params, {"tokens": toks}, 64)
    tok = torch.argmax(logits[:, -1], -1)[:, None].to(torch.int32)
    issue, wall = [], []
    for t in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model.decode_step(params, cache, tok, 9 + t)
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        issue.append((t1 - t0) * 1e3)
        wall.append((time.perf_counter() - t0) * 1e3)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for t in range(steps):
            model.decode_step(params, cache, tok, 9 + steps + t)
        torch.cuda.synchronize()
    ka = prof.key_averages()
    device_us = sum(e.self_device_time_total for e in ka
                    if e.device_type == DeviceType.CUDA)
    launches = sum(e.count for e in ka
                   if e.key in ("cudaLaunchKernel", "cuLaunchKernelEx",
                                "cudaLaunchKernelExC"))
    return (statistics.median(issue), statistics.median(wall),
            device_us / 1e3 / steps, launches / steps)


def serve_bounds(cfg, params, B, S, max_seq, kv_len):
    """(prefill bound ms, its kind, decode-step bound ms, its kind) of the
    dense model: the prefill's products (2 x block parameters a token, the
    last position's unembedding, 4 x hd a kept causal pair a head) at 989
    TFLOP/s against its bytes (the weights but the embedding table read
    once, the rows gathered, the cache written); a decode step's bytes (the
    same weights read once, the cache rows below ``kv_len``) at 3.35
    TB/s."""
    from repro_torch.models import layers as L
    el = cfg.torch_dtype.itemsize
    emb = params["embed"]["embedding"].numel() * el
    weights = _nbytes(params) - emb
    blocks = sum(t.numel() for t in L.tree_leaves(params["blocks"]))
    L_, KV, hd, H = cfg.num_layers, cfg.num_kv_heads, cfg.head_dim, \
        cfg.num_heads
    ops = (2 * blocks * B * S + 2 * cfg.d_model * cfg.padded_vocab * B
           + 4 * hd * H * L_ * B * S * (S + 1) // 2)
    cache_w = 2 * L_ * B * max_seq * KV * hd * el
    pre_b = (weights + B * S * cfg.d_model * el + cache_w) / PEAK_BYTES_S
    pre_o = ops / PEAK_BF16_S
    dec_b = (weights + B * cfg.d_model * el
             + 2 * L_ * B * kv_len * KV * hd * el) / PEAK_BYTES_S
    return (max(pre_b, pre_o) * 1e3, "bytes" if pre_b >= pre_o
            else "operations", dec_b * 1e3, "bytes")


def serve_kernel_rows(torch, ref, fa_mod, da_mod, sm_clock_hz, dev, cfg, B,
                      S, max_seq, kv_len) -> dict:
    """The two kernels at the long round's shapes, seeded operands: flash
    attention over the prefill's [B, S, 32, 128] bf16 q, k, v (K/V repeated
    to 32 heads), causal; decoding of [B, 32, 128] against the repeated
    [B, max_seq, 32, 128] bf16 cache at ``kv_len``.  Each against its plain
    version, timed beside it and SDPA, and bounded (``run_suite_kernel``)."""
    g = torch.Generator(device=dev).manual_seed(13)
    bf = torch.bfloat16
    H, D = cfg.num_heads, cfg.head_dim
    q, k, v = (torch.randn(B, S, H, D, generator=g, device=dev).to(bf)
               for _ in range(3))
    dq = torch.randn(B, H, D, generator=g, device=dev).to(bf)
    dk, dv = (torch.randn(B, max_seq, H, D, generator=g, device=dev)
              .to(bf) for _ in range(2))
    lens = torch.full((B,), kv_len, dtype=torch.int32, device=dev)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    mask = (torch.arange(max_seq, device=dev)[None, :]
            < lens[:, None])[:, None, None, :]
    pairs = B * H * S * (S + 1) // 2
    specs = {
        "flash_attention": dict(
            name="flash_attention serving", kernel=lambda: fa_mod
            .flash_attention(q, k, v, True),
            plain=lambda: ref.flash_attention(q, k, v, True),
            library=lambda: sdpa(q.transpose(1, 2), k.transpose(1, 2),
                                 v.transpose(1, 2), is_causal=True),
            tol=(2e-2, 2e-2), peak=PEAK_BF16_S, nbytes=4 * q.numel() * 2,
            ops=4 * D * pairs, exps=pairs, per=5, plain_reps=2),
        "decode_attention": dict(
            name="decode_attention serving", kernel=lambda: da_mod
            .decode_attention(dq, dk, dv, lens),
            plain=lambda: ref.decode_attention(dq, dk, dv, lens),
            library=lambda: sdpa(dq[:, :, None], dk.transpose(1, 2),
                                 dv.transpose(1, 2), attn_mask=mask),
            tol=(2e-4 + 2.0 ** -7,) * 2, peak=PEAK_F32_S,
            nbytes=2 * B * kv_len * H * D * 2 + 2 * dq.numel() * 2 + B * 4,
            ops=4 * D * kv_len * B * H, per=10, device_time=True),
    }
    rows = {n: run_suite_kernel(torch, spec, sm_clock_hz, label="phase 13")
            for n, spec in specs.items()}
    shape = {"flash_attention": f"B {B}, S {S}, H {H}, D {D}, bf16, causal",
             "decode_attention": f"B {B}, S {max_seq}, H {H}, D {D}, bf16, "
                                 f"kv_len {kv_len}"}
    return {n: dict(shape=shape[n], **row) for n, row in rows.items()}


def model_server_phase(torch, ref, fa_mod, da_mod, dev, sm_clock_hz) -> dict:
    """13. The model server on the card: llama3-8b whole in bfloat16 through
    ``ServeEngine`` (the launcher's defaults, then the long-prompt round),
    every other config at full width (depth cut where it must be), and the
    kernel route against the plain route.  Returns the attention kernels'
    launches on the served path (counters zeroed before it) and their rows
    at the long round's shapes."""
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import stub_inputs
    from repro_torch.models import build
    from repro_torch.models import layers as L
    from repro_torch.serve.engine import serve_batch
    t_phase = time.perf_counter()
    # float32 products in full float32 (the reference's); phase 5 set this
    torch.backends.cuda.matmul.allow_tf32 = False
    counters = lambda: (fa_mod.flash_attention.launches,
                        da_mod.decode_attention.launches,
                        da_mod.decode_attention.combine_launches)

    # (a) llama3-8b whole; what earlier phases still hold on the card is
    # counted apart from each peak
    held = torch.cuda.memory_allocated() / 1e9
    cfg = get_config(SERVE_ARCH)
    model = build(cfg)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in L.tree_leaves(params))
    print(f"phase 13 {cfg.name}: {cfg.num_layers} layers, d {cfg.d_model}, "
          f"{cfg.num_heads} heads (GQA {cfg.num_kv_heads}) of "
          f"{cfg.head_dim}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size} "
          f"(padded {cfg.padded_vocab}); {n_params:,} parameters, "
          f"{_nbytes(params) / 1e9:.2f} GB bf16, drawn on the card in "
          f"{time.perf_counter() - t0:.2f} s")
    # warm-up (cuBLAS handles, the kernels' first calls), not counted
    serve_batch(model, params, [np.arange(3, dtype=np.int32)], 2, 8)
    torch.cuda.synchronize()
    # where a decode step's time goes, before the counted rounds
    issue, wall, device, n_launch = decode_step_split(torch, model, params)
    print(f"phase 13 {cfg.name} decode step (B 4, max_seq 64): host issue "
          f"{issue:.2f} ms, wall to the synchronize {wall:.2f} ms (medians "
          f"of 3); under the profiler {n_launch:.0f} kernel launches and "
          f"{device:.2f} ms of kernel time a step: the device busy "
          f"{device / wall:.1%} of the wall")
    fa_mod.flash_attention.launches = 0
    da_mod.decode_attention.launches = 0
    da_mod.decode_attention.combine_launches = 0
    long_shape, decode_ms = None, {}
    for label, r in SERVE_ROUNDS:
        before = counters()
        torch.cuda.reset_peak_memory_stats()
        eng, timed, wall, n_tok = serve_requests(torch, model, params, r)
        peak = torch.cuda.max_memory_allocated() / 1e9
        fa_n, da_n, co_n = (a - b for a, b in zip(counters(), before))
        B, S = timed.shapes[-1]
        kv_mid = S + r["new"] // 2
        pre_b, pre_by, dec_b, dec_by = serve_bounds(
            cfg, params, B, S, r["max_seq"], kv_mid)
        dec_med = statistics.median(timed.decode_ms)
        print(f"phase 13 {cfg.name} {label}: {r['requests']} requests, "
              f"batch {r['batch']}, prompts {r['lo']}-{r['hi'] - 1} tokens, "
              f"{r['new']} new each, max_seq {r['max_seq']}: {n_tok} tokens "
              f"in {wall:.3f} s, {n_tok / wall:.1f} tok/s; "
              f"{eng.prefill_rounds} prefill rounds, {eng.decode_steps} "
              f"decode steps")
        print(f"phase 13 {cfg.name} {label}: prefill ms "
              + ", ".join(f"{t:.2f} ({s[0]} x {s[1]})" for t, s in
                          zip(timed.prefill_ms, timed.shapes))
              + f"; last prefill bound {pre_b:.2f} ms ({pre_by}); decode "
              f"step median {dec_med:.2f} ms (min {min(timed.decode_ms):.2f}"
              f", max {max(timed.decode_ms):.2f}), bound {dec_b:.2f} ms "
              f"({dec_by}: the weights once, the cache below kv_len "
              f"{kv_mid}); peak memory {peak:.2f} GB ({peak - held:.2f} "
              f"GB above the {held:.2f} GB earlier phases hold)")
        print(f"phase 13 {cfg.name} {label}: launches flash_attention "
              f"{fa_n}, decode_attention split {da_n}, combine {co_n}")
        if fa_n <= 0 or da_n <= 0 or co_n <= 0:
            fail(f"serve {cfg.name} {label}: an attention kernel was not "
                 f"launched ({fa_n}, {da_n}, {co_n})")
        long_shape = (B, S, r["max_seq"], kv_mid)
        decode_ms.setdefault(label, dec_med)
    del params, model
    torch.cuda.empty_cache()

    # (b) every other config at full width
    for arch, layers in SERVE_OTHERS:
        cfg = get_config(arch)
        cut = "whole"
        if layers is not None:
            cfg = cfg.scaled(num_layers=layers)
            cut = (f"{layers} of {get_config(arch).num_layers} layers "
                   "(depth cut only)")
        model = build(cfg)
        before = counters()
        torch.cuda.reset_peak_memory_stats()
        params = model.init(torch.Generator(device=dev).manual_seed(0))
        max_seq = SERVE_OTHERS_MAX_SEQ + cfg.num_patches
        r = dict(requests=4, batch=4, lo=3, hi=10, new=4, max_seq=max_seq,
                 seed=0)
        eng, timed, wall, n_tok = serve_requests(
            torch, model, params, r, extra=stub_inputs(cfg, 4, dev))
        fa_n, da_n, co_n = (a - b for a, b in zip(counters(), before))
        n_params = sum(t.numel() for t in L.tree_leaves(params))
        print(f"phase 13 {cfg.name}: {cut}; d {cfg.d_model}, "
              f"{n_params:,} parameters, {_nbytes(params) / 1e9:.2f} GB; "
              f"{n_tok} tokens in "
              f"{wall:.3f} s ({n_tok / wall:.1f} tok/s), prefill "
              f"{timed.prefill_ms[0]:.2f} ms, decode step median "
              f"{statistics.median(timed.decode_ms):.2f} ms; launches flash "
              f"{fa_n}, decode {da_n}; peak memory "
              f"{torch.cuda.max_memory_allocated() / 1e9 - held:.2f} GB "
              "above what earlier phases hold")
        if cfg.family != "ssm" and (fa_n <= 0 or da_n <= 0):
            fail(f"serve {cfg.name}: an attention kernel was not launched")
        del params, model
        torch.cuda.empty_cache()
    launches = dict(zip(("flash_attention", "decode_attention",
                         "decode_attention_combine"), counters()))
    print(f"phase 13 launches on the served path: {launches}")

    # (c) the kernel route against the plain route
    p = SERVE_PARITY
    cfg = get_config(SERVE_ARCH).scaled(num_layers=p["layers"],
                                        dtype="float32",
                                        cache_dtype="float32")
    model = build(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(p["seed"]))
    cpu_params = L.tree_map(lambda t: t.cpu(), params)
    rng = np.random.default_rng(p["seed"])
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (
        p["B"], p["S"] + p["steps"])).astype(np.int32))
    max_seq = p["S"] + p["steps"]
    before = counters()
    card = [model.prefill(params, {"tokens": toks[:, :p["S"]].to(dev)},
                          max_seq)]
    plain = [model.prefill(cpu_params, {"tokens": toks[:, :p["S"]]},
                           max_seq)]
    for t in range(p["steps"]):
        tok = toks[:, p["S"] + t:p["S"] + t + 1]
        card.append(model.decode_step(params, card[-1][1], tok.to(dev),
                                      p["S"] + t))
        plain.append(model.decode_step(cpu_params, plain[-1][1], tok,
                                       p["S"] + t))
    fa_n, da_n, _ = (a - b for a, b in zip(counters(), before))
    errs = [float((c[0].cpu() - w[0]).abs().max()) for c, w in
            zip(card, plain)]
    scale = max(float(w[0].abs().max()) for w in plain)
    print(f"phase 13 kernel route vs plain route ({cfg.name} at full width, "
          f"{p['layers']} layers, float32, B {p['B']}, S {p['S']}, "
          f"{p['steps']} teacher-forced decode steps; {fa_n} flash and "
          f"{da_n} decode launches on the card): max abs err prefill "
          f"{errs[0]:.3g}, decode " + ", ".join(f"{e:.3g}" for e in errs[1:])
          + f"; largest |logit| {scale:.4g}, bar {p['tol']:g} of it "
          f"({p['tol'] * scale:.3g})")
    if max(errs) > p["tol"] * scale or fa_n != p["layers"] \
            or da_n != p["layers"] * p["steps"]:
        fail("the kernel route differs from the plain route, or did not "
             "run on the kernels")
    del params, cpu_params, card, plain, model
    torch.cuda.empty_cache()

    rows = serve_kernel_rows(torch, ref, fa_mod, da_mod, sm_clock_hz, dev,
                             get_config(SERVE_ARCH), *long_shape)
    print(f"phase 13 model server: ok; phase wall "
          f"{time.perf_counter() - t_phase:.2f} s")
    return {"launches": launches, "rows": rows,
            "decode_ms": decode_ms[SERVE_ROUNDS[0][0]]}


# ---- 14. the trainer --------------------------------------------------------
# qwen2.5-3b trained whole at its published widths (configs/qwen2_5_3b.py: 36
# layers, d 2,048, 16 heads with 2 KV heads of 128, d_ff 11,008, vocab
# 151,936, QKV bias) in bfloat16 with remat on, through
# trainstep.build_train_step and the port's AdamW at B 2 x S 4,096: three
# steps on one batch, then one of two microbatches.  A step runs the
# flash-attention kernel once a layer in the forward and once in the remat
# recompute (72 launches a batch); the attention backward is the plain
# route's VJP (layers.FlashAttention) until the backward kernel, which runs
# once a layer (36 launches a step, a launch being a memset and three
# kernels: the statistics pre-pass, one pass over the kept pairs, the dQ
# post-pass).
TRAIN_ARCH = "qwen2.5-3b"
TRAIN_B, TRAIN_S = 2, 4096
# flash attention at the training shape against the float32 plain version
# on the same bf16 inputs: each (b, s, h) row of D within this share of the
# row's norm.  The kernel rounds its probabilities to bf16 for the product
# with V and its output to bf16, 2^-9 each: a float64 emulation of that
# arithmetic on the CPU (standard-normal bf16 inputs, S 4,096, D 128,
# causal, 4 heads) puts the worst row at 3.1e-3 of its norm (median
# 2.3e-3); the bar is one bf16 unit, 2^-7
FLASH_TRAIN_ROW_TOL = 2 ** -7
# the backward kernel at the training shape against the float32 plain
# backward (ref.flash_attention_bwd) on the same bf16 inputs, output and
# lse: each (b, s, h) row of dq, dk and dv within this share of the row's
# norm.  The kernel rounds P and dS to bf16 for the products with dO, K and
# Q, and its gradients to bf16, 2^-9 each: a float32 emulation of that
# arithmetic on the CPU (standard-normal bf16 inputs, S 4,096, D 128,
# causal, 2 heads) puts the worst row at 4.0e-3 of its norm (dk; median
# 2.3e-3); the bar is one bf16 unit, 2^-7, as the forward's.  A row's norm
# is floored at the median row's: the first query's dq is 0 in exact
# arithmetic (its one key has P = 1, so dP = Delta), and float32 sums of
# dO V and dO O in other orders leave ~1e-7 of it (chip run 3 of PR 31:
# 4.4e24 of the plain version's 0)
FLASH_BWD_ROW_TOL = 2 ** -7
TRAIN_STEPS = ((1, 3), (2, 1))         # (microbatches, steps)
# what the run should show, stated before it (PERF.md, trainer phase):
# parameters, bytes of parameters + gradients (bf16) + float32 moments, the
# peak (with the 5 GB float32 logits and their gradient; the backward
# kernel holds no score tensor, where the plain VJP held ~0.5 GB a chunk:
# at or below the 60.28 GB measured with it), a step's FLOP and its bound,
# and a step's wall with the backward kernel (36 x 39.7 ms of plain VJP
# replaced by 36 x ~1.5 ms)
TRAIN_EXPECT = dict(params=3.40e9, state_gb=40.8, peak_gb=(59, 60.3),
                    flop=2.2e14, bound_s=0.22, step_s=(0.7, 0.9))
# the kernel route's gradients against the plain route's (native autograd
# through _plain_attn) on the same weights and batch: every leaf's largest
# difference within this share of the plain leaf's largest magnitude.
# bfloat16 at qwen2.5-3b's width (2 layers, B 2 x S 4,096, the chunked
# route): the kernel's output differs from the plain route's by an ulp of
# bfloat16 (2^-8) here and there, and the backward carries it through two
# layers' bf16 products, ~8 ulps.  The same bar holds the bf16 plain
# route's gradients to the float32 ones (the same weights upcast): the
# embedding's gradient, summed over ~2,100 positions of the batch's first
# token, is summed in float32 (layers.embed_fwd), and each other leaf is
# rounded products.  float32 at lm-10m's width (4 layers, train_lm's B 8
# x S 128, the exact route): the kernel's 3xTF32 products against float32
# ones (~1e-6), grown through the backward
TRAIN_PARITY = (("qwen2.5-3b", dict(num_layers=2), 2, 4096, 3e-2),
                ("lm-10m", {}, 8, 128, 1e-3))
# train_lm's resume: the losses of a run stopped at step 30 and resumed to
# 60 against the uninterrupted run's, bit for bit (0): every sum of the
# step is in a fixed order (the embedding gradient's segment sum, the
# attention backward without atomics); 1e-4 while the embedding gradient's
# atomic adds summed in another order from run to run
TRAIN_RESUME_RTOL = 0.0


def train_flop(cfg, params, B, S) -> float:
    """A rematted step's products: 8 x block parameters a token (forward,
    recompute, backward twice), 6 x the unembedding, and a layer's
    attention at 4 D a kept causal pair a head forward (twice) and 10 D
    backward."""
    from repro_torch.models import layers as L
    blocks = sum(t.numel() for t in L.tree_leaves(params["blocks"]))
    T = B * S
    pairs = B * cfg.num_heads * S * (S + 1) // 2
    return (8 * blocks * T + 6 * cfg.d_model * cfg.padded_vocab * T
            + cfg.num_layers * pairs * (4 + 4 + 10) * cfg.head_dim)


def train_step_split(torch, model, params, opt_state, batch, opt_cfg):
    """Where a full-width step's time goes: the loss forward alone, the
    block stack's forward alone (what remat recomputes), the forward and
    backward (``value_and_grad``) and the optimizer (``apply_``), each by
    CUDA events (warm: the counted steps ran first); then one forward and
    backward under ``torch.profiler``: its wall time and its kernels'
    device time.  The optimizer step is a real one (the parameters
    move)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.train import optimizer as opt
    from repro_torch.train import trainstep as ts
    cfg = model.cfg
    with torch.no_grad():
        fwd = cuda_ms(torch, lambda: model.loss(params, batch), reps=3,
                      warmup=1)
        blocks = cuda_ms(torch, lambda: model.mod.forward(
            params, batch["tokens"], cfg), reps=3, warmup=1)
    out = {}
    vg = cuda_ms(torch, lambda: out.update(
        g=ts.value_and_grad(model, params, batch)[1]), reps=1, warmup=0)
    opt_ms = cuda_ms(torch, lambda: opt.apply_(opt_cfg, params, out["g"],
                                               opt_state), reps=1, warmup=0)
    out.clear()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        ts.value_and_grad(model, params, batch)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    device = sum(e.self_device_time_total for e in prof.key_averages()
                 if e.device_type == DeviceType.CUDA) / 1e3
    return dict(forward_ms=fwd, blocks_forward_ms=blocks, value_and_grad_ms=vg,
                optimizer_ms=opt_ms, profiled_wall_ms=wall,
                profiled_device_ms=device)


def attention_backward_rows(torch, ref, fa_mod, sm_clock_hz, dev, cfg, B,
                            S) -> tuple[dict, dict]:
    """Flash attention at the training shape ([B, S, H, D] bf16, causal,
    K / V repeated to H heads as the model gives them): the kernel held
    row by row to the float32 plain version (``FLASH_TRAIN_ROW_TOL``),
    timed beside its bf16 plain version and SDPA's forward and bounded
    (``run_suite_kernel``), and beside it the forward with its row
    log-sum-exp; then the attention backward a layer: the backward kernel
    held row by row to the float32 plain backward on the same bf16 inputs
    (``FLASH_BWD_ROW_TOL``), two calls bit for bit, timed beside its plain
    version, SDPA's forward and backward (and SDPA's forward alone) and
    its bound (10 D flops a kept pair a head at 989 TFLOP/s; q, k, v, out,
    dout and lse read once, dq, dk, dv written once), and the plain
    route's VJP, recomputed, the route before the kernel.  Returns the
    forward's row and the backward's."""
    from repro_torch.kernels import flash_attention_bwd as fab
    from repro_torch.models import layers as L
    g = torch.Generator(device=dev).manual_seed(17)
    bf, f32 = torch.bfloat16, torch.float32
    H, D = cfg.num_heads, cfg.head_dim
    q, k, v, dout = (torch.randn(B, S, H, D, generator=g, device=dev)
                     .to(bf) for _ in range(4))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    pairs = B * H * S * (S + 1) // 2
    row = run_suite_kernel(torch, dict(
        name="flash_attention training", kernel=lambda: fa_mod
        .flash_attention(q, k, v, True),
        plain=lambda: ref.flash_attention(q, k, v, True),
        want=lambda: ref.flash_attention(q.to(f32), k.to(f32), v.to(f32),
                                          True),
        want_is="the float32 plain version on the same bf16 inputs",
        rows=True, tol=FLASH_TRAIN_ROW_TOL,
        library=lambda: sdpa(q.transpose(1, 2), k.transpose(1, 2),
                             v.transpose(1, 2), is_causal=True),
        peak=PEAK_BF16_S, nbytes=4 * q.numel() * 2,
        ops=4 * D * pairs, exps=pairs, per=5, plain_reps=2), sm_clock_hz,
        label="phase 14")
    row["lse_ms"] = cuda_ms(torch, lambda: fa_mod.flash_attention_lse(
        q, k, v, True), reps=10, per=5)
    print(f"phase 14 flash_attention training: forward {row['ms']:.4f} ms, "
          f"with the row log-sum-exp written {row['lse_ms']:.4f} ms")
    out, lse = fa_mod.flash_attention_lse(q, k, v, True)
    qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_()
                  for t in (q, k, v))
    dt_ = dout.transpose(1, 2)

    def sdpa_fb():
        o = sdpa(qt, kt, vt, is_causal=True)
        return torch.autograd.grad(o, (qt, kt, vt), dt_)

    wide = lambda *ts: [t.to(f32) for t in ts]
    bwd = run_suite_kernel(torch, dict(
        name="flash_attention_bwd training",
        kernel=lambda: fab.flash_attention_bwd(q, k, v, out, lse, dout,
                                               True),
        plain=lambda: ref.flash_attention_bwd(q, k, v, out, lse, dout, True),
        want=lambda: ref.flash_attention_bwd(
            *wide(q, k, v, out), lse, *wide(dout), True),
        want_is="the float32 plain backward on the same bf16 inputs "
                "(row norms floored at the median row's)",
        rows=True, row_floor=True, tol=FLASH_BWD_ROW_TOL, library=sdpa_fb,
        peak=PEAK_BF16_S, nbytes=8 * q.numel() * 2 + lse.numel() * 4,
        ops=10 * D * pairs, exps=pairs, per=2, plain_reps=2), sm_clock_hz,
        label="phase 14")
    first = fab.flash_attention_bwd(q, k, v, out, lse, dout, True)
    again = fab.flash_attention_bwd(q, k, v, out, lse, dout, True)
    bwd["bitwise_repeat"] = all(torch.equal(a, b)
                                for a, b in zip(first, again))
    del first, again
    if not bwd["bitwise_repeat"]:
        fail("flash_attention_bwd: two calls on the same inputs differ")
    bwd["sdpa_forward_ms"] = cuda_ms(torch, lambda: sdpa(
        qt, kt, vt, is_causal=True), reps=10, per=5)
    bwd["sdpa_backward_ms"] = bwd["library_ms"] - bwd["sdpa_forward_ms"]

    def plain_vjp():
        qd, kd, vd = (t.detach().requires_grad_() for t in (q, k, v))
        with torch.enable_grad():
            o = L._plain_attn(qd, kd, vd, True)
            return torch.autograd.grad(o, (qd, kd, vd), dout)

    # the call's kernels apart: the statistics pre-pass, the one-pass main
    # kernel, the dQ post-pass (and the counters' memset)
    # (a kernel the profiler did not see is None, and so is the sum)
    pieces = kernel_pieces(torch, lambda: fab.flash_attention_bwd(
        q, k, v, out, lse, dout, True), dict(
            prepass_ms="stats_kernel", main_kernel_ms="bwd_h16_kernel",
            postpass_ms="dq_post_kernel"))
    total = pieces.pop("all_ms")
    bwd.update(pieces, device_ms=total)
    rate = ("" if bwd["main_kernel_ms"] is None else
            f" ({10 * D * pairs / bwd['main_kernel_ms'] / 1e9:.1f} TFLOP/s)")
    print(f"phase 14 attention backward's kernels (profiler, ms a call): "
          f"pre-pass {ms_text(bwd['prepass_ms'])}, main kernel "
          f"{ms_text(bwd['main_kernel_ms'])}{rate}, post-pass "
          f"{ms_text(bwd['postpass_ms'])}; all kernels "
          f"{ms_text(bwd['device_ms'])}")
    bwd["plain_vjp_ms"] = cuda_ms(torch, plain_vjp, reps=3, warmup=1)
    qg, kg, vg = (t.clone().requires_grad_() for t in (q, k, v))
    o = L.FlashAttention.apply(qg, kg, vg, True)
    bwd["function_backward_ms"] = cuda_ms(torch, lambda: torch.autograd.grad(
        o, (qg, kg, vg), dout, retain_graph=True), reps=5)
    del o
    print(f"phase 14 attention backward a layer (B {B}, S {S}, H {H}, D {D}"
          f", bf16, causal): backward kernel {bwd['ms']:.4f} ms "
          f"(FlashAttention's backward {bwd['function_backward_ms']:.4f}; "
          f"{10 * D * pairs / bwd['ms'] / 1e9:.1f} TFLOP/s of the 10 D it "
          f"does, two calls bit for bit); the plain route's VJP "
          f"{bwd['plain_vjp_ms']:.3f} ms; SDPA forward + backward "
          f"{bwd['library_ms']:.4f} ms (forward {bwd['sdpa_forward_ms']:.4f}"
          f", backward alone {bwd['sdpa_backward_ms']:.4f}); bound "
          f"{bwd['bound_ms']:.4f} ms ({bwd['bound_by']}, 10 D a kept pair; "
          f"{10 * D * pairs / 1e9:.1f} G ops); {cfg.num_layers} layers "
          f"{bwd['ms'] * cfg.num_layers:.1f} ms a step")
    return dict(shape=f"B {B}, S {S}, H {H}, D {D}, bf16, causal", **row,
                backward_kernel_ms=bwd["ms"],
                backward_plain_vjp_ms=bwd["plain_vjp_ms"],
                backward_sdpa_fwd_bwd_ms=bwd["library_ms"],
                backward_bound_ms=bwd["bound_ms"]), bwd


def segment_sum_row(torch, dev, cfg, B, S, sm_clock_hz) -> dict:
    """The embedding gradient's segment sum at the trainer's shape: the
    step's batch of B x S tokens (the data pipeline's Zipf draw) and random
    bf16 gradient rows of d_model into the padded vocabulary.  The kernel's
    float32 sums within float32 rounding of float64 (n 2^-24 times the sum
    of magnitudes, n the row's count), its bf16 output that sum rounded
    once, two calls bit for bit; timed (bf16 out, as the trainer calls it)
    beside its plain version, ``index_put_`` with accumulate (the gather's
    autograd backward, the route before the kernel) and its bound (the
    rows read once, the table written once)."""
    from repro_torch.data import pipeline as dpipe
    from repro_torch.kernels import segment_sum as ss
    tokens = dpipe.batch_at(dpipe.DataConfig(cfg.vocab_size, S, B, seed=0),
                            0, dev)["tokens"].reshape(-1)
    V, D, N = cfg.padded_vocab, cfg.d_model, tokens.numel()
    rows = torch.randn(N, D, generator=torch.Generator(device=dev)
                       .manual_seed(5), device=dev).to(torch.bfloat16)
    got = ss.segment_sum(rows, tokens, V, torch.float32)
    again = ss.segment_sum(rows, tokens, V, torch.float32)
    plain = ss.segment_sum_plain(rows, tokens, V, torch.float32)
    f64 = torch.zeros(V, D, dtype=torch.float64, device=dev).index_add_(
        0, tokens, rows.double())
    mag = torch.zeros_like(f64).index_add_(0, tokens, rows.double().abs())
    n = torch.bincount(tokens, minlength=V).double()[:, None]
    worst = float(((got.double() - f64).abs() / (n * 2 ** -24 * mag)
                   .clamp_min(1e-300)).max())
    bf16_once = torch.equal(ss.segment_sum(rows, tokens, V),
                            got.to(torch.bfloat16))
    err = float((got - plain).abs().max())
    # the kernel's two-level order, spelled out in plain torch
    same_order = torch.equal(got, ss.segment_sum_chunked(
        rows, tokens, V, torch.float32))
    del f64, mag, plain
    ok = worst <= 1 and torch.equal(got, again) and bf16_once and same_order
    ms = cuda_ms(torch, lambda: ss.segment_sum(rows, tokens, V), reps=10)
    plain_ms = cuda_ms(torch, lambda: ss.segment_sum_plain(
        rows, tokens, V, torch.bfloat16), reps=5)
    lib_ms = cuda_ms(torch, lambda: torch.zeros(
        V, D, dtype=torch.bfloat16, device=dev).index_put_(
            (tokens,), rows, accumulate=True), reps=10)
    bound = (N * D * 2 + V * D * 2) / PEAK_BYTES_S * 1e3
    # the call's pieces: the sort (the cast to int32 keys and torch's
    # stable sort), the chunk pass and the write pass
    # (a pass the profiler did not see is None, and so is the sort)
    pieces = kernel_pieces(torch, lambda: ss.segment_sum(rows, tokens, V),
                           dict(chunk_pass_ms="chunk_kernel",
                                write_pass_ms="write_kernel"))
    total = pieces.pop("all_ms")
    pieces["sort_ms"] = (None if total is None else
                         total - pieces["chunk_pass_ms"]
                         - pieces["write_pass_ms"])
    rate = ("" if pieces["write_pass_ms"] is None else
            f" at {V * D * 2 / pieces['write_pass_ms'] / 1e6:.0f} GB/s")
    print(f"phase 14 segment_sum's pieces (profiler, ms a call): sort "
          f"{ms_text(pieces['sort_ms'])}, chunk pass "
          f"{ms_text(pieces['chunk_pass_ms'])}, write pass "
          f"{ms_text(pieces['write_pass_ms'])} (the table's "
          f"{V * D * 2 / 1e9:.3f} GB{rate}); equal to "
          f"segment_sum_chunked bit for bit {same_order}")
    print(f"phase 14 segment_sum (the embedding gradient: {N} tokens, the "
          f"most frequent {int(n.max())} times, x {D} bf16 into {V} rows): "
          f"float32 sums off float64 by {worst:.3g} of the float32 rounding "
          f"bound (bar 1); bf16 out the float32 sum rounded once "
          f"{bf16_once}; two calls bit for bit {torch.equal(got, again)}; "
          f"max abs err against the plain version {err:.3g}; kernel "
          f"{ms:.4f} ms, plain {plain_ms:.4f} ms, index_put_ with accumulate "
          f"{lib_ms:.4f} ms, bound {bound:.4f} ms (bytes)")
    if not ok:
        fail(f"segment_sum: {worst} of the rounding bound, repeat "
             f"{torch.equal(got, again)}, bf16 rounded once {bf16_once}, "
             f"the chunked order {same_order}")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound, "bound_by": "bytes", "library_ms": lib_ms,
            **pieces}


def grad_route_parity(torch, fa_mod, dev) -> None:
    """Every leaf's gradient through the kernel route (``FlashAttention``:
    the flash kernel forward and the backward kernel, once a layer)
    against the plain route's (native autograd through ``_plain_attn``,
    ``layers.PlainAttention``) on the same weights and batch, at
    ``TRAIN_PARITY``'s widths, and in bf16 the plain route's against the
    float32 gradient (the same weights upcast), each within the bar; the
    attention weights' gradients nonzero."""
    from repro_torch.kernels import flash_attention_bwd as fab
    from repro_torch.configs import get_config
    from repro_torch.data import pipeline as dpipe
    from repro_torch.examples import train_lm
    from repro_torch.models import build
    from repro_torch.models import layers as L
    from repro_torch.train import trainstep as ts
    from repro_torch.train.checkpoint import _flatten_with_names as named
    for arch, over, B, S, tol in TRAIN_PARITY:
        cfg = (train_lm.small_cfg() if arch == "lm-10m"
               else get_config(arch)).scaled(**over)
        model = build(cfg)
        params = model.init(torch.Generator(device=dev).manual_seed(2))
        batch = dpipe.batch_at(dpipe.DataConfig(cfg.vocab_size, S, B, 2), 0,
                               dev)
        n0 = fa_mod.flash_attention.launches
        b0 = fab.flash_attention_bwd.launches
        loss_k, g_k = ts.value_and_grad(model, params, batch)
        n_k = fa_mod.flash_attention.launches - n0
        b_k = fab.flash_attention_bwd.launches - b0
        flash = L.FlashAttention
        L.FlashAttention = L.PlainAttention
        try:
            n0 = fa_mod.flash_attention.launches
            b0 = fab.flash_attention_bwd.launches
            loss_p, g_p = ts.value_and_grad(model, params, batch)
            n_p = fa_mod.flash_attention.launches - n0
            b_p = fab.flash_attention_bwd.launches - b0
            to_f32 = {}
            if cfg.dtype != "float32":
                f32 = L.tree_map(lambda t: t.float(), params)
                g_f = ts.value_and_grad(build(cfg.scaled(dtype="float32")),
                                        f32, batch)[1]
                for (name, b), (_, f) in zip(named(g_p), named(g_f)):
                    to_f32[name] = float((b.float() - f).abs().max()
                                         / f.abs().max().clamp_min(1e-30))
                del f32, g_f
        finally:
            L.FlashAttention = flash
        errs = {}
        for (name, a), (_, b) in zip(named(g_k), named(g_p)):
            scale = float(b.float().abs().max())
            errs[name] = (float((a.float() - b.float()).abs().max())
                          / max(scale, 1e-30), scale)
        over = {n: e for n, (e, _) in errs.items() if e > tol}
        far = {n: e for n, e in to_f32.items() if e > tol}
        worst = max(errs, key=lambda n: errs[n][0])
        attn = {n: e for n, e in errs.items()
                if n.split("/")[-1] in ("wq", "wk", "wv", "bq", "bk", "bv")}
        print(f"phase 14 gradient route parity {cfg.name} ({cfg.num_layers} "
              f"layers, d {cfg.d_model}, {cfg.dtype}, B {B} x S {S}, "
              f"{'chunked' if S > L.EXACT_ATTN_MAX_SEQ else 'exact'} plain "
              f"route; flash launches {n_k} kernel route, {n_p} plain; "
              f"backward kernel launches {b_k} kernel route, {b_p} plain): "
              f"loss {float(loss_k):.6f} vs {float(loss_p):.6f}; worst leaf "
              f"{worst} rel {errs[worst][0]:.3g} (bar {tol:g})"
              + (f"; the bf16 plain route's worst leaf against float32 "
                 f"{max(to_f32.values()):.3g} (bar {tol:g})"
                 if to_f32 else "")
              + "; attention "
              + ", ".join(f"{n.split('/')[-1]} {e:.3g} (|g| {s:.3g})"
                          for n, (e, s) in attn.items()))
        print(f"phase 14 gradient route parity {cfg.name} per leaf "
              "(kernel vs plain; bf16 plain vs float32): "
              + json.dumps({n: [round(e, 6), round(to_f32.get(n, 0.0), 6)]
                            for n, (e, _) in errs.items()}))
        if over or far or any(s <= 0 for _, s in attn.values()) \
                or n_k != (cfg.num_layers if not cfg.remat
                           else 2 * cfg.num_layers) or n_p != 0 \
                or b_k != cfg.num_layers or b_p != 0 \
                or len(attn) != (6 if cfg.qkv_bias else 3):
            fail(f"gradient route parity {cfg.name}: over the bar {over}, "
                 f"bf16 plain route off float32 {far}, attention {attn}, "
                 f"launches {n_k} / {n_p}, backward {b_k} / {b_p}")
        del params, g_k, g_p, model
        torch.cuda.empty_cache()


def loop_and_entry_points(torch, dev, tmp) -> dict:
    """train_lm (lm-10m, 60 steps: the loss falls), a run stopped at step
    30 and resumed to 60 against an uninterrupted one, a retried injected
    failure and an out-of-memory error raised past its retries, then
    ``quickstart --arch llama3-8b`` and the launcher's ``--smoke``."""
    from repro_torch.configs.base import InputShape
    from repro_torch.examples import quickstart, train_lm
    from repro_torch.launch import train as launch_train
    from repro_torch.models import build
    from repro_torch.train.loop import LoopConfig, train
    t0 = time.perf_counter()
    run_captured("phase 14 train_lm", lambda: train_lm.main(
        ["--ckpt", f"{tmp}/train_lm"]))
    model = build(train_lm.small_cfg())
    shape = InputShape("train", seq_len=128, global_batch=8, kind="train")
    lc = lambda d, n: LoopConfig(total_steps=n, ckpt_every=20,
                                 ckpt_dir=f"{tmp}/{d}", log_every=1000)
    whole = train(model, shape, None, None, lc("whole", 60), device=dev)
    first = train(model, shape, None, None, lc("split", 30), device=dev)
    second = train(model, shape, None, None, lc("split", 60), device=dev)
    resumed = np.asarray(first.losses + second.losses)
    rel = float(np.abs(resumed - whole.losses).max()
                / np.abs(whole.losses).max())
    print(f"phase 14 train_lm resume: stopped at 30, resumed to 60 "
          f"(restarts {second.restarts}): losses {whole.losses[0]:.4f} -> "
          f"{whole.losses[-1]:.4f}, largest relative difference from the "
          f"uninterrupted run {rel:.3g} (bar {TRAIN_RESUME_RTOL:g}); "
          f"bitwise {bool((resumed == whole.losses).all())}; median step "
          f"{statistics.median(whole.step_times) * 1e3:.2f} ms")
    if rel > TRAIN_RESUME_RTOL or not (resumed == whole.losses).all() \
            or second.restarts != 1 \
            or not whole.losses[-1] < whole.losses[0]:
        fail("train_lm's resume does not follow the uninterrupted run")
    calls = []

    def flaky(step, attempt):
        if step == 1 and attempt == 0:
            calls.append(step)
            raise RuntimeError("injected preemption")

    st = train(model, shape, None, None,
               LoopConfig(total_steps=3, ckpt_every=10,
                          ckpt_dir=f"{tmp}/retry", retry_backoff_s=0.01),
               fail_injector=flaky, device=dev)
    attempts = []

    def oom(step, attempt):
        attempts.append(attempt)
        raise torch.cuda.OutOfMemoryError("injected out of memory")

    try:
        train(model, shape, None, None,
              LoopConfig(total_steps=1, ckpt_dir=f"{tmp}/oom", max_retries=2,
                         retry_backoff_s=0.01), fail_injector=oom,
              device=dev)
        fail("an out-of-memory error past the retries was swallowed")
    except torch.cuda.OutOfMemoryError:
        pass
    print(f"phase 14 retry: injected failure at step 1 retried "
          f"({len(calls)} call, {st.step} steps, restarts {st.restarts}); "
          f"an out-of-memory error raised after attempts {attempts}")
    if calls != [1] or st.step != 3 or attempts != [0, 1, 2]:
        fail("the loop's retry")
    run_captured("phase 14 quickstart llama3-8b", lambda: quickstart.main(
        ["--arch", "llama3-8b", "--ckpt", f"{tmp}/quickstart"]))
    run_captured("phase 14 launch.train --smoke", lambda: launch_train.main(
        ["--arch", TRAIN_ARCH, "--smoke", "--steps", "4", "--ckpt",
         f"{tmp}/launch"]))
    return {"wall_s": time.perf_counter() - t0}


def trainer_phase(torch, ref, fa_mod, da_mod, dev, sm_clock_hz) -> dict:
    """14. The trainer on the card: qwen2.5-3b whole (``TRAIN_STEPS`` steps
    at B 2 x S 4,096), the step's time split, the attention backward and
    the kernel at the training shape, the kernel route's gradients
    against the plain route's, and the loop with its entry points.
    Returns the attention kernels' launches on the trained path (the
    full-width steps, the loop runs and quickstart's serving; counters
    zeroed before) and the flash-attention row at the training shape."""
    import tempfile
    from repro_torch.configs import get_config
    from repro_torch.configs.base import InputShape
    from repro_torch.data import pipeline as dpipe
    from repro_torch.models import build
    from repro_torch.models import layers as L
    from repro_torch.train import optimizer as opt
    from repro_torch.kernels import flash_attention_bwd as fab
    from repro_torch.kernels import segment_sum as ss
    from repro_torch.train import trainstep as ts
    t_phase = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    names = ("flash_attention", "decode_attention", "decode_attention_combine",
             "flash_attention_bwd", "segment_sum")
    counters = lambda: (fa_mod.flash_attention.launches,
                        da_mod.decode_attention.launches,
                        da_mod.decode_attention.combine_launches,
                        fab.flash_attention_bwd.launches,
                        ss.segment_sum.launches)
    held = torch.cuda.memory_allocated() / 1e9
    cfg = get_config(TRAIN_ARCH)
    model = build(cfg)
    e = TRAIN_EXPECT
    print(f"phase 14 {cfg.name} expected: {e['params'] / 1e9:.2f} B "
          f"parameters; {e['state_gb']:.1f} GB of parameters, gradients "
          f"and float32 moments; peak {e['peak_gb'][0]}-{e['peak_gb'][1]} "
          f"GB; {e['flop']:.2g} FLOP a step, bound {e['bound_s']:.2f} s at "
          f"989 TFLOP/s bf16; a step {e['step_s'][0]}-{e['step_s'][1]} s; "
          f"{2 * cfg.num_layers} flash launches, {cfg.num_layers} backward "
          f"kernel launches and one segment sum a batch")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    opt_state = opt.init(params)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in L.tree_leaves(params))
    state_gb = (2 * _nbytes(params) + 2 * _nbytes(opt_state.mu)) / 1e9
    flop = train_flop(cfg, params, TRAIN_B, TRAIN_S)
    bound_s = flop / PEAK_BF16_S
    print(f"phase 14 {cfg.name}: {cfg.num_layers} layers, d {cfg.d_model}, "
          f"{cfg.num_heads} heads (GQA {cfg.num_kv_heads}) of "
          f"{cfg.head_dim}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}, QKV "
          f"bias {cfg.qkv_bias}, {cfg.dtype}, remat {cfg.remat}; "
          f"{n_params:,} parameters; parameters + gradients + moments "
          f"{state_gb:.2f} GB; drawn in {time.perf_counter() - t0:.2f} s; "
          f"{flop:.4g} FLOP a step, bound {bound_s * 1e3:.1f} ms; "
          f"{held:.2f} GB held by earlier phases")
    opt_cfg = opt.OptConfig()
    dcfg = dpipe.DataConfig(cfg.vocab_size, TRAIN_S, TRAIN_B, seed=0)
    shape = InputShape("train", TRAIN_S, TRAIN_B, "train")
    fa_mod.flash_attention.launches = 0
    da_mod.decode_attention.launches = 0
    da_mod.decode_attention.combine_launches = 0
    fab.flash_attention_bwd.launches = 0
    ss.segment_sum.launches = 0
    step_rows, step, after = [], 0, None
    for micro, n in TRAIN_STEPS:
        fn = ts.build_train_step(model, shape, None, opt_cfg=opt_cfg,
                                 microbatches=micro)[0]
        for _ in range(n):
            batch = dpipe.batch_at(dcfg, step, dev)
            before = counters()
            torch.cuda.reset_peak_memory_stats()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            params, opt_state, m = fn(params, opt_state, batch)
            loss = float(m["loss"])
            wall = time.perf_counter() - t0
            peak = torch.cuda.max_memory_allocated() / 1e9
            fa_n, bwd_n, ss_n = (counters()[i] - before[i] for i in (0, 3, 4))
            row = dict(step=step, microbatches=micro, wall_ms=wall * 1e3,
                       tokens_s=TRAIN_B * TRAIN_S / wall, loss=loss,
                       grad_norm=float(m["grad_norm"]), peak_gb=peak,
                       flash_launches=fa_n, backward_launches=bwd_n,
                       segment_sum_launches=ss_n)
            step_rows.append(row)
            print(f"phase 14 {cfg.name} step {step} (microbatches {micro}):"
                  f" {wall * 1e3:.1f} ms, {row['tokens_s']:.0f} tokens/s, "
                  f"loss {loss:.5f}, grad_norm {row['grad_norm']:.4f}, "
                  f"peak {peak:.2f} GB, flash launches {fa_n}, backward "
                  f"kernel launches {bwd_n}, segment sums {ss_n}")
            if not (np.isfinite(loss) and np.isfinite(row["grad_norm"])) \
                    or fa_n != 2 * cfg.num_layers * micro \
                    or bwd_n != cfg.num_layers * micro or ss_n != micro:
                fail(f"train {cfg.name} step {step}: loss {loss}, "
                     f"{fa_n} flash launches, {bwd_n} backward kernel "
                     f"launches, {ss_n} segment sums")
            step += 1
        if after is None:
            # phase 15's sharded steps start from the same state and
            # batches: the parameters after these steps, on the host
            after = {"steps": list(step_rows),
                     "params": L.tree_map(lambda t: t.cpu(), params)}
    full_launches = counters()
    split = train_step_split(torch, model, params, opt_state,
                             dpipe.batch_at(dcfg, step, dev), opt_cfg)
    s = split
    print(f"phase 14 {cfg.name} step split (CUDA events, ms): loss forward "
          f"{s['forward_ms']:.1f}, block stack forward (what remat "
          f"recomputes) {s['blocks_forward_ms']:.1f}, forward + backward "
          f"{s['value_and_grad_ms']:.1f}, optimizer {s['optimizer_ms']:.1f};"
          f" under the profiler one forward + backward {s['profiled_wall_ms']:.1f}"
          f" ms wall, {s['profiled_device_ms']:.1f} ms of kernels "
          f"({1 - s['profiled_device_ms'] / s['profiled_wall_ms']:.1%} idle)")
    del params, opt_state, model
    torch.cuda.empty_cache()
    row, bwd_row = attention_backward_rows(torch, ref, fa_mod, sm_clock_hz,
                                           dev, cfg, TRAIN_B, TRAIN_S)
    ss_row = segment_sum_row(torch, dev, cfg, TRAIN_B, TRAIN_S, sm_clock_hz)
    grad_route_parity(torch, fa_mod, dev)
    before = counters()
    with tempfile.TemporaryDirectory() as tmp:
        loop = loop_and_entry_points(torch, dev, tmp)
    launches = dict(zip(names, (a + c - b for a, b, c in
                                zip(counters(), before, full_launches))))
    print(f"phase 14 loop and entry points: {loop['wall_s']:.1f} s; "
          f"launches on the trained path (full width, loop, quickstart's "
          f"serving): {launches}")
    if min(launches.values()) <= 0:
        fail(f"trainer: a kernel of the trained path was not launched: "
             f"{launches}")
    print(f"phase 14 trainer: ok; phase wall "
          f"{time.perf_counter() - t_phase:.2f} s")
    return {"launches": launches, "row": row, "steps": step_rows,
            "split": split, "after": after,
            "rows": {"flash_attention_bwd": bwd_row, "segment_sum": ss_row}}


# ---- 15. the device mesh ----------------------------------------------------
# The mesh branches at published widths on a one-rank NCCL mesh (data 1,
# model 1), the reference's single-device baseline: llama3-8b served through
# build_prefill_step / build_decode_step (every decode step through
# collectives.flash_decode_attention on the split and combine kernels),
# granite-moe-3b's prefill through the MoE's shard_map branch (expert
# parallelism at model 1), and qwen2.5-3b's sharded train step from phase
# 14's initial state (at model 1 the serve steps' tensor parallelism is the
# identity, so the mesh serving is bit for bit the one-device steps); then
# two gloo ranks on the one card (scripts/mesh_two_ranks.py): the
# collectives alone, the tensor-parallel decode, the MoE and the pipeline at
# .smoke() widths, llama3-8b at full width cut to 2 layers through the
# tensor-parallel prefill and decode steps on (1, 2), and the
# tensor-parallel train step (qwen2.5-3b at full width cut to 2 layers;
# mamba2-130m whole with its serve steps, the SSD heads over "model"); and
# the dry run in subprocesses.
MESH_SERVE_ROUND = SERVE_ROUNDS[0]          # the launcher's defaults
MESH_MOE_ARCH = "granite-moe-3b-a800m"
MESH_MOE_SHAPE = (4, 64)                    # a prefill's B x S
# the sharded step's gradient norm against phase 14's, relative: the
# parameters move by ~lr (3e-6 to 9e-6 in these warm-up steps), far inside
# TRAIN_PARITY's bar, so this is what holds the step's gradient
MESH_GRAD_NORM_RTOL = 1e-4
# the two-rank check against the one-rank results on the card: the
# reference's bars (tests/test_distributed.py)
MESH_TWO_RANK_TOL = dict(logits=3e-4, cache=1e-5, moe=2e-4, pipeline=1e-5)
# the kernels each two-rank job's path must launch on each rank
MESH_TWO_RANK_KERNELS = {
    "decode": ("decode_attention", "decode_attention_combine"),
    "llama_full": ("decode_attention", "decode_attention_combine",
                   "flash_attention"),
    "train_full": ("flash_attention", "flash_attention_bwd", "segment_sum"),
    "mamba_full": ("segment_sum",)}
# the dry run's predictions for the phase-14 step (one rank, B 2 x S 4,096),
# stated before the run (PERF.md, the mesh's findings): the counted FLOPs
# over train_flop's products, and the bound
MESH_DRYRUN_EXPECT = dict(flop_ratio=(1.0, 1.25), bound="memory")


class StepModel:
    """A model whose prefill and decode go through the step builders
    (``trainstep.build_prefill_step`` / ``build_decode_step``) on ``mesh``
    (None: the one-device steps), one step function a shape; the logits of
    every call are kept (gathered whole) for the comparison."""

    def __init__(self, torch, model, mesh):
        self.torch, self.model, self.mesh, self.cfg = torch, model, mesh, \
            model.cfg
        self.steps, self.logits = {}, []

    def _step(self, kind, B, max_seq):
        from repro_torch.configs.base import InputShape
        from repro_torch.train import trainstep as ts
        key = (kind, B, max_seq)
        if key not in self.steps:
            build = (ts.build_prefill_step if kind == "prefill"
                     else ts.build_decode_step)
            self.steps[key] = build(self.model, InputShape(
                "serve", max_seq, B, kind), self.mesh)[0]
        return self.steps[key]

    def _keep(self, logits):
        from repro_torch.distributed import sharding as shd
        logits = shd.full(logits)
        self.logits.append(logits.clone())
        return logits

    def prefill(self, params, batch, max_seq):
        self.max_seq = max_seq
        fn = self._step("prefill", batch["tokens"].shape[0], max_seq)
        logits, cache = fn(params, batch)
        return self._keep(logits), cache

    def decode_step(self, params, cache, tokens, pos):
        fn = self._step("decode", tokens.shape[0], self.max_seq)
        logits, cache = fn(params, cache, tokens, pos)
        return self._keep(logits), cache


def mesh_serve(torch, fa_mod, da_mod, mesh, dev, phase13_decode_ms) -> dict:
    """(a) llama3-8b whole through the step builders, the launcher's round
    with mesh=None steps and then on the mesh: the logits bit for bit.
    Returns the mesh round's row, with the attention kernels' launches in
    that round alone (``flash``, ``split``, ``combine``)."""
    from repro_torch.configs import get_config
    from repro_torch.distributed import sharding as shd
    from repro_torch.models import build
    from repro_torch.train import trainstep as ts
    cfg = get_config(SERVE_ARCH)
    model = build(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    placed = shd.place_tree(params, ts.param_shardings(model, mesh))
    r = MESH_SERVE_ROUND[1]
    runs = {}
    for label, m, p in (("mesh=None", None, params), ("mesh", mesh, placed)):
        steps = StepModel(torch, model, m)
        serve_requests(torch, steps, p, dict(r, requests=2, new=2))  # warm
        steps.logits.clear()
        n0 = (da_mod.decode_attention.launches,
              da_mod.decode_attention.combine_launches,
              fa_mod.flash_attention.launches)
        torch.cuda.reset_peak_memory_stats()
        eng, timed, wall, n_tok = serve_requests(torch, steps, p, r)
        runs[label] = dict(
            logits=steps.logits, wall=wall, tokens=n_tok,
            decode_ms=statistics.median(timed.decode_ms),
            prefill_ms=statistics.median(timed.prefill_ms),
            peak_gb=torch.cuda.max_memory_allocated() / 1e9,
            split=da_mod.decode_attention.launches - n0[0],
            combine=da_mod.decode_attention.combine_launches - n0[1],
            flash=fa_mod.flash_attention.launches - n0[2],
            steps=eng.decode_steps)
        print(f"phase 15 {cfg.name} served ({MESH_SERVE_ROUND[0]}, "
              f"{label} steps): {n_tok} tokens in {wall:.3f} s, "
              f"{n_tok / wall:.1f} tok/s; prefill median "
              f"{runs[label]['prefill_ms']:.2f} ms, decode step median "
              f"{runs[label]['decode_ms']:.2f} ms (phase 13's "
              f"{phase13_decode_ms:.2f}); {eng.decode_steps} decode steps, "
              f"split {runs[label]['split']}, combine "
              f"{runs[label]['combine']} launches; peak "
              f"{runs[label]['peak_gb']:.2f} GB")
    host_rows(torch, model, placed, mesh)
    a, b = runs["mesh=None"]["logits"], runs["mesh"]["logits"]
    same = len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))
    print(f"phase 15 {cfg.name} mesh steps against mesh=None steps: "
          f"{len(b)} logits tensors, bit for bit {same}")
    if not same or runs["mesh"]["split"] != \
            runs["mesh"]["steps"] * cfg.num_layers \
            or runs["mesh"]["combine"] != runs["mesh"]["split"]:
        fail(f"mesh serve: logits equal {same}, launches "
             f"{runs['mesh']['split']} / {runs['mesh']['combine']} for "
             f"{runs['mesh']['steps']} decode steps")
    del params, placed, model
    torch.cuda.empty_cache()
    return runs["mesh"]


def host_rows(torch, model, params, mesh, top: int = 8) -> None:
    """One decode step on the mesh (B 4, max_seq 64) under the profiler:
    its wall, its kernels' device time, and the operators with the most
    host time (self CPU time)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs.base import InputShape
    from repro_torch.train import trainstep as ts
    shape = InputShape("serve", 64, 4, "decode")
    pf = ts.build_prefill_step(model, InputShape("serve", 64, 4, "prefill"),
                               mesh)[0]
    dec = ts.build_decode_step(model, shape, mesh)[0]
    toks = torch.zeros(4, 9, dtype=torch.int32, device="cuda")
    _, cache = pf(params, {"tokens": toks})
    tok = toks[:, :1]
    dec(params, cache, tok, 9)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        dec(params, cache, tok, 10)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    ev = prof.key_averages()
    device = sum(e.self_device_time_total for e in ev
                 if e.device_type == DeviceType.CUDA) / 1e3
    cpu = sorted((e for e in ev if e.device_type == DeviceType.CPU),
                 key=lambda e: -e.self_cpu_time_total)[:top]
    print(f"phase 15 one mesh decode step under the profiler: {wall:.2f} "
          f"ms wall, {device:.2f} ms of kernels; most host time: "
          + ", ".join(f"{e.key} {e.self_cpu_time_total / 1e3:.2f} ms x "
                      f"{e.count}" for e in cpu))
    # the Python side of the same step: the functions with the most
    # cumulative time, three steps under cProfile
    import cProfile
    import pstats
    prof = cProfile.Profile()
    prof.enable()
    for t in range(3):
        dec(params, cache, tok, 11 + t)
    torch.cuda.synchronize()
    prof.disable()
    st = pstats.Stats(prof).stats
    rows = sorted(((v[3] / 3e-3, f"{Path(k[0]).name}:{k[1]}({k[2]})")
                   for k, v in st.items() if "repro_torch" in k[0]
                   or "distributed_c10d" in k[0]), reverse=True)[:top]
    print("phase 15 one mesh decode step, cumulative host ms a step "
          "(cProfile): " + ", ".join(f"{n} {ms:.2f}" for ms, n in rows))


def mesh_moe(torch, fa_mod, mesh, dev) -> int:
    """(b) granite-moe-3b whole: a prefill step on the mesh (every layer's
    MoE through the shard_map branch, expert parallelism at model 1)
    against the one-device step, bit for bit, with torch's deterministic
    algorithms off: the combine sums each token's slots in slot order
    (``moe._SlotSum``; an ``index_add_`` combine differed from call to call
    by 0.188 of a largest logit of 4.69 on an H100 80GB HBM3 at 700 W).
    Returns the flash kernel's launches in the mesh call alone."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import InputShape
    from repro_torch.distributed import sharding as shd
    from repro_torch.models import build
    from repro_torch.models import moe as M
    from repro_torch.train import trainstep as ts
    cfg = get_config(MESH_MOE_ARCH)
    model = build(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    B, S = MESH_MOE_SHAPE
    shape = InputShape("prefill", S, B, "prefill")
    toks = torch.randint(0, cfg.vocab_size, (B, S), dtype=torch.int32,
                         generator=torch.Generator().manual_seed(3)).to(dev)
    local = ts.build_prefill_step(model, shape)[0]
    fn, (p_sh, _), _, _ = ts.build_prefill_step(model, shape, mesh)
    placed = shd.place_tree(params, p_sh)
    calls = []
    sharded = M._moe_sharded
    M._moe_sharded = lambda *a: calls.append(1) or sharded(*a)
    if torch.are_deterministic_algorithms_enabled():
        fail("mesh MoE: torch's deterministic algorithms are on")
    try:
        local(params, {"tokens": toks})               # warm
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        l0, _ = local(params, {"tokens": toks})
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        f0 = fa_mod.flash_attention.launches
        l1, c1 = fn(placed, {"tokens": toks})
        flash = fa_mod.flash_attention.launches - f0
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        again, _ = local(params, {"tokens": toks})
    finally:
        M._moe_sharded = sharded
    err = float((shd.full(l1) - l0).abs().max())
    noise = float((again - l0).abs().max())
    print(f"phase 15 {cfg.name} whole ({cfg.num_layers} layers, "
          f"{cfg.num_experts} experts top-{cfg.experts_per_token}) prefill "
          f"B {B} x S {S}, deterministic algorithms off: {len(calls)} MoE "
          f"calls on the shard_map branch (expert parallelism at model 1), "
          f"{flash} flash launches; "
          f"mesh {(t2 - t1) * 1e3:.1f} ms, mesh=None {(t1 - t0) * 1e3:.1f} "
          f"ms; logits max abs err {err:.3g} against the local branch, "
          f"whose own two calls differ by {noise:.3g}; bar: bit for bit")
    if err > 0 or noise > 0 or len(calls) != cfg.num_layers \
            or flash != cfg.num_layers:
        fail(f"mesh MoE: {err} off the local branch (its own spread "
             f"{noise}), {len(calls)} sharded calls, {flash} flash launches")
    del params, placed, model, c1
    torch.cuda.empty_cache()
    return flash


def mesh_train(torch, fa_mod, mesh, dev, trainer) -> dict:
    """(c) qwen2.5-3b whole: three sharded steps from phase 14's initial
    state and batches, against phase 14's mesh=None steps (its parameters
    after them, on the host)."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import InputShape
    from repro_torch.data import pipeline as dpipe
    from repro_torch.distributed import sharding as shd
    from repro_torch.models import build
    from repro_torch.train import optimizer as opt
    from repro_torch.train import trainstep as ts
    from repro_torch.train.checkpoint import _flatten_with_names as named
    tol = dict((a, t) for a, _, _, _, t in TRAIN_PARITY)[TRAIN_ARCH]
    cfg = get_config(TRAIN_ARCH)
    model = build(cfg)
    shape = InputShape("train", TRAIN_S, TRAIN_B, "train")
    fn, (p_sh, o_sh, _), _, _ = ts.build_train_step(
        model, shape, mesh, opt_cfg=opt.OptConfig(), microbatches=1)
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    state = shd.place_tree(opt.init(params), o_sh)
    params = shd.place_tree(params, p_sh)
    dcfg = dpipe.DataConfig(cfg.vocab_size, TRAIN_S, TRAIN_B, seed=0)
    want = trainer["after"]
    rows = []
    for step, ref in enumerate(want["steps"]):
        batch = dpipe.batch_at(dcfg, step, dev)
        before = fa_mod.flash_attention.launches
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, state, m = fn(params, state, batch)
        loss = float(m["loss"])
        wall = time.perf_counter() - t0
        row = dict(wall_ms=wall * 1e3, loss=loss,
                   grad_norm=float(m["grad_norm"]),
                   peak_gb=torch.cuda.max_memory_allocated() / 1e9,
                   flash_launches=fa_mod.flash_attention.launches - before)
        rows.append(row)
        print(f"phase 15 {cfg.name} sharded step {step} (mesh 1x1): "
              f"{row['wall_ms']:.1f} ms (phase 14 {ref['wall_ms']:.1f}), "
              f"loss {loss:.5f} (phase 14 {ref['loss']:.5f}), grad_norm "
              f"{row['grad_norm']:.6f} (phase 14 {ref['grad_norm']:.6f}), peak "
              f"{row['peak_gb']:.2f} GB (phase 14 {ref['peak_gb']:.2f}), "
              f"flash launches {row['flash_launches']}")
        gn_err = abs(row["grad_norm"] - ref["grad_norm"]) / ref["grad_norm"]
        if row["flash_launches"] != 2 * cfg.num_layers \
                or abs(loss - ref["loss"]) > tol * abs(ref["loss"]) \
                or gn_err > MESH_GRAD_NORM_RTOL:
            fail(f"sharded step {step}: loss {loss} against "
                 f"{ref['loss']}, grad_norm {row['grad_norm']} against "
                 f"{ref['grad_norm']}, {row['flash_launches']} flash "
                 f"launches")
    worst, worst_name = 0.0, ""
    for (name, a), (_, b) in zip(named(params), named(want["params"])):
        a = shd.full(a).float()
        b = b.to(dev).float()
        e = float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))
        if e > worst:
            worst, worst_name = e, name
    print(f"phase 15 {cfg.name} parameters after {len(rows)} sharded steps "
          f"against phase 14's: worst leaf {worst_name} rel {worst:.3g} "
          f"(bar {tol:g}); step wall median "
          f"{statistics.median(r['wall_ms'] for r in rows):.1f} ms against "
          f"{statistics.median(r['wall_ms'] for r in want['steps']):.1f}: "
          f"the DTensor host overhead")
    if worst > tol:
        fail(f"sharded train step: {worst_name} off by {worst:.3g}")
    del params, state, model
    torch.cuda.empty_cache()
    return {"steps": rows, "worst": worst}


def mesh_two_ranks(torch, dev, tmp) -> dict:
    """(d) two gloo ranks on the one card (scripts/mesh_two_ranks.py), a
    pair of processes a job, every job at once: each collective of the
    mesh path alone, then the tensor-parallel decode over a sequence
    sharded over model 2, llama3-8b at full width (2 layers, float32)
    through the tensor-parallel prefill and decode steps, the MoE's expert
    parallelism, a two-stage pipeline and the tensor-parallel train jobs
    (``train_full``, ``mamba_full``; each rank holds itself to one rank in
    its own process), each held to the one-rank result on the card; a
    path that failed where one of its collectives failed alone is named,
    with them, as kept on the CPU tests.  The kernels of each job's path
    (``MESH_TWO_RANK_KERNELS``) must be launched on each rank.  Returns
    the serve jobs' launches and the train jobs', each summed over the
    jobs' ranks."""
    sys.path.insert(0, str(ROOT / "scripts"))
    import mesh_two_ranks as w
    from repro_torch.configs import get_config
    from repro_torch.models import build
    from repro_torch.models import moe as M
    jobs = list(w.PROBES) + list(w.USES)
    procs = {}
    for job in jobs:
        d = Path(tmp) / job.replace("/", "_")
        d.mkdir()
        procs[job] = (d, [subprocess.Popen(
            [sys.executable, str(ROOT / "scripts" / "mesh_two_ranks.py"),
             str(r), str(d), str(dev), job], stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True) for r in range(2)])
    status = {}
    try:
        # the one-rank results, while the ranks run
        x = w.inputs(torch, dev)
        t0 = time.perf_counter()
        one_full = w.full_one_rank(torch, dev)
        print(f"phase 15 llama3-8b full width ({w.FULL}) on one rank: "
              f"{time.perf_counter() - t0:.1f} s")
        for job, (d, ps) in procs.items():
            outs = [p.communicate(timeout=600) for p in ps]
            codes = [p.returncode for p in ps]
            status[job] = "ok" if codes == [0, 0] else (
                f"exit {codes}: " + next(
                    (ln for _, se in outs for ln in reversed(
                        se.strip().splitlines()) if ln.strip()), "")[:160])
    finally:
        for _, ps in procs.values():
            for p in ps:
                if p.poll() is None:
                    p.kill()
                    p.wait()
    print("phase 15 two ranks on one card (gloo), each collective alone "
          "on a CUDA tensor: " + json.dumps({j: status[j]
                                             for j in w.PROBES}))
    full, full_cache = one_full
    one = w.decode_cases(torch, build(get_config("llama3-8b").smoke()
                                      .scaled(**w.LLAMA_SMOKE)),
                         x["llama"], x)
    moe_local = M.moe_fwd(x["moe"], x["moe_h"],
                          get_config("granite-moe-3b-a800m").smoke())[0]
    pipe = x["pipe_x"]
    for s in range(2):
        pipe = torch.tanh(pipe @ x["pipe_w"][s])
    t = MESH_TWO_RANK_TOL
    tp_launches, train_launches = {}, {}
    for name, uses in w.USES.items():
        if status[name] != "ok":
            failed = [c for c in uses if status[c] != "ok"]
            if not failed:
                fail(f"two-rank {name}: {status[name]}")
            print(f"phase 15 two ranks: {name} not run on the card: gloo "
                  f"failed {', '.join(failed)} on a CUDA tensor; its "
                  f"two-rank check stays on the CPU tests "
                  f"(tests/test_torch_distributed.py)")
            continue
        errs, floor = [], {}
        for r in range(2):
            res = torch.load(procs[name][0] / f"rank{r}.pt")
            if "launches" in res:
                print(f"phase 15 two ranks: {name} rank {r}: parameters "
                      f"{res['param_bytes'] / 1e9:.4f} GB, peak "
                      f"{res.get('peak_bytes', 0) / 1e9:.3f} GB in the "
                      f"steps; launches {res['launches']}")
                want = MESH_TWO_RANK_KERNELS[name]
                if min(res["launches"][k] for k in want) <= 0:
                    fail(f"two-rank {name}: a kernel of its path was not "
                         f"launched on rank {r}: {res['launches']}")
                into = train_launches if name in w.TRAIN_JOBS \
                    else tp_launches
                for k, v in res["launches"].items():
                    into[k] = into.get(k, 0) + v
            if name in w.TRAIN_JOBS:
                big = (f"largest magnitudes {res['largest']}; "
                       if res["largest"] else "")
                print(f"phase 15 two ranks: {name} rank {r}: (loss, "
                      f"grad_norm) a step {res['metrics']} against one "
                      f"rank's {res['one_metrics']}; {big}worst error of "
                      f"each bar {w.TRAIN_BARS}: " + json.dumps(
                          {k: float(f"{v:.4g}")
                           for k, v in res["worst"].items()}))
                if r == 0 and "floor" in res:
                    floor = res["floor"]
                    print(f"phase 15 two ranks: {name}: one rank on the "
                          f"host against one rank on the card, the float32 "
                          f"floor at this scale, in the same bars: "
                          + json.dumps({k: float(f"{v:.4g}")
                                        for k, v in floor.items()})
                          + f"; host (loss, grad_norm) a step "
                          f"{res['host_metrics']}")
                # a bar, or the floor where one rank's own float32 spread
                # passes it (w.FLOORED)
                scale = floor if name in w.FLOORED else {}
                errs.append(max(v / max(1.0, scale.get(k, 0.0))
                                for k, v in res["worst"].items()))
            elif name == "decode":
                for S, (l1, k1, v1) in one.items():
                    l, k, v = res[f"decode{S}"]
                    lr = l1.chunk(2, dim=-1)[r].cpu()
                    kr, vr = (c.chunk(2, dim=2)[r].cpu() for c in (k1, v1))
                    errs.append(max(float((l - lr).abs().max())
                                    / t["logits"],
                                    float((k - kr).abs().max()) / t["cache"],
                                    float((v - vr).abs().max()) / t["cache"]))
            elif name == "llama_full":
                e_l = float((res["logits"] - full.chunk(2, dim=-1)[r]).abs()
                            .max())
                e_c = max(float((res["cache"][n] - c.chunk(2, dim=2)[r])
                                .abs().max()) for n, c in full_cache.items())
                print(f"phase 15 two ranks: llama_full rank {r}: "
                      f"{len(full)} calls' logits (largest "
                      f"{float(full.abs().max()):.3f}) max abs err "
                      f"{e_l:.3g} (bar {t['logits']:g}), its rows of the "
                      f"cache {e_c:.3g} (bar {t['cache']:g})")
                errs.append(max(e_l / t["logits"], e_c / t["cache"]))
            elif name == "moe":
                errs.append(float((res["moe"][0] - moe_local.cpu()).abs()
                                  .max()) / t["moe"])
            else:
                errs.append(float((res["pipeline"] - pipe.cpu()).abs()
                                  .max()) / t["pipeline"])
        print(f"phase 15 two ranks: {name} on {dev} against one rank: "
              f"worst error {max(errs):.3g} of the bar")
        if max(errs) > 1:
            fail(f"two-rank {name} differs from one rank")
    for name in ("decode", "llama_full") + w.TRAIN_JOBS:
        if status[name] != "ok":
            fail(f"two-rank {name}: {status[name]}")
    return tp_launches, train_launches


def mesh_dryrun(cfg_flop, tmp) -> dict:
    """(e) the dry run, in subprocesses: qwen2.5-3b x train_4k on the
    single-pod 16 x 16 fake mesh, and phase 14's step shape on one rank."""
    out = Path(tmp) / "dryrun_torch.jsonl"
    cells = (["--shape", "train_4k", "--mesh", "single"],
             ["--shape", "train_4k", "--mesh", "one", "--batch",
              str(TRAIN_B), "--seq", str(TRAIN_S)])
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    for args in cells:
        t0 = time.perf_counter()
        run = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
             TRAIN_ARCH, *args, "--out", str(out)], capture_output=True,
            text=True, env=env, timeout=600)
        if run.returncode:
            fail(f"dry run {args}: exit {run.returncode}\n"
                 f"{run.stderr[-3000:]}")
        print(f"phase 15 dry run {' '.join(args)} "
              f"({time.perf_counter() - t0:.1f} s): "
              f"{run.stdout.strip().splitlines()[0]}")
    recs = [json.loads(ln) for ln in out.read_text().splitlines()]
    pod, one = recs
    for r in recs:
        print(f"phase 15 dry run record {r['arch']} {r['shape']} "
              f"{r['mesh']}: " + json.dumps(
                  {"per_device": {k: v for k, v in r["per_device"].items()
                                  if k != "ici_by_op"},
                   "roofline": r["roofline"]}))
    if not (pod["per_device"]["fits_80GB"] and min(
            pod["roofline"]["t_compute_s"], pod["roofline"]["t_memory_s"],
            pod["roofline"]["t_collective_s"]) > 0):
        fail(f"dry run train_4k: {pod['per_device']}")
    ratio = one["per_device"]["flops"] / cfg_flop
    lo, hi = MESH_DRYRUN_EXPECT["flop_ratio"]
    print(f"phase 15 dry run of phase 14's step (B {TRAIN_B} x S "
          f"{TRAIN_S}, one rank): {one['per_device']['flops']:.4g} FLOP "
          f"counted against train_flop's {cfg_flop:.4g} (ratio "
          f"{ratio:.3f}; predicted {lo}-{hi}); bound "
          f"{one['roofline']['bound']} (predicted "
          f"{MESH_DRYRUN_EXPECT['bound']}), t_compute "
          f"{one['roofline']['t_compute_s'] * 1e3:.1f} ms, t_memory "
          f"{one['roofline']['t_memory_s'] * 1e3:.1f} ms")
    return {"pod": pod, "one": one, "ratio": ratio}


def mesh_phase(torch, fa_mod, da_mod, dev, server, trainer) -> dict:
    """15. The device mesh on the card (see the section's comment).
    Returns the attention kernels' launches in the calls that went through
    the mesh (a's mesh round, b's mesh prefill, c's sharded steps; each
    counted around its call, so the mesh=None runs they are held to add
    nothing), and in d's tensor-parallel serve jobs (``tp_launches``)."""
    import tempfile
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import build
    t_phase = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    with tempfile.TemporaryDirectory() as tmp:
        torch.cuda.set_device(torch.cuda.current_device())
        dist.init_process_group(
            "nccl", init_method=f"file://{tmp}/store", rank=0, world_size=1,
            device_id=torch.device("cuda", torch.cuda.current_device()))
        try:
            mesh = make_host_mesh(data=1, model=1)
            print(f"phase 15 mesh {mesh} on the {dist.get_backend()} "
                  f"backend")
            serve = mesh_serve(torch, fa_mod, da_mod, mesh, dev,
                               server["decode_ms"])
            moe_flash = mesh_moe(torch, fa_mod, mesh, dev)
            train = mesh_train(torch, fa_mod, mesh, dev, trainer)
            launches = {
                "flash_attention": serve["flash"] + moe_flash + sum(
                    r["flash_launches"] for r in train["steps"]),
                "decode_attention": serve["split"],
                "decode_attention_combine": serve["combine"]}
            print(f"phase 15 launches on the mesh paths: {launches}")
            if min(launches.values()) <= 0:
                fail(f"mesh: an attention kernel was not launched: "
                     f"{launches}")
        finally:
            dist.destroy_process_group()
        two = Path(tmp) / "two"
        two.mkdir()
        tp_launches, train_launches = mesh_two_ranks(torch, dev, two)
        print(f"phase 15 launches on the tensor-parallel serve paths (two "
              f"ranks, both ranks' summed): {tp_launches}")
        print(f"phase 15 launches on the tensor-parallel train paths (two "
              f"ranks, both ranks' summed): {train_launches}")
        cfg = get_config(TRAIN_ARCH)
        dry = mesh_dryrun(train_flop(cfg, build(cfg).param_structs(),
                                     TRAIN_B, TRAIN_S), tmp)
    print(f"phase 15 device mesh: ok; phase wall "
          f"{time.perf_counter() - t_phase:.2f} s")
    return {"launches": launches, "tp_launches": tp_launches,
            "train_launches": train_launches, "train": train, "dryrun": dry}


def codegen_round_trip(tracegen) -> None:
    """The code generator on the host: every app emitted and held to the
    committed corpus (``src/repro_torch/asm``) after the 4-line header, then
    ``python -m repro_torch.core.codegen --check-all``'s round trip (decode
    at every MVL of ``rvv.CHECK_MVLS``, fingerprint-equal to the torch.fx
    lowering)."""
    from repro_torch.core import codegen, crossval
    t0 = time.perf_counter()
    apps = sorted(a for a in tracegen.APPS if tracegen.APPS[a].kernel)
    texts = {a: codegen.emit_app(a) for a in apps}
    emit_s = time.perf_counter() - t0
    differ = [a for a, text in texts.items()
              if text.splitlines()[4:] != (
                  ROOT / "src" / "repro_torch" / "asm"
                  / tracegen.APPS[a].asm).read_text().splitlines()[4:]]
    t0 = time.perf_counter()
    reports = [r for a in apps
               for r in crossval.round_trip_app(a, text=texts[a])]
    bad = [f"{r.app}@{r.mvl}: {r.problems}" for r in reports if not r.ok]
    print(f"phase 8 codegen: {len(apps) - len(differ)}/{len(apps)} emitted "
          f"files equal to the committed corpus after the header "
          f"({emit_s:.1f} s); round trips {len(reports) - len(bad)}/"
          f"{len(reports)} ok ({time.perf_counter() - t0:.1f} s)")
    if differ or bad or len(apps) != 10 or len(reports) != 60:
        fail(f"codegen: corpus differs for {differ}; round trips {bad}")


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", type=Path, default=None,
                    help="another checkout's root: phase 3 also times its "
                         "collect build and phase 9 its profiler path, in "
                         "this run")
    parent = ap.parse_args(argv).parent
    sys.stdout.reconfigure(line_buffering=True)   # phase lines survive a kill
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir() or not GOLDEN.exists():
        print("chip_smoke: run from a checkout of the repository "
              "(src/repro_torch and tests/golden_sweep.json beside this "
              "script)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch import _build, _device
    from repro_torch.configs import vector_engine as ve
    from repro_torch.core import anchors, engine as eng, isa
    from repro_torch.core import scalar_pipeline as sp
    from repro_torch.core import suite, tracegen
    from repro_torch.kernels import blackscholes as bs_mod
    from repro_torch.kernels import canneal as ca_mod
    from repro_torch.kernels import decode_attention as da_mod
    from repro_torch.kernels import engine_scan, ops, ref
    from repro_torch.kernels import flash_attention as fa_mod
    from repro_torch.kernels import jacobi2d as j2_mod
    from repro_torch.kernels import particlefilter as pf_mod
    from repro_torch.kernels import pathfinder as path_mod
    from repro_torch.kernels import ssd_scan as ssd_mod
    from repro_torch.kernels import streamcluster as sc_mod
    from repro_torch.kernels import swaptions as sw_mod
    # launch counters of the suite kernels, in SUITE_REPLACES order
    suite_mods = (sw_mod.cum_normal_inv, sc_mod.streamcluster_dist,
                  pf_mod.find_index, ca_mod.swap_cost, j2_mod.jacobi2d_step,
                  path_mod.pathfinder, fa_mod.flash_attention,
                  da_mod.decode_attention, ssd_mod.ssd_scan)

    dev = _device.resolve()
    # ---- 1. device + build ------------------------------------------------
    print(nvidia_smi("name,power.limit"))
    sm_clock_hz = float(nvidia_smi("clocks.max.sm").split()[0]) * 1e6
    t0 = time.perf_counter()
    report = _build.build_all()
    build_s = time.perf_counter() - t0
    for name, r in report.items():
        regs = [ln.strip() for ln in r["log"].splitlines()
                if "Used" in ln or "bytes stack" in ln]
        print(f"phase 1 build {name}: {r['seconds']:.1f} s  {' | '.join(regs)}")
    print(f"phase 1 flash_attention SASS: {sass_counts(_build)}")
    # the sliced kernel and the float32 D-256 instantiation must not spill
    for width, entry, no_spill in (
            ("D-256", "flash_h16_kernelILi4E", False),
            ("D-512", "flash_h16_kernelILi8E", False),
            ("sliced", "flash_h16_sliced_kernel", True),
            ("float32 D-256", "flash_f32_kernelILi4E", True),
            ("float32 sliced", "flash_f32_sliced_kernel", True)):
        lines = entry_lines(report, "flash_attention", entry)
        print(f"phase 1 flash_attention {width} instantiation: {lines}")
        if no_spill and any(int(n) for n in
                            re.findall(r"(\d+) bytes spill", lines)):
            fail(f"flash_attention {width}: ptxas spills ({lines})")
    # the attention backward's kernels (16-bit: the statistics pre-pass,
    # the one-pass main kernel on wgmma, the dQ post-pass; float32: its two
    # 3xTF32 passes) and the embedding gradient's segment sum (the chunk
    # pass and the write pass); the main kernel must not spill
    for source, entry in (("flash_attention_bwd", "stats_kernel"),
                          ("flash_attention_bwd", "bwd_h16_kernel"),
                          ("flash_attention_bwd", "dq_post_kernel"),
                          ("flash_attention_bwd", "dq_f32_kernel"),
                          ("flash_attention_bwd", "dkv_f32_kernel"),
                          ("segment_sum", "chunk_kernel"),
                          ("segment_sum", "write_kernel")):
        lines = entry_lines(report, source, entry)
        print(f"phase 1 {source} {entry}: {lines}")
        if entry == "bwd_h16_kernel" and any(
                int(n) for n in re.findall(r"(\d+) bytes spill", lines)):
            fail(f"flash_attention_bwd {entry}: ptxas spills ({lines})")
    print(f"phase 1 flash_attention_bwd SASS: "
          f"{sass_counts(_build, 'flash_attention_bwd')}")
    # and the SSD scan's chunk kernels (its passes (a) and (c)); the chunk
    # pass, bound for two blocks an SM, spills a few bytes at 128 registers
    print(f"phase 1 ssd_scan chunk kernels: "
          f"{entry_lines(report, 'ssd_scan', 'ssd_chunk_kernel')}")
    print(f"phase 1 jacobi2d cluster kernel: "
          f"{entry_lines(report, 'jacobi2d', 'jacobi2d_cluster_kernel')}")
    # Jacobi-2D's tiled kernel, streamcluster's kernel (16-bit and 3xTF32
    # instantiations), pathfinder's strip and pyramid kernels and canneal's
    # tile and row kernels; none may spill, and the streamcluster library
    # must hold wgmma (HGMMA) where it was counted
    for source, entry in (("jacobi2d", "jacobi2d_tiled_kernel"),
                          ("streamcluster", "streamcluster_kernel"),
                          ("pathfinder", "pathfinder_strips_kernel"),
                          ("pathfinder", "pathfinder_pyramid_kernel"),
                          ("canneal", "swap_cost_tiles_kernel"),
                          ("canneal", "swap_cost_rows_kernel")):
        lines = entry_lines(report, source, entry)
        print(f"phase 1 {entry}: {lines}")
        if any(int(n) for n in re.findall(r"(\d+) bytes spill", lines)):
            fail(f"{entry}: ptxas spills ({lines})")
    # the engine scan's instantiations: the default build (its line as
    # before the collect build existed: 72 registers, 28,928 bytes) and the
    # collect build's scan (three warps) and pre-pass, which must not spill
    for label, entry, no_spill in (
            ("default", "engine_scan_kernelILb0E", False),
            ("collect scan (three warps)", "engine_scan_kernelILb1E", True),
            ("collect pre-pass", "engine_prepass_kernelILb1E", True)):
        lines = entry_lines(report, "engine_scan", entry)
        print(f"phase 1 engine_scan {label} build: {lines}")
        if no_spill and any(int(n) for n in
                            re.findall(r"(\d+) bytes spill", lines)):
            fail(f"engine_scan {label}: ptxas spills ({lines})")
        if label == "default" and lines != "not in this run's build log":
            same = "Used 72 registers" in lines and "28928 bytes smem" in lines
            print(f"phase 1 engine_scan default build as before the collect "
                  f"build (72 registers, 28,928 B): {'yes' if same else 'no'}")
    sc_sass = sass_counts(_build, "streamcluster")
    print(f"phase 1 streamcluster SASS: {sc_sass}")
    if sc_sass.startswith("HGMMA 0"):
        fail(f"streamcluster: no wgmma in the build ({sc_sass})")
    print(f"phase 1 device: {torch.cuda.get_device_name(0)} "
          f"sm_clock_max={sm_clock_hz / 1e6:.0f} MHz  build wall {build_s:.1f} s")

    # ---- 2. Black-Scholes ---------------------------------------------------
    rng = np.random.RandomState(2021)
    cols = [rng.uniform(lo, hi, BS_OPTIONS).astype(np.float32)
            for lo, hi in ((10, 100), (10, 100), (0.01, 0.1), (0.05, 0.65),
                           (0.1, 2.0))]
    calls = (rng.uniform(size=BS_OPTIONS) > 0.5).astype(np.int32)
    # the 100 PARSEC runs re-price the same 65,536 options
    bs_args = [torch.from_numpy(np.tile(c, BS_RUNS)).to(dev) for c in cols]
    bs_args.append(torch.from_numpy(np.tile(calls, BS_RUNS)).to(dev))
    n_opt = bs_args[0].numel()
    got = bs_mod.blackscholes(*bs_args)
    want = ref.blackscholes(*bs_args)
    torch.cuda.synchronize()
    if got.shape != (n_opt,) or not torch.isfinite(got).all():
        fail("blackscholes: non-finite or misshapen output")
    bs_err = float((got - want).abs().max())
    if not torch.allclose(got, want, rtol=3e-5, atol=3e-5):
        fail(f"blackscholes kernel vs plain: max abs err {bs_err}")
    # the plain version against float64 on the host, first 65,536 options
    f64 = ref.blackscholes(*(t[:BS_OPTIONS].double().cpu()
                             for t in bs_args[:5]),
                           bs_args[5][:BS_OPTIONS].cpu())
    if not torch.allclose(got[:BS_OPTIONS].cpu().double(), f64,
                          rtol=1e-4, atol=1e-4):
        fail("blackscholes kernel vs float64 host reference")
    bs_ms = cuda_ms(torch, lambda: bs_mod.blackscholes(*bs_args), reps=20,
                    per=25)
    bs_issue_ms = host_issue_ms(torch, lambda: bs_mod.blackscholes(*bs_args),
                                per=25)
    bs_plain_ms = cuda_ms(torch, lambda: ref.blackscholes(*bs_args), reps=20,
                          per=5)
    bs_t_bytes = n_opt * BS_BYTES / PEAK_BYTES_S
    bs_t_ops = n_opt * BS_OPS / PEAK_F32_S
    bs_bound_ms = max(bs_t_bytes, bs_t_ops) * 1e3
    bs_bound_by = "bytes" if bs_t_bytes >= bs_t_ops else "operations"
    print(f"phase 2 blackscholes: n={n_opt} max_abs_err={bs_err:.3g} "
          f"(rtol=atol=3e-5) kernel {bs_ms:.4f} ms (host issue "
          f"{bs_issue_ms:.4f} ms/call), plain {bs_plain_ms:.4f} ms, "
          f"bound {bs_bound_ms:.4f} ms ({bs_bound_by}; {n_opt * BS_BYTES / 1e6:.1f}"
          f" MB at 3.35 TB/s, H100 SXM)")

    # ---- 3. engine scan, kernel against plain --------------------------------
    def timed(fn):
        """``fn()`` once between CUDA events: (result, ms)."""
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn()
        end.record()
        end.synchronize()
        return out, start.elapsed_time(end)

    def compare(tag, inp):
        """The default kernel against the plain version, bit for bit:
        (max abs err, the plain version's ms)."""
        k = engine_scan.scan(*inp.args())
        p, plain_ms = timed(lambda: engine_scan.scan_plain(*inp.args()))
        torch.cuda.synchronize()
        if not torch.isfinite(k).all():
            fail(f"engine_scan {tag}: non-finite output")
        diff = (k != p).any(0)
        err = float((k - p).abs().max())
        print(f"phase 3 engine_scan {tag}: {k.shape[1]} lanes, "
              f"T_max={int(inp.n_steps.max())}, differing lanes "
              f"{int(diff.sum())}, max abs {err:.3g} (bar: bit for bit)")
        if not torch.equal(k, p):
            fail(f"engine_scan {tag}: kernel differs from plain in "
                 f"{int(diff.sum())} lanes")
        return err, plain_ms

    def compare_collect(tag, inp):
        """The collect build against ``scan_plain(collect=True)``: timing
        outputs, accumulators and timeline bit for bit, and its timing
        outputs bit for bit the default kernel's: (max abs err, the plain
        version's ms)."""
        got = engine_scan.scan_collect(*inp.args())
        want, plain_ms = timed(lambda: engine_scan.scan_plain(
            *inp.args(), collect=True))
        default = engine_scan.scan(*inp.args())
        torch.cuda.synchronize()
        bits = lambda t: t.view(torch.int32)
        same = [torch.equal(bits(g), bits(w)) for g, w in zip(got, want)]
        # the float outputs (the timeline's last word is the cause's bits)
        floats = [(got[0], want[0]), (got[1], want[1]),
                  (got[2][..., :3], want[2][..., :3])]
        err = max(float((g - w).abs().max()) if g.numel() else 0.0
                  for g, w in floats)
        n_rec = int(inp.n_steps.long().sum())
        print(f"phase 3 engine_scan collect {tag}: {got[0].shape[1]} lanes, "
              f"{n_rec} records, T_max={int(inp.n_steps.max())}: timing "
              f"outputs / stalls + occupancy / timeline bitwise equal to the "
              f"plain version {same}, timing outputs bitwise equal to the "
              f"default kernel's {torch.equal(got[0], default)}; max abs "
              f"{err:.3g} (bar: bit for bit)")
        if not all(same) or not torch.equal(got[0], default):
            fail(f"engine_scan collect {tag}: differs from the plain version "
                 f"or from the default kernel")
        if not torch.isfinite(got[0]).all() or not torch.isfinite(got[1]).all():
            fail(f"engine_scan collect {tag}: non-finite output")
        return err, plain_ms

    def scan_times(inp):
        """Device ms of one launch's pre-pass, of its scan, and their sum."""
        xi, xf, params, consts, period, n, ck = inp.args()
        recs = engine_scan.prepass(xi, xf, params, consts)
        pre = cuda_ms(torch, lambda: engine_scan.prepass(xi, xf, params,
                                                         consts),
                      reps=10, per=10)
        steps = cuda_ms(torch, lambda: engine_scan.steps(*recs, params,
                                                         period, n, ck),
                        reps=10, per=3)
        return pre, steps, pre + steps

    scan_err = collect_err = 0.0
    short = ("jacobi-2d", "pathfinder", "swaptions", "streamcluster")
    pairs = [(a, c) for a in short for c in ve.TABLE10]
    short_inp = suite.scan_inputs(pairs, device=dev)
    scan_err = max(scan_err, compare("short-body apps x Table 10",
                                     short_inp)[0])
    collect_err = max(collect_err, compare_collect(
        "short-body apps x Table 10", short_inp)[0])
    variants = [dict(ooo_issue=True), dict(interconnect="crossbar"),
                dict(mshrs=1), dict(l2_kb=1024),
                dict(ooo_issue=True, interconnect="crossbar", mshrs=1,
                     l2_kb=1024, queue_entries=8)]
    traces, cfgs = [], []
    for seed in range(40):
        base = ve.TABLE10[(7 * seed) % len(ve.TABLE10)]
        cfgs.append(dataclasses.replace(base, **variants[seed % len(variants)]))
        traces.append(random_trace(isa, seed))
    random_inp = eng.pack(traces, cfgs, [3 * len(t) for t in traces],
                          [len(t) for t in traces], dev)
    scan_err = max(scan_err, compare(
        "random traces x ooo/crossbar/mshrs1/1MB", random_inp)[0])
    collect_err = max(collect_err, compare_collect(
        "random traces x ooo/crossbar/mshrs1/1MB", random_inp)[0])
    # the collect build's block edges: a lone lane, a block short of and
    # just past 32 lanes, ragged n_steps with lanes of none
    for B in (1, 31, 33):
        collect_err = max(collect_err, compare_collect(
            f"ragged B {B}", ragged_inputs(eng, isa, ve, B, dev))[0])
    study_pairs = [(a, c) for a in tracegen.RIVEC_APPS for c in ve.TABLE10]
    study_inp = suite.scan_inputs(study_pairs, device=dev)
    # the plain version's time is its one run in the comparison
    err, scan_plain_ms = compare("study (7 apps x Table 10)", study_inp)
    scan_err = max(scan_err, err)
    pre_ms, steps_ms, scan_ms = scan_times(study_inp)
    call_ms = cuda_ms(torch, lambda: engine_scan.scan(*study_inp.args()),
                      reps=10, per=3)
    scan_bound_ms, scan_bound_by = scan_bound(study_inp, sm_clock_hz)
    n_rec = int(study_inp.n_steps.long().sum())
    print(f"phase 3 engine_scan time (168 lanes, {n_rec} records, T_max="
          f"{int(study_inp.n_steps.max())}): kernel {scan_ms:.4f} ms = "
          f"pre-pass {pre_ms:.4f} ms + scan {steps_ms:.4f} ms "
          f"({n_rec / scan_ms / 1e3:.1f} M records/s; "
          f"{steps_ms * 1e-3 * sm_clock_hz / int(study_inp.n_steps.max()):.1f}"
          f" cycles a step at the max SM clock; scan() call {call_ms:.4f} "
          f"ms), plain {scan_plain_ms:.1f} ms, bound {scan_bound_ms:.4f} ms "
          f"({scan_bound_by}); against the kernel table's {SCAN_TABLE_MS} ms "
          f"{(scan_ms / SCAN_TABLE_MS - 1) * 100:+.1f} % (held to +-5 %: "
          f"{'yes' if abs(scan_ms / SCAN_TABLE_MS - 1) <= 0.05 else 'no'})")
    # the collect build on the same operands: bit for bit against its plain
    # version (whose one run is its time), then timed beside the default
    err, collect_plain_ms = compare_collect("study (7 apps x Table 10)",
                                            study_inp)
    collect_err = max(collect_err, err)
    xi, xf, params, consts, period, n, ck = study_inp.args()
    recs = engine_scan.prepass(xi, xf, params, consts, collect=True)
    collect_pre_ms = cuda_ms(torch, lambda: engine_scan.prepass(
        xi, xf, params, consts, collect=True), reps=10, per=10)
    collect_steps_ms = cuda_ms(torch, lambda: engine_scan.steps_collect(
        *recs, params, period, n, ck), reps=10, per=3)
    collect_ms = cuda_ms(torch, lambda: engine_scan.scan_collect(
        *study_inp.args()), reps=10, per=3)
    default_ms = cuda_ms(torch, lambda: engine_scan.scan(*study_inp.args()),
                         reps=10, per=3)
    acc_rows = engine_scan.N_STALL + engine_scan.N_OCC
    collect_bound_ms, collect_bound_by = scan_bound(
        study_inp, sm_clock_hz, extra_bytes=16 * n_rec + 4 * acc_rows * len(n))
    print(f"phase 3 engine_scan collect time (168 lanes, {n_rec} records): "
          f"call {collect_ms:.4f} ms (pre-pass {collect_pre_ms:.4f} + scan "
          f"{collect_steps_ms:.4f}; the zeroed timeline the rest) against "
          f"the default call's {default_ms:.4f} ms in turn "
          f"({collect_ms / default_ms:.2f}x); "
          f"{collect_steps_ms * 1e-3 * sm_clock_hz / int(n.max()):.1f} cycles "
          f"a step at the max SM clock; plain {collect_plain_ms:.1f} ms; "
          f"bound {collect_bound_ms:.4f} ms ({collect_bound_by}), "
          f"{collect_bound_ms / collect_ms:.1%} of it")
    if parent is None:
        print(f"phase 3 engine_scan collect, the parent tree's build: not "
              f"timed in this run (--parent DIR times it here; the first "
              f"design took {COLLECT_FIRST_DESIGN_MS} ms)")
    else:
        ours = engine_scan.steps_collect(*recs, params, period, n, ck)
        parent_ms, theirs = parent_collect(torch, _build, parent, recs,
                                           (params, period, n, ck), ours)
        bits = lambda t: t.view(torch.int32)
        same = all(torch.equal(bits(a), bits(b))
                   for a, b in zip(ours, theirs))
        print(f"phase 3 engine_scan collect, the parent tree's build "
              f"({parent}): scan {parent_ms:.4f} ms against this tree's "
              f"{collect_steps_ms:.4f} ms ({parent_ms / collect_steps_ms:.2f}x"
              f"); outputs bit for bit equal: {same}")
        if not same:
            fail("engine_scan collect: this tree's build differs from the "
                 "parent tree's")

    # ---- 4. the study: the main path ----------------------------------------
    engine_scan.scan.launches = 0
    bs_mod.blackscholes.launches = 0
    t0 = time.perf_counter()
    prices = ops.blackscholes(*bs_args)
    torch.cuda.synchronize()
    bs_app_s = time.perf_counter() - t0
    if not torch.isfinite(prices).all() or not torch.equal(prices, got):
        fail("blackscholes app run: output differs from phase 2")
    # cold: loop bodies and scalar baselines built anew, as in a fresh process
    suite.clear_caches()
    t0 = time.perf_counter()
    table = suite.sweep_all(tracegen.RIVEC_APPS)
    sweep_cold_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    if suite.sweep_all(tracegen.RIVEC_APPS) != table:
        fail("sweep_all: a repeat call differs")
    sweep_s = time.perf_counter() - t0
    anchor_got = suite.speedup_batch(
        [(a, eng.VectorEngineConfig(mvl=m, lanes=l))
         for a, m, l, _, _ in anchors.ANCHORS])
    q = eng.VectorEngineConfig(mvl=64, lanes=4)
    quick = suite.speedup_batch(
        [("blackscholes", q),
         ("blackscholes", eng.VectorEngineConfig(mvl=64, lanes=4,
                                                 issue_width=1)),
         ("streamcluster", q),
         ("streamcluster", eng.VectorEngineConfig(mvl=64, lanes=4,
                                                  l2_kb=1024))])
    fig10 = [(a, c) for a in tracegen.RIVEC_APPS
             for c in ve.TABLE10 + ve.TABLE10_L2_1MB + ve.TABLE10_MSHR1]
    t0 = time.perf_counter()
    fig10_got = suite.speedup_batch(fig10)
    fig10_s = time.perf_counter() - t0
    launches = {"engine_scan": engine_scan.scan.launches,
                "blackscholes": bs_mod.blackscholes.launches}

    golden = json.loads(GOLDEN.read_text())
    worst, bad = 0.0, []
    for app, grid in table.items():
        for (m, l), s in grid.items():
            w = golden[app][f"{m}x{l}"]
            rel = abs(s - w) / abs(w)
            worst = max(worst, rel)
            if not np.isfinite(s) or rel > 1e-2:
                bad.append(f"{app} {m}x{l}: {s} vs {w}")
    n_cells = sum(len(g) for g in table.values())
    print(f"phase 4 study: sweep_all {n_cells} cells in {sweep_cold_s:.4f} s "
          f"cold, {sweep_s:.4f} s warm, worst rel vs golden {worst:.3g} "
          f"(rtol 1e-2), "
          f"blackscholes app {n_opt} options in {bs_app_s * 1e3:.2f} ms")
    if n_cells != 168 or bad:
        fail(f"golden sweep: {n_cells} cells, off: {bad[:5]}")
    misses = []
    for (app, mvl, lanes, target, kind), s in zip(anchors.ANCHORS, anchor_got):
        ok = (anchors.EQ_LO <= s / target <= anchors.EQ_HI if kind == "eq"
              else s <= target * anchors.LT_SLACK)
        if not ok:
            misses.append(f"{app}@{mvl}x{lanes}={s:.3f} vs {target} [{kind}]")
    print(f"phase 4 anchors: {len(anchors.ANCHORS) - len(misses)}/"
          f"{len(anchors.ANCHORS)} in band")
    if misses:
        fail(f"anchors out of band: {misses}")
    bs_base, bs_narrow, sc_256, sc_1mb = quick
    print(f"phase 4 quickstart: blackscholes {bs_base:.4f} -> issue_width=1 "
          f"{bs_narrow:.4f}; streamcluster 256KB {sc_256:.4f} -> 1MB "
          f"{sc_1mb:.4f}")
    if not (bs_narrow > bs_base and sc_1mb > sc_256):
        fail("README quickstart claims do not hold")
    per_app = 3 * len(ve.TABLE10)       # each app: Table 10, 1 MB LLC, MSHR=1
    base_cells = [s for i, s in enumerate(fig10_got)
                  if i % per_app < len(ve.TABLE10)]
    flat = [table[a][(c.mvl, c.lanes)] for a in tracegen.RIVEC_APPS
            for c in ve.TABLE10]
    if base_cells != flat or not all(np.isfinite(fig10_got)):
        fail("Fig-10/MSHR study: Table-10 cells differ from sweep_all")
    print(f"phase 4 Fig-10 + MSHR study: {len(fig10)} lanes in "
          f"{fig10_s:.4f} s wall")
    # the whole golden table: ten apps + ten ':asm' variants x Table 10
    names = sorted(tracegen.APPS) + list(tracegen.ASM_APPS)
    suite.clear_caches()
    t0 = time.perf_counter()
    study = suite.sweep_all(names)
    study_cold_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    if suite.sweep_all(names) != study:
        fail("sweep_all over the 20 names: a repeat call differs")
    study_s = time.perf_counter() - t0
    launches["engine_scan"] = engine_scan.scan.launches
    worst, bad, n_cells = 0.0, [], 0
    for app, grid in study.items():
        for (m, l), s in grid.items():
            n_cells += 1
            w = golden[app][f"{m}x{l}"]
            rel = abs(s - w) / abs(w)
            worst = max(worst, rel)
            if not np.isfinite(s) or rel > 1e-2:
                bad.append(f"{app} {m}x{l}: {s} vs {w}")
    if any(study[a] != table[a] for a in tracegen.RIVEC_APPS):
        fail("sweep_all over the 20 names: RiVec cells differ from the "
             "seven-app study")
    full_pairs = [(a, c) for a in names for c in ve.TABLE10]
    lane_len, lane_app = max(
        (len(tracegen.body_for(a, suite.effective_mvl(a, c), c)), a)
        for a, c in full_pairs)
    full_inp = suite.scan_inputs(full_pairs, device=dev)
    full_pre_ms, full_steps_ms, full_scan_ms = scan_times(full_inp)
    print(f"phase 4 golden table: {n_cells - len(bad)}/{n_cells} cells "
          f"within rtol 1e-2 ({len(names)} names x {len(ve.TABLE10)} "
          f"configs), worst rel {worst:.3g}; sweep_all {study_cold_s:.4f} s "
          f"cold, {study_s:.4f} s warm; longest lane {lane_app} "
          f"{lane_len} records x 32 = {lane_len * 32}; scan over the "
          f"{len(full_pairs)} lanes {full_scan_ms:.4f} ms (pre-pass "
          f"{full_pre_ms:.4f} + scan {full_steps_ms:.4f})")
    if n_cells != len(golden) * len(ve.TABLE10) or n_cells != 480 or bad:
        fail(f"golden table: {n_cells} cells, off: {bad[:5]}")
    warm_sweep_split(torch, eng, suite, tracegen, engine_scan, names, study,
                     dev)
    scalar_fold_time(sp, ve, names)
    print(f"phase 4 launches on the main path: {launches}")
    if min(launches.values()) <= 0:
        fail(f"a kernel was not launched on the main path: {launches}")

    # ---- 5. the suite kernels' path -----------------------------------------
    t0 = time.perf_counter()
    data = suite_inputs(torch, dev)
    torch.cuda.synchronize()
    inputs_s = time.perf_counter() - t0
    # the library yardsticks of phase 6 in full float32, as the kernels
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    for mod in suite_mods:
        mod.launches = 0
    for counter in set(fa_mod.COUNTERS.values()):
        setattr(fa_mod.flash_attention, counter, 0)
    da_mod.decode_attention.combine_launches = 0
    ssd_mod.ssd_scan.chunk_launches = ssd_mod.ssd_scan.state_launches = 0
    ssd_mod.ssd_scan.panel_launches = 0
    j2_mod.jacobi2d.launches = j2_mod.jacobi2d.loop_launches = 0
    j2_mod.jacobi2d.tiled_launches = 0
    j2_mod.jacobi2d_step.width1_launches = 0
    sc_mod.streamcluster_dist.tf32_launches = 0
    path_mod.pathfinder.pyramid_launches = 0
    ca_mod.swap_cost.rows_launches = 0
    t0 = time.perf_counter()
    outs = {"swaptions": ops.cum_normal_inv(data["sw"]),
            "streamcluster": ops.streamcluster_dist(*data["sc"]),
            "streamcluster_bf16": ops.streamcluster_dist(*data["sc_bf16"]),
            "streamcluster_f16": ops.streamcluster_dist(*data["sc_f16"]),
            "particlefilter": ops.particlefilter_findindex(*data["pf"]),
            "pf_flags": pf_mod.find_index.last_flags,
            "particlefilter_shuffled": ops.particlefilter_findindex(
                *data["pf_shuffled"]),
            "pf_shuffled_flags": pf_mod.find_index.last_flags,
            "canneal": ops.canneal_swap_cost(*data["ca"]),
            "canneal_wide": ops.canneal_swap_cost(*data["ca_wide"]),
            "pathfinder": ops.pathfinder(data["path"]),
            "pathfinder_inf": ops.pathfinder(data["path_inf"]),
            "pathfinder_short": ops.pathfinder(data["path"][:PATH_SHORT]),
            "flash_attention": ops.flash_attention(*data["fa"]),
            "flash_attention_bf16": ops.flash_attention(*data["fa_bf16"]),
            "flash_attention_llama": ops.flash_attention(*data["fa_llama"]),
            "flash_attention_gemma": ops.flash_attention(*data["fa_gemma"]),
            "flash_attention_gemma_f32": ops.flash_attention(
                *data["fa_gemma_f32"]),
            "flash_attention_d512": ops.flash_attention(*data["fa_d512"]),
            "flash_attention_d640": ops.flash_attention(*data["fa_d640"]),
            "flash_attention_d640_f16": ops.flash_attention(
                *data["fa_d640_f16"]),
            "flash_attention_f32_d512": ops.flash_attention(
                *data["fa_f32_d512"]),
            "flash_attention_mixed": ops.flash_attention(*data["fa_mixed"]),
            "decode_attention": ops.decode_attention(*data["da"]),
            "decode_attention_f16": ops.decode_attention(*data["da_f16"]),
            "decode_attention_d512": ops.decode_attention(*data["da_d512"]),
            "decode_attention_mixed": ops.decode_attention(
                *data["da_mixed"]),
            "ssd_scan": ops.ssd_scan(*data["ssd"], chunk=SSD_CHUNK),
            **{key: ops.ssd_scan(*data[key], chunk=SSD_CHUNK)
               for key in SSD_PANELS}}
    torch.cuda.synchronize()
    suite_s = time.perf_counter() - t0
    # the app: RiVec's 4,000 sweeps in one call (one cluster launch)
    t0 = time.perf_counter()
    outs["jacobi2d"] = ops.jacobi2d(data["j2"], iters=J2_SWEEPS)
    torch.cuda.synchronize()
    j2_app_s = time.perf_counter() - t0
    # and in bfloat16; PolyBench's 1,000 sweeps on the tiled route, timed
    # on the host clock (wall), in float32 and bfloat16; one sweep of its
    # grid (the loop route), and one through the one-sweep kernel's own
    # entry (its vector route); one float16 sweep of the app's grid (its
    # width-one route: 164 is no multiple of 8)
    outs["jacobi2d_bf16"] = ops.jacobi2d(data["j2_bf16"], iters=J2_SWEEPS)
    j2_big_s = {}
    for key in ("j2_big", "j2_big_bf16"):
        t0 = time.perf_counter()
        outs[key.replace("j2", "jacobi2d")] = ops.jacobi2d(
            data[key], iters=J2_BIG_SWEEPS)
        torch.cuda.synchronize()
        j2_big_s[key] = time.perf_counter() - t0
    outs["jacobi2d_big_step"] = ops.jacobi2d(data["j2_big"], iters=1)
    outs["jacobi2d_big_sweep"] = ops.jacobi2d_step(data["j2_big"])
    outs["jacobi2d_f16_step"] = ops.jacobi2d_step(data["j2_f16"])
    torch.cuda.synchronize()
    for name, mod in zip(SUITE_REPLACES, suite_mods):
        launches[name] = mod.launches
    # Jacobi-2D's two routes and the SSD scan's N-panel sum, their own
    # counters
    launches["jacobi2d_cluster"] = j2_mod.jacobi2d.launches
    launches["jacobi2d_loop"] = j2_mod.jacobi2d.loop_launches
    launches["jacobi2d_tiled"] = j2_mod.jacobi2d.tiled_launches
    # the one-sweep kernel's width-one route (its vector route counts as
    # jacobi2d_step.launches)
    launches["jacobi2d_width1"] = j2_mod.jacobi2d_step.width1_launches
    # streamcluster's 3xTF32 instantiation (float32; its 16-bit ones count as
    # streamcluster.launches)
    launches["streamcluster_3xtf32"] = \
        sc_mod.streamcluster_dist.tf32_launches
    launches["ssd_scan_panels"] = ssd_mod.ssd_scan.panel_launches
    # pathfinder's pyramid route (its strip route counts as
    # pathfinder.launches, the edges' memset included)
    launches["pathfinder_pyramid"] = path_mod.pathfinder.pyramid_launches
    # canneal's row kernel (its tile kernel counts as swap_cost.launches)
    launches["canneal_rows"] = ca_mod.swap_cost.rows_launches
    # flash attention's routes past D 128, each its own counter
    for name, counter in FA_ROUTES.items():
        launches[name] = getattr(fa_mod.flash_attention, counter)
    launches["decode_attention_combine"] = \
        da_mod.decode_attention.combine_launches
    # the SSD scan's chunk and state passes (its output pass counts as
    # ssd_scan.launches)
    launches["ssd_scan_chunk_pass"] = ssd_mod.ssd_scan.chunk_launches
    launches["ssd_scan_state_pass"] = ssd_mod.ssd_scan.state_launches
    path_counts = {n: launches[n]
                   for n in (*SUITE_REPLACES, *FA_ROUTES,
                             "decode_attention_combine",
                             "ssd_scan_chunk_pass", "ssd_scan_state_pass",
                             "jacobi2d_cluster", "jacobi2d_loop",
                             "jacobi2d_tiled", "jacobi2d_width1",
                             "streamcluster_3xtf32",
                             "ssd_scan_panels", "pathfinder_pyramid",
                             "canneal_rows")}
    # the particle filter's two calls: the path each took, from its flags
    pf_paths = {key: "search" if pf_mod.searched(outs.pop(flags)) else
                "count" for key, flags in
                (("particlefilter", "pf_flags"),
                 ("particlefilter_shuffled", "pf_shuffled_flags"))}
    print(f"phase 5 suite kernels through kernels.ops: {suite_s * 1e3:.1f} ms"
          f" wall (inputs made in {inputs_s:.1f} s); jacobi2d {J2_SWEEPS} "
          f"sweeps of {J2_N} x {J2_N} in {j2_app_s * 1e3:.3f} ms wall "
          f"({j2_app_s * 1e6 / J2_SWEEPS:.3f} us/sweep, one launch); "
          f"PolyBench's {J2_BIG_SWEEPS} sweeps of {J2_BIG} x {J2_BIG} "
          f"(tiled route, first call) {j2_big_s['j2_big'] * 1e3:.3f} ms wall "
          f"float32, {j2_big_s['j2_big_bf16'] * 1e3:.3f} ms bfloat16; "
          f"launches {path_counts}; particle filter paths {pf_paths}")
    if min(path_counts.values()) <= 0:
        fail(f"a suite kernel was not launched on its path: {launches}")
    for key, iters, want in (("j2", J2_SWEEPS, "cluster"),
                             ("j2_bf16", J2_SWEEPS, "cluster"),
                             ("j2_big", J2_BIG_SWEEPS, "tiled"),
                             ("j2_big_bf16", J2_BIG_SWEEPS, "tiled"),
                             ("j2_big", 1, "loop")):
        got = j2_mod.route(*data[key].shape, data[key].dtype,
                           iters=iters).name
        if got != want:
            fail(f"jacobi2d {key}, {iters} sweeps: the {got} route, not the "
                 f"{want} route")
    for key, want in (("j2_big", 4), ("j2_f16", 1)):
        g = data[key]
        if j2_mod.step_width(g.shape[1], g.dtype, g.data_ptr()) != want:
            fail(f"jacobi2d {key}: one sweep at width "
                 f"{j2_mod.step_width(g.shape[1], g.dtype, g.data_ptr())}, "
                 f"not {want}")
    want_tiled = 2 * -(-J2_BIG_SWEEPS // j2_mod.MAX_K_TILED)
    if launches["jacobi2d_tiled"] != want_tiled:
        fail(f"jacobi2d: {launches['jacobi2d_tiled']} tiled launches, not "
             f"{want_tiled}")
    for F, want in ((CA_F, "tiles"), (CA_WIDE_F, "rows")):
        if ca_mod.route(F) != want:
            fail(f"canneal, {F} slots: the {ca_mod.route(F)} route, not the "
                 f"{want} route")
    path_card = path_mod.card(data["path"].device)
    for key, rows, want in (("path", PATH_R, "strips"),
                            ("path_inf", PATH_R, "strips"),
                            ("path", PATH_SHORT, "pyramid")):
        got = path_mod.route(rows, PATH_C, *path_card)
        if got.name != want:
            fail(f"pathfinder {key}, {rows} rows: the {got.name} route, not "
                 f"the {want} route")
    want_path = 2 * path_mod.route(PATH_R, PATH_C, *path_card).launches
    if launches["pathfinder"] != want_path:
        fail(f"pathfinder: {launches['pathfinder']} device operations on the "
             f"strip route, not {want_path}")
    # the pyramid's main-path call (the wall's first PATH_SHORT rows) is one
    # launch with no scratch row, and canneal's padded rows one launch of
    # the row kernel
    want_pyr = path_mod.pyramid_plan(PATH_SHORT, PATH_C).launches
    if want_pyr != 1 or launches["pathfinder_pyramid"] != want_pyr:
        fail(f"pathfinder: {launches['pathfinder_pyramid']} pyramid launches "
             f"for {PATH_SHORT} rows, not one")
    if launches["canneal_rows"] != 1:
        fail(f"canneal: {launches['canneal_rows']} row-kernel launches, not "
             "one")
    for key, want in (("sc", "3xtf32/tma"), ("sc_bf16", "wgmma/tma"),
                      ("sc_f16", "wgmma/tma")):
        if sc_mod.path(*data[key]) != want:
            fail(f"streamcluster {key} took {sc_mod.path(*data[key])}, not "
                 f"{want}")
    for key in SSD_PANELS:
        if not ssd_mod.plan(*data[key][0].shape[1:],
                            data[key][3].shape[-1]).panel:
            fail(f"{key}: not on the N-panel route")
    if pf_paths != {"particlefilter": "search",
                    "particlefilter_shuffled": "count"}:
        fail(f"particle filter: paths {pf_paths}, expected the search on "
             "Rodinia's CDF and the count on the shuffled one")
    for key, want in (("fa_d512", "wgmma512/tma"),
                      ("fa_gemma_f32", "3xtf32_256/cp.async16"),
                      ("fa_d640", "wgmma_sliced/tma"),
                      ("fa_d640_f16", "wgmma_sliced/tma"),
                      ("fa_f32_d512", "3xtf32_sliced/cp.async16")):
        if fa_mod.path(*data[key]) != want:
            fail(f"flash attention {key} took {fa_mod.path(*data[key])}, "
                 f"not {want}")
    check_suite_outputs(torch, ref, data, outs)

    # ---- 6. suite kernels against their plain versions, times, bounds -------
    rows = {spec["name"]: run_suite_kernel(torch, spec, sm_clock_hz)
            for spec in suite_specs(torch, ref, data, suite_mods)}
    jacobi_step_routes(torch, j2_mod, ref, data)
    jacobi_routes(torch, j2_mod, ops, data["j2"], j2_app_s, sm_clock_hz)
    jacobi_polybench(torch, j2_mod, data, rows)

    # ---- 7. the scalar-scorecard gate and the study drivers ------------------
    scalar_gate_and_study(sp, {
        "blackscholes": bs_mod.blackscholes, "jacobi2d_step":
        j2_mod.jacobi2d_step, "pathfinder": path_mod.pathfinder,
        "streamcluster": sc_mod.streamcluster_dist, "swaptions":
        sw_mod.cum_normal_inv, "canneal": ca_mod.swap_cost,
        "particlefilter": pf_mod.find_index, "flash_attention":
        fa_mod.flash_attention, "ssd_scan": ssd_mod.ssd_scan})

    # ---- 8. the RVV code generator: corpus and round trip --------------------
    codegen_round_trip(tracegen)

    # ---- 9. the profiler: the collect build's path ---------------------------
    collect_launches = profiler_phase(torch, eng, engine_scan,
                                      dev)["launches"]
    if parent is not None:
        # the parent tree's build on the same path, in a process of its own
        run = subprocess.run(
            [sys.executable, str(ROOT / "scripts" / "collect_path_timing.py"),
             "--src", str(parent / "src"), "--label", "phase 9 parent"],
            capture_output=True, text=True, timeout=600)
        for ln in run.stdout.splitlines():
            if "collect calls (T, B" not in ln and " profiler: " not in ln \
                    and " module_stress: " not in ln:
                print(ln)
        if run.returncode:
            fail(f"the parent tree's profiler path: exit {run.returncode}\n"
                 f"{run.stderr[-2000:]}")

    # ---- 10-12. DSE at full width, the surrogate search, the service --------
    import tempfile
    with tempfile.TemporaryDirectory() as tmp:
        truth, dse_cache = dse_phase(torch, eng, suite, engine_scan, ve,
                                     golden, dev, tmp)
        search_launches = surrogate_phase(torch, engine_scan, ve, truth,
                                          dse_cache, dev, sm_clock_hz)
        serve_launches = serve_phase(engine_scan, tmp)

    # ---- 13. the model server -------------------------------------------------
    server = model_server_phase(torch, ref, fa_mod, da_mod, dev,
                                sm_clock_hz)

    # ---- 14. the trainer ------------------------------------------------------
    # the suite's inputs and outputs are not read past phase 6; the
    # full-width step needs the card's memory
    data.clear()
    outs.clear()
    torch.cuda.empty_cache()
    trainer = trainer_phase(torch, ref, fa_mod, da_mod, dev, sm_clock_hz)

    # ---- 15. the device mesh ----------------------------------------------------
    mesh = mesh_phase(torch, fa_mod, da_mod, dev, server, trainer)
    del trainer["after"]

    # ---- 16. kernels line -----------------------------------------------------
    kernels = [
        {"name": "engine_scan", "route": "cuda",
         "source": "src/repro_torch/csrc/engine_scan.cu",
         "replaces": "src/repro/core/engine.py:198",
         "launches": launches["engine_scan"], "max_abs_err": scan_err,
         "ms": scan_ms, "plain_ms": scan_plain_ms, "bound_ms": scan_bound_ms,
         "bound_by": scan_bound_by, "library_ms": None,
         # launches is the study's (phase 4); the search's and the
         # service's paths launch the same kernel (phases 11 and 12)
         "launches_by_path": {"study": launches["engine_scan"],
                              "search": search_launches,
                              "serve": serve_launches}},
        {"name": "engine_scan_collect", "route": "cuda",
         "source": "src/repro_torch/csrc/engine_scan.cu",
         "replaces": "src/repro/core/engine.py:435",
         "launches": collect_launches, "max_abs_err": collect_err,
         "ms": collect_ms, "plain_ms": collect_plain_ms,
         "bound_ms": collect_bound_ms, "bound_by": collect_bound_by,
         "library_ms": None,
         # each call (one counted launch) is these two kernels, the scan
         # three warps a block (the recurrence, and the attribution on two
         # more)
         "kernels": ["engine_prepass_kernel<true>",
                     "engine_scan_kernel<true>, three warps a block"],
         "launches_per_call": 2},
        {"name": "blackscholes", "route": "cuda",
         "source": "src/repro_torch/csrc/blackscholes.cu",
         "replaces": "src/repro/kernels/blackscholes.py:38",
         "launches": launches["blackscholes"], "max_abs_err": bs_err,
         "ms": bs_ms, "plain_ms": bs_plain_ms, "bound_ms": bs_bound_ms,
         "bound_by": bs_bound_by, "library_ms": None},
    ]
    # decoding's entry is its split kernel alone (the whole call, both
    # kernels, is phase 6's decode_attention row)
    # streamcluster's entry is its 16-bit kernel (bfloat16, counted by
    # streamcluster.launches); its 3xTF32 instantiation has its own
    row_of = {"decode_attention": "decode_attention_split",
              "streamcluster": "streamcluster_bf16"}
    for name, replaces in SUITE_REPLACES.items():
        kernels.append({"name": name, "route": "cuda",
                        "source": f"src/repro_torch/csrc/{name}.cu",
                        "replaces": replaces, "launches": launches[name],
                        **rows[row_of.get(name, name)]})
    # flash attention's routes past 128 columns: the wgmma kernel's D-256
    # instantiation at gemma-7b's width, its D-512 instantiation, its
    # sliced kernel at D 640, the 3xTF32 kernel's D-256 instantiation
    # (float32 at gemma's width, S 1,024) and its sliced kernel (float32 at
    # D 512); the particle filter's count path (the shuffled CDF; its
    # launches are the wrapper's, both calls); decoding's combine kernel
    for name, source, row, of, counter in (
            ("flash_attention_wgmma256", "flash_attention",
             "flash_attention_gemma", "flash_attention",
             "flash_attention_wgmma256"),
            ("flash_attention_wgmma512", "flash_attention",
             "flash_attention_d512", "flash_attention",
             "flash_attention_wgmma512"),
            ("flash_attention_sliced", "flash_attention",
             "flash_attention_d640", "flash_attention",
             "flash_attention_sliced"),
            ("flash_attention_3xtf32_256", "flash_attention",
             "flash_attention_gemma_f32", "flash_attention",
             "flash_attention_3xtf32_256"),
            ("particlefilter_shuffled", "particlefilter",
             "particlefilter_shuffled", "particlefilter", "particlefilter"),
            ("flash_attention_3xtf32_sliced", "flash_attention",
             "flash_attention_f32_d512", "flash_attention",
             "flash_attention_3xtf32_sliced"),
            ("decode_attention_combine", "decode_attention",
             "decode_attention_combine", "decode_attention",
             "decode_attention_combine"),
            ("jacobi2d_cluster", "jacobi2d", "jacobi2d_cluster", "jacobi2d",
             "jacobi2d_cluster"),
            ("jacobi2d_loop", "jacobi2d", "jacobi2d_loop", "jacobi2d",
             "jacobi2d_loop"),
            ("jacobi2d_tiled", "jacobi2d", "jacobi2d_tiled", "jacobi2d",
             "jacobi2d_tiled"),
            ("jacobi2d_width1", "jacobi2d", "jacobi2d_width1", "jacobi2d",
             "jacobi2d_width1"),
            ("streamcluster_3xtf32", "streamcluster", "streamcluster",
             "streamcluster", "streamcluster_3xtf32"),
            ("ssd_scan_panels", "ssd_scan", "ssd_scan_n512", "ssd_scan",
             "ssd_scan_panels"),
            ("pathfinder_pyramid", "pathfinder", "pathfinder_pyramid",
             "pathfinder", "pathfinder_pyramid"),
            ("canneal_rows", "canneal", "canneal_rows", "canneal",
             "canneal_rows")):
        kernels.append({"name": name, "route": "cuda",
                        "source": f"src/repro_torch/csrc/{source}.cu",
                        "replaces": SUITE_REPLACES[of],
                        "launches": launches[counter], **rows[row]})
    # the attention backward kernel and the embedding gradient's segment
    # sum, on the trainer's path (phase 14; launches there, counters zeroed
    # before its full-width steps), timed at its shapes
    kernels.append({"name": "flash_attention_bwd", "route": "cuda",
                    "source": "src/repro_torch/csrc/flash_attention_bwd.cu",
                    "replaces": "layers.FlashAttention.backward (plain VJP); "
                                "no Pallas kernel: the reference "
                                "differentiates src/repro/models/layers.py:"
                                "142 _exact_attn and :159 _chunked_attn",
                    "launches": trainer["launches"]["flash_attention_bwd"],
                    # each counted call (bf16) is a memset and these three
                    "kernels": ["stats_kernel (pre-pass)",
                                "bwd_h16_kernel (one pass over the kept "
                                "pairs)", "dq_post_kernel (post-pass)"],
                    "launches_per_call": 3,
                    **trainer["rows"]["flash_attention_bwd"]})
    kernels.append({"name": "segment_sum", "route": "cuda",
                    "source": "src/repro_torch/csrc/segment_sum.cu",
                    "replaces": "layers.embed_fwd's gradient (autograd's "
                                "index_put_ with accumulate); no Pallas "
                                "kernel",
                    "launches": trainer["launches"]["segment_sum"],
                    # each counted call is a sort and these two
                    "kernels": ["chunk_kernel (chunks of long rows)",
                                "write_kernel (the table, once)"],
                    "launches_per_call": 2,
                    **trainer["rows"]["segment_sum"]})
    # the attention kernels also run on the model server's path (phase 13):
    # its launches (launches stays the suite's, phase 5), and the two
    # kernels at the long round's llama3-8b shapes
    # and on the trainer's path (phase 14), flash attention with its row at
    # qwen2.5-3b's training shape and the attention backward beside it
    for entry in kernels:
        if entry["name"] in server["launches"]:
            entry["launches_by_path"] = {
                "suite": entry["launches"],
                "model_server": server["launches"][entry["name"]],
                "trainer": trainer["launches"][entry["name"]],
                "mesh": mesh["launches"][entry["name"]],
                "mesh_tensor_parallel":
                    mesh["tp_launches"].get(entry["name"], 0)}
        if entry["name"] in ("flash_attention_bwd", "segment_sum"):
            entry["launches_by_path"] = {
                "trainer": entry["launches"]}
        if entry["name"] in ("flash_attention", "flash_attention_bwd",
                             "segment_sum"):
            entry["launches_by_path"]["mesh_tensor_parallel_train"] = \
                mesh["train_launches"].get(entry["name"], 0)
        if entry["name"] in server["rows"]:
            entry["serve"] = server["rows"][entry["name"]]
        if entry["name"] == "flash_attention":
            entry["train"] = trainer["row"]
    print(json.dumps({"kernels": kernels}))
    # ---- 17. last line ----------------------------------------------------------
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
