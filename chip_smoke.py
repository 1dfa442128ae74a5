#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Run from the repository root on a machine with a CUDA card and the CUDA
toolkit.  It imports only ``camera_calibration_torch`` and, for the
rows of [5] at the benchmark's deployments, ``calib_bench`` (never JAX)
and:

1. prints the card's name and power limit;
2. builds the hand-written kernels from ``camera_calibration_torch/csrc``
   and prints what ``ptxas -v`` says of each (registers, shared memory,
   spills), and the staged-or-not plan, shared memory, block size,
   blocks per SM and persistent grid of both projection kernels at the
   bench grid, at 45×79 and at 84×100, and the launch plan of
   ``window_apply_j`` (warps an observation, blocks) at the bench shape,
   at [7]'s and [9b]'s final grids and at 108×108, each equal to its
   Python mirror; and the NoncentralGeneric projection kernel's plan
   (staged or not, block size, shared memory, blocks per SM) at the same
   three grids;
3. holds every kernel against its plain PyTorch version on the card, at the
   shapes of the benchmark problem's main path (262,144 observations, 16×16
   grid), on a non-square 21×28 grid, on the 45×79 grid of a 1080p camera
   (the window ops on random inputs, the projections on 262,144 random
   pixels of a 1920×1080 pinhole camera), and with K = 5 window Jacobians:
   at 45×79 the K = 5 block diagonal runs in bands of grid rows; narrower
   bands than the plan's must give bit-identical results at 16×16; and the
   two matvec kernels on a bfloat16 ``j_win`` (the CG matvecs' copies):
   the central and noncentral bench ``j_win``, random 45×79 inputs at K = 2
   and 5, N odd, even but not a multiple of 8, and a view that is not
   4-byte aligned; bf16 JᵀW·s in narrower bands bit for bit; the block
   diagonal's own bf16 variant on the bench ``j_win`` (K = 2), the
   noncentral one (K = 5) and random K = 5 inputs at 45×79 (in bands),
   repeatable and in narrower bands bit for bit, and within 1e-6 of the
   float32 kernel on the widened values; and the kernels past their staged
   plans: ``project_blocks`` at the 84×100 grid
   of a 2448×2048 camera (262,144 random pixels; it reads its grid and
   frames from device memory there, while ``project`` still stages its
   grid), each printing which variant ran, and ``window_apply_j`` at K = 5
   on a 108×108 grid (a tangent larger than a block's shared memory, read
   through L1 as at every grid);
4. drives the main paths, each with the launch counts set to 0 just before
   and read just after: ``optimize`` on the full-size benchmark problem in
   the two-pass and cached-blocks forms, with ``solver="auto"`` (it
   resolves to ``schur``), ``"schur_direct"``, ``"schur_direct_points"``,
   ``"pcg"``, ``block_chunk``, ``debug_verify`` and ``profile_dir``; and on
   the NoncentralGeneric twin of the bench problem in both step forms
   (the noncentral projection kernel and the K = 5 window kernels); on
   the parametric twins of the bench
   problem (ThinPrismFisheye, OpenCV, Radial) in both step forms with
   ``solver="auto"`` and ``"schur"``, and the ThinPrismFisheye one with
   ``"schur_direct"``, ``"schur_direct_points"`` and ``"pcg"`` (no kernel
   of a grid model may launch there: the point-eliminated ``schur`` runs
   take the Schur legs' two kernels, which do not depend on the
   intrinsics); and with ``cg_jacobian_dtype="bfloat16"`` on
   the central, noncentral and ThinPrismFisheye problems (the bf16 kernels,
   the Schur legs' included, launch once per CG iteration, the float32 matvec kernels only outside
   CG).  It checks that every kernel of a path ran and that the paired cost
   falls in every run, and compares one LM step through the kernels with
   one through the plain versions, central and noncentral, in float32 and
   with bf16 CG;
5. times every kernel, its plain version and, for the two matvecs, a
   torch.sparse product as the library yardstick, with CUDA events around
   calls from Python (``ms``, ``plain_ms``, ``library_ms``), and every
   kernel again as one replay of a CUDA graph of 100 calls (``graph_ms``:
   the card's time alone, without the host's per-call cost), the matvecs
   also with the L2 cache flushed before each call (``cold_graph_ms``); the
   three
   window kernels also at K = 5 on the noncentral bench's ``j_win``, the
   two reductions also at K = 5 and K = 2 at 45×79 (with a torch.sparse
   JᵀW·s beside them, and at K = 5 also in twice the bands, which is what
   a band costs), the two projections also at 45×79 and 84×100 and
   ``window_apply_j`` at K = 5 on 108×108 (the rows' ``past_the_staged_plan``);
   the two bf16 matvec
   kernels at K = 2 and 5 (with a torch.sparse product of the same bf16
   matrix where torch.sparse takes one) and the bf16 block diagonal at
   K = 2 and 5 (also L2-cold); the LM iterations per second of
   both step forms, of each solver mode, of the noncentral path, of each
   parametric path and of bf16 CG, with the host clock; and the dense
   direct solve's assembly and Cholesky apart; and the NoncentralGeneric
   projection kernel at the shape of its main path (every slot of one
   start state of the benchmark's ``ncg1080.ba_final`` deployment, 45×79,
   1,036,200 points, warm-started from the observed pixels), first held
   to its plain version at 4 and 50 iterations (valid-mask flips at most
   1%, pixels within 1e-3 px on the points valid in both but for at most
   0.1% of them), then timed
   at 4 iterations with its plain version and its bound (the window
   evaluations' shared-memory reads and FLOP; JSON row
   ``project_noncentral``); and the Schur legs' two passes at one start
   state of each cell's deployment (``cg1080.ba_final`` 500×3,454 and
   ``ncg1080.ba_final`` 300×3,454 slots), float32 and bf16 Jacobians,
   held to their float64 plain versions and timed beside the plain
   composition, with the byte bound of the rows they read (JSON rows
   ``schur_point_leg[_bf16]_<cell>``, ``schur_pose_leg[_bf16]_<cell>``);
6. profiles two LM iterations with ``torch.profiler`` (device busy share,
   host syncs, the kernels that take the most time; the trace goes to
   ``camera_calibration_torch/_build/chip_smoke_trace.json``);
7. runs the calibration pipeline from a feature dataset as the command
   line does, with its defaults: 100 views of a 24×24 board by a 1920×1080
   pinhole camera (``problems.make_calibration_dataset``), written to
   ``dataset.bin`` and read back; dense initialization (the native
   densification, the relative-pose bootstrap and the P3P polish on the
   host); the initial state on the card in float32 at the coarsest of the
   three pyramid grids (25×44, 34×59, 45×79); ``calibrate`` with the
   counts set to 0 just before it and read per BA stage, then a float64
   polish on the CPU; the state saved with ``state_io``.  It requires the
   median reprojection error under 0.02 px, the metric scale within 0.05
   of 1, the final grid 45×79 and all five kernels launched at each of the
   three grids; prints each stage's host time, LM iterations and LM it/s
   and the launches per grid; and holds each kernel to its plain version
   and one LM step through the kernels to the plain step at the inputs of
   each grid's first BA stage, where it also times ``window_apply_j``
   (beside torch.sparse CSR's J_intr·v, and L2-cold) and the two
   reductions (beside torch.sparse CSR's JᵀW·s) on that grid's own
   ``j_win`` (JSON rows ``<kernel>_pipeline_<grid>``);
8. detects features in camera images through the port's own entry
   points: ``cli.main`` create-pattern (a 24×24 board of 2 cm squares with
   its central tag), render-synthetic (30 seeded 1920×1080 views by a
   pinhole camera with fx = 0.85·1920, 0.6–0.9 m away, noise 0.01, defocus
   σ 0.8 px, one thread per core) and extract-features (detection on the
   card).  It requires
   every view to detect at least 70% of the corners its true pose puts
   inside the image, the detected corners' median distance to the
   rendered truth under 0.1 px, the first refinement batch within 1e-3 px
   (95% of its features; median 1e-4 px, all 1e-2 px) of the same batch
   refined in float64 on the CPU; it prints the host seconds of each
   stage, the features per view and the corner refinement throughput at
   the reference benchmark's shape (2048 features, 512 + 64 samples, a
   1280×1024 image, best of 3), with a ``torch.profiler`` reading of one
   such call.  The calibration of its dataset is [9a]'s, through the
   command line;
9a. calibrates [8]'s dataset through the command line with its defaults:
   ``cli.main calibrate --dataset_files <dataset.bin> --report`` (three
   levels at 25 px a cell to 45×79, ``auto``, float32 on the card, a
   float64 polish on the CPU), with the counts set to 0 just before and
   read per BA stage; then ``report`` of the saved state (float64 on the
   CPU, and float32 on the card through the projection kernel),
   ``compare`` with the rendering camera's own model, ``fit-parametric``
   of the three parametric models and ``create-legends``.  It requires the
   median reprojection error under 0.1 px, the scale within 0.05 of 1, the
   final grid 45×79, all five kernels at each pyramid grid (and each, and
   one LM step, against the plain versions there), the report's median
   equal to ``calibrate``'s within 1%, every report file, the ``report``
   command's numbers within 1e-6 relative of the report of the polished
   state in memory over the same observations (the command counts the
   outliers ``calibrate`` removed) and the card report launching
   ``project``, its median within 1e-3 px of the float64 one; it prints
   the host seconds of each stage and the LM it/s of each BA;
9b. calibrates a NoncentralGeneric camera from scratch at 1920×1080:
   ``problems.make_noncentral_calibration_dataset`` (20 views of a 25×19
   board of 1.5 cm cells by the cross-slit camera of the reference
   package's noncentral tests) written to ``dataset.bin``, then ``cli.main
   calibrate --model noncentral_generic --report --num_pyramid_levels 6
   --polish_iterations 60``: the noncentral initialization on the host,
   the pyramid BA on the card (11×19 up to 45×79; the noncentral
   projection kernel and the K = 5 window kernels), the float64 polish.
   It requires the median reprojection error under 0.01 px, the final
   grid 45×79, the projection kernel and the three window kernels at
   each of the six pyramid grids (each against its plain version there,
   the projection on the observed rows at 4 iterations; at 45×79 the
   three window kernels also timed as at [7]'s
   grids, rows ``<kernel>_k5_pipeline_45x79``) and the line offsets image
   and lines .obj; it
   prints the host seconds of the initialization, the state, each BA stage
   and the polish, and the LM it/s of each BA.  Not the command line's
   defaults: with them (three levels, a 10-iteration polish) this dataset
   ends at a median of 0.062 px on an H100 machine, above the bar.  There
   the initialization accepts a bootstrap whose L-BFGS polish stopped at
   its 600-iteration cap with a direction-field handedness of 0.084 (the
   reference's test asks only > 0.05), poses about 12° off; another
   machine's LAPACK rejects the same triple (handedness 0.008) and
   bootstraps from the next (see NONCENTRAL_LEVELS);
10. estimates stereo depth at 1920×1080 through the command line: a rig
   of two CentralGeneric cameras on ``problems.pinhole_model``'s 45×79
   grid (fx = 0.85·1920) 0.2 m apart, saved with ``state_io``; two
   scenes rendered on the host as the reference package's stereo tests
   render them (a fronto-parallel plane at 2 m and the slanted plane
   z = 2 + 0.6·x, their texture's frequencies scaled so that a period
   spans about 10–20 px); ``cli.main stereo-depth`` with its defaults (96
   levels, 8 PatchMatch rounds) on both and with ``--algorithm
   plane_sweep`` on the slanted one.  It requires the reference tests'
   bars (fronto: more than half the pixels good, median relative depth
   error under 0.02; slanted: PatchMatch under 0.02 and under 0.7× the
   plane sweep's error, median |n·n_gt| above 0.95), a non-empty .obj,
   ``project`` launched 365 times per PatchMatch run (219 per plane
   sweep), and ``project`` at the stereo shape (2,073,600 warm-started
   directions, 6 iterations) within the projection tolerance of its plain
   version and bitwise repeatable; it prints the host seconds of each
   stage, the peak device memory and a ``torch.profiler`` reading of one
   PatchMatch round, and times ``project`` at that shape;
11. runs the COLMAP tools and ``visualize-calibration`` on [9a]'s
   calibration: the OpenCV model that [9a]'s ``fit-parametric`` fitted,
   with [9a]'s poses, saved as a state; ``export-colmap`` with [8]'s
   dataset; ``refine-colmap`` of the export on the card (the cost must
   fall); ``compare-point-clouds`` of [10]'s fronto cloud with the true
   plane's (median distance under 0.04 m); ``visualize-calibration`` of
   [9a]'s state and of the refined COLMAP model.  Every file must be
   written;
12. drives live input, the visualizer and sharding: [12a] ``cli.main
   record`` of [8]'s 30 views from a ``dir:`` input (detection on the
   card, one frame at a time, ``--record_images``): every view kept with
   the feature ids of [8]'s extract-features dataset, the positions
   within the RECORD_* bars, 30 recorded images and the coverage map, the
   host seconds per frame (reading, detection, bookkeeping); [12b] the live
   frame rate of 24 rendered 640×480 views of a 12×12 board through
   ``run_live_capture`` (as ``benchmarks/live_fps.py`` measures the
   reference package's, frame 0 excluded); [12c] ``cli.main calibrate
   --dataset_files <[12a]'s dataset.bin>`` with the defaults, without and
   then with ``--live_directory`` (the counts set to 0 just before the
   second): the calibration bar of [9a], every hook image, the final state
   bit for bit equal to the run without the visualizer, the hooks' host
   seconds apart from the stages'; [12d] ``optimize`` on the full-size
   bench problem through ``parallel.sharding`` in a one-rank NCCL group,
   in both step forms: the kernels launched, at least one all-reduce per
   CG iteration, the result bit for bit equal to the unsharded
   ``optimize``, the LM it/s of both and the time of one all-reduce;
13. prints one JSON line listing every kernel (with its launches per
   pipeline grid of [7], of [9a], of [12c], for the K = 5 window rows and
   ``project_noncentral`` of [9b], for ``project`` of each [10] run, and
   per step form of [12d]),
   the ``nvidia-smi`` line of the card, and last ``{"ok": true,
   "device": {...}}``.

It exits non-zero, without the last line, when there is no CUDA card, when
the package is missing, or when any phase fails.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import time
from contextlib import ExitStack, contextmanager
from unittest import mock

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))

# Published peaks of one H100 SXM (NVIDIA data sheet): HBM bandwidth and
# float32 outside the tensor cores; and shared memory, 128 B a clock on each
# of its 132 SMs at the 1.98 GHz boost clock.
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOP_PER_S = 67e12
PEAK_SMEM_BYTES_PER_S = 132 * 128 * 1.98e9

# FLOP per point of csrc/project.cu, counted from its source: one LM
# iteration (surface + derivatives, 2×2 solve, test-point cost), the final
# cost, and the sensitivities + 64 window-Jacobian values of the blocks form.
FLOP_LM_ITERATION = 550
FLOP_FINAL_COST = 160
FLOP_BLOCKS_TAIL = 850
# Of csrc/project_noncentral.cu, counted from its source: one evaluation at
# a g (the window with both derivatives, the offset and its 3×2 Jacobian),
# the 2×2 solve of an iteration, and the shared memory an evaluation reads
# (16 knots of 6 floats).
FLOP_NCG_EVALUATION = 690
FLOP_NCG_SOLVE = 46
SMEM_BYTES_NCG_EVALUATION = 16 * 24

# Tolerances (see the checks below for the reasons).
WINDOW_REL_TOL = 1e-4
PROJ_PX_TOL = 1e-2
PROJ_FLIP_FRACTION = 1e-3
BLOCKS_REL_TOL = 1e-3
STEP_REL_TOL = 1e-3

# Points of the 1080p projection case ([3], [5]): as many as the bench rows.
N_PROJECTION = 262_144
# The NoncentralGeneric projection at the shape of its main path ([5]): the
# benchmark's ncg1080.ba_final deployment (45×79, 1,036,200 slots), one of
# its start states, warm-started from the observed pixels, as many
# iterations as its bundle adjustment's blocks and cost passes
# (BAOptions.proj_iterations), and as many as the other callers on the card
# default to.  Held to the plain version at the card tests' tolerances
# (see check_noncentral_projection).
NCG_CELL, NCG_CELL_SEED = "ncg1080.ba_final", 1
NCG_ITERATIONS = (4, 50)
NCG_PX_TOL = 1e-3
NCG_FLIP_FRACTION = 1e-2

# Grids past one block's shared memory ([3], [5]): the 84×100 grid of a
# 2448×2048 camera at 25 px a cell, where project_blocks reads its grid and
# frames from device memory (project still stages its grid), and the K=5
# tangent of window_apply_j at 108×108.
MP5_CAMERA = (2448, 2048)
MP5_GRID = (84, 100)
K5_UNSTAGED_GRID = (108, 108)

# The calibration pipeline ([7]): a 1920×1080 pinhole camera and 100 views
# of a 24×24 board of 2 cm squares, calibrated with the command line's
# defaults (3 pyramid levels at 25 px per cell, outlier factor 8, 100 final
# iterations, solver "auto", float32 on the card and a 10-iteration float64
# polish on the CPU).
PIPELINE_IMAGESETS = 100
PIPELINE_MEDIAN_PX = 0.02
# One LM step through the kernels vs the plain step at a pipeline state:
# the new state's RMS residual to 5e-6 px, ten times the largest gap read
# on an H100 (5.0e-7 px at 34×59, where the RMS is 9.7e-4 px; 2.6e-7 px at
# 45×79 and 1e-8 px at 25×44).
PIPELINE_STEP_RMS_PX = 5e-6
PIPELINE_KERNELS = ("project", "project_blocks", "window_apply_j",
                    "window_apply_jtw", "window_block_diag")
# The three pyramid grids of a 1920×1080 camera at 25 px per cell.
PIPELINE_GRIDS = ("25x44", "34x59", "45x79")
PIPELINE_GRID_SHAPES = ((25, 44), (34, 59), (45, 79))
# window_apply_j's launch plan printed in [2]: (label, N, gh, gw, K) of the
# bench problem, [7]'s and [9b]'s final grids and the K=5 tangent past one
# block's shared memory.
APPLY_J_PLAN_CASES = (("bench", 262_144, 16, 16, 2),
                      ("[7] final grid", 57_600, 45, 79, 2),
                      ("[9b] final grid", 9_500, 45, 79, 5),
                      ("a tangent past a block's shared memory", 262_144,
                       108, 108, 5))
APPLY_J_SOURCE = ("camera_calibration_torch/csrc/window_apply_j.cu",
                  "camera_calibration_tpu/ba/window_pallas.py:133")
# The reductions' sources and the TPU kernels they replace.
REDUCTION_SOURCES = {
    "window_apply_jtw": ("camera_calibration_torch/csrc/window_apply_jtw.cu",
                         "camera_calibration_tpu/ba/window_pallas.py:78"),
    "window_block_diag": ("camera_calibration_torch/csrc/window_block_diag.cu",
                          "camera_calibration_tpu/ba/window_pallas.py:99"),
}

# Calibration from images ([8] detects, [9a] calibrates): 30 rendered views
# of a 24×24 board by a 1920×1080 pinhole camera, at depths that keep most
# of the board in view (fx = 0.85·1920 px), with sensor noise and a defocus
# blur.  The bars: at least
# 70% of the corners inside the image detected in every view; the
# detector's median distance to the rendered truth under 0.1 px (the
# reference package's bar for a noisy board, tests/test_detector.py); one
# refinement batch on the card in float32 against float64 on the CPU: the
# same converged flags but for 1%, the positions' median gap within 1e-4
# px, 95% of them within 1e-3 px and all within 1e-2 px (float64 keeps
# accepting LM steps along the symmetry cost's flat valleys that float32
# cannot resolve, a few 1e-3 px on the worst features of a CPU float32
# rehearsal; a float64 solve or float64 sample coordinates do not change
# that); the calibration's median reprojection error under 0.1 px ([9a];
# the reference package's end-to-end bar, tests/test_stress_e2e.py).
IMAGE_TAG = "[8]"
IMAGE_VIEWS = 30
IMAGE_SEED = 8
IMAGE_MIN_Z, IMAGE_MAX_Z = 0.6, 0.9
IMAGE_NOISE, IMAGE_DEFOCUS = 0.01, 0.8
IMAGE_MIN_DETECTED = 0.7
IMAGE_MEDIAN_TRUTH_PX = 0.1
IMAGE_RING_MEDIAN_PX = 1e-4
IMAGE_RING_PX = 1e-3
IMAGE_RING_MAX_PX = 1e-2
IMAGE_MEDIAN_PX = 0.1
# The float32 report on the card against the float64 one ([9a]): float32
# pixel coordinates near 1920 px are 1.2e-4 px apart, and the projections
# converge to ~1e-4 px, so the medians agree to 1e-3 px.
CARD_REPORT_PX = 1e-3

# NoncentralGeneric from scratch ([9b]): the cross-slit camera of the
# reference package's noncentral tests at 1920×1080, 20 views of a board of
# 25×19 corners 1.5 cm apart (the tests' 36×27 cm board, denser), and the
# reference's bar on exact data (tests/test_noncentral_init.py).  The
# initialization's outcome changes with last-bit differences, and on the
# card's machine it is a poor one (tools/trace_noncentral_init.py follows
# it step by step): the dataset, the rasterized matches and the random
# draws are the same bits on both machines, the Ramalingam–Sturm solve of
# the first triple differs by 1.4e-9 (the two machines' LAPACK), both
# machines' L-BFGS polishes of it stop at the 600-iteration cap, and the
# mirror test, which asks only for a handedness above 0.05 (as the
# reference's does, camera_calibration_tpu/init/noncentral_init.py:266),
# accepts it at 0.084 on the card's machine and rejects it at 0.008
# elsewhere.  From those poses (about 12° off) the float32 BA's steps
# stall: with the command line's three levels and 10-iteration polish the
# run ends at 0.062 px.  A deeper pyramid (six levels, the coarsest 11×19)
# and a longer float64 polish (up to 60 iterations; it stops at a 1e-4
# relative cost reduction) carry that start under the bar.  The fault is
# the reference's acceptance test, kept here for parity (ROADMAP queue 3).
NONCENTRAL_VIEWS = 20
NONCENTRAL_BOARD = (25, 19, 0.015)
NONCENTRAL_LEVELS = 6
NONCENTRAL_POLISH = 60
NONCENTRAL_SEED, NONCENTRAL_INIT_SEED = 1, 2
NONCENTRAL_MEDIAN_PX = 0.01
NONCENTRAL_KERNELS = ("window_apply_j", "window_apply_jtw",
                      "window_block_diag")
NCG_PROJECTION = "project_noncentral"
# The two passes of the point-eliminated Schur matvec on grid tables
# (ba/schur_cuda.py), and the deployments [5] times them at: the
# benchmark's two cells, one start state each.
SCHUR_LEGS = ("schur_point_leg", "schur_pose_leg")
SCHUR_CELLS = (("cg1080.ba_final", 1), ("ncg1080.ba_final", 1))


STEREO_SIZE = (1920, 1080)
STEREO_GRID = (45, 79)
STEREO_BASELINE = 0.2
STEREO_TEXTURE_SCALE = 12.0  # the reference tests' texture, 12x finer
# the reference's stereo tests' bars (tests/test_stereo.py)
STEREO_GOOD_FRACTION = 0.5
STEREO_MEDIAN_REL = 0.02
STEREO_PM_VS_PS = 0.7
STEREO_NORMAL_DOT = 0.95
# project launches of one stereo-depth run at the command line's defaults
# (96 levels, 8 rounds, mutation_count 2, 6 polish rounds):
# left sweep 96 + 1 + 12, left PatchMatch 1 + 8·12, right sweep 109,
# right PatchMatch 1 + 4·12, LR mask 1
STEREO_LAUNCHES = {"patch_match": 365, "plane_sweep": 219}
COLMAP_NN_MEDIAN_M = 0.04  # STEREO_MEDIAN_REL of the 2 m plane

# Live input ([12]).  [12a] records [8]'s 30 views through ``record``: one
# ``FeatureDetector.detect`` per frame where [8]'s extract-features ran
# ``detect_batch`` over all of them.  The two refine the same predictions
# in batches of other compositions: the detector draws 8 anti-aliasing
# offsets of its matching stage per refinement batch, and float32 batched
# products round by batch shape, so a feature on a flat stretch of the
# symmetry cost can converge elsewhere (the reference's design).  On an
# H100 the same ids in all 30 views, the positions 3.7e-4 px apart at the
# median, 1.6e-2 px at the 99th percentile and 2.9 px at most, 113 of the
# 13,413 features (0.84%) more than 5e-2 px apart; against the rendered
# truth the largest distance 2.67 px per frame, 2.03 px batched (on a CPU
# rehearsal, float32: 2e-4 px, 1.4e-2 px).  So the bars: every view kept,
# with the same feature ids; the median gap within RECORD_MEDIAN_PX, 99%
# of the gaps within RECORD_P99_PX and at most RECORD_TAIL_FRACTION of
# the features beyond it; the recorded positions as close to the
# rendered truth as [8]'s bar (median under IMAGE_MEDIAN_TRUTH_PX), and
# their largest distance to it within RECORD_TRUTH_MAX_FACTOR of the
# batched features' largest.
RECORD_MEDIAN_PX = 1e-3
RECORD_P99_PX = 5e-2
RECORD_TAIL_FRACTION = 0.02
RECORD_TRUTH_MAX_FACTOR = 2.0
# [12b]: the live frame rate as benchmarks/live_fps.py measures the
# reference package's: 24 VGA views of a 12×12 board, frame 0 excluded.
LIVE_FPS_VIEWS, LIVE_FPS_SIZE, LIVE_FPS_SEED = 24, (640, 480), 7
LIVE_FPS_MIN_KEPT = 0.8  # 23 of the 24 views hold a detected board
# [12c]: ``calibrate --live_directory`` writes these hooks' images.
LIVE_HOOK_PNGS = ("initialization", "reprojection_errors", "removed_outliers",
                  "error_histogram", "error_directions",
                  "observation_directions")


def log(*args):
    print(*args, flush=True)


class SmokeFailure(RuntimeError):
    pass


def require(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def time_ms(torch, fn, reps, warmup=2, graph=False):
    """Mean milliseconds per call of ``fn`` on the card (CUDA events around
    ``reps`` calls).  With ``graph``, the ``reps`` calls are captured once
    into a CUDA graph and the events time one replay: the card runs the
    same work back to back, and the host's per-call cost (Python, launches),
    which can exceed a short kernel's, is left out."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    if graph:
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            for _ in range(reps):
                fn()
        g.replay()
        run = g.replay
    else:
        def run():
            for _ in range(reps):
                fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    run()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def cold_graph_ms(torch, fn, reps=50):
    """Graph-replay milliseconds of ``fn`` when its inputs are not in the
    50 MB L2 cache: each call follows a 128 MB read (a sum), and the reads'
    own time, measured alone, is taken off.  A bf16 ``j_win`` of the bench
    (33.5 MB) fits in L2, so back-to-back replays of one call read it from
    there; in the CG loop other blocks pass through between two calls."""
    flush = torch.ones(32 * 2 ** 20, dtype=torch.float32,
                       device=torch.device("cuda"))
    both = time_ms(torch, lambda: (flush.sum(), fn()), reps, warmup=1,
                   graph=True)
    return both - time_ms(torch, flush.sum, reps, warmup=1, graph=True)


def projection_work(n, grid_bytes, loop_flop, blocks):
    """(bytes, FLOP) of one projection call on N points: the directions and
    warm starts read, the grid (and, for the blocks form, both frame fields)
    read once, the outputs written; the LM loop's FLOP, the final cost and,
    for the blocks form, the tail."""
    if not blocks:
        return (n * (3 + 2) * 4 + grid_bytes + n * (2 + 1) * 4,
                loop_flop + FLOP_FINAL_COST * n)
    return (n * (3 + 2) * 4 + 3 * grid_bytes + n * (2 + 1 + 6 + 64 + 2) * 4,
            loop_flop + (FLOP_FINAL_COST + FLOP_BLOCKS_TAIL) * n)


def bound_ms(nbytes, flops, smem_bytes=0):
    """The least time for the work: bytes over HBM rate, FLOP over the
    float32 rate or shared-memory reads over their rate, whichever is
    largest; and which one it is."""
    return max((nbytes / PEAK_BYTES_PER_S * 1e3, "bytes"),
               (flops / PEAK_F32_FLOP_PER_S * 1e3, "operations"),
               (smem_bytes / PEAK_SMEM_BYTES_PER_S * 1e3, "shared memory"))


def rel_err(got, ref):
    scale = float(ref.abs().max())
    return float((got - ref).abs().max()) / max(scale, 1e-30)


def nvidia_smi_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        timeout=60)
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else "?"


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card is available", file=sys.stderr)
        return 1
    if not os.path.isdir(os.path.join(REPO, "camera_calibration_torch")):
        print("chip_smoke: camera_calibration_torch/ not found beside "
              "chip_smoke.py; run it from the repository", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)

    from camera_calibration_torch import _cuda, problems
    from camera_calibration_torch.ba import lm_pcg
    from camera_calibration_torch.ba import window_cuda as wc
    from camera_calibration_torch.models import central_generic as cg
    from camera_calibration_torch.models import central_generic_cuda as cgc
    from camera_calibration_torch.models import noncentral_generic_cuda as ncgc
    from camera_calibration_torch.ops import manifolds

    t_start = time.perf_counter()
    rows_k5 = {}
    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    smi = nvidia_smi_line()
    log(f"[1] card: {kind}; nvidia-smi: {smi}; torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}")

    # ---------------------------------------------------------- 2. build
    t0 = time.perf_counter()
    build_dir = _cuda.build()
    _cuda.lib()
    log(f"[2] kernels built in {time.perf_counter() - t0:.1f} s "
        f"({build_dir.name})")
    for line in _cuda.build_log().splitlines():
        if line.startswith("==") or "ptxas info" in line or "spill" in line:
            log("    " + line.strip())
    for gh_, gw_ in ((16, 16), (45, 79), MP5_GRID):
        for blocks in (False, True):
            per_sm, nblocks = cgc.launch_shape(blocks, N_PROJECTION, gh_,
                                               gw_, dev)
            staged = cgc.project_staged(gh_, gw_, blocks)
            require(_cuda.lib().cct_project_staged(int(blocks), gh_, gw_)
                    == int(staged), "the staged plan differs from the C one")
            log(f"[2] {'project_blocks' if blocks else 'project'} at "
                f"{gh_}x{gw_}: {'staged' if staged else 'unstaged'}, "
                f"{cgc.project_smem_bytes(gh_, gw_, blocks)} B "
                f"shared, {per_sm} blocks of {cgc.threads(gh_, gw_, blocks)} "
                f"threads per SM, {nblocks} persistent blocks for "
                f"{N_PROJECTION} points on {_cuda.num_sms(dev)} SMs")
    for gh_, gw_ in ((16, 16), (45, 79), MP5_GRID):
        plan = ncgc.plan(gh_, gw_)
        require(plan["blocks_per_sm"] * plan["threads"] == 1024,
                f"{NCG_PROJECTION} at {gh_}x{gw_}: {plan}")
        log(f"[2] {NCG_PROJECTION} at {gh_}x{gw_}: "
            f"{'staged' if plan['staged'] else 'unstaged'}, "
            f"{plan['smem_bytes']} B shared, {plan['blocks_per_sm']} blocks "
            f"of {plan['threads']} threads per SM")
    for label_, n_, gh_, gw_, k_ in APPLY_J_PLAN_CASES:
        plan = wc.apply_j_plan_on_card(n_, k_)
        require(plan == {"parts": wc.APPLY_J_PARTS,
                         "threads": wc.APPLY_J_THREADS,
                         "blocks": wc.apply_j_blocks(n_)},
                f"the window_apply_j plan at {label_} differs from the C "
                f"one: {plan}")
        log(f"[2] window_apply_j {label_} ({gh_}x{gw_}, K={k_}, N={n_}): "
            f"{plan['parts']} warps an observation, {plan['blocks']} blocks "
            f"of {plan['threads']} threads, the tangent "
            f"({gh_ * gw_ * k_ * 4} B) read through L1")
    for name in wc.REDUCTIONS:
        for k_ in wc.SUPPORTED_K:
            for gh_, gw_ in ((16, 16),) + PIPELINE_GRID_SHAPES:
                rows, bands = wc.reduction_bands(name, gh_, gw_, k_)
                per_sm = [wc._resident_blocks(name, k_, gh_, gw_, dev.index, e)
                          for e in (4, 2)]
                scheme = ("knot owners" if wc.uses_owners(gh_, gw_)
                          else "slot classes")
                log(f"[2] {name} K={k_} at {gh_}x{gw_}: {scheme}, {bands} "
                    f"band(s) of {rows} rows, "
                    f"{wc.reduction_smem_bytes(name, gh_, gw_, k_)}"
                    f" B shared, blocks of {wc.THREADS} threads per SM "
                    f"{per_sm[0]} (float32) / {per_sm[1]} (bf16; shared "
                    f"memory allows "
                    f"{wc.smem_blocks_per_sm(name, gh_, gw_, k_)}), clusters "
                    f"of {wc.CLUSTER}")

    # ------------------------------------------ 3. kernels vs plain versions
    rng = np.random.default_rng(0)
    options = lm_pcg.BAOptions(max_pcg_iterations=20, proj_iterations=4)
    state, data, meta = problems.make_bench_problem(device=dev)
    seg = data[0]
    model = state.intrinsics[0]
    n_obs = seg.count
    log(f"[3] bench problem: {n_obs} rows, {meta['n_obs']} valid "
        f"observations, {model.grid_height}x{model.grid_width} grid")

    def check_project(mdl, d, g0, iters, label):
        """Kernel vs plain projection.  Both run the same float32 iteration;
        they differ by rounding (summation order, division), which can flip
        an accept test where the cost is flat near convergence.  So the
        converged points are held to PROJ_PX_TOL px (a tenth of the 0.1 px
        calibration target), and the valid masks may differ on at most
        PROJ_FLIP_FRACTION of the points."""
        lo, hi = cg._static_clamp_bounds(mdl)
        eps = cg.default_eps(torch.float32)
        gk, ck = cgc.project_grid_coords(mdl.grid, d, g0, lo, hi, iters, eps)
        gp, cp = cgc.project_grid_coords_plain(mdl.grid, d, g0, lo, hi,
                                               iters, eps)
        torch.cuda.synchronize()
        vk, vp = ck < 1e4 * eps, cp < 1e4 * eps
        both = vk & vp
        flips = int((vk != vp).sum())
        dg = (gk - gp)[both].abs()
        sx, sy = cg.pixel_scale_to_grid_scale(mdl)
        err_px = max(float(dg[:, 0].max()) / sx, float(dg[:, 1].max()) / sy)
        log(f"    project {label}: {int(both.sum())} valid in both, "
            f"{flips} valid-mask flips, max |Δpx| {err_px:.3e}")
        require(flips <= max(8, PROJ_FLIP_FRACTION * d.shape[0]),
                f"project {label}: {flips} valid-mask flips")
        require(err_px <= PROJ_PX_TOL, f"project {label}: |Δpx| {err_px}")
        return float(dg.max())

    def check_blocks(mdl, d, g0, iters, label):
        """Kernel vs plain blocks pass: the projection as above; p_px and
        j_win, on points valid in both with the same window base, to
        BLOCKS_REL_TOL of their largest value (they are smooth functions of
        g, which agrees to ~1e-5 grid units)."""
        lo, hi = cg._static_clamp_bounds(mdl)
        eps = cg.default_eps(torch.float32)
        t1, t2 = (t.contiguous() for t in manifolds.direction_tangents(mdl.grid))
        sx, sy = cg.pixel_scale_to_grid_scale(mdl)
        args = (mdl.grid, t1, t2, d, g0, lo, hi, (1 / sx, 1 / sy), iters, eps)
        gk, ck, pk, jk, bk = cgc.project_blocks(*args)
        gp, cp, pp, jp, bp = cgc.project_blocks_plain(*args)
        torch.cuda.synchronize()
        vk, vp = ck < 1e4 * eps, cp < 1e4 * eps
        same = vk & vp & (bk == bp).all(dim=1)
        flips = int((vk != vp).sum())
        dg = (gk - gp)[vk & vp].abs()
        err_px = max(float(dg[:, 0].max()) / sx, float(dg[:, 1].max()) / sy)
        e_p = rel_err(pk[same], pp[same])
        e_j = rel_err(jk[:, same], jp[:, same])
        log(f"    project_blocks {label}: {flips} flips, max |Δpx| "
            f"{err_px:.3e}, p_px rel {e_p:.3e}, j_win rel {e_j:.3e}, "
            f"base differs on {int((~(bk == bp).all(dim=1) & vk & vp).sum())}")
        require(flips <= max(8, PROJ_FLIP_FRACTION * d.shape[0]),
                f"project_blocks {label}: {flips} flips")
        require(err_px <= PROJ_PX_TOL, f"project_blocks {label}: {err_px}")
        require(e_p <= BLOCKS_REL_TOL and e_j <= BLOCKS_REL_TOL,
                f"project_blocks {label}: p_px {e_p}, j_win {e_j}")
        return max(float(dg.max()), float((jk[:, same] - jp[:, same]).abs().max()))

    def check_window(j_win, base, gh, gw, k, label, tangent=None, ws=None,
                     w=None):
        """Window kernels vs plain versions to WINDOW_REL_TOL (max abs error
        over the largest reference value, the reference package's own bar).
        The plain version runs on the same inputs promoted to float64, so
        the error measured is the kernel's own and not the float32 sum
        order of the plain version's index_add_.  Each kernel must also
        give bit-identical results on a second run (fixed-order sums, no
        atomics)."""
        n = j_win.shape[1]
        if tangent is None:
            tangent = torch.as_tensor(rng.normal(0, 1, (gh, gw, k)),
                                      dtype=torch.float32, device=dev)
        if ws is None:
            ws = torch.as_tensor(rng.normal(0, 1, (n, 2)),
                                 dtype=torch.float32, device=dev)
        if w is None:
            w = torch.as_tensor(rng.uniform(0, 1, n), dtype=torch.float32,
                                device=dev)
        out = {}
        j64, t64, ws64, w64 = (t.double() for t in (j_win, tangent, ws, w))
        pairs = (
            ("window_apply_j",
             lambda: wc.window_apply_j(j_win, base, tangent),
             lambda: wc.window_apply_j_plain(j64, base, t64)),
            ("window_apply_jtw",
             lambda: wc.window_apply_jtw(j_win, base, ws, gh, gw, k),
             lambda: wc.window_apply_jtw_plain(j64, base, ws64, gh, gw, k)),
            ("window_block_diag",
             lambda: wc.window_block_diag(j_win, base, w, gh, gw, k),
             lambda: wc.window_block_diag_plain(j64, base, w64, gh, gw, k)),
        )
        for name, kern, plain in pairs:
            got, ref = kern(), plain()
            again = kern()
            torch.cuda.synchronize()
            e = rel_err(got.double(), ref)
            det = bool(torch.equal(got, again))
            log(f"    {name} {label}: rel err {e:.3e}, repeatable {det}")
            require(e <= WINDOW_REL_TOL, f"{name} {label}: rel err {e}")
            require(det, f"{name} {label}: not bit-identical across runs")
            out[name] = float((got.double() - ref).abs().max())
        return out

    t0 = time.perf_counter()
    max_abs = {}
    d0, g00 = problems.bench_projection_inputs(state, seg)
    max_abs["project"] = check_project(model, d0, g00, options.proj_iterations,
                                       "bench 16x16")
    max_abs["project_blocks"] = check_blocks(
        model, d0, g00, options.proj_iterations, "bench 16x16")
    blocks0, _ = lm_pcg.compute_blocks(data, state, (seg.pixel,), options)
    b0 = blocks0[0]
    gh, gw = model.grid.shape[:2]
    max_abs.update(check_window(b0.intr.j_win, b0.intr.base_xy, gh, gw, 2,
                                "bench 16x16 K=2", w=b0.weight))

    # A non-square pyramid-like grid: projections of random image points,
    # and random window inputs whose windows also reach past the grid.
    gh2, gw2 = 21, 28
    small = problems.pinhole_model(640, 480, gw2, gh2, device=dev)
    n2 = 50_000
    dirs2, g02 = problems.pinhole_projection_inputs(small, n2, rng)
    check_project(small, dirs2, g02, 8, f"{gh2}x{gw2}")
    check_blocks(small, dirs2, g02, 8, f"{gh2}x{gw2}")
    # 45x79 is the pipeline's default grid for a 1080p camera (25 px cells);
    # the random inputs of the full-size cases are timed again in [5].
    hd = problems.pinhole_model(1920, 1080, 79, 45, device=dev)
    dirs_hd, g0_hd = problems.pinhole_projection_inputs(
        hd, N_PROJECTION, np.random.default_rng(45))
    check_project(hd, dirs_hd, g0_hd, options.proj_iterations, "1080p 45x79")
    check_blocks(hd, dirs_hd, g0_hd, options.proj_iterations, "1080p 45x79")
    # A 5 MP camera's grid: project_blocks past its staged plan, project at
    # 84x100 still staged; the K=5 J.v at 108x108 past its staged tangent.
    mp5 = problems.pinhole_model(*MP5_CAMERA, MP5_GRID[1], MP5_GRID[0],
                                 device=dev)
    dirs_5, g0_5 = problems.pinhole_projection_inputs(
        mp5, N_PROJECTION, np.random.default_rng(84))
    require(not cgc.project_staged(*MP5_GRID, blocks=True),
            "the 5 MP case does not reach the unstaged kernel")
    label_5 = "5 MP {}x{}".format(*MP5_GRID)
    for blocks in (False, True):
        log(f"[3] {'project_blocks' if blocks else 'project'} {label_5}: "
            f"{'staged' if cgc.project_staged(*MP5_GRID, blocks) else 'unstaged (fields read from device memory)'}")
    unstaged = {
        "project": dict(max_abs=check_project(
            mp5, dirs_5, g0_5, options.proj_iterations, label_5)),
        "project_blocks": dict(max_abs=check_blocks(
            mp5, dirs_5, g0_5, options.proj_iterations, label_5)),
    }
    hh5, ww5 = K5_UNSTAGED_GRID
    jw108 = torch.as_tensor(rng.normal(0, 1, (32 * 5, n_obs)),
                            dtype=torch.float32, device=dev)
    base108 = torch.as_tensor(
        np.stack([rng.integers(-3, ww5, n_obs), rng.integers(-3, hh5, n_obs)],
                 1), dtype=torch.int32, device=dev)
    log(f"[3] window_apply_j K=5 at {hh5}x{ww5}: a tangent of "
        f"{hh5 * ww5 * 5 * 4} B, past one block's shared memory (read through "
        "L1 as at every grid); the reductions in bands")
    errs108 = check_window(jw108, base108, hh5, ww5, 5,
                           f"random {hh5}x{ww5} K=5")
    unstaged["window_apply_j_k5"] = dict(max_abs=errs108["window_apply_j"])
    random_windows = {}
    for k, (hh, ww), nn in ((2, (gh2, gw2), n2), (5, (gh2, gw2), n2),
                            (5, (gh, gw), n_obs), (2, (45, 79), n_obs),
                            (5, (45, 79), n_obs)):
        jw = torch.as_tensor(rng.normal(0, 1, (32 * k, nn)),
                             dtype=torch.float32, device=dev)
        base = torch.as_tensor(
            np.stack([rng.integers(-3, ww, nn), rng.integers(-3, hh, nn)], 1),
            dtype=torch.int32, device=dev)
        errs = check_window(jw, base, hh, ww, k, f"random {hh}x{ww} K={k}")
        if nn == n_obs:
            random_windows[(hh, ww, k)] = (jw, base)
        if (hh, ww, k) == (45, 79, 5):
            require(wc.reduction_bands("window_block_diag", hh, ww, k)[1] > 1,
                    "the K=5 block diagonal at 45x79 is not banded")
            for name, err in errs.items():
                rows_k5.setdefault(name, {})["err_45x79"] = err
    # The NoncentralGeneric twin of the bench problem: its real K=5 j_win.
    t1_ = time.perf_counter()
    nstate, ndata, nmeta = problems.make_noncentral_bench_problem(device=dev)
    nblocks0, _ = lm_pcg.compute_blocks(ndata, nstate, (ndata[0].pixel,),
                                        options)
    nb0 = nblocks0[0]
    log(f"[3] noncentral bench problem: {nmeta['n_obs']} valid observations, "
        f"made in {time.perf_counter() - t1_:.1f} s")
    errs = check_window(nb0.intr.j_win, nb0.intr.base_xy, gh, gw, 5,
                        "noncentral bench 16x16 K=5", w=nb0.weight)
    for name, err in errs.items():
        rows_k5.setdefault(name, {})["max_abs_err"] = err
    # Bands narrower than the plan's (one band at 16x16) must give
    # bit-identical results: every knot sums the same tiles in order.
    for k, (jw, base) in ((2, (b0.intr.j_win, b0.intr.base_xy)),
                          (5, random_windows[(gh, gw, 5)])):
        ws_b = torch.as_tensor(rng.normal(0, 1, (jw.shape[1], 2)),
                               dtype=torch.float32, device=dev)
        w_b = torch.as_tensor(rng.uniform(0, 1, jw.shape[1]),
                              dtype=torch.float32, device=dev)
        for name, call in (
                ("window_apply_jtw", lambda **kw: wc.window_apply_jtw(
                    jw, base, ws_b, gh, gw, k, **kw)),
                ("window_block_diag", lambda **kw: wc.window_block_diag(
                    jw, base, w_b, gh, gw, k, **kw))):
            require(wc.reduction_bands(name, gh, gw, k)[1] == 1,
                    f"{name} K={k}: not one band at 16x16")
            whole = call()
            same = all(bool(torch.equal(whole, call(band_rows=r)))
                       for r in (1, 5, 8))
            log(f"    {name} K={k} 16x16 in bands of 1, 5 and 8 rows: "
                f"bit-identical to one band {same}")
            require(same, f"{name} K={k}: banded result differs")

    def check_window_bf16(j16, base, gh, gw, k, label):
        """The two matvec kernels on a bfloat16 j_win vs their plain versions
        on the same bf16 values promoted to float64, to WINDOW_REL_TOL;
        bit-identical on a second run; launched as the bf16 variants."""
        n = j16.shape[1]
        tangent = torch.as_tensor(rng.normal(0, 1, (gh, gw, k)),
                                  dtype=torch.float32, device=dev)
        ws = torch.as_tensor(rng.normal(0, 1, (n, 2)), dtype=torch.float32,
                             device=dev)
        j64 = j16.double()
        out = {}
        for name, kern, plain in (
                ("window_apply_j",
                 lambda: wc.window_apply_j(j16, base, tangent),
                 lambda: wc.window_apply_j_plain(j64, base, tangent.double())),
                ("window_apply_jtw",
                 lambda: wc.window_apply_jtw(j16, base, ws, gh, gw, k),
                 lambda: wc.window_apply_jtw_plain(j64, base, ws.double(), gh,
                                                   gw, k))):
            before = dict(_cuda.launches)
            got, ref = kern(), plain()
            again = kern()
            torch.cuda.synchronize()
            e = rel_err(got.double(), ref)
            det = bool(torch.equal(got, again))
            counted = (_cuda.launches[name + "_bf16"]
                       - before.get(name + "_bf16", 0),
                       _cuda.launches[name] - before.get(name, 0))
            log(f"    {name} bf16 {label}: rel err {e:.3e}, repeatable {det}")
            require(e <= WINDOW_REL_TOL, f"{name} bf16 {label}: rel err {e}")
            require(det, f"{name} bf16 {label}: not bit-identical across runs")
            require(counted == (2, 0), f"{name} bf16 {label}: launches "
                    f"{counted} (bf16, float32)")
            out[name + "_bf16"] = float((got.double() - ref).abs().max())
        return out

    def unaligned_bf16(jw):
        """A contiguous bf16 copy of ``jw`` one element into a buffer: no
        row is 4-byte aligned (the kernels' single-element staging)."""
        buf = torch.empty(jw.numel() + 1, dtype=torch.bfloat16, device=dev)
        view = buf[1:].view(jw.shape)
        view.copy_(jw)
        require(view.data_ptr() % 4 == 2, "bf16 view is aligned")
        return view

    bf16_errs = check_window_bf16(b0.intr.j_win.bfloat16(), b0.intr.base_xy,
                                  gh, gw, 2, "bench 16x16 K=2")
    bf16_errs_k5 = check_window_bf16(nb0.intr.j_win.bfloat16(),
                                     nb0.intr.base_xy, gh, gw, 5,
                                     "noncentral bench 16x16 K=5")
    for k in (2, 5):
        jw, base = random_windows[(45, 79, k)]
        check_window_bf16(jw.bfloat16(), base, 45, 79, k,
                          f"random 45x79 K={k}")
    for nn, label in ((50_001, "N odd"), (50_002, "N % 8 == 2"),
                      (50_000, "unaligned view")):
        jw = torch.as_tensor(rng.normal(0, 1, (32 * 5, nn)),
                             dtype=torch.float32, device=dev)
        base = torch.as_tensor(
            np.stack([rng.integers(-3, gw2, nn), rng.integers(-3, gh2, nn)],
                     1), dtype=torch.int32, device=dev)
        j16 = unaligned_bf16(jw) if label == "unaligned view" \
            else jw.bfloat16()
        check_window_bf16(j16, base, gh2, gw2, 5, f"random {gh2}x{gw2} K=5, "
                          f"{label}")
    # bf16 JᵀW·s in bands narrower than the plan's: the same bits
    ws_b = torch.as_tensor(rng.normal(0, 1, (n_obs, 2)), dtype=torch.float32,
                           device=dev)
    for k, hh, ww, (jw, base), widths in (
            (2, gh, gw, (b0.intr.j_win, b0.intr.base_xy), (1, 5, 8)),
            (5, 45, 79, random_windows[(45, 79, 5)], (9, 20))):
        j16 = jw.bfloat16()
        whole = wc.window_apply_jtw(j16, base, ws_b, hh, ww, k)
        same = all(bool(torch.equal(whole, wc.window_apply_jtw(
            j16, base, ws_b, hh, ww, k, band_rows=r))) for r in widths)
        bands = wc.reduction_bands("window_apply_jtw", hh, ww, k)[1]
        log(f"    window_apply_jtw bf16 K={k} {hh}x{ww} in bands of "
            f"{widths} rows: bit-identical to the plan's ({bands} band(s)) "
            f"{same}")
        require(same, f"window_apply_jtw bf16 K={k}: banded result differs")

    def check_block_diag_bf16(j16, base, w, gh, gw, k, label, widths=()):
        """The block diagonal on a bfloat16 j_win (its own bf16 variant) vs
        the plain version on the same bf16 values promoted to float64, to
        WINDOW_REL_TOL, and vs the float32 kernel on the widened values
        (the same products; the partial sums split over the blocks of the
        bf16 plan's occupancy) to 1e-6; bit-identical on a second run and
        in bands of ``widths`` rows; launched as the bf16 variant only."""
        name = "window_block_diag"
        before = dict(_cuda.launches)
        got = wc.window_block_diag(j16, base, w, gh, gw, k)
        again = wc.window_block_diag(j16, base, w, gh, gw, k)
        torch.cuda.synchronize()
        counted = (_cuda.launches[name + "_bf16"]
                   - before.get(name + "_bf16", 0),
                   _cuda.launches[name] - before.get(name, 0))
        ref = wc.window_block_diag_plain(j16.double(), base, w.double(), gh,
                                         gw, k)
        e = rel_err(got.double(), ref)
        widened = wc.window_block_diag(j16.float().contiguous(), base, w, gh,
                                       gw, k)
        banded = all(bool(torch.equal(got, wc.window_block_diag(
            j16, base, w, gh, gw, k, band_rows=r))) for r in widths)
        bands = wc.reduction_bands(name, gh, gw, k)[1]
        e32 = rel_err(got.double(), widened.double())
        log(f"    {name} bf16 {label}: rel err {e:.3e}, repeatable "
            f"{bool(torch.equal(got, again))}, vs the float32 kernel on the "
            f"widened values {e32:.3e} (bit-identical "
            f"{bool(torch.equal(got, widened))}), {bands} band(s), narrower "
            f"bands {widths} bit-identical {banded}")
        require(e <= WINDOW_REL_TOL, f"{name} bf16 {label}: rel err {e}")
        require(bool(torch.equal(got, again)) and banded,
                f"{name} bf16 {label}: not bit-identical across runs/bands")
        require(e32 <= 1e-6,
                f"{name} bf16 {label}: {e32} from the float32 kernel")
        require(counted == (2, 0),
                f"{name} bf16 {label}: launches {counted} (bf16, float32)")
        return float((got.double() - ref).abs().max())

    bd_bf16_errs = {
        2: check_block_diag_bf16(b0.intr.j_win.bfloat16(), b0.intr.base_xy,
                                 b0.weight, gh, gw, 2, "bench 16x16 K=2",
                                 (1, 5, 8)),
        5: check_block_diag_bf16(nb0.intr.j_win.bfloat16(), nb0.intr.base_xy,
                                 nb0.weight, gh, gw, 5,
                                 "noncentral bench 16x16 K=5", (1, 5, 8))}
    jw_r, base_r = random_windows[(45, 79, 5)]
    w_r = torch.as_tensor(rng.uniform(0, 1, jw_r.shape[1]),
                          dtype=torch.float32, device=dev)
    require(wc.reduction_bands("window_block_diag", 45, 79, 5)[1] > 1,
            "the bf16 K=5 block diagonal at 45x79 is not banded")
    check_block_diag_bf16(jw_r.bfloat16(), base_r, w_r, 45, 79, 5,
                          "random 45x79 K=5", (9,))
    log(f"[3] kernel checks passed in {time.perf_counter() - t0:.1f} s")

    # ------------------------------------------------------ 4. main paths
    central_kernels = ("project", "project_blocks", "window_apply_j",
                       "window_apply_jtw", "window_block_diag")
    window_kernels = central_kernels[2:]

    def drive(label, st0, dat, runs, kernels):
        """One path: the counts set to 0, the ``optimize`` runs, the counts
        read; every kernel of the path launched, the paired cost falls in
        every run, the state stays finite.  Returns (counts, histories)."""
        _cuda.reset_launches()
        t0_ = time.perf_counter()
        infos = [(form, opts, lm_pcg.optimize(st0, None, None, opts,
                                              data=dat))
                 for form, opts in runs]
        torch.cuda.synchronize()
        counts = dict(_cuda.launches)
        log(f"[4] {label} ran in {time.perf_counter() - t0_:.1f} s; launches "
            f"{json.dumps(counts, sort_keys=True)}")
        for name in kernels:
            require(counts.get(name, 0) > 0,
                    f"{label}: kernel {name} never launched")
        for form, opts, (st, info) in infos:
            hist = info["history"]
            for h in hist:
                log(f"    {label}, {form} it {h['iteration']}: cost "
                    f"{h['cost']:.6g} -> {h['new_cost']:.6g} (paired "
                    f"{h['paired_cost']:.6g} -> {h['paired_new_cost']:.6g}) "
                    f"accepted {h['accepted']} pcg {h['pcg_iterations']}")
            require(hist and hist[0]["accepted"]
                    and hist[0]["paired_new_cost"] < hist[0]["paired_cost"],
                    f"{label}, {form}: the first step did not lower the "
                    "paired cost")
            require(tuple(st.points.shape) == tuple(st0.points.shape)
                    and bool(torch.isfinite(st.points).all())
                    and bool(torch.isfinite(st.rig_t_global).all()),
                    f"{label}, {form}: non-finite or misshapen state")
        return counts, [info["history"] for _, _, (_, info) in infos]

    two_pass = dataclasses.replace(options, max_lm_iterations=3)
    cached = dataclasses.replace(two_pass, lm_steps_per_call=3)
    forms = (("two-pass", two_pass), ("cached-blocks", cached))
    launches, _ = drive("central bench, schur", state, data, forms,
                        central_kernels + SCHUR_LEGS)
    auto = dataclasses.replace(two_pass, solver="auto")
    resolved = lm_pcg.resolve_solver(auto, state).solver
    reduced = state.points.shape[0] * 3 + 6 + gh * gw * 2
    log(f"[4] solver='auto' resolves to {resolved!r} on the bench problem "
        f"({reduced} reduced unknowns)")
    require(resolved == ("schur" if reduced > 2048 else "schur_direct"),
            f"auto resolved to {resolved}")
    profile_dir = str(_cuda.BUILD_ROOT / "lm_profile")
    # verify_cost's finite differences need a cost that float32 resolves:
    # at the start state (cost 2.6e5, float32 spacing 0.016) the cost's
    # rounding puts an error of several percent on the central difference
    # (the check's bar is 5%), so debug_verify runs from the state after
    # one LM iteration (cost about 68)
    verify_state, _ = lm_pcg.optimize(
        state, None, None, dataclasses.replace(two_pass, max_lm_iterations=1),
        data=data)
    # the direct solves never apply J_intr to a vector
    direct_kernels = central_kernels[:2] + central_kernels[3:]
    for label, st0, run, kernels in (
            ("central bench, auto", state, auto,
             central_kernels if resolved == "schur" else direct_kernels),
            ("central bench, schur_direct", state,
             dataclasses.replace(two_pass, solver="schur_direct"),
             direct_kernels),
            ("central bench, schur_direct_points", state,
             dataclasses.replace(two_pass, solver="schur_direct_points"),
             direct_kernels),
            ("central bench, pcg", state,
             dataclasses.replace(two_pass, solver="pcg"), central_kernels),
            ("central bench, block_chunk=65536", state,
             dataclasses.replace(two_pass, block_chunk=65536),
             central_kernels),
            ("central bench after one LM iteration, debug_verify",
             verify_state, dataclasses.replace(two_pass, debug_verify=True,
                                               max_lm_iterations=1),
             central_kernels),
            ("central bench, profile_dir", state,
             dataclasses.replace(two_pass, profile_dir=profile_dir,
                                 max_lm_iterations=1), central_kernels)):
        drive(label, st0, data, (("two-pass", run),), kernels)
    require(os.path.exists(os.path.join(profile_dir, "lm_trace.json")),
            "profile_dir wrote no trace")
    report = lm_pcg.verify_cost(verify_state, data, options)
    log(f"    verify_cost after one LM iteration: {json.dumps(report)}")
    nc_launches, _ = drive("noncentral bench, schur", nstate, ndata, forms,
                           (NCG_PROJECTION,) + window_kernels + SCHUR_LEGS)

    # The parametric twins of the bench problem: dense intrinsics blocks
    # (einsums), so no kernel of a grid model may launch; their grid tables
    # take the Schur legs.
    param_problems = {}
    auto_forms = tuple((f"{form}, auto", dataclasses.replace(o, solver="auto"))
                       for form, o in forms)
    for pkind in ("thin_prism_fisheye", "opencv", "radial"):
        t1_ = time.perf_counter()
        pst, pdat, pmeta = problems.make_parametric_bench_problem(pkind,
                                                                  device=dev)
        param_problems[pkind] = (pst, pdat)
        log(f"[4] {pkind} bench problem: {pmeta['n_obs']} valid rows of "
            f"{pdat[0].count}, {pst.intrinsics[0].params.numel()} "
            f"parameters, made in {time.perf_counter() - t1_:.1f} s; auto "
            f"resolves to {lm_pcg.resolve_solver(auto, pst).solver!r}")
        counts, _ = drive(f"{pkind} bench", pst, pdat,
                          auto_forms + tuple((f"{f}, schur", o)
                                             for f, o in forms), SCHUR_LEGS)
        # the Schur legs do not depend on the intrinsics: only they launch
        require(not any(c for k_, c in counts.items()
                        if k_ not in SCHUR_LEGS),
                f"{pkind}: a grid kernel launched: {counts}")
    tpf_state, tpf_data = param_problems["thin_prism_fisheye"]
    for mode in ("schur_direct", "schur_direct_points", "pcg"):
        counts, _ = drive(f"thin_prism_fisheye bench, {mode}", tpf_state,
                          tpf_data, (("two-pass", dataclasses.replace(
                              two_pass, solver=mode)),), ())
        require(not any(counts.values()),
                f"thin_prism_fisheye {mode}: a grid kernel launched: {counts}")

    # bf16 CG: the bf16 matvec kernels launch once per CG iteration (cold
    # starts: one matvec an iteration), the float32 ones only outside CG
    # (schur: the back-substitution's J·v, the gradient's and the
    # right-hand side's JᵀW·s, per LM step).
    bf16 = dataclasses.replace(two_pass, cg_jacobian_dtype="bfloat16")
    bf16_launches = {}
    for label, st0, dat, grid in (
            ("central bench", state, data, True),
            ("noncentral bench", nstate, ndata, True),
            ("thin_prism_fisheye bench", tpf_state, tpf_data, False)):
        counts, (hist,) = drive(f"{label}, bf16 CG", st0, dat,
                                (("two-pass", bf16),),
                                ("window_apply_j_bf16",
                                 "window_apply_jtw_bf16") if grid else ())
        bf16_launches[label] = counts
        n_cg = sum(h["pcg_iterations"] for h in hist)
        expect = ({"window_apply_j_bf16": n_cg, "window_apply_jtw_bf16": n_cg,
                   "window_apply_j": len(hist),
                   "window_apply_jtw": 2 * len(hist)} if grid else
                  dict.fromkeys(("window_apply_j_bf16",
                                 "window_apply_jtw_bf16", "window_apply_j",
                                 "window_apply_jtw"), 0))
        # the Schur legs on every grid table: both passes a CG iteration in
        # bf16, the right-hand side and the back-substitution in float32
        expect.update({f"{k_}_bf16": n_cg for k_ in SCHUR_LEGS})
        expect.update(dict.fromkeys(SCHUR_LEGS, len(hist)))
        got = {k_: counts.get(k_, 0) for k_ in expect}
        log(f"    {label}, bf16 CG: {n_cg} CG iterations in {len(hist)} "
            f"steps; matvec launches {got}")
        require(got == expect, f"{label}, bf16 CG: matvec launches {got}, "
                f"expected {expect}")

    # One LM step through the kernels and one through the plain versions,
    # both on the card, from the same state (the reference package's bar),
    # on both models.  The central step runs at λ = 1e-2.  At that λ the
    # noncentral system is nearly undamped along its ill-conditioned
    # origin directions, where float32 rounding in the window sums moves
    # the step by up to 1e-3: so it is held at the λ its first LM step
    # takes (λ < 0: from the diagonal), and the λ = 1e-2 step is printed
    # only.
    lam = torch.tensor(1e-2, dtype=torch.float32, device=dev)
    lam_first = torch.tensor(-1.0, dtype=torch.float32, device=dev)
    bf16_opts = dataclasses.replace(options, cg_jacobian_dtype="bfloat16")
    for label, st0, dat, lam_, held, opts in (
            ("central", state, data, lam, True, options),
            ("noncentral", nstate, ndata, lam_first, True, options),
            ("noncentral, λ = 1e-2", nstate, ndata, lam, False, options),
            ("central, bf16 CG", state, data, lam, True, bf16_opts),
            ("noncentral, bf16 CG", nstate, ndata, lam_first, True,
             bf16_opts)):
        warm = tuple(s_.pixel for s_ in dat)
        out_k = lm_pcg.lm_step(st0, warm, lam_, dat, opts)
        before = dict(_cuda.launches)
        with plain_routes(cgc, wc):
            out_p = lm_pcg.lm_step(st0, warm, lam_, dat, opts)
        require(dict(_cuda.launches) == before,
                "the plain step launched a kernel")
        cost_k, cost_p = float(out_k[5]), float(out_p[5])
        cost_rel = abs(cost_k - cost_p) / max(abs(cost_p), 1e-30)
        dp = (out_k[0].points - out_p[0].points).abs().max()
        pts_rel = float(dp) / float(out_p[0].points.abs().max())
        # the step's λ: halved after an accepted step, doubled after a
        # rejected one
        lam_used = float(out_k[2]) * (2.0 if out_k[3] else 0.5)
        log(f"    one {label} LM step (λ {lam_used:.4g}), kernels vs "
            f"plain on the card: new cost {cost_k:.6g} vs {cost_p:.6g} (rel "
            f"{cost_rel:.3e}), points max|Δ|/scale {pts_rel:.3e}, pcg "
            f"{out_k[6]} vs {out_p[6]}{'' if held else ' (printed only)'}")
        require(not held or (cost_rel <= STEP_REL_TOL
                             and pts_rel <= STEP_REL_TOL),
                f"{label} LM step through the kernels disagrees with the "
                "plain step")

    # ----------------------------------------------------------- 5. times
    t0 = time.perf_counter()
    lo, hi = cg._static_clamp_bounds(model)
    eps = cg.default_eps(torch.float32)
    iters = options.proj_iterations
    t1, t2 = (t.contiguous() for t in manifolds.direction_tangents(model.grid))
    sx, sy = cg.pixel_scale_to_grid_scale(model)
    blk_args = (model.grid, t1, t2, d0, g00, lo, hi, (1 / sx, 1 / sy), iters,
                eps)
    _, iters_run = cgc.lm_loop_plain(model.grid, d0, g00, lo, hi, iters, eps)
    loop_flop = FLOP_LM_ITERATION * float(iters_run.sum())
    jw, base, wt = b0.intr.j_win, b0.intr.base_xy, b0.weight
    tangent = torch.as_tensor(rng.normal(0, 1, (gh, gw, 2)),
                              dtype=torch.float32, device=dev)
    ws = torch.as_tensor(rng.normal(0, 1, (n_obs, 2)), dtype=torch.float32,
                         device=dev)
    inside = float(wc._window_index(base, gh, gw)[1].sum())
    n = n_obs
    # Library yardstick of the two matvecs: a cuSPARSE product with J_intr
    # prebuilt as a CSR matrix from j_win and base (the build is not timed).
    j_csr, jt_csr = sparse_intrinsics_jacobian(torch, jw, base, gh, gw, 2)
    lib_j = lambda: (j_csr @ tangent.reshape(-1, 1)).reshape(n, 2)  # noqa: E731
    lib_jtw = lambda: (jt_csr @ ws.reshape(-1, 1)).reshape(gh, gw, 2)  # noqa: E731
    for name, lib, ref in (
            ("window_apply_j", lib_j,
             wc.window_apply_j_plain(jw.double(), base, tangent.double())),
            ("window_apply_jtw", lib_jtw,
             wc.window_apply_jtw_plain(jw.double(), base, ws.double(), gh,
                                       gw, 2))):
        e = rel_err(lib().double(), ref)
        require(e <= WINDOW_REL_TOL, f"{name}: sparse yardstick rel err {e}")
    grid_bytes = gh * gw * 3 * 4
    jw_bytes = jw.numel() * 4
    proj_bytes, proj_flops = projection_work(n, grid_bytes, loop_flop, False)
    blk_bytes, blk_flops = projection_work(n, grid_bytes, loop_flop, True)
    rows = {
        "project": dict(
            source="camera_calibration_torch/csrc/project.cu",
            replaces="camera_calibration_tpu/models/central_generic_pallas.py:163",
            kern=lambda: cgc.project_grid_coords(model.grid, d0, g00, lo, hi,
                                                 iters, eps),
            plain=lambda: cgc.project_grid_coords_plain(model.grid, d0, g00,
                                                        lo, hi, iters, eps),
            nbytes=proj_bytes, flops=proj_flops),
        "project_blocks": dict(
            source="camera_calibration_torch/csrc/project.cu",
            replaces="camera_calibration_tpu/models/central_generic_pallas.py:176",
            kern=lambda: cgc.project_blocks(*blk_args),
            plain=lambda: cgc.project_blocks_plain(*blk_args),
            nbytes=blk_bytes, flops=blk_flops),
        "window_apply_j": dict(
            source="camera_calibration_torch/csrc/window_apply_j.cu",
            replaces="camera_calibration_tpu/ba/window_pallas.py:133",
            kern=lambda: wc.window_apply_j(jw, base, tangent),
            plain=lambda: wc.window_apply_j_plain(jw, base, tangent),
            library=lib_j,
            nbytes=jw_bytes + n * 2 * 4 + gh * gw * 2 * 4 + n * 2 * 4,
            flops=4 * 2 * inside),
        "window_apply_jtw": dict(
            source="camera_calibration_torch/csrc/window_apply_jtw.cu",
            replaces="camera_calibration_tpu/ba/window_pallas.py:78",
            kern=lambda: wc.window_apply_jtw(jw, base, ws, gh, gw, 2),
            plain=lambda: wc.window_apply_jtw_plain(jw, base, ws, gh, gw, 2),
            library=lib_jtw,
            nbytes=jw_bytes + n * 2 * 4 + n * 2 * 4 + gh * gw * 2 * 4,
            flops=4 * 2 * inside),
        "window_block_diag": dict(
            source="camera_calibration_torch/csrc/window_block_diag.cu",
            replaces="camera_calibration_tpu/ba/window_pallas.py:99",
            kern=lambda: wc.window_block_diag(jw, base, wt, gh, gw, 2),
            plain=lambda: wc.window_block_diag_plain(jw, base, wt, gh, gw, 2),
            nbytes=jw_bytes + n * 2 * 4 + n * 4 + gh * gw * 4 * 4,
            flops=6 * 3 * inside),
    }
    # The three window kernels at K=5 on the noncentral bench's j_win (16x16),
    # launched on the noncentral path.
    jw5, base5, wt5 = nb0.intr.j_win, nb0.intr.base_xy, nb0.weight
    n5 = jw5.shape[1]
    tangent5 = torch.as_tensor(rng.normal(0, 1, (gh, gw, 5)),
                               dtype=torch.float32, device=dev)
    ws5 = torch.as_tensor(rng.normal(0, 1, (n5, 2)), dtype=torch.float32,
                          device=dev)
    inside5 = float(wc._window_index(base5, gh, gw)[1].sum())
    j5_csr, jt5_csr = sparse_intrinsics_jacobian(torch, jw5, base5, gh, gw, 5)
    jw5_bytes = jw5.numel() * 4
    for key, name, kern, plain, lib, nbytes, flops in (
            ("window_apply_j", "window_apply_j_k5",
             lambda: wc.window_apply_j(jw5, base5, tangent5),
             lambda: wc.window_apply_j_plain(jw5, base5, tangent5),
             lambda: (j5_csr @ tangent5.reshape(-1, 1)).reshape(n5, 2),
             jw5_bytes + n5 * 2 * 4 + gh * gw * 5 * 4 + n5 * 2 * 4,
             4 * 5 * inside5),
            ("window_apply_jtw", "window_apply_jtw_k5",
             lambda: wc.window_apply_jtw(jw5, base5, ws5, gh, gw, 5),
             lambda: wc.window_apply_jtw_plain(jw5, base5, ws5, gh, gw, 5),
             lambda: (jt5_csr @ ws5.reshape(-1, 1)).reshape(gh, gw, 5),
             jw5_bytes + n5 * 2 * 4 + n5 * 2 * 4 + gh * gw * 5 * 4,
             4 * 5 * inside5),
            ("window_block_diag", "window_block_diag_k5",
             lambda: wc.window_block_diag(jw5, base5, wt5, gh, gw, 5),
             lambda: wc.window_block_diag_plain(jw5, base5, wt5, gh, gw, 5),
             None, jw5_bytes + n5 * 2 * 4 + n5 * 4 + gh * gw * 25 * 4,
             6 * 15 * inside5)):
        if lib is not None:
            e = rel_err(lib().double(), plain().double())
            require(e <= WINDOW_REL_TOL, f"{name}: sparse yardstick rel err {e}")
        rows[name] = dict(
            source=rows[key]["source"], replaces=rows[key]["replaces"],
            kern=kern, plain=plain, nbytes=nbytes, flops=flops,
            launch_key=key, counts=nc_launches,
            max_abs=rows_k5[key]["max_abs_err"],
            **({} if lib is None else {"library": lib}))
    # The two matvec kernels' bf16 variants, on the bench j_win rounded to
    # bf16 (K=2, launched on the central bf16 CG path) and the noncentral
    # one (K=5): half the j_win bytes.  The library yardstick is
    # torch.sparse with the same bf16 matrix, where it takes one: its
    # vector and result are then bf16 too.
    for k, (jw_f, base_f, tan_f, ws_f), path, errs in (
            (2, (jw, base, tangent, ws), "central bench", bf16_errs),
            (5, (jw5, base5, tangent5, ws5), "noncentral bench",
             bf16_errs_k5)):
        j16 = jw_f.bfloat16()
        n_k = j16.shape[1]
        inside_k = float(wc._window_index(base_f, gh, gw)[1].sum())
        try:
            j16_csr, jt16_csr = sparse_intrinsics_jacobian(torch, j16, base_f,
                                                           gh, gw, k)
            t16, w16 = tan_f.bfloat16(), ws_f.bfloat16()
            libs = {"window_apply_j":
                    lambda a=j16_csr, v=t16: a @ v.reshape(-1, 1),
                    "window_apply_jtw":
                    lambda a=jt16_csr, v=w16: a @ v.reshape(-1, 1)}
            for fn in libs.values():
                fn()
        except (RuntimeError, NotImplementedError) as exc:
            log(f"[5] torch.sparse takes no bf16 CSR product here: {exc}")
            libs = {}
        suffix = "_bf16" if k == 2 else "_bf16_k5"
        for key, kern, plain, nbytes in (
                ("window_apply_j",
                 lambda j16=j16, b=base_f, t=tan_f: wc.window_apply_j(j16, b, t),
                 lambda j16=j16, b=base_f, t=tan_f: wc.window_apply_j_plain(
                     j16, b, t),
                 j16.numel() * 2 + n_k * 2 * 4 + gh * gw * k * 4
                 + n_k * 2 * 4),
                ("window_apply_jtw",
                 lambda j16=j16, b=base_f, w_=ws_f, k=k: wc.window_apply_jtw(
                     j16, b, w_, gh, gw, k),
                 lambda j16=j16, b=base_f, w_=ws_f, k=k:
                 wc.window_apply_jtw_plain(j16, b, w_, gh, gw, k),
                 j16.numel() * 2 + n_k * 2 * 4 + n_k * 2 * 4
                 + gh * gw * k * 4)):
            row = dict(source=rows[key]["source"],
                       replaces=rows[key]["replaces"], kern=kern, plain=plain,
                       nbytes=nbytes, flops=4 * k * inside_k,
                       launch_key=key + "_bf16", counts=bf16_launches[path],
                       max_abs=errs[key + "_bf16"])
            if key in libs:
                row["library"] = libs[key]
            rows[key + suffix] = row
    # The block diagonal's bf16 variant on the same two j_win rounded to
    # bf16.  No path of the LM step reads it (the preconditioner is built
    # from the float32 blocks), so its launches on the paths are 0.
    for k, (jw_f, base_f, wt_f), suffix in (
            (2, (jw, base, wt), "_bf16"), (5, (jw5, base5, wt5), "_bf16_k5")):
        j16 = jw_f.bfloat16()
        n_k = j16.shape[1]
        inside_k = float(wc._window_index(base_f, gh, gw)[1].sum())
        rows["window_block_diag" + suffix] = dict(
            source=rows["window_block_diag"]["source"],
            replaces=rows["window_block_diag"]["replaces"],
            kern=lambda j16=j16, b=base_f, w_=wt_f, k=k: wc.window_block_diag(
                j16, b, w_, gh, gw, k),
            plain=lambda j16=j16, b=base_f, w_=wt_f, k=k:
            wc.window_block_diag_plain(j16, b, w_, gh, gw, k),
            nbytes=j16.numel() * 2 + n_k * 2 * 4 + n_k * 4 + gh * gw * k * k * 4,
            flops=6 * (k * (k + 1) // 2) * inside_k,
            launch_key="window_block_diag_bf16", max_abs=bd_bf16_errs[k])
    kernels = []
    for name, r in rows.items():
        ms = time_ms(torch, r["kern"], reps=100, warmup=5)
        graph_ms = time_ms(torch, r["kern"], reps=100, warmup=1, graph=True)
        plain_ms = time_ms(torch, r["plain"], reps=3, warmup=1)
        library_ms = (time_ms(torch, r["library"], reps=100, warmup=5)
                      if "library" in r else None)
        # the matvecs read j_win once a CG iteration, and a bf16 j_win fits
        # in L2: time them cold too
        cold_ms = (cold_graph_ms(torch, r["kern"])
                   if name.startswith("window_apply") or "_bf16" in name
                   else None)
        b_ms, b_by = bound_ms(r["nbytes"], r["flops"])
        n_launch = r.get("counts", launches).get(r.get("launch_key", name), 0)
        lib_txt = "" if library_ms is None else f", torch.sparse {library_ms:.4f} ms"
        cold_txt = "" if cold_ms is None else f", L2-cold graph {cold_ms:.4f} ms"
        log(f"[5] {name}: {ms:.4f} ms, graph {graph_ms:.4f} ms{cold_txt} (plain "
            f"{plain_ms:.4f} ms{lib_txt}, bound {b_ms:.4f} ms by {b_by}; "
            f"{n_launch} launches on its path) on {smi}")
        kernels.append({
            "name": name, "route": "cuda", "source": r["source"],
            "replaces": r["replaces"], "launches": n_launch,
            "max_abs_err": r.get("max_abs", max_abs.get(name)), "ms": ms,
            "graph_ms": graph_ms, "plain_ms": plain_ms, "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": library_ms,
            **({} if cold_ms is None else {"cold_graph_ms": cold_ms}),
        })

    # The two reductions beyond the bench shapes, on the random inputs of
    # [3]: K=5 on the bench grid, K=2 and K=5 (banded block diagonal) on the
    # 1080p default grid.
    for (hh, ww, k), (jw_x, base_x) in random_windows.items():
        nx = jw_x.shape[1]
        ws_x = torch.as_tensor(rng.normal(0, 1, (nx, 2)), dtype=torch.float32,
                               device=dev)
        w_x = torch.as_tensor(rng.uniform(0, 1, nx), dtype=torch.float32,
                              device=dev)
        inside_x = float(wc._window_index(base_x, hh, ww)[1].sum())
        common = jw_x.numel() * 4 + nx * 2 * 4
        _, jt_x = sparse_intrinsics_jacobian(torch, jw_x, base_x, hh, ww, k)
        lib_x = lambda: (jt_x @ ws_x.reshape(-1, 1)).reshape(hh, ww, k)  # noqa: E731
        e = rel_err(lib_x().double(), wc.window_apply_jtw_plain(
            jw_x.double(), base_x, ws_x.double(), hh, ww, k))
        require(e <= WINDOW_REL_TOL, f"sparse JtW {hh}x{ww} K={k}: rel err {e}")
        for name, fn, plain, lib, nbytes, flops in (
                ("window_apply_jtw",
                 lambda **kw: wc.window_apply_jtw(jw_x, base_x, ws_x, hh, ww,
                                                  k, **kw),
                 lambda: wc.window_apply_jtw_plain(jw_x, base_x, ws_x, hh,
                                                   ww, k),
                 lib_x, common + nx * 2 * 4 + hh * ww * k * 4,
                 4 * k * inside_x),
                ("window_block_diag",
                 lambda **kw: wc.window_block_diag(jw_x, base_x, w_x, hh, ww,
                                                   k, **kw),
                 lambda: wc.window_block_diag_plain(jw_x, base_x, w_x, hh,
                                                    ww, k),
                 None, common + nx * 4 + hh * ww * k * k * 4,
                 6 * (k * (k + 1) // 2) * inside_x)):
            ms = time_ms(torch, fn, reps=100, warmup=5)
            graph_ms = time_ms(torch, fn, reps=100, warmup=1, graph=True)
            plain_ms = time_ms(torch, plain, reps=3, warmup=1)
            library_ms = (None if lib is None
                          else time_ms(torch, lib, reps=100, warmup=5))
            b_ms, b_by = bound_ms(nbytes, flops)
            bands = wc.reduction_bands(name, hh, ww, k)[1]
            lib_txt = ("" if library_ms is None
                       else f", torch.sparse {library_ms:.4f} ms")
            log(f"[5] {name} random {hh}x{ww} K={k}: {ms:.4f} ms, graph "
                f"{graph_ms:.4f} ms (plain {plain_ms:.4f} ms, bound "
                f"{b_ms:.4f} ms by {b_by}{lib_txt}; {nx} observations, "
                f"{bands} band(s)) on {smi}")
            if (hh, ww, k) == (45, 79, 5):
                rows_k5[name]["at_45x79"] = dict(
                    ms=ms, graph_ms=graph_ms, plain_ms=plain_ms,
                    bound_ms=b_ms, bound_by=b_by,
                    library_ms=library_ms, bands=bands,
                    max_abs_err=rows_k5[name]["err_45x79"])
                # what a band costs: the same call in twice the bands (the
                # same layout and bits)
                rows_b = -(-hh // (2 * bands))
                graph_2x = time_ms(torch, lambda: fn(band_rows=rows_b),
                                   reps=100, warmup=1, graph=True)
                log(f"[5] {name} random {hh}x{ww} K={k} in {2 * bands} "
                    f"bands of {rows_b} rows: graph {graph_2x:.4f} ms on "
                    f"{smi}")

    # The two projections on the 1080p inputs of [3] (45x79 grid).
    lo_hd, hi_hd = cg._static_clamp_bounds(hd)
    t1_hd, t2_hd = (t.contiguous()
                    for t in manifolds.direction_tangents(hd.grid))
    sx_hd, sy_hd = cg.pixel_scale_to_grid_scale(hd)
    _, iters_hd = cgc.lm_loop_plain(hd.grid, dirs_hd, g0_hd, lo_hd, hi_hd,
                                    iters, eps)
    loop_flop_hd = FLOP_LM_ITERATION * float(iters_hd.sum())
    hd_args = (dirs_hd, g0_hd, lo_hd, hi_hd)
    hd_blk_args = (hd.grid, t1_hd, t2_hd, dirs_hd, g0_hd, lo_hd, hi_hd,
                   (1 / sx_hd, 1 / sy_hd), iters, eps)
    for name, fn, plain, blocks in (
            ("project",
             lambda: cgc.project_grid_coords(hd.grid, *hd_args, iters, eps),
             lambda: cgc.project_grid_coords_plain(hd.grid, *hd_args, iters,
                                                   eps), False),
            ("project_blocks",
             lambda: cgc.project_blocks(*hd_blk_args),
             lambda: cgc.project_blocks_plain(*hd_blk_args), True)):
        ms = time_ms(torch, fn, reps=100, warmup=5)
        graph_ms = time_ms(torch, fn, reps=100, warmup=1, graph=True)
        plain_ms = time_ms(torch, plain, reps=3, warmup=1)
        b_ms, b_by = bound_ms(*projection_work(
            N_PROJECTION, 45 * 79 * 3 * 4, loop_flop_hd, blocks))
        log(f"[5] {name} 1080p 45x79: {ms:.4f} ms, graph {graph_ms:.4f} ms "
            f"(plain {plain_ms:.4f} ms, bound {b_ms:.4f} ms by {b_by}; "
            f"{N_PROJECTION} points, "
            f"{float(iters_hd.float().mean()):.3f} LM iterations each) on "
            f"{smi}")

    # The NoncentralGeneric projection at the shape of its main path.
    kernels.append(noncentral_projection_row(torch, smi, nc_launches))
    # The Schur legs at the benchmark cells' deployments.
    kernels.extend(schur_legs_rows(torch, smi, {
        ("cg1080.ba_final", torch.float32): launches,
        ("ncg1080.ba_final", torch.float32): nc_launches,
        ("cg1080.ba_final", torch.bfloat16): bf16_launches["central bench"],
        ("ncg1080.ba_final", torch.bfloat16):
        bf16_launches["noncentral bench"]}))

    # The kernels past their staged plans ([3]): project and project_blocks
    # at the 5 MP grid, J.v at K=5 108x108.
    lo_5, hi_5 = cg._static_clamp_bounds(mp5)
    _, iters_5 = cgc.lm_loop_plain(mp5.grid, dirs_5, g0_5, lo_5, hi_5, iters,
                                   eps)
    t1_5, t2_5 = (t.contiguous() for t in manifolds.direction_tangents(mp5.grid))
    sx_5, sy_5 = cg.pixel_scale_to_grid_scale(mp5)
    blk_5 = (mp5.grid, t1_5, t2_5, dirs_5, g0_5, lo_5, hi_5,
             (1 / sx_5, 1 / sy_5), iters, eps)
    tan108 = torch.as_tensor(rng.normal(0, 1, (hh5, ww5, 5)),
                             dtype=torch.float32, device=dev)
    inside108 = float(wc._window_index(base108, hh5, ww5)[1].sum())
    j108_csr, _ = sparse_intrinsics_jacobian(torch, jw108, base108, hh5, ww5,
                                             5)
    g5 = MP5_GRID[0] * MP5_GRID[1]
    for name, fn, plain, lib, work in (
            ("project",
             lambda: cgc.project_grid_coords(mp5.grid, dirs_5, g0_5, lo_5,
                                             hi_5, iters, eps),
             lambda: cgc.project_grid_coords_plain(mp5.grid, dirs_5, g0_5,
                                                   lo_5, hi_5, iters, eps),
             None, projection_work(N_PROJECTION, g5 * 12,
                                   FLOP_LM_ITERATION * float(iters_5.sum()),
                                   False)),
            ("project_blocks", lambda: cgc.project_blocks(*blk_5),
             lambda: cgc.project_blocks_plain(*blk_5), None,
             projection_work(N_PROJECTION, g5 * 12,
                             FLOP_LM_ITERATION * float(iters_5.sum()), True)),
            ("window_apply_j_k5",
             lambda: wc.window_apply_j(jw108, base108, tan108),
             lambda: wc.window_apply_j_plain(jw108, base108, tan108),
             lambda: (j108_csr @ tan108.reshape(-1, 1)).reshape(n_obs, 2),
             (jw108.numel() * 4 + n_obs * 2 * 4 + hh5 * ww5 * 5 * 4
              + n_obs * 2 * 4, 4 * 5 * inside108))):
        ms = time_ms(torch, fn, reps=100, warmup=5)
        graph_ms = time_ms(torch, fn, reps=100, warmup=1, graph=True)
        plain_ms = time_ms(torch, plain, reps=3, warmup=1)
        library_ms = (None if lib is None
                      else time_ms(torch, lib, reps=100, warmup=5))
        b_ms, b_by = bound_ms(*work)
        at = ("{}x{}".format(*MP5_GRID) if name.startswith("project")
              else "{}x{}".format(*K5_UNSTAGED_GRID))
        staged = (cgc.project_staged(*MP5_GRID, name == "project_blocks")
                  if name.startswith("project") else False)
        lib_txt = ("" if library_ms is None
                   else f", torch.sparse {library_ms:.4f} ms")
        log(f"[5] {name} at {at} ({'staged' if staged else 'unstaged'}): "
            f"{ms:.4f} ms, graph {graph_ms:.4f} ms (plain {plain_ms:.4f} ms, "
            f"bound {b_ms:.4f} ms by {b_by}{lib_txt}) on {smi}")
        unstaged[name].update(
            grid=at, staged=staged, ms=ms, graph_ms=graph_ms,
            plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
            library_ms=library_ms, max_abs_err=unstaged[name].pop("max_abs"))
    for row in kernels:
        if row["name"] in unstaged:
            row["past_the_staged_plan"] = unstaged[row["name"]]

    # LM iterations per second of both step forms, from a fresh perturbation
    # (the kernels are built and warm); no early stop inside the window.
    # The step is bound by the host, whose clock varies from run to run, so
    # each form is timed twice, in turns (two-pass, cached, cached, two-pass).
    n_it = 10
    timed = dataclasses.replace(options, max_lm_iterations=n_it,
                                cost_reduction_threshold=0.0,
                                max_consecutive_rejects=n_it + 1)
    cached_timed = dataclasses.replace(timed, lm_steps_per_call=n_it)
    for label, opts in (("two-pass", timed), ("cached-blocks", cached_timed),
                        ("cached-blocks", cached_timed),
                        ("two-pass", timed)):
        s_try = problems.perturb_bench_state(state, seed=100)
        torch.cuda.synchronize()
        t1_ = time.perf_counter()
        _, info = lm_pcg.optimize(s_try, None, None, opts, data=data)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t1_
        hist = info["history"]
        cg_mean = float(np.mean([h["pcg_iterations"] for h in hist]))
        log(f"[5] LM iterations/s, {label}: {len(hist) / dt:.3f} "
            f"({len(hist)} iterations in {dt:.3f} s, {cg_mean:.1f} CG "
            f"iterations each, cost {hist[0]['cost']:.6g} -> "
            f"{hist[-1]['new_cost']:.6g}; {n_obs} rows, {gh}x{gw} grid) "
            f"on {smi}")
    # Each solver mode, the noncentral path, each parametric path and bf16
    # CG: 6 iterations each, from a fresh perturbation where the problem
    # has one (host clock).
    n_mode = 6
    six = dataclasses.replace(timed, max_lm_iterations=n_mode)
    for label, st0, dat, opts in (
            [(f"central, {m}", problems.perturb_bench_state(state, seed=100),
              data, dataclasses.replace(six, solver=m))
             for m in ("auto", "schur_direct", "schur_direct_points", "pcg")]
            + [(f"noncentral, schur, {form}", nstate, ndata,
                dataclasses.replace(six, lm_steps_per_call=k_))
               for form, k_ in (("two-pass", 1), ("cached-blocks", n_mode))]
            + [(f"{pkind}, schur, two-pass", *param_problems[pkind], six)
               for pkind in ("thin_prism_fisheye", "opencv", "radial")]
            + [(f"thin_prism_fisheye, {m}", tpf_state, tpf_data,
                dataclasses.replace(six, solver=m))
               for m in ("schur_direct", "schur_direct_points", "pcg")]
            + [("central, schur, bf16 CG",
                problems.perturb_bench_state(state, seed=100), data,
                dataclasses.replace(six, cg_jacobian_dtype="bfloat16")),
               ("noncentral, schur, bf16 CG", nstate, ndata,
                dataclasses.replace(six, cg_jacobian_dtype="bfloat16")),
               ("thin_prism_fisheye, schur, bf16 CG", tpf_state, tpf_data,
                dataclasses.replace(six, cg_jacobian_dtype="bfloat16"))]):
        torch.cuda.synchronize()
        t1_ = time.perf_counter()
        _, info = lm_pcg.optimize(st0, None, None, opts, data=dat)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t1_
        hist = info["history"]
        cg_mean = float(np.mean([h["pcg_iterations"] for h in hist]))
        log(f"[5] LM iterations/s, {label}: {len(hist) / dt:.3f} "
            f"({len(hist)} iterations in {dt:.3f} s, {cg_mean:.1f} CG "
            f"iterations each, cost {hist[0]['cost']:.6g} -> "
            f"{hist[-1]['new_cost']:.6g}) on {smi}")

    # The dense direct solve at bench shapes: the whole solve, and the
    # Cholesky factorization and solve of an SPD matrix of the reduced
    # system's size alone (its cost does not depend on the values).
    blocks_d, _ = lm_pcg.compute_blocks(data, state, (seg.pixel,), options)
    mask_d = lm_pcg.fix_gauge_mask(state, ())
    grad_d = lm_pcg._masked(lm_pcg.apply_jtw(data, blocks_d,
                                             [b.r for b in blocks_d], state),
                            mask_d)
    diag_d = lm_pcg.jtwj_block_diag(data, blocks_d, state)
    f_dim = lm_pcg._flat_offsets(state)[1]
    a_ = torch.randn(f_dim, f_dim, device=dev)
    spd = a_ @ a_.T + f_dim * torch.eye(f_dim, device=dev)
    rhs = torch.randn(f_dim, 1, device=dev)
    chol_ms = time_ms(torch, lambda: torch.cholesky_solve(
        rhs, torch.linalg.cholesky_ex(spd)[0]), reps=5, warmup=2)
    for elim in ("poses", "points"):
        solve_ms = time_ms(torch, lambda: lm_pcg.schur_direct_solve(
            data, blocks_d, state, grad_d, diag_d, lam, mask_d, options,
            eliminate=elim), reps=3, warmup=1)
        log(f"[5] schur_direct_solve, {elim} eliminated: {solve_ms:.3f} ms "
            f"(Cholesky of the {f_dim}x{f_dim} system {chol_ms:.3f} ms, "
            f"assembly and back-substitution {solve_ms - chol_ms:.3f} ms) "
            f"on {smi}")
    log(f"[5] timing took {time.perf_counter() - t0:.1f} s")

    # ------------------------------------------------ 6. where the time goes
    profile_step(torch, lm_pcg, problems.perturb_bench_state(state, seed=101),
                 data, dataclasses.replace(timed, max_lm_iterations=2), smi)
    log(f"[6] whole run so far {time.perf_counter() - t_start:.1f} s")

    # ------------------------------------------ 7. the calibration pipeline
    pipeline = calibration_pipeline(
        torch, smi, PIPELINE_IMAGESETS,
        checks=dict(project=check_project, blocks=check_blocks,
                    window=check_window))
    for row in kernels:
        if row["name"] in PIPELINE_KERNELS:
            row["pipeline_launches"] = {
                grid: counts.get(row["name"], 0)
                for grid, counts in pipeline["launches"].items()}
    kernels += pipeline["window_rows"]
    log(f"[7] whole run {time.perf_counter() - t_start:.1f} s")

    # ----------------------------------- 8. feature detection in images
    images = image_pipeline(torch, smi, IMAGE_VIEWS)
    log(f"[8] whole run {time.perf_counter() - t_start:.1f} s")

    # ------------- 9a. the command line's calibration of [8]'s dataset
    checks = dict(project=check_project, blocks=check_blocks,
                  window=check_window)
    cli_run = cli_pipeline(torch, smi, images, checks)
    log(f"[9a] whole run {time.perf_counter() - t_start:.1f} s")

    # ------------------------ 9b. NoncentralGeneric from scratch at 1080p
    nc_run = noncentral_pipeline(torch, smi, checks)
    kernels += nc_run["window_rows"]
    log(f"[9b] whole run {time.perf_counter() - t_start:.1f} s")
    for row in kernels:
        if row["name"] in PIPELINE_KERNELS:
            row["cli_launches"] = {
                grid: counts.get(row["name"], 0)
                for grid, counts in cli_run["launches"].items()}
        if row["name"] in (k + "_k5" for k in NONCENTRAL_KERNELS):
            row["noncentral_launches"] = {
                grid: counts.get(row["name"][:-len("_k5")], 0)
                for grid, counts in nc_run["launches"].items()}
        if row["name"] == NCG_PROJECTION:
            row["noncentral_launches"] = {
                grid: counts.get(NCG_PROJECTION, 0)
                for grid, counts in nc_run["launches"].items()}

    # ------------------------------- 10. stereo depth at 1920x1080
    stereo = stereo_pipeline(torch, smi, checks)
    log(f"[10] whole run {time.perf_counter() - t_start:.1f} s")

    # ----------------------- 11. the COLMAP tools and the visualization
    colmap_pipeline(torch, smi, cli_run, images["dataset"], stereo)
    log(f"[11] whole run {time.perf_counter() - t_start:.1f} s")

    # ------------------- 12. live input, the visualizer and sharding
    recorded = record_pipeline(torch, smi, images)
    log(f"[12a] whole run {time.perf_counter() - t_start:.1f} s")
    live_frame_rate(torch, smi)
    log(f"[12b] whole run {time.perf_counter() - t_start:.1f} s")
    live = live_calibration(torch, smi, recorded)
    log(f"[12c] whole run {time.perf_counter() - t_start:.1f} s")
    sharded = sharded_optimize(torch, smi)
    log(f"[12d] whole run {time.perf_counter() - t_start:.1f} s")
    for row in kernels:
        if row["name"] in PIPELINE_KERNELS:
            row["live_launches"] = {
                grid: counts.get(row["name"], 0)
                for grid, counts in live["launches"].items()}
            row["sharded_launches"] = {
                form: counts.get(row["name"], 0)
                for form, counts in sharded["launches"].items()}
    for row in kernels:
        if row["name"] == "project":
            row["stereo_launches"] = stereo["launches"]
            row["stereo"] = stereo["project"]

    for row in kernels:
        extra = rows_k5.get(row["name"][:-len("_k5")], {}).get("at_45x79")
        if row["name"].endswith("_k5") and extra:
            row["at_45x79"] = extra
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def calibration_pipeline(torch, smi, n_imagesets, checks, device=None):
    """The calibration pipeline from a feature dataset, as the command line
    runs it: the dataset written to ``dataset.bin`` and read back, dense
    initialization, the initial state on the card at the coarsest pyramid
    grid (float32) and ``calibrate``, with the launch counts set to 0 just
    before ``calibrate`` and read per BA stage.  Holds the result to the
    quality bar (median reprojection error, metric scale, final grid), every
    kernel to its plain version at each pyramid grid's own inputs, and one
    LM step per grid through the kernels to the plain step.  Returns the
    launches per grid and the report."""
    from camera_calibration_torch import _cuda, problems
    from camera_calibration_torch.io import dataset_bin

    dev = torch.device("cuda") if device is None else torch.device(device)
    out_dir = _cuda.BUILD_ROOT / "pipeline"
    out_dir.mkdir(parents=True, exist_ok=True)
    times = {}
    t0 = time.perf_counter()
    ds, _, _ = problems.make_calibration_dataset(
        seed=2, n_imagesets=n_imagesets, k=24, w=1920, h=1080, cell=0.02)
    n_features = sum(len(s_.features[0]) for s_ in ds.imagesets)
    path = out_dir / "dataset.bin"
    dataset_bin.save_dataset(path, ds)
    ds = dataset_bin.load_datasets(str(path))
    require(sum(len(s_.features[0]) for s_ in ds.imagesets) == n_features,
            "dataset.bin lost features")
    times["dataset"] = time.perf_counter() - t0
    log(f"[7] dataset: {len(ds.imagesets)} imagesets of a "
        f"{ds.image_sizes[0][0]}x{ds.image_sizes[0][1]} camera, {n_features} "
        f"features, written to and read from dataset.bin "
        f"({path.stat().st_size} bytes) in {times['dataset']:.2f} s")
    return calibrate_dataset(torch, smi, ds, checks, dev, out_dir, "[7]",
                             PIPELINE_MEDIAN_PX, times)


def calibrate_dataset(torch, smi, ds, checks, dev, out_dir, tag, median_px,
                      times):
    """Dense initialization, the initial state on ``dev`` at the coarsest
    pyramid grid (float32) and ``calibrate`` of a feature dataset of a
    1920×1080 camera, as the command line runs them, then the state saved
    under ``out_dir``; the checks of :func:`calibration_pipeline`, with the
    median reprojection error held under ``median_px``.  Log lines start
    with ``tag``; host times are added to ``times``."""
    from camera_calibration_torch import native
    from camera_calibration_torch import calibrate as cal
    from camera_calibration_torch.init.dense_init import (
        DenseInitializer, DenseInitOptions,
    )
    from camera_calibration_torch.init.state_init import build_ba_state
    from camera_calibration_torch.io import state_io

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    native.reset_calls()
    t0 = time.perf_counter()
    result = DenseInitializer(ds, 0, DenseInitOptions(seed=0)).run()
    times["init"] = time.perf_counter() - t0
    require(result is not None, "dense initialization failed")
    n_loc = sum(result.image_used)
    log(f"{tag} dense initialization: {n_loc}/{len(ds.imagesets)} imagesets "
        f"localized, buffer {result.buffer_size[0]}x{result.buffer_size[1]},"
        f" {native.calls['densify_matches']} native densify calls, "
        f"{times['init']:.2f} s (host)")
    require(native.calls["densify_matches"] > 0,
            "the native densification did not run")
    require(n_loc >= 0.9 * len(ds.imagesets),
            f"only {n_loc} imagesets localized")

    full = cal.compute_grid_resolution(*ds.image_sizes[0], 25)
    coarse = cal.grid_resolution_for_level(2, *full)
    t0 = time.perf_counter()
    state, data, fid, used = build_ba_state(
        ds, [result], (max(4, coarse[1]), max(4, coarse[0])),
        dtype=torch.float32, device=dev)
    sync()
    times["state"] = time.perf_counter() - t0
    grid0 = tuple(state.intrinsics[0].grid.shape[:2])
    log(f"{tag} initial state: {grid0[0]}x{grid0[1]} grid, "
        f"{int(data[0].valid.sum())} observations of "
        f"{state.points.shape[0]} points in {sum(used)} imagesets, "
        f"{state.points.dtype} on {state.points.device}, "
        f"{times['state']:.2f} s (host: the fit on the CPU)")
    require(state.points.device.type == dev.type
            and state.points.dtype == torch.float32
            and state.intrinsics[0].grid.device.type == dev.type,
            "the initial state is not float32 on the card")

    rec = CalibrationRecord(torch, dev)
    options = cal.CalibrateOptions(polish_iterations=10)
    with rec.recording(cal):
        st_f, data_f, report = cal.calibrate(
            state, data, options, known_geometries=ds.known_geometries,
            feature_id_to_point_index=fid, image_used=used,
            log=lambda *a: log("    " + " ".join(str(x) for x in a)))
    times["calibrate"] = rec.seconds
    per_grid = rec.summarize(tag, report, times, smi)
    rec.gate(st_f, report, median_px, PIPELINE_KERNELS)

    t0 = time.perf_counter()
    state_io.save_ba_state(out_dir / "state", st_f, used, fid)
    require((out_dir / "state" / "intrinsics0.yaml").exists(),
            "state_io wrote no intrinsics")
    log(f"{tag} state saved to {out_dir / 'state'} in "
        f"{time.perf_counter() - t0:.2f} s")
    window_rows = check_pyramid_grids(torch, rec, checks, dev, tag,
                                      timed=PIPELINE_GRIDS, smi=smi)
    return {"launches": per_grid, "report": report, "times": times,
            "stages": rec.stages, "window_rows": window_rows}


def grid_name(model):
    """"gh x gw" of a grid model (its direction grid if noncentral)."""
    grid = model.grid if hasattr(model, "grid") else model.direction_grid
    return "x".join(str(v) for v in grid.shape[:2])


class CalibrationRecord:
    """What one ``calibrate`` run did, stage by stage: while
    :meth:`recording` is active, ``calibrate.run_ba`` and
    ``calibrate.delete_outlier_features`` are wrapped to record each BA
    stage's grid, device, LM iterations, host seconds, costs and kernel
    launches, and the inputs of each grid's first stage on the card.  The
    launch counts are set to 0 when the recording starts."""

    PYRAMID_NAMES = ["pyramid BA (10 it @ 1e-4)", "pyramid BA (50 it @ 1)"]
    FINAL_NAMES = ["outlier-pass BA", "final BA", "float64 polish"]

    def __init__(self, torch, dev):
        self.torch, self.dev = torch, dev
        self.stages, self.firsts, self.outlier_pass = [], {}, {}
        self.seconds = None

    def sync(self):
        if self.dev.type == "cuda":
            self.torch.cuda.synchronize()

    def _delta(self, before):
        from camera_calibration_torch import _cuda

        return {k: _cuda.launches[k] - before.get(k, 0)
                for k in _cuda.launches
                if _cuda.launches[k] != before.get(k, 0)}

    @contextmanager
    def recording(self, cal):
        from camera_calibration_torch import _cuda

        run_ba, delete_outliers = cal.run_ba, cal.delete_outlier_features

        def recorded(st, dat, max_iterations, threshold, options, **kw):
            grid = grid_name(st.intrinsics[0])
            if st.points.device.type == self.dev.type:
                self.firsts.setdefault(grid, (st, dat))
            before = dict(_cuda.launches)
            self.sync()
            t1 = time.perf_counter()
            out = run_ba(st, dat, max_iterations, threshold, options, **kw)
            self.sync()
            rep = out[1]["report"]
            self.stages.append(dict(
                grid=grid, device=str(st.points.device),
                dtype=str(st.points.dtype).replace("torch.", ""),
                max_iterations=max_iterations, threshold=threshold,
                iterations=rep.iterations, accepted=rep.accepted,
                seconds=time.perf_counter() - t1, start=t1 - t_cal,
                initial_cost=rep.initial_cost, final_cost=rep.final_cost,
                launches=self._delta(before)))
            return out

        def outliers(st, dat, factor):
            before = dict(_cuda.launches)
            self.sync()
            t1 = time.perf_counter()
            out = delete_outliers(st, dat, factor)
            self.sync()
            self.outlier_pass.update(
                grid=grid_name(st.intrinsics[0]),
                seconds=time.perf_counter() - t1, removed=out[1],
                launches=self._delta(before))
            return out

        _cuda.reset_launches()
        t_cal = time.perf_counter()
        with mock.patch.object(cal, "run_ba", recorded), \
                mock.patch.object(cal, "delete_outlier_features", outliers):
            yield self
        self.sync()
        self.seconds = time.perf_counter() - t_cal
        self.totals = dict(_cuda.launches)

    def per_grid(self):
        """Kernel launches per pyramid grid (the BA stages on the card and
        the outlier pass)."""
        per_grid = {}
        for st_ in self.stages:
            if st_["device"].startswith(self.dev.type):
                acc = per_grid.setdefault(st_["grid"], {})
                for k, v in st_["launches"].items():
                    acc[k] = acc.get(k, 0) + v
        for k, v in self.outlier_pass.get("launches", {}).items():
            acc = per_grid.setdefault(self.outlier_pass["grid"], {})
            acc[k] = acc.get(k, 0) + v
        return per_grid

    def summarize(self, tag, report, times, smi):
        """Log each stage, the pyramid levels, the outlier pass, the
        launches per grid and the report; returns the launches per grid."""
        stages = self.stages
        n_pyr = len(stages) - len(self.FINAL_NAMES)
        names = self.PYRAMID_NAMES * (n_pyr // 2) + self.FINAL_NAMES
        for i, st_ in enumerate(stages):
            label = names[i] if i < len(names) else f"stage {i}"
            log(f"{tag} {label} at {st_['grid']} ({st_['dtype']} on "
                f"{st_['device']}): {st_['iterations']} LM iterations "
                f"({st_['accepted']} accepted) in {st_['seconds']:.3f} s = "
                f"{st_['iterations'] / max(st_['seconds'], 1e-9):.2f} LM "
                f"it/s, cost {st_['initial_cost']:.6g} -> "
                f"{st_['final_cost']:.6g}; launches "
                f"{json.dumps(st_['launches'], sort_keys=True)} on {smi}")
        starts = [st_["start"] for st_ in stages] + [self.seconds]
        for i in range(0, n_pyr, 2):
            log(f"{tag} pyramid level {(n_pyr - i) // 2} "
                f"({stages[i]['grid']}): {starts[i + 2] - starts[i]:.3f} s "
                "(host, both BAs and the resample)")
        op = self.outlier_pass
        log(f"{tag} outlier pass at {op['grid']}: removed {op['removed']} "
            f"in {op['seconds']:.3f} s; launches "
            f"{json.dumps(op['launches'], sort_keys=True)}")
        per_grid = self.per_grid()
        log(f"{tag} launches per grid: {json.dumps(per_grid, sort_keys=True)}"
            f"; total {json.dumps(self.totals, sort_keys=True)}")
        shown = {k: v for k, v in report.items()
                 if k not in ("solver", "pyramid")}
        log(f"{tag} report: {json.dumps(shown, sort_keys=True)}")
        log(f"{tag} host times (s): {json.dumps(times, sort_keys=True)} on "
            f"{smi}")
        return per_grid

    def gate(self, st_f, report, median_px, kernels, scale_tol=0.05,
             grids=PIPELINE_GRIDS):
        """The quality bar: the final grid (the last of ``grids``, 45×79),
        the median reprojection error, the metric scale within
        ``scale_tol`` of 1 (unless None), a finite float64 CPU state from a
        polish that ran alone on the CPU, and every kernel of ``kernels``
        launched at each pyramid grid of ``grids``, coarse to fine."""
        torch = self.torch
        got = grid_name(st_f.intrinsics[0])
        require(got == grids[-1], f"final grid {got}")
        require(report["reprojection_error_median"] < median_px,
                "median reprojection error "
                f"{report['reprojection_error_median']}")
        require(scale_tol is None
                or abs(report["scale_factor"] - 1.0) < scale_tol,
                f"scale factor {report['scale_factor']}")
        require(st_f.points.dtype == torch.float64
                and st_f.points.device.type == "cpu"
                and bool(torch.isfinite(st_f.points).all()),
                "the polished state is not a finite float64 CPU state")
        require(len(self.stages) == 2 * len(grids) + 1
                and self.stages[-1]["device"] == "cpu"
                and self.stages[-1]["launches"] == {},
                "the polish did not run alone on the CPU")
        per_grid = self.per_grid()
        require(sorted(per_grid) == sorted(grids),
                f"pipeline grids {sorted(per_grid)}")
        for grid, counts in per_grid.items():
            for name in kernels:
                require(counts.get(name, 0) > 0,
                        f"pipeline: kernel {name} never launched at {grid}")


def check_pyramid_grids(torch, rec, checks, dev, tag, timed=(), smi=""):
    """Each kernel against its plain version at the inputs of each pyramid
    grid's first BA stage (the observed rows of the grid-layout table);
    for a CentralGeneric camera also one LM step through the kernels
    against the plain step, for a NoncentralGeneric one the K = 5 window
    kernels and the noncentral projection (4 iterations, warm-started from
    the observed pixels).  At the grids of ``timed``
    J_intr·v is also timed (:func:`time_pipeline_apply_j`) and the two
    reductions are held bit for bit across band heights and timed
    (:func:`time_pipeline_reductions`); returns their JSON rows."""
    from camera_calibration_torch import problems
    from camera_calibration_torch.ba import lm_pcg
    from camera_calibration_torch.ba import window_cuda as wc
    from camera_calibration_torch.models import central_generic_cuda as cgc

    t0 = time.perf_counter()
    bopts = lm_pcg.BAOptions(solver="schur", proj_iterations=4)
    per_grid = rec.per_grid()
    rows = []
    for grid, (st0, dat0) in rec.firsts.items():
        model = st0.intrinsics[0]
        central = hasattr(model, "grid")
        gh, gw = (model.grid if central else model.direction_grid).shape[:2]
        data_g = lm_pcg.maybe_grid_layout(dat0, st0, bopts)
        seg = data_g[0]
        blocks, _ = lm_pcg.compute_blocks(data_g, st0, (seg.pixel,), bopts)
        b = blocks[0]
        checks["window"](b.intr.j_win, b.intr.base_xy, gh, gw,
                         2 if central else 5,
                         f"pipeline {grid}, {b.intr.j_win.shape[1]} rows",
                         w=b.weight)
        if grid in timed:
            rows.append(time_pipeline_apply_j(
                torch, b.intr.j_win, b.intr.base_xy, gh, gw,
                2 if central else 5, f"{tag} {grid}", per_grid.get(grid, {}),
                smi))
            rows += time_pipeline_reductions(
                torch, b.intr.j_win, b.intr.base_xy, b.weight, gh, gw,
                2 if central else 5, f"{tag} {grid}", per_grid.get(grid, {}),
                smi)
        if not central:
            x, warm = noncentral_projection_inputs(st0, seg)
            obs = seg.valid
            check_noncentral_projection(torch, model, x[obs].contiguous(),
                                        warm[obs].contiguous(), 4,
                                        f"pipeline {grid}")
            continue
        d, g0 = problems.bench_projection_inputs(st0, seg)
        obs = seg.valid
        checks["project"](model, d[obs].contiguous(), g0[obs].contiguous(),
                          4, f"pipeline {grid}")
        checks["blocks"](model, d[obs].contiguous(), g0[obs].contiguous(),
                         4, f"pipeline {grid}")
        warm = tuple(s_.pixel for s_ in data_g)
        lam = torch.tensor(-1.0, dtype=torch.float32, device=dev)
        out_k = lm_pcg.lm_step(st0, warm, lam, data_g, bopts)
        with plain_routes(cgc, wc):
            out_p = lm_pcg.lm_step(st0, warm, lam, data_g, bopts)
        cost_k, cost_p = float(out_k[5]), float(out_p[5])
        cost_rel = abs(cost_k - cost_p) / max(abs(cost_p), 1e-30)
        pts_rel = float((out_k[0].points - out_p[0].points).abs().max()) / \
            float(out_p[0].points.abs().max())
        n_obs = int(obs.sum())
        rms_k, rms_p = ((2.0 * c / n_obs) ** 0.5 for c in (cost_k, cost_p))
        log(f"    one LM step at the pipeline's {grid} state, kernels vs "
            f"plain: new cost {cost_k:.6g} vs {cost_p:.6g} (rel "
            f"{cost_rel:.3e}; RMS residual {rms_k:.4e} vs {rms_p:.4e} px, "
            f"|Δ| {abs(rms_k - rms_p):.3e} px), "
            f"points max|Δ|/scale {pts_rel:.3e}")
        # Near convergence the residuals are ~1e-3 px, where the kernels'
        # float32 projections (held to PROJ_PX_TOL above) move the cost by
        # ~0.1% relative: the step's points are held to STEP_REL_TOL and
        # its cost as an RMS residual, to PIPELINE_STEP_RMS_PX.
        require(pts_rel <= STEP_REL_TOL
                and abs(rms_k - rms_p) <= PIPELINE_STEP_RMS_PX,
                f"pipeline {grid}: the LM step through the kernels "
                "disagrees with the plain step")
    log(f"{tag} pipeline kernel checks in {time.perf_counter() - t0:.1f} s")
    return rows


def noncentral_projection_inputs(state, table):
    """The NoncentralGeneric projection's inputs on the main path: the
    camera-frame points (N, 3) of every row of ``table`` and the warm
    starts (N, 2), the observed pixels."""
    from camera_calibration_torch.ba.state import (broadcast_rows,
                                                   transform_to_camera)

    x = broadcast_rows(state.points, table.point, table.grid_shape, 1)
    x_cam, _ = transform_to_camera(state, table.imageset, table.camera, x,
                                   grid_shape=table.grid_shape)
    return x_cam.contiguous(), table.pixel.contiguous()


def check_noncentral_projection(torch, model, points, warm, iters, label):
    """``ncg_projection_kernel`` (one launch) against the plain
    ``noncentral_generic.project_points`` on the same inputs, on the card.
    Both run the same float32 iteration and differ by rounding, so the
    pixels of the points valid in both agree within NCG_PX_TOL (the card
    tests' tolerance) but for the few where a test met its threshold
    within rounding: an accept test at a flat cost, or the cost at eps,
    takes a step in one and not in the other, and from there the point
    lies wherever that step left it, inside the validity bar.  Such points
    are held to the share the central projections allow their flips
    (PROJ_FLIP_FRACTION, at least 8), and valid-mask flips to
    NCG_FLIP_FRACTION (the card tests').  The largest gap on the points
    converged in both (final cost below eps) and on all valid in both are
    printed.  Returns (those two gaps, the flips, the points apart)."""
    from camera_calibration_torch import _cuda
    from camera_calibration_torch.models import noncentral_generic as ncg
    from camera_calibration_torch.models import noncentral_generic_cuda as ncgc

    eps = 1e-10
    n = points.shape[0]
    before = _cuda.launches["project_noncentral"]
    px_k, _, v_k, cost_k = ncgc.project_points_and_cost(model, points, warm,
                                                        iters, eps)
    px_p, g_p, v_p = ncg.project_points(model, points, init_xy=warm,
                                        max_iterations=iters, eps=eps)
    cost_p = ncg._cost_at(model, g_p, points)
    torch.cuda.synchronize()
    require(_cuda.launches["project_noncentral"] == before + 1,
            f"project_noncentral {label}: not one launch")
    both = v_k & v_p
    settled = both & (cost_k < eps) & (cost_p < eps)
    flips = int((v_k != v_p).sum())
    gap = (px_k - px_p).abs().amax(dim=1)
    apart = int((gap[both] > NCG_PX_TOL).sum())
    err = float(gap[settled].max()) if bool(settled.any()) else 0.0
    err_valid = float(gap[both].max()) if bool(both.any()) else 0.0
    log(f"    project_noncentral {label}: {n} points, {iters} iterations, "
        f"{int(both.sum())} valid in both, {flips} valid-mask flips, "
        f"{apart} more than {NCG_PX_TOL} px apart; max |Δpx| {err:.3e} on "
        f"the {int(settled.sum())} converged in both, {err_valid:.3e} on "
        f"all valid in both")
    require(flips <= NCG_FLIP_FRACTION * n,
            f"project_noncentral {label}: {flips} valid-mask flips")
    require(apart <= max(8, PROJ_FLIP_FRACTION * n),
            f"project_noncentral {label}: {apart} points more than "
            f"{NCG_PX_TOL} px apart")
    return err, err_valid, flips, apart


def noncentral_projection_row(torch, smi, launches):
    """[5]: ``ncg_projection_kernel`` at the shape of its main path: every
    slot of one start state of NCG_CELL's deployment (45×79, 1,036,200
    slots), warm-started from the observed pixels.  Held to the plain
    version at each of NCG_ITERATIONS (:func:`check_noncentral_projection`),
    then timed at the bundle adjustment's 4 iterations as [5] times the
    bench rows (events, graph replay, the plain version).  The bound: the
    window evaluations the points need (one at the start and one an
    iteration, as many iterations as the plain loop runs each point:
    ``noncentral_generic_cuda.lm_loop_plain``), their FLOP and shared-memory
    reads, and the points, warm starts, grids and outputs once through HBM.
    Returns one JSON row (``launches``: the noncentral path's count in
    [4])."""
    from calib_bench import harness
    from camera_calibration_torch.models import noncentral_generic as ncg
    from camera_calibration_torch.models import noncentral_generic_cuda as ncgc

    dev = torch.device("cuda")
    _, _, cfg, mix, units = harness.load_cell(NCG_CELL)
    job = units.setup(cfg, mix, NCG_CELL_SEED, dev)
    state = job.starts[NCG_CELL_SEED % len(job.starts)]
    model = state.intrinsics[0]
    points, warm = noncentral_projection_inputs(state, job.table)
    del job
    n, gh, gw = points.shape[0], model.grid_height, model.grid_width
    plan = ncgc.plan(gh, gw)
    log(f"[5] project_noncentral at {NCG_CELL} ({gh}x{gw}, {n} points): "
        f"{json.dumps(plan)}")
    checks = {iters: check_noncentral_projection(
        torch, model, points, warm, iters, f"{NCG_CELL}")
        for iters in NCG_ITERATIONS}
    iters = NCG_ITERATIONS[0]
    done_at = ncgc.lm_loop_plain(model, points, warm, iters)[3]
    runs = torch.where(done_at >= 0, done_at + 1, iters)
    evaluations = n + float(runs.sum())
    b_ms, b_by = bound_ms(
        n * (3 + 2) * 4 + gh * gw * 6 * 4 + n * (2 + 2 + 1) * 4 + n,
        FLOP_NCG_EVALUATION * evaluations
        + FLOP_NCG_SOLVE * float(runs.sum()),
        SMEM_BYTES_NCG_EVALUATION * evaluations)

    def fn():
        return ncgc.project_points(model, points, warm, iters)

    def plain():
        return ncg.project_points(model, points, init_xy=warm,
                                  max_iterations=iters)

    ms = time_ms(torch, fn, reps=100, warmup=5)
    graph_ms = time_ms(torch, fn, reps=100, warmup=1, graph=True)
    plain_ms = time_ms(torch, plain, reps=3, warmup=1)
    ran = {str(k): int((runs == k).sum()) for k in range(1, iters + 1)}
    log(f"[5] project_noncentral at {NCG_CELL}, {iters} iterations: "
        f"{ms:.4f} ms, graph {graph_ms:.4f} ms (plain {plain_ms:.4f} ms, "
        f"bound {b_ms:.4f} ms by {b_by}; {evaluations:.0f} window "
        f"evaluations, points by iterations run {json.dumps(ran)}; "
        f"{launches.get('project_noncentral', 0)} launches on its path) on "
        f"{smi}")
    return {
        "name": "project_noncentral", "route": "cuda",
        "source": "camera_calibration_torch/csrc/project_noncentral.cu",
        "replaces": None, "launches": launches.get("project_noncentral", 0),
        "max_abs_err": checks[iters][0], "ms": ms, "graph_ms": graph_ms,
        "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": None, "n": n, "grid": f"{gh}x{gw}",
        "iterations": iters, "plan": plan,
        "checks": {str(k): dict(zip(("max_abs_px_converged",
                                     "max_abs_px_valid", "flips",
                                     "apart"), v))
                   for k, v in checks.items()}}


def schur_legs_rows(torch, smi, launches):
    """[5]: the two passes of the Schur legs (``schur_point_leg_kernel``,
    ``schur_pose_leg_kernel``) at the shapes of their main path: the
    blocks of one start state of each of SCHUR_CELLS' deployments (every
    slot of the view × corner grid, the unobserved ~30% with weight 0), a
    seeded masked tangent, J_intr·x from the window kernel, the damped
    point inverses at λ = 1e-3; float32 and bf16 Jacobians.  Each pass is
    held to its plain version in float64 on the same values (pass B given
    the kernel's t), then timed as [5] times the other rows (events, graph
    replay), beside the plain composition it replaced (the same einsums on
    the card).  The bound: the bytes the inputs need once through HBM
    (a kept row's Jacobians, weight and s_intr; an unobserved row's weight,
    which is all the kernels read of it; pass B's ws written for every
    row; x, t, D⁻¹ once).  Returns one JSON row per pass, cell and
    Jacobian type; ``launches`` by (cell, Jacobian type) holds the counts of
    [4]'s run of that row's own path (the central or noncentral bench
    problem, float32 or bf16 CG), and the row gives its kernel's (0 where
    the path was not run)."""
    from calib_bench import harness
    from camera_calibration_torch.ba import lm_pcg
    from camera_calibration_torch.ba import residuals as res
    from camera_calibration_torch.ba import schur_cuda as sc
    from camera_calibration_torch.ba.state import fix_gauge_mask

    dev = torch.device("cuda")
    rows = []
    for cell, seed in SCHUR_CELLS:
        _, _, cfg, mix, units = harness.load_cell(cell)
        job = units.setup(cfg, mix, seed, dev)
        state = job.starts[seed % len(job.starts)]
        data = (job.table,)
        options = lm_pcg.BAOptions()
        blocks, _ = lm_pcg.compute_blocks(data, state, (job.table.pixel,),
                                          options)
        del job
        b = blocks[0]
        gs = tuple(data[0].grid_shape)
        m, p = gs
        n = m * p
        kept = int((b.weight != 0).sum())
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        mask = fix_gauge_mask(state)
        x = mask.unravel(torch.randn(mask.ravel().shape, generator=gen,
                                     device=dev) * mask.ravel())
        s_intr = res.intr_apply_j(b.intr, x.intr[0]).contiguous()
        pts_b = lm_pcg.jtwj_block_diag(data, blocks, state)[2]
        d_inv = lm_pcg._damped_inv(
            pts_b, torch.tensor(1e-3, device=dev)).contiguous()
        for jac in (torch.float32, torch.bfloat16):
            js = [j.to(jac) for j in (b.j_rig, b.j_cam, b.j_point)]
            args = js + [b.weight, s_intr, x.rig, x.cam[0]]
            args64 = [a.double() for a in args]
            t = sc.point_leg(*args, gs)
            err_a = rel_err(t.double(), sc.point_leg_plain(*args64, gs))
            rig, cam = torch.empty((m, 6), device=dev), torch.empty(6,
                                                                    device=dev)
            rig64 = torch.empty((m, 6), dtype=torch.float64, device=dev)
            cam64 = torch.empty(6, dtype=torch.float64, device=dev)
            ws = sc.pose_leg(*args, t, d_inv, gs, rig, cam)
            ws64 = sc.pose_leg_plain(*args64, t.double(), d_inv.double(), gs,
                                     rig64, cam64)
            err_b = max(rel_err(ws.double(), ws64),
                        rel_err(rig.double(), rig64),
                        rel_err(cam.double(), cam64))
            require(max(err_a, err_b) <= WINDOW_REL_TOL,
                    f"schur legs at {cell}, {jac}: {err_a}, {err_b}")
            plan = sc.point_leg_plan(m, p, js[0].element_size(), dev.index)
            jac_b = 30 * js[0].element_size()
            need = kept * (jac_b + 4 + 8) + (n - kept) * 4 + m * 24 + 24
            cases = (
                ("schur_point_leg", need + p * 12, kept * 62,
                 lambda: sc.point_leg(*args, gs),
                 lambda: sc.point_leg_plain(*args, gs), err_a),
                ("schur_pose_leg", need + n * 8 + p * 48 + m * 24,
                 kept * 130,
                 lambda: sc.pose_leg(*args, t, d_inv, gs, rig, cam),
                 lambda: sc.pose_leg_plain(*args, t, d_inv, gs, rig, cam),
                 err_b))
            for name, nbytes, flop, fn, plain, err in cases:
                ms = time_ms(torch, fn, reps=50, warmup=3)
                graph_ms = time_ms(torch, fn, reps=50, warmup=1, graph=True)
                plain_ms = time_ms(torch, plain, reps=5, warmup=1)
                b_ms, b_by = bound_ms(nbytes, flop)
                tag = name + ("_bf16" if jac == torch.bfloat16 else "")
                log(f"[5] {tag} at {cell} ({m}x{p}, {kept} of {n} rows "
                    f"kept): {ms:.4f} ms, graph {graph_ms:.4f} ms (plain "
                    f"{plain_ms:.4f} ms, bound {b_ms:.4f} ms by {b_by}, "
                    f"{nbytes} B; rel err {err:.2e}; pass A plan "
                    f"{json.dumps(plan)}) on {smi}")
                rows.append({
                    "name": f"{tag}_{cell}", "route": "cuda",
                    "source": "camera_calibration_torch/csrc/schur_legs.cu",
                    "replaces": None,
                    "launches": launches.get((cell, jac), {}).get(tag, 0),
                    "max_abs_err": err, "ms": ms, "graph_ms": graph_ms,
                    "plain_ms": plain_ms, "bound_ms": b_ms,
                    "bound_by": b_by, "library_ms": None, "n": n,
                    "kept": kept, "grid": f"{m}x{p}"})
    return rows


def time_pipeline_apply_j(torch, jw, base, gh, gw, k, label, launches, smi):
    """J_intr·v on a pipeline grid's own ``j_win`` and window bases, with a
    tangent made from a seed: held against its float64 plain version and
    bit for bit across two calls, then timed as [5] times the bench rows
    (events, graph replay, graph replay with L2 flushed), with torch.sparse
    CSR's J_intr·v beside it (events and graph).  The bound: j_win, the
    bases and the output once, the tangent once.  Returns one JSON row
    (``launches``: that grid's count in the pipeline)."""
    from camera_calibration_torch.ba import window_cuda as wc

    name = "window_apply_j"
    n = jw.shape[1]
    rng = np.random.default_rng(gh * 1000 + gw + k)
    tangent = torch.as_tensor(rng.normal(0, 1, (gh, gw, k)),
                              dtype=torch.float32, device=jw.device)
    fn = lambda: wc.window_apply_j(jw, base, tangent)  # noqa: E731
    got, again = fn(), fn()
    reference = wc.window_apply_j_plain(jw.double(), base, tangent.double())
    err = float((got.double() - reference).abs().max())
    e = err / float(reference.abs().max())
    require(e <= WINDOW_REL_TOL, f"{name} {label}: rel err {e}")
    require(bool(torch.equal(got, again)),
            f"{name} {label}: not bit-identical across runs")
    j_csr, _ = sparse_intrinsics_jacobian(torch, jw, base, gh, gw, k)
    lib = lambda: (j_csr @ tangent.reshape(-1, 1)).reshape(n, 2)  # noqa: E731
    e_lib = rel_err(lib().double(), reference)
    require(e_lib <= WINDOW_REL_TOL, f"sparse J.v {label}: rel err {e_lib}")
    plan = wc.apply_j_plan_on_card(n, k)
    ms = time_ms(torch, fn, reps=100, warmup=5)
    graph_ms = time_ms(torch, fn, reps=100, warmup=1, graph=True)
    cold_ms = cold_graph_ms(torch, fn)
    plain_ms = time_ms(torch, lambda: wc.window_apply_j_plain(
        jw, base, tangent), reps=3, warmup=1)
    library_ms = time_ms(torch, lib, reps=100, warmup=5)
    library_graph_ms = time_ms(torch, lib, reps=100, warmup=1, graph=True)
    inside = float(wc._window_index(base, gh, gw)[1].sum())
    b_ms, b_by = bound_ms(jw.numel() * jw.element_size() + n * 2 * 4
                          + gh * gw * k * 4 + n * 2 * 4, 4 * k * inside)
    log(f"    {name} {label} K={k}: {n} rows, rel err {e:.3e}, repeatable; "
        f"{plan['blocks']} blocks of {plan['threads']} threads; {ms:.4f} ms, "
        f"graph "
        f"{graph_ms:.4f} ms, L2-cold graph {cold_ms:.4f} ms (plain "
        f"{plain_ms:.4f} ms, torch.sparse {library_ms:.4f} ms (graph "
        f"{library_graph_ms:.4f}), bound {b_ms:.4f} ms by {b_by}; "
        f"{launches.get(name, 0)} launches there) on {smi}")
    return {
        "name": f"{name}{'_k5' if k == 5 else ''}_pipeline_{gh}x{gw}",
        "route": "cuda", "source": APPLY_J_SOURCE[0],
        "replaces": APPLY_J_SOURCE[1], "launches": launches.get(name, 0),
        "max_abs_err": err, "ms": ms, "graph_ms": graph_ms,
        "cold_graph_ms": cold_ms, "plain_ms": plain_ms, "bound_ms": b_ms,
        "bound_by": b_by, "library_ms": library_ms,
        "library_graph_ms": library_graph_ms, "n": n, "pipeline": label,
        "blocks": plan["blocks"]}


def time_pipeline_reductions(torch, jw, base, wt, gh, gw, k, label, launches,
                             smi):
    """The two reductions on a pipeline grid's own window inputs: each
    held bit for bit across band heights (1, half the plan's, the plan's)
    and against its float64 plain version, then timed as [5] times the
    bench rows, with torch.sparse CSR's JᵀW·s beside JᵀW·s.  Returns one
    JSON row each (``launches``: that grid's count in the pipeline)."""
    from camera_calibration_torch.ba import window_cuda as wc

    n = jw.shape[1]
    rng = np.random.default_rng(gh * 1000 + gw)
    ws = torch.as_tensor(rng.normal(0, 1, (n, 2)), dtype=torch.float32,
                         device=jw.device)
    inside = float(wc._window_index(base, gh, gw)[1].sum())
    _, jt = sparse_intrinsics_jacobian(torch, jw, base, gh, gw, k)
    lib = lambda: (jt @ ws.reshape(-1, 1)).reshape(gh, gw, k)  # noqa: E731
    common = jw.numel() * 4 + n * 2 * 4
    out = []
    for name, fn, ref, library, nbytes, flops in (
            ("window_apply_jtw",
             lambda **kw: wc.window_apply_jtw(jw, base, ws, gh, gw, k, **kw),
             lambda: wc.window_apply_jtw_plain(jw.double(), base, ws.double(),
                                               gh, gw, k),
             lib, common + n * 2 * 4 + gh * gw * k * 4, 4 * k * inside),
            ("window_block_diag",
             lambda **kw: wc.window_block_diag(jw, base, wt, gh, gw, k, **kw),
             lambda: wc.window_block_diag_plain(jw.double(), base,
                                                wt.double(), gh, gw, k),
             None, common + n * 4 + gh * gw * k * k * 4,
             6 * (k * (k + 1) // 2) * inside)):
        rows_p, bands = wc.reduction_bands(name, gh, gw, k)
        got = fn()
        reference = ref()
        err = float((got.double() - reference).abs().max())
        e = err / float(reference.abs().max())
        heights = sorted({1, max(1, rows_p // 2), rows_p})
        same = all(bool(torch.equal(got, fn(band_rows=r))) for r in heights)
        require(e <= WINDOW_REL_TOL, f"{name} {label}: rel err {e}")
        require(same, f"{name} {label}: band heights {heights} differ")
        if library is not None:
            e_lib = rel_err(library().double(), reference)
            require(e_lib <= WINDOW_REL_TOL,
                    f"sparse JtW {label}: rel err {e_lib}")
        ms = time_ms(torch, fn, reps=100, warmup=5)
        graph_ms = time_ms(torch, fn, reps=100, warmup=1, graph=True)
        plain_ms = time_ms(torch, lambda: getattr(wc, name + "_plain")(
            jw, base, ws if name == "window_apply_jtw" else wt, gh, gw, k),
            reps=3, warmup=1)
        library_ms = (None if library is None
                      else time_ms(torch, library, reps=100, warmup=5))
        library_graph_ms = (None if library is None
                            else time_ms(torch, library, reps=100, warmup=1,
                                         graph=True))
        b_ms, b_by = bound_ms(nbytes, flops)
        lib_txt = ("" if library_ms is None else
                   f", torch.sparse {library_ms:.4f} ms (graph "
                   f"{library_graph_ms:.4f})")
        log(f"    {name} {label} K={k}: {n} rows, rel err {e:.3e}, band "
            f"heights {heights} bit-identical; {ms:.4f} ms, graph "
            f"{graph_ms:.4f} ms (plain {plain_ms:.4f} ms{lib_txt}, bound "
            f"{b_ms:.4f} ms by {b_by}; {launches.get(name, 0)} launches "
            f"there, {bands} band(s)) on {smi}")
        out.append({
            "name": f"{name}{'_k5' if k == 5 else ''}_pipeline_"
                    f"{gh}x{gw}",
            "route": "cuda", "source": REDUCTION_SOURCES[name][0],
            "replaces": REDUCTION_SOURCES[name][1],
            "launches": launches.get(name, 0), "max_abs_err": err,
            "ms": ms, "graph_ms": graph_ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": library_ms,
            "n": n, "pipeline": label})
    return out


def image_pipeline(torch, smi, n_views, device=None):
    """Feature detection in camera images through the port's own entry
    points: ``cli.main`` create-pattern (a 24×24 board of 2 cm squares with
    its central tag), render-synthetic (``n_views`` seeded views by a
    1920×1080 pinhole camera with fx = 0.85·1920) and extract-features
    (detection on ``device``, the card by default).  Gates: every view
    detects at least IMAGE_MIN_DETECTED of the board corners its true pose
    puts inside the image (2·window_half_size from the border); the median
    distance of detected corners to the rendered truth is under
    IMAGE_MEDIAN_TRUTH_PX; the first refinement batch of the detection,
    refined again on the CPU in float64, converges to within IMAGE_RING_PX
    of the card's float32 result on 95% of its features
    (IMAGE_RING_MEDIAN_PX on the median, IMAGE_RING_MAX_PX on all).  Also
    prints the refinement throughput at the reference benchmark's shape.
    The calibration of the dataset it writes is [9a]'s
    (:func:`cli_pipeline`), through the command line.  Returns the
    dataset's path, the output directory and the host times."""
    import shutil

    from camera_calibration_torch import _cuda, cli
    from camera_calibration_torch.features import detector as fdet
    from camera_calibration_torch.features import patch_refinement as pref
    from camera_calibration_torch.features.degrade import degrade
    from camera_calibration_torch.features import pattern as pat
    from camera_calibration_torch.io import dataset_bin

    dev = torch.device("cuda") if device is None else torch.device(device)
    out_dir = _cuda.BUILD_ROOT / "images"
    shutil.rmtree(out_dir, ignore_errors=True)
    times = {}
    w, h = 1920, 1080
    t0 = time.perf_counter()
    cli.main(["create-pattern", "--output_directory", str(out_dir / "pattern"),
              "--squares_x", "24", "--squares_y", "24",
              "--square_length_in_meters", "0.02"])
    base = out_dir / "pattern" / "pattern_resolution_24x24_segments_16"
    times["pattern"] = time.perf_counter() - t0
    render = ["--width", str(w), "--height", str(h), "--min_z",
              str(IMAGE_MIN_Z), "--max_z", str(IMAGE_MAX_Z)]
    t0 = time.perf_counter()
    cli.main(["render-synthetic", "--pattern_file", f"{base}.yaml",
              "--output_directory", str(out_dir / "views"), "--num_images",
              str(n_views), *render, "--noise", str(IMAGE_NOISE),
              "--defocus_sigma", str(IMAGE_DEFOCUS), "--seed",
              str(IMAGE_SEED)])
    times["render"] = time.perf_counter() - t0

    # detection on the card, keeping the inputs and result of the first
    # refinement batch (the rings next to every view's tag)
    first = {}
    two_stage = pref.refine_two_stage_patches

    def keep_first(*args, **kw):
        out = two_stage(*args, **kw)
        if not first:
            first.update(args=args, out=out)
        return out

    path = out_dir / "dataset.bin"
    t0 = time.perf_counter()
    with mock.patch.object(pref, "refine_two_stage_patches", keep_first):
        cli.main(["extract-features", "--image_directories",
                  str(out_dir / "views"), "--pattern_files", f"{base}.yaml",
                  "--output", str(path),
                  *([] if device is None else ["--device", str(dev)])])
    if dev.type == "cuda":
        torch.cuda.synchronize()
    times["detect"] = time.perf_counter() - t0
    ds = dataset_bin.load_datasets(str(path))
    require(len(ds.imagesets) == n_views and ds.image_sizes == [(w, h)],
            "extract-features did not write every view")

    # every view against the rendered truth
    spec = pat.load_pattern_yaml(f"{base}.yaml")
    corner_map = pat.corners_for_patterns([spec])[0]
    margin = 2 * fdet.DetectorOptions().window_half_size
    per_view, errs = [], []
    for (i, h_pp, view_rng), imageset in zip(
            cli.render_views(spec, n_views, w, h, IMAGE_MIN_Z, IMAGE_MAX_Z,
                             IMAGE_SEED), ds.imagesets):
        # the render drew the view's noise from the same generator
        degrade(np.zeros((h, w)), view_rng, defocus_sigma=IMAGE_DEFOCUS,
                noise=IMAGE_NOISE)
        truth, inside_margin = {}, set()
        for fid, (cx, cy) in corner_map.items():
            q = h_pp @ np.array([cx, cy, 1.0])
            truth[fid] = q[:2] / q[2]  # pixel-corner convention
            c = truth[fid] - 0.5
            if (margin <= c[0] <= w - 1 - margin
                    and margin <= c[1] <= h - 1 - margin):
                inside_margin.add(fid)
        found = {f.feature_id: f.xy for f in imageset.features[0]}
        inside = [fid for fid in found if fid in inside_margin]
        errs += [float(np.linalg.norm(xy - truth[fid]))
                 for fid, xy in found.items()]
        n_truth = len(inside_margin)
        per_view.append((len(found), len(inside), n_truth))
        require(len(inside) >= IMAGE_MIN_DETECTED * n_truth,
                f"view {i}: {len(inside)} of the {n_truth} corners inside the "
                "image detected")
    med = float(np.median(errs))
    log(f"{IMAGE_TAG} features per view (detected, of them inside the "
        f"margin, corners inside the margin): {per_view}")
    log(f"{IMAGE_TAG} {len(errs)} features in {n_views} views, median "
        f"distance to the rendered truth {med:.4f} px (90th percentile "
        f"{float(np.percentile(errs, 90)):.4f}, max {max(errs):.4f})")
    require(med < IMAGE_MEDIAN_TRUTH_PX,
            f"median distance to the truth {med} px")

    # the first refinement batch again on the CPU in float64
    args = first["args"]
    image, idx = args[0], args[-1]
    used = torch.unique(idx)
    remap = torch.full((image.shape[0],), -1, dtype=torch.long,
                       device=idx.device)
    remap[used] = torch.arange(used.numel(), device=idx.device)
    cpu_args = [a.detach().cpu().double() if a.is_floating_point()
                else a.detach().cpu() for a in args[1:-1] if torch.is_tensor(a)]
    t0 = time.perf_counter()
    on_cpu = two_stage(image[used].cpu().double(), *cpu_args[:7],
                       args[8], args[9], remap[idx.long()].cpu())
    cpu_s = time.perf_counter() - t0
    on_card = first["out"].double().cpu()
    ok_card, ok_cpu = on_card[:, 3] > 0.5, on_cpu[:, 3] > 0.5
    both = ok_card & ok_cpu
    gaps = (on_card[both, :2] - on_cpu[both, :2]).abs().amax(dim=1).numpy()
    flips = int((ok_card != ok_cpu).sum())
    q50, q95 = (float(np.percentile(gaps, q)) for q in (50, 95))
    log(f"{IMAGE_TAG} first refinement batch: {on_card.shape[0]} features "
        f"of {used.numel()} views, {int(both.sum())} converged on both, "
        f"{flips} converged on one only; card float32 vs CPU float64 |Δ| "
        f"median {q50:.3e}, 95th percentile {q95:.3e}, max "
        f"{float(gaps.max()):.3e} px, {int((gaps > IMAGE_RING_PX).sum())} "
        f"over {IMAGE_RING_PX} px (CPU float64 {cpu_s:.2f} s)")
    require(int(both.sum()) > 0.5 * on_card.shape[0]
            and flips <= max(2, 0.01 * on_card.shape[0])
            and q50 <= IMAGE_RING_MEDIAN_PX and q95 <= IMAGE_RING_PX
            and float(gaps.max()) <= IMAGE_RING_MAX_PX,
            "the first refinement batch on the card disagrees with float64 "
            "on the CPU")

    # refinement throughput at the reference benchmark's shape: 2048
    # features, 512 symmetry + 64 matching samples, a 1280x1024 image
    rng = np.random.default_rng(0)
    bh, bw = 1024, 1280
    img = rng.uniform(0, 1, (bh, bw)).astype(np.float32)
    n_f, n_s, whs = 2048, 512, 10
    n_match = n_s // 8
    positions = rng.uniform(60, [bw - 60, bh - 60], (n_f, 2))
    h0 = np.tile(np.eye(3, dtype=np.float32), (n_f, 1, 1))
    h0[:, 0, 0] += rng.uniform(-0.05, 0.05, n_f)
    h0[:, 1, 1] += rng.uniform(-0.05, 0.05, n_f)
    from camera_calibration_torch.features import refinement as fref
    offs = fref.make_sample_offsets(rng, whs, n_s) * whs
    samples = np.tile(offs[None], (n_f, 1, 1)).astype(np.float32)
    rendered = rng.uniform(0, 1, (n_f, n_match)).astype(np.float32)

    def on(a, dtype=torch.float32):
        return torch.as_tensor(a, dtype=dtype, device=dev)

    bench = (on(img)[None], on(positions), on(h0), on(samples[:, :n_match]),
             on(rendered), on(np.ones((n_f, n_match)), torch.bool),
             on(samples), on(np.ones((n_f, n_s)), torch.bool), whs,
             pref.patch_size_for_window(whs),
             on(np.zeros(n_f), torch.int32))
    best = None
    for _ in range(4):  # the first is a warm-up
        t0 = time.perf_counter()
        float(pref.refine_two_stage_patches(*bench).sum())
        dt = time.perf_counter() - t0
        best = dt if best is None else min(best, dt)
    log(f"{IMAGE_TAG} corner refinement: {n_f / best:.1f} features/s "
        f"({n_f} features, {n_s} + {n_match} samples, {bw}x{bh} image, "
        f"best of 3: {best * 1e3:.1f} ms) on {smi}")
    if dev.type == "cuda":
        _, *prof = device_profile(
            torch, lambda: pref.refine_two_stage_patches(*bench),
            "refinement_trace.json")
        log_profile(IMAGE_TAG, "one refinement call at that shape", *prof,
                    smi)

    log(f"{IMAGE_TAG} host seconds per stage: pattern "
        f"{times['pattern']:.2f}, render {times['render']:.2f}, detect "
        f"{times['detect']:.2f} on {smi}; the calibration of this dataset "
        "is [9a]'s")
    return {"dataset": path, "out_dir": out_dir, "times": times,
            "refinements_per_s": n_f / best, "views": out_dir / "views",
            "pattern": f"{base}.yaml"}


@contextmanager
def timed_cli_stages(times, captured):
    """Time the command line's stages into ``times`` (host seconds of the
    initialization, the initial state, ``calibrate`` and the report) and
    keep ``calibrate``'s result and the report's metrics in
    ``captured``."""
    from camera_calibration_torch import calibrate as cal
    from camera_calibration_torch import cli
    from camera_calibration_torch.init import state_init
    from camera_calibration_torch.report import calibration_report as crep

    def timed(key, fn, keep=None):
        def run(*args, **kw):
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            times[key] = times.get(key, 0.0) + time.perf_counter() - t0
            if keep is not None:
                captured[keep] = out
            return out
        return run

    with mock.patch.object(cli, "_dense_initialization",
                           timed("init", cli._dense_initialization)), \
            mock.patch.object(state_init, "build_ba_state",
                              timed("state", state_init.build_ba_state,
                                    "initial")), \
            mock.patch.object(cal, "calibrate",
                              timed("calibrate", cal.calibrate, "result")), \
            mock.patch.object(crep, "create_calibration_report",
                              timed("report", crep.create_calibration_report,
                                    "metrics")):
        yield


REPORT_FILES = ("_info.txt", "_errors_histogram.png", "_error_magnitudes.png",
                "_error_directions.png", "_grid_point_locations.png",
                "_observation_directions.png")


def report_numbers(path):
    """The numbers of a report's ``_info.txt``, in order."""
    import re

    return [float(v) for v in re.findall(
        r"-?\d+\.?\d*(?:[eE][-+]?\d+)?", path.read_text())]


def cli_pipeline(torch, smi, images, checks, device=None):
    """[9a]: the command line's calibration of [8]'s dataset.bin on the
    card with its defaults (three levels at 25 px a cell to 45×79,
    ``auto``, float32 on the card and a float64 polish on the CPU) and
    ``--report``; then ``report`` of the saved state (float64 on the CPU,
    and float32 on the card through the projection kernel), ``compare`` of
    the state with the rendering camera's own model, ``fit-parametric``
    of the three parametric models and ``create-legends``.  Gates: [8]'s
    calibration bar (median < IMAGE_MEDIAN_PX, scale within 0.05, final
    grid 45×79, the five kernels at each pyramid grid, each kernel and one
    LM step against the plain versions at each grid); the report's median
    equal to ``calibrate``'s within 1%; every report file written; the
    ``report`` command's numbers within 1e-6 relative of the report of the
    polished state in memory over the same observations (the command
    rebuilds its tables from dataset.bin, so it counts the outliers that
    ``calibrate`` removed, as the reference's command does); the card
    report launching ``project``, its median within CARD_REPORT_PX of
    that one.
    ``device``: the card by default."""
    from camera_calibration_torch import _cuda, cli, problems
    from camera_calibration_torch import calibrate as cal
    from camera_calibration_torch.ba.state import BAState
    from camera_calibration_torch.io import state_io

    dev = torch.device("cuda") if device is None else torch.device(device)
    on = [] if device is None else ["--device", str(dev)]
    out = images["out_dir"] / "cli"
    path = images["dataset"]
    times, captured = dict(images["times"]), {}
    rec = CalibrationRecord(torch, dev)
    with timed_cli_stages(times, captured), rec.recording(cal):
        rc = cli.main(["calibrate", "--dataset_files", str(path),
                       "--output_directory", str(out), "--report", *on])
    require(rc == 0, f"calibrate exited with {rc}")
    st_f, _, report = captured["result"]
    per_grid = rec.summarize("[9a]", report, times, smi)
    rec.gate(st_f, report, IMAGE_MEDIAN_PX, PIPELINE_KERNELS)
    metrics = captured["metrics"][0]
    rel = (abs(metrics["reprojection_error_median"]
               - report["reprojection_error_median"])
           / report["reprojection_error_median"])
    log(f"[9a] report: median {metrics['reprojection_error_median']:.6g} px "
        f"(calibrate's {report['reprojection_error_median']:.6g}, rel "
        f"{rel:.3e}), {metrics['reprojection_error_count']} errors, "
        f"{times['report']:.2f} s")
    require(rel <= 0.01, "the report's median differs from calibrate's")
    for suffix in REPORT_FILES:
        require((out / "report" / f"report_camera0{suffix}").exists(),
                f"calibrate --report wrote no {suffix}")
    check_pyramid_grids(torch, rec, checks, dev, "[9a]")

    # the report command on the saved state: float64 on the CPU gives the
    # numbers of the polished state in memory over every observation of
    # dataset.bin (outliers included, as the command rebuilds its tables);
    # float32 on the card goes through the projection kernel
    from camera_calibration_torch.ba.dataset import build_per_camera_tables
    from camera_calibration_torch.io import dataset_bin
    from camera_calibration_torch.report.calibration_report import (
        create_calibration_report)

    _, _, fid, used = captured["initial"]
    ds = dataset_bin.load_datasets(str(path))
    create_calibration_report(
        out / "report_all", st_f, build_per_camera_tables(
            ds, fid, image_used=used, dtype=torch.float64, device="cpu"),
        num_total_imagesets=len(ds.imagesets))
    mine = report_numbers(out / "report_all" / "report_camera0_info.txt")
    t0 = time.perf_counter()
    args = ["report", "--state_directory", str(out / "state"),
            "--dataset_files", str(path)]
    require(cli.main(args + ["--output_directory", str(out / "report_cpu"),
                             "--device", "cpu"]) == 0,
            "report (CPU) failed")
    t_cpu = time.perf_counter() - t0
    again = report_numbers(out / "report_cpu" / "report_camera0_info.txt")
    worst = max(abs(a - b) / max(abs(a), 1e-12) for a, b in zip(mine, again))
    log(f"[9a] report command, float64 on the CPU: {len(again)} numbers, "
        f"median {again[5]:.6g} px over {int(again[4])} observations "
        f"(calibrate --report: {metrics['reprojection_error_median']:.6g} "
        f"px over the {metrics['reprojection_error_count']} left after the "
        f"outlier pass); largest relative difference from the in-memory "
        f"state's report over the same observations {worst:.3e} "
        f"({t_cpu:.2f} s)")
    require(len(mine) == len(again) and worst <= 1e-6,
            "the report command's numbers differ from the saved state's")
    before = dict(_cuda.launches)
    t0 = time.perf_counter()
    require(cli.main(args + ["--output_directory", str(out / "report_card"),
                             *on]) == 0, "report (card) failed")
    rec.sync()
    t_card = time.perf_counter() - t0
    n_project = _cuda.launches["project"] - before.get("project", 0)
    card = report_numbers(out / "report_card" / "report_camera0_info.txt")
    card_gap = abs(card[5] - again[5])
    log(f"[9a] report command, float32 on the card: median {card[5]:.6g} px "
        f"(float64: {again[5]:.6g}, |Δ| {card_gap:.3e} px), {n_project} "
        f"project launches ({t_card:.2f} s) on {smi}")
    require(n_project > 0, "the card report launched no projection kernel")
    require(card_gap <= CARD_REPORT_PX,
            f"the card report's median is {card_gap} px from float64's")

    # compare with the rendering camera (fx = 0.85·1920, centred)
    truth = problems.pinhole_model(1920, 1080, 79, 45, device="cpu",
                                   dtype=torch.float64)
    one = torch.tensor([[1.0, 0, 0, 0]], dtype=torch.float64)
    zero = torch.zeros((1, 3), dtype=torch.float64)
    state_io.save_ba_state(out / "truth", BAState(
        rig_q_global=one, rig_t_global=zero, cam_q_rig=one, cam_t_rig=zero,
        points=zero, intrinsics=(truth,)), [True], {0: 0})
    require(cli.main(["compare", str(out / "state"), str(out / "truth"),
                      *on]) == 0, "compare failed")

    t0 = time.perf_counter()
    # without --co_estimate_rotation (the rotation co-estimate takes the
    # port's eager jvp fits ~9x longer): the calibration's frame is rotated
    # against the rendering camera's (``compare`` above reads it), so the
    # residual fields show the rotation too
    from camera_calibration_torch.models import parametric as pm

    fits = {}
    fit = pm.fit_parametric_to_dense
    with mock.patch.object(pm, "fit_parametric_to_dense", lambda *a, **k: (
            fits.setdefault(type(a[0]).__name__, fit(*a, **k)))):
        require(cli.main(["fit-parametric", "--state_directory",
                          str(out / "state"), "--output_directory",
                          str(out / "fit"), *on]) == 0,
                "fit-parametric failed")
    rec.sync()
    times["fit_parametric"] = time.perf_counter() - t0
    for name in ("central_thin_prism_fisheye", "central_opencv",
                 "central_radial"):
        require((out / "fit" / f"fitting_{name}_residual_field.png").exists(),
                f"fit-parametric wrote no {name} residual field")
    require(cli.main(["create-legends", "--output_directory",
                      str(out / "legends")]) == 0, "create-legends failed")
    require(len(list((out / "legends").glob("legend_*.png"))) == 3,
            "create-legends wrote no three legends")
    log(f"[9a] host seconds per stage: {json.dumps(times, sort_keys=True)} "
        f"on {smi}")
    return {"launches": per_grid, "report": report, "times": times,
            "out_dir": out, "fits": fits}


def noncentral_pipeline(torch, smi, checks, device=None):
    """[9b]: a NoncentralGeneric camera calibrated from scratch at
    1920×1080 through the command line: ``problems.
    make_noncentral_calibration_dataset`` (the cross-slit camera of the
    reference package's noncentral tests; NONCENTRAL_VIEWS views of a
    NONCENTRAL_BOARD board) written to dataset.bin, then ``calibrate
    --model noncentral_generic --report --num_pyramid_levels
    NONCENTRAL_LEVELS --polish_iterations NONCENTRAL_POLISH``: the
    noncentral initialization on the host, the
    initial state and the pyramid BA on the card (the noncentral
    projection kernel and the three K = 5 window kernels), the float64
    polish on the CPU.  Gates: median < NONCENTRAL_MEDIAN_PX, the final
    grid 45×79, the noncentral projection kernel and the three window
    kernels at each pyramid grid (and each against its plain version
    there), no central projection kernel, the line offsets image and the
    lines .obj written; the metric scale is printed.  ``device``: the card
    by default."""
    from camera_calibration_torch import _cuda, cli, problems
    from camera_calibration_torch import calibrate as cal
    from camera_calibration_torch.io import dataset_bin

    dev = torch.device("cuda") if device is None else torch.device(device)
    on = [] if device is None else ["--device", str(dev)]
    out = _cuda.BUILD_ROOT / "noncentral"
    out.mkdir(parents=True, exist_ok=True)
    times, captured = {}, {}
    t0 = time.perf_counter()
    nx, ny, cell = NONCENTRAL_BOARD
    ds, _, _ = problems.make_noncentral_calibration_dataset(
        seed=NONCENTRAL_SEED, n_imagesets=NONCENTRAL_VIEWS, w=1920, h=1080,
        nx=nx, ny=ny, cell=cell)
    path = out / "dataset.bin"
    dataset_bin.save_dataset(path, ds)
    times["dataset"] = time.perf_counter() - t0
    n_features = sum(len(s_.features[0]) for s_ in ds.imagesets)
    log(f"[9b] dataset: {len(ds.imagesets)} views of a {nx}x{ny} board "
        f"({cell} m) by the 1920x1080 noncentral camera, {n_features} "
        f"features, {times['dataset']:.2f} s")
    rec = CalibrationRecord(torch, dev)
    with timed_cli_stages(times, captured), rec.recording(cal):
        rc = cli.main(["calibrate", "--dataset_files", str(path),
                       "--output_directory", str(out / "out"), "--model",
                       "noncentral_generic", "--report", "--seed",
                       str(NONCENTRAL_INIT_SEED), "--num_pyramid_levels",
                       str(NONCENTRAL_LEVELS), "--polish_iterations",
                       str(NONCENTRAL_POLISH), *on])
    require(rc == 0, f"calibrate exited with {rc}")
    st_f, _, report = captured["result"]
    per_grid = rec.summarize("[9b]", report, times, smi)
    require(type(st_f.intrinsics[0]).__name__ == "NoncentralGenericModel",
            "the calibrated model is not NoncentralGeneric")
    # the metric scale is printed, not gated: a noncentral model's scale
    # is weakly observed, and the reference's noncentral tests bar none
    full = cal.compute_grid_resolution(1920, 1080, 25)
    grids = tuple("{1}x{0}".format(*cal.grid_resolution_for_level(lv, *full))
                  for lv in range(NONCENTRAL_LEVELS - 1, -1, -1))
    rec.gate(st_f, report, NONCENTRAL_MEDIAN_PX,
             NONCENTRAL_KERNELS + (NCG_PROJECTION,), scale_tol=None,
             grids=grids)
    for grid, counts in per_grid.items():
        require(not counts.get("project") and not counts.get("project_blocks"),
                f"a central projection kernel launched on the noncentral "
                f"path at {grid}")
    for suffix in ("_line_offsets.png", "_lines.obj", "_info.txt"):
        require((out / "out" / "report" / f"report_camera0{suffix}").exists(),
                f"calibrate --report wrote no {suffix}")
    window_rows = check_pyramid_grids(torch, rec, checks, dev, "[9b]",
                                      timed=("45x79",), smi=smi)
    lm = {f"{st_['grid']} {i}": round(st_["iterations"]
                                      / max(st_["seconds"], 1e-9), 3)
          for i, st_ in enumerate(rec.stages)}
    log(f"[9b] host seconds: init {times['init']:.2f}, state "
        f"{times['state']:.2f}, calibrate {times['calibrate']:.2f} (of it "
        f"the float64 polish {rec.stages[-1]['seconds']:.2f}), report "
        f"{times['report']:.2f}; LM it/s per BA stage {json.dumps(lm)} on "
        f"{smi}")
    return {"launches": per_grid, "report": report, "times": times,
            "window_rows": window_rows}


def stereo_texture(u, v):
    """The reference's stereo tests' texture (tests/test_stereo.py)."""
    return (0.5 + 0.2 * np.sin(37.0 * u) * np.cos(29.0 * v)
            + 0.15 * np.sin(11.0 * u + 23.0 * v)
            + 0.15 * np.cos(53.0 * u - 17.0 * v))


def render_plane(torch, model64, center, slope, scale):
    """(image, ray depth) of the textured plane z = 2 + slope·x seen by a
    camera at ``center`` (world = the left camera's frame), as the
    reference's stereo tests render it, with the texture coordinates
    scaled by ``scale``; rays from ``model64`` (float64)."""
    from camera_calibration_torch.stereo import patch_match as pms

    g = model64.grid
    d = pms.pixel_directions(model64, model64.height, model64.width,
                             g.dtype, g.device).cpu().numpy()
    c = np.asarray(center, float)
    s = (2.0 - (c[2] - slope * c[0])) / (d[..., 2] - slope * d[..., 0])
    pts = c + s[..., None] * d
    return (np.clip(stereo_texture(pts[..., 0] * scale, pts[..., 1] * scale),
                    0, 1), s)


@contextmanager
def stereo_stages(torch, dev, times, captured):
    """Time ``stereo-depth``'s stages into ``times`` (host seconds, the
    card synchronised around each) and keep the left pass's results and
    its PatchMatch inputs in ``captured``."""
    from camera_calibration_torch.stereo import patch_match as pms

    calls = {"depth_maps": 0}

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    def timed(key, fn, keep=None):
        def run(*args, **kw):
            side = "left" if calls["depth_maps"] <= 1 else "right"
            name = key.format(side=side)
            sync()
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            sync()
            times[name] = times.get(name, 0.0) + time.perf_counter() - t0
            if keep is not None and side == "left":
                captured[keep] = (args, out)
            return out
        return run

    def depth_map(*args, **kw):
        calls["depth_maps"] += 1
        return compute(*args, **kw)

    compute = timed("{side}_pass", pms.compute_depth_map, "left")
    with mock.patch.object(pms, "compute_depth_map", depth_map), \
            mock.patch.object(pms, "_plane_sweep_jit",
                              timed("{side}_sweep", pms._plane_sweep_jit)), \
            mock.patch.object(pms, "_patch_match_jit",
                              timed("{side}_patch_match", pms._patch_match_jit,
                                    "patch_match")), \
            mock.patch.object(pms, "lr_consistency_mask",
                              timed("lr_mask", pms.lr_consistency_mask)), \
            mock.patch.object(pms, "bilateral_filter",
                              timed("bilateral", pms.bilateral_filter)), \
            mock.patch.object(pms, "connected_component_filter",
                              timed("components",
                                    pms.connected_component_filter)), \
            mock.patch.object(pms, "export_point_cloud",
                              timed("export", pms.export_point_cloud)):
        yield


def stereo_pipeline(torch, smi, checks, device=None, size=STEREO_SIZE,
                    grid=STEREO_GRID):
    """[10]: ``stereo-depth`` at ``size`` on a saved two-camera rig (see the
    module docstring).  ``device``: the card by default.  Returns the
    project launches per run and ``project``'s numbers at the stereo
    shape."""
    import cv2

    from camera_calibration_torch import _cuda, cli, problems
    from camera_calibration_torch.ba.state import BAState
    from camera_calibration_torch.io import state_io
    from camera_calibration_torch.models import central_generic as cg
    from camera_calibration_torch.models import central_generic_cuda as cgc
    from camera_calibration_torch.models import protocol
    from camera_calibration_torch.stereo import patch_match as pms

    dev = torch.device("cuda") if device is None else torch.device(device)
    on = [] if device is None else ["--device", str(dev)]
    w, h = size
    out = _cuda.BUILD_ROOT / "stereo"
    out.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    model = problems.pinhole_model(w, h, grid[1], grid[0], device=dev)
    model64 = problems.pinhole_model(w, h, grid[1], grid[0], device=dev,
                                     dtype=torch.float64)
    baseline = np.array([-STEREO_BASELINE, 0.0, 0.0])
    one = torch.tensor([[1.0, 0, 0, 0]], dtype=torch.float64)
    state_io.save_ba_state(out / "rig", BAState(
        rig_q_global=one, rig_t_global=torch.zeros((1, 3), dtype=torch.float64),
        cam_q_rig=one.repeat(2, 1),
        cam_t_rig=torch.as_tensor(np.stack([np.zeros(3), baseline])),
        points=torch.zeros((1, 3), dtype=torch.float64),
        intrinsics=(model, model)), [True], {0: 0})
    scenes = {}
    for name, slope, scale in (("fronto", 0.0, 0.8 * STEREO_TEXTURE_SCALE),
                               ("slanted", 0.6, 1.1 * STEREO_TEXTURE_SCALE)):
        paths = []
        for side, center in (("left", np.zeros(3)), ("right", -baseline)):
            img, depth = render_plane(torch, model64, center, slope, scale)
            paths.append(out / f"{name}_{side}.png")
            cv2.imwrite(str(paths[-1]), np.round(img * 255).astype(np.uint8))
            if side == "left":
                truth = depth
        scenes[name] = (paths, truth)
    log(f"[10] rig of two {w}x{h} cameras on a {grid[0]}x{grid[1]} grid, "
        f"{STEREO_BASELINE} m baseline; scenes rendered in "
        f"{time.perf_counter() - t0:.2f} s")

    runs, launches, clouds = {}, {}, {}
    for scene, algorithm in (("fronto", "patch_match"),
                             ("slanted", "patch_match"),
                             ("slanted", "plane_sweep")):
        label = f"{scene} {algorithm}"
        (left, right), _ = scenes[scene]
        cloud = out / f"{scene}_{algorithm}.obj"
        times, captured = {}, {}
        held = 0.0
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats()
            held = torch.cuda.memory_allocated() / 2 ** 30
        _cuda.reset_launches()
        t1 = time.perf_counter()
        with stereo_stages(torch, dev, times, captured):
            rc = cli.main(["stereo-depth", "--state_directory",
                           str(out / "rig"), "--left_image", str(left),
                           "--right_image", str(right), "--output",
                           str(cloud), "--algorithm", algorithm, *on])
        times["total"] = time.perf_counter() - t1
        require(rc == 0, f"stereo-depth {label} exited with {rc}")
        launches[label] = _cuda.launches.get("project", 0)
        peak = (torch.cuda.max_memory_allocated() / 2 ** 30
                if dev.type == "cuda" else float("nan"))
        n_lines = sum(1 for _ in open(cloud))
        require(n_lines > 0, f"stereo-depth {label} wrote an empty cloud")
        log(f"[10] stereo-depth {label}: {n_lines} points, {launches[label]} "
            f"project launches, peak device memory {peak:.2f} GiB "
            f"({peak - held:.2f} GiB above the {held:.2f} GiB held before "
            f"the run); host "
            f"seconds {json.dumps({k: round(v, 3) for k, v in times.items()}, sort_keys=True)} "
            f"on {smi}")
        runs[label] = captured
        clouds[label] = cloud
        expected = STEREO_LAUNCHES[algorithm]
        require(device is not None or launches[label] == expected,
                f"stereo-depth {label}: {launches[label]} project launches, "
                f"{expected} expected")

    def interior(margin):
        m = np.zeros((h, w), bool)
        m[margin:-margin, margin:-margin] = True
        return m

    def left_result(label):
        return {k: v.cpu().numpy() for k, v in runs[label]["left"][1].items()}

    # fronto: the reference test's bars
    res = left_result("fronto patch_match")
    gt = scenes["fronto"][1]
    good = interior(8) & np.isfinite(res["cost"]) & (res["cost"] < 0.2)
    rel = np.abs(res["depth"][good] - gt[good]) / gt[good]
    log(f"[10] fronto plane: {100 * good.mean():.1f}% good pixels, median "
        f"relative depth error {np.median(rel):.5f}")
    require(good.mean() > STEREO_GOOD_FRACTION,
            f"fronto: {good.mean():.3f} good pixels")
    require(np.median(rel) < STEREO_MEDIAN_REL,
            f"fronto: median relative error {np.median(rel)}")

    # slanted: PatchMatch against the plane sweep, and the normals
    gt = scenes["slanted"][1]
    errs = {}
    for algorithm in ("patch_match", "plane_sweep"):
        res = left_result(f"slanted {algorithm}")
        ok = interior(10) & np.isfinite(res["cost"])
        errs[algorithm] = float(np.median(
            np.abs(res["depth"][ok] - gt[ok]) / gt[ok]))
    n_gt = np.array([0.6, 0.0, -1.0]) / np.hypot(0.6, 1.0)
    normals = left_result("slanted patch_match")["normals"]
    dots = float(np.median(np.abs(normals[interior(10)] @ n_gt)))
    log(f"[10] slanted plane: median relative depth error PatchMatch "
        f"{errs['patch_match']:.5f}, plane sweep {errs['plane_sweep']:.5f}; "
        f"median |n·n_gt| {dots:.4f}")
    require(errs["patch_match"] < STEREO_MEDIAN_REL,
            f"slanted: PatchMatch error {errs['patch_match']}")
    require(errs["patch_match"] < STEREO_PM_VS_PS * errs["plane_sweep"],
            f"slanted: PatchMatch {errs['patch_match']} not under "
            f"{STEREO_PM_VS_PS}x the plane sweep's {errs['plane_sweep']}")
    require(dots > STEREO_NORMAL_DOT, f"slanted: median |n·n_gt| {dots}")

    # one PatchMatch round of the fronto run under the profiler
    pm_args = runs["fronto patch_match"]["patch_match"][0]
    evaluate, state0 = pms._patch_match_setup(*pm_args)
    opts = pm_args[-1]
    gen = torch.Generator(device=dev)
    gen.manual_seed(opts.seed)
    draws = pms._draws(gen, opts, h, w, pm_args[0])
    before = _cuda.launches.get("project", 0)
    if dev.type == "cuda":
        _, *prof = device_profile(torch, lambda: pms._patch_match_round(
            evaluate, pm_args[2], state0, *draws, opts),
            "stereo_round_trace.json")
        log_profile("[10]", "one PatchMatch round at "
                    f"{w}x{h} ({_cuda.launches.get('project', 0) - before} "
                    "project launches)", *prof, smi)

    # project at the stereo shape: the warm-started directions of the
    # level nearest 2 m, from the level before it
    dirs = pm_args[2].reshape(-1, 3)
    levels = torch.linspace(1.0 / opts.max_depth, 1.0 / opts.min_depth,
                            opts.num_levels, dtype=torch.float64)
    k = int(torch.argmin((levels - 0.5).abs()))
    r_rel, t_rel = pm_args[3], pm_args[4]
    prev = (dirs / float(levels[k - 1])) @ r_rel.T + t_rel
    cur = (dirs / float(levels[k])) @ r_rel.T + t_rel
    warm, _, _ = protocol.project_points(model, prev, max_iterations=6)
    d = (cur / torch.linalg.vector_norm(cur, dim=-1, keepdim=True)).contiguous()
    g0 = cg.pixel_to_grid(model, warm).contiguous()
    lo, hi = cg._static_clamp_bounds(model)
    eps = cg.default_eps(torch.float32)
    n = d.shape[0]
    project = {"points": n, "grid": f"{grid[0]}x{grid[1]}", "iterations": 6}
    project["max_abs_err"] = checks["project"](model, d, g0, 6,
                                               f"stereo {w}x{h}")
    a = cgc.project_grid_coords(model.grid, d, g0, lo, hi, 6, eps)
    b = cgc.project_grid_coords(model.grid, d, g0, lo, hi, 6, eps)
    require(torch.equal(a[0], b[0]) and torch.equal(a[1], b[1]),
            "project at the stereo shape is not bitwise repeatable")
    if dev.type == "cuda":
        fn = lambda: cgc.project_grid_coords(model.grid, d, g0, lo, hi, 6,  # noqa: E731
                                             eps)
        _, iters = cgc.lm_loop_plain(model.grid, d, g0, lo, hi, 6, eps)
        b_ms, b_by = bound_ms(*projection_work(
            n, grid[0] * grid[1] * 12, FLOP_LM_ITERATION * float(iters.sum()),
            False))
        project.update(
            ms=time_ms(torch, fn, reps=20, warmup=3),
            graph_ms=time_ms(torch, fn, reps=20, warmup=1, graph=True),
            cold_graph_ms=cold_graph_ms(torch, fn, reps=20),
            plain_ms=time_ms(torch, lambda: cgc.project_grid_coords_plain(
                model.grid, d, g0, lo, hi, 6, eps), reps=2, warmup=1),
            bound_ms=b_ms, bound_by=b_by,
            mean_lm_iterations=float(iters.float().mean()))
        log(f"[10] project at the stereo shape ({n} warm-started directions, "
            f"{grid[0]}x{grid[1]}, 6 iterations): {project['ms']:.4f} ms, "
            f"graph {project['graph_ms']:.4f} ms, L2-cold graph "
            f"{project['cold_graph_ms']:.4f} ms (plain "
            f"{project['plain_ms']:.4f} ms, bound {b_ms:.4f} ms by {b_by}; "
            f"{project['mean_lm_iterations']:.3f} LM iterations each) on "
            f"{smi}")
    return {"launches": launches, "project": project, "out_dir": out,
            "clouds": clouds, "truth": scenes["fronto"][1],
            "dirs": pm_args[2].cpu().numpy()}


def colmap_pipeline(torch, smi, cli_run, dataset, stereo, device=None):
    """[11]: the COLMAP tools and ``visualize-calibration`` on [9a]'s
    calibration and [10]'s cloud (see the module docstring)."""
    import dataclasses as dc
    import io
    from contextlib import redirect_stdout

    from camera_calibration_torch import _cuda, cli
    from camera_calibration_torch.ba import lm_pcg
    from camera_calibration_torch.io import colmap, state_io
    from camera_calibration_torch.stereo import patch_match as pms

    on = [] if device is None else ["--device", str(device)]
    out = _cuda.BUILD_ROOT / "colmap"
    out.mkdir(parents=True, exist_ok=True)
    times = {}
    state, used, fid = state_io.load_ba_state(cli_run["out_dir"] / "state",
                                              device="cpu")
    fitted = cli_run["fits"]["CentralOpenCVModel"]
    opencv = dc.replace(fitted, params=fitted.params.detach().cpu().double())
    state_io.save_ba_state(out / "state", dc.replace(
        state, intrinsics=(opencv,)), used, fid)
    t0 = time.perf_counter()
    require(cli.main(["export-colmap", "--state_directory",
                      str(out / "state"), "--output_directory",
                      str(out / "colmap"), "--dataset_files",
                      str(dataset)]) == 0, "export-colmap failed")
    times["export_colmap"] = time.perf_counter() - t0
    exported = colmap.read_model(out / "colmap", device="cpu")
    n_obs = sum(len(im.points2d) for im in exported.images)
    require(len(exported.images) == sum(used) and n_obs > 0,
            "export-colmap wrote the wrong images")

    infos = []
    optimize = lm_pcg.optimize
    t0 = time.perf_counter()
    with mock.patch.object(lm_pcg, "optimize", lambda *a, **k: infos.append(
            optimize(*a, **k)) or infos[-1]):
        require(cli.main(["refine-colmap", "--colmap_model",
                          str(out / "colmap"), "--output_directory",
                          str(out / "refined"), "--iterations", "10",
                          *on]) == 0, "refine-colmap failed")
    times["refine_colmap"] = time.perf_counter() - t0
    hist = infos[-1][1]["history"]
    first, last = hist[0]["cost"], infos[-1][1]["final_cost"]
    log(f"[11] refine-colmap: {len(exported.images)} images, {n_obs} "
        f"observations, {len(hist)} LM iterations, cost {first:.6g} -> "
        f"{last:.6g} on {smi}")
    require(last < first, "refine-colmap did not lower the cost")
    for name in ("cameras.txt", "images.txt", "points3D.txt"):
        require((out / "refined" / name).exists(),
                f"refine-colmap wrote no {name}")

    # [10]'s fronto cloud against the true plane's points (every 2nd pixel)
    truth = out / "fronto_truth.obj"
    sub = (slice(None, None, 2), slice(None, None, 2))
    pms.export_point_cloud(truth, {"depth": stereo["truth"][sub],
                                   "dirs": stereo["dirs"][sub]})
    text = io.StringIO()
    t0 = time.perf_counter()
    with redirect_stdout(text):
        require(cli.main(["compare-point-clouds",
                          str(stereo["clouds"]["fronto patch_match"]),
                          str(truth)]) == 0, "compare-point-clouds failed")
    times["compare_point_clouds"] = time.perf_counter() - t0
    line = text.getvalue().strip()
    median = float(line.split("median ")[1].split()[0])
    log(f"[11] compare-point-clouds (stereo cloud -> true plane): {line}")
    require(median < COLMAP_NN_MEDIAN_M,
            f"the stereo cloud lies a median {median} m from the plane")

    t0 = time.perf_counter()
    for tag, args in (("state", ["--state_directory",
                                 str(cli_run["out_dir"] / "state")]),
                      ("colmap", ["--colmap_model", str(out / "refined")])):
        require(cli.main(["visualize-calibration", *args,
                          "--output_directory", str(out / "vis"), *on]) == 0,
                f"visualize-calibration of the {tag} failed")
        for suffix in ("_directions.png", "_distortion.png"):
            require((out / "vis" / f"{tag}_camera0{suffix}").exists(),
                    f"visualize-calibration wrote no {tag} {suffix}")
    times["visualize_calibration"] = time.perf_counter() - t0
    log(f"[11] host seconds per command: "
        f"{json.dumps({k: round(v, 3) for k, v in times.items()}, sort_keys=True)} "
        f"on {smi}")


def sparse_intrinsics_jacobian(torch, j_win, base, gh, gw, k):
    """J_intr (2N × gh·gw·K, row n·2 + i) and its transpose as CSR matrices
    built from ``j_win`` and the window bases; knots outside the grid are
    left out."""
    n = j_win.shape[1]
    dev = j_win.device
    off = torch.arange(4, device=dev)
    kx = base[:, 0].long()[:, None] + off
    ky = base[:, 1].long()[:, None] + off
    inside = (((ky >= 0) & (ky < gh))[:, :, None]
              & ((kx >= 0) & (kx < gw))[:, None, :])
    col = (ky[:, :, None] * gw + kx[:, None, :])[..., None] * k \
        + torch.arange(k, device=dev)
    row = torch.arange(n, device=dev)[:, None] * 2 + torch.arange(2, device=dev)
    shape = (n, 2, 4, 4, k)
    mask = inside[:, None, :, :, None].expand(shape)
    rows = row[:, :, None, None, None].expand(shape)[mask]
    cols = col[:, None].expand(shape)[mask]
    vals = j_win.reshape(2, 4, 4, k, n).permute(4, 0, 1, 2, 3)[mask]
    size = (2 * n, gh * gw * k)
    j = torch.sparse_coo_tensor(torch.stack([rows, cols]), vals, size,
                                check_invariants=False)
    jt = torch.sparse_coo_tensor(torch.stack([cols, rows]), vals, size[::-1],
                                 check_invariants=False)
    return (j.coalesce().to_sparse_csr(), jt.coalesce().to_sparse_csr())


def record_pipeline(torch, smi, images, device=None):
    """[12a]: ``cli.main record`` of [8]'s rendered 1920×1080 views from a
    ``dir:`` input, detection on ``device`` (the card by default) one frame
    at a time, ``--record_images``.  Gates: every view kept, with the
    feature ids of [8]'s extract-features dataset; the positions against
    that dataset's and against the rendered truth within the RECORD_*
    bars (see there); 30 recorded images and the coverage map.  Prints
    the host seconds per frame: reading the image, detection, the
    consumer's bookkeeping.  Returns the recorded dataset's path and the
    output directory."""
    import shutil

    from camera_calibration_torch import cli
    from camera_calibration_torch.io import dataset_bin
    from camera_calibration_torch.ui import live_capture

    dev = torch.device("cuda") if device is None else torch.device(device)
    on = [] if device is None else ["--device", str(dev)]
    out = images["out_dir"] / "record"
    shutil.rmtree(out, ignore_errors=True)
    seen = {}
    run = live_capture.run_live_capture

    def timed_run(image_input, consumer, stop_event=None):
        t0 = time.perf_counter()
        kept = run(image_input, consumer, stop_event)
        seen.update(consumer=consumer, seconds=time.perf_counter() - t0)
        return kept

    t0 = time.perf_counter()
    with mock.patch.object(live_capture, "run_live_capture", timed_run):
        rc = cli.main(["record", "--inputs", f"dir:{images['views']}",
                       "--pattern_files", str(images["pattern"]),
                       "--record_images", "--output_directory", str(out),
                       *on])
    total = time.perf_counter() - t0
    require(rc == 0, f"record exited with {rc}")
    got = dataset_bin.load_datasets(str(out / "dataset.bin"))
    ref = dataset_bin.load_datasets(str(images["dataset"]))
    n = len(ref.imagesets)
    kept = {int(a.filenames[0][len("image"):-len(".png")]): a
            for a in got.imagesets}
    log(f"[12a] record: {len(kept)} of {n} views kept")
    if len(kept) != n or got.image_sizes != ref.image_sizes:
        raise SmokeFailure(f"record kept {len(kept)} of {n} views")
    # the rendered truth of every view (the render drew each view's noise
    # from the generator of its pose)
    from camera_calibration_torch.features import pattern as pat
    from camera_calibration_torch.features.degrade import degrade

    spec = pat.load_pattern_yaml(str(images["pattern"]))
    corner_map = pat.corners_for_patterns([spec])[0]
    (w, h), = ref.image_sizes
    homographies = []
    for _, h_pp, view_rng in cli.render_views(spec, n, w, h, IMAGE_MIN_Z,
                                              IMAGE_MAX_Z, IMAGE_SEED):
        homographies.append(h_pp)
        degrade(np.zeros((h, w)), view_rng, defocus_sigma=IMAGE_DEFOCUS,
                noise=IMAGE_NOISE)

    def truth_gap(i, fid, xy):
        q = homographies[i] @ np.array([*corner_map[fid], 1.0])
        return float(np.linalg.norm(xy - q[:2] / q[2]))

    same_ids, worst_ids, gaps, truth = 0, 0.0, [], {"record": [], "batch": []}
    for i, a in sorted(kept.items()):
        fa = {f.feature_id: np.asarray(f.xy) for f in a.features[0]}
        fb = {f.feature_id: np.asarray(f.xy) for f in
              ref.imagesets[i].features[0]}
        same_ids += sorted(fa) == sorted(fb)
        worst_ids = max(worst_ids, len(set(fa) ^ set(fb)) / max(len(fb), 1))
        gaps += [float(np.abs(fa[k] - fb[k]).max()) for k in fa if k in fb]
        truth["record"] += [truth_gap(i, k, xy) for k, xy in fa.items()]
        truth["batch"] += [truth_gap(i, k, xy) for k, xy in fb.items()]
    gaps = np.asarray(gaps)
    log(f"[12a] record: {len(gaps)} features in both datasets; the same "
        f"feature ids as extract-features in {same_ids} of {len(kept)} "
        f"views, at most {100 * worst_ids:.2f}% of a view's features in one "
        f"only; per-frame detect vs batched detect_batch |Δ| median "
        f"{float(np.median(gaps)):.3e} px, 99th percentile "
        f"{float(np.percentile(gaps, 99)):.3e}, max {float(gaps.max()):.3e} "
        f"({int((gaps > RECORD_P99_PX).sum())} over {RECORD_P99_PX} px)")
    for label, t in truth.items():
        log(f"[12a] {label} positions against the rendered truth: median "
            f"{float(np.median(t)):.4f} px, 99th percentile "
            f"{float(np.percentile(t, 99)):.4f}, max {max(t):.4f}")
    require(same_ids == n,
            "record found other features than extract-features")
    require(np.median(gaps) <= RECORD_MEDIAN_PX
            and np.percentile(gaps, 99) <= RECORD_P99_PX
            and (gaps > RECORD_P99_PX).sum() <= RECORD_TAIL_FRACTION
            * gaps.size, "record's positions are off extract-features'")
    require(np.median(truth["record"]) < IMAGE_MEDIAN_TRUTH_PX
            and max(truth["record"])
            <= RECORD_TRUTH_MAX_FACTOR * max(truth["batch"]),
            "record's positions are off the rendered truth")
    n_rec = len(list((out / "images_camera0").glob("image*.png")))
    require(n_rec == n and (out / "coverage_camera0.png").exists(),
            f"record wrote {n_rec} images or no coverage map")
    c = seen["consumer"]
    log(f"[12a] record host seconds per frame: {total / n:.3f} the whole "
        f"command, {(seen['seconds'] - c.imageset_seconds) / n:.3f} reading "
        f"the image, {c.detect_seconds / n:.3f} detection, "
        f"{(c.imageset_seconds - c.detect_seconds) / n:.3f} bookkeeping "
        f"(coverage, recording); whole command {total:.2f} s "
        f"(extract-features of the same views in one batch: "
        f"{images['times']['detect']:.2f} s) on {smi}")
    return {"dataset": out / "dataset.bin", "out_dir": out}


def live_frame_rate(torch, smi, device=None, n_views=LIVE_FPS_VIEWS):
    """[12b]: the live frame rate as ``benchmarks/live_fps.py`` measures
    the reference package's: ``n_views`` rendered 640×480 views of a 12×12
    board through ``run_live_capture`` from a ``dir:`` input, detection
    on ``device`` (the card by default); each frame's host time around
    ``new_imageset``, frame 0 excluded."""
    import shutil

    from camera_calibration_torch import _cuda, cli
    from camera_calibration_torch.ba.dataset import Dataset
    from camera_calibration_torch.features import detector as fdet
    from camera_calibration_torch.features import pattern as pat
    from camera_calibration_torch.io.image_input import create_image_input
    from camera_calibration_torch.ui import live_capture

    dev = torch.device("cuda") if device is None else torch.device(device)
    root = _cuda.BUILD_ROOT / "live_fps"
    shutil.rmtree(root, ignore_errors=True)
    cli.main(["create-pattern", "--output_directory", str(root / "pat"),
              "--squares_x", "12", "--squares_y", "12",
              "--square_length_in_meters", "0.02"])
    yaml = root / "pat" / "pattern_resolution_12x12_segments_16.yaml"
    w, h = LIVE_FPS_SIZE
    cli.main(["render-synthetic", "--pattern_file", str(yaml),
              "--output_directory", str(root / "images"), "--num_images",
              str(n_views), "--width", str(w), "--height", str(h),
              "--min_z", "0.35", "--max_z", "0.55", "--noise", "0.01",
              "--seed", str(LIVE_FPS_SEED)])
    det = fdet.FeatureDetector([pat.load_pattern_yaml(str(yaml))], device=dev)
    consumer = live_capture.LiveImageConsumer(
        Dataset(num_cameras=1, image_sizes=[]), det,
        live_capture.LiveCaptureOptions(visualization_directory=None),
        log=lambda *a: None)
    frames, new_imageset = [], consumer.new_imageset

    def timed(images, filenames=None):
        d0 = consumer.detect_seconds
        t0 = time.perf_counter()
        kept = new_imageset(images, filenames)
        frames.append((time.perf_counter() - t0,
                       consumer.detect_seconds - d0))
        return kept

    consumer.new_imageset = timed
    with create_image_input(f"dir:{root / 'images'}") as image_input:
        kept = live_capture.run_live_capture(image_input, consumer)
    ft = np.asarray([f[0] for f in frames[1:]])
    dt = np.asarray([f[1] for f in frames[1:]])
    feats = [len(s.features[0]) for s in consumer.dataset.imagesets[1:]]
    log(f"[12b] live detection at {w}x{h}: "
        f"{1.0 / float(np.median(ft)):.2f} frames/s (median of {ft.size} "
        f"frames, frame 0 excluded: {frames[0][0]:.3f} s); frame ms median "
        f"{1e3 * float(np.median(ft)):.1f}, p90 "
        f"{1e3 * float(np.percentile(ft, 90)):.1f}; per frame detection "
        f"{1e3 * float(np.median(dt)):.1f} ms, bookkeeping "
        f"{1e3 * float(np.median(ft - dt)):.2f} ms; {kept} of {n_views} "
        f"views kept, median {float(np.median(feats)):.0f} features on {smi}")
    # a view whose board the detector misses is dropped, as the reference
    # benchmark counts it; most views must hold the board
    require(kept >= LIVE_FPS_MIN_KEPT * n_views,
            f"live capture kept {kept} of {n_views} views")
    return 1.0 / float(np.median(ft))


def live_calibration(torch, smi, recorded, device=None):
    """[12c]: ``cli.main calibrate --dataset_files <[12a]'s dataset.bin>``
    with the defaults (three levels to 45×79, float32 on ``device``, the
    card by default, and the float64 polish), first without and then with
    ``--live_directory`` (both with ``--dense_initialization_base_path``:
    the first computes the initialization and saves it, the second loads
    it; the launch counts are set to 0 just before the second).  Gates:
    the calibration bar of [9a] (median < IMAGE_MEDIAN_PX, scale, final
    grid 45×79, the five kernels at each pyramid grid), every hook image
    of LIVE_HOOK_PNGS, and the final state and report equal, bit for bit,
    to the run without the visualizer.  Prints the hooks' host seconds
    apart from the stages'."""
    import shutil

    from camera_calibration_torch import calibrate as cal
    from camera_calibration_torch import cli
    from camera_calibration_torch.ui import calibration_visualizer as cv

    dev = torch.device("cuda") if device is None else torch.device(device)
    on = [] if device is None else ["--device", str(dev)]
    out = recorded["out_dir"] / "calibrate"
    shutil.rmtree(out, ignore_errors=True)
    base = ["calibrate", "--dataset_files", str(recorded["dataset"]),
            "--dense_initialization_base_path", str(out / "init.npz"), *on]
    plain_times, plain = {}, {}
    with timed_cli_stages(plain_times, plain):
        rc = cli.main(base + ["--output_directory", str(out / "plain")])
    require(rc == 0, f"calibrate exited with {rc}")

    hooks = {}

    def timed_hook(name, fn):
        def run(*args, **kw):
            t0 = time.perf_counter()
            result = fn(*args, **kw)
            if dev.type == "cuda":
                torch.cuda.synchronize()
            acc = hooks.setdefault(name, [0, 0.0])
            acc[0] += 1
            acc[1] += time.perf_counter() - t0
            return result
        return run

    names = [n for n in vars(cv.CalibrationVisualizer)
             if n.startswith("update_")]
    times, captured = {}, {}
    rec = CalibrationRecord(torch, dev)
    live = out / "live_images"
    with ExitStack() as stack:
        for n in names:
            stack.enter_context(mock.patch.object(
                cv.CalibrationVisualizer, n,
                timed_hook(n, getattr(cv.CalibrationVisualizer, n))))
        stack.enter_context(timed_cli_stages(times, captured))
        stack.enter_context(rec.recording(cal))
        rc = cli.main(base + ["--output_directory", str(out / "live"),
                              "--live_directory", str(live)])
    require(rc == 0, f"calibrate --live_directory exited with {rc}")
    st_f, data_f, report = captured["result"]
    per_grid = rec.summarize("[12c]", report, times, smi)
    rec.gate(st_f, report, IMAGE_MEDIAN_PX, PIPELINE_KERNELS)
    for name in LIVE_HOOK_PNGS:
        require((live / f"{name}_camera0.png").exists(),
                f"calibrate --live_directory wrote no {name} image")
    p_state, p_data, p_report = plain["result"]
    same = all(torch.equal(a, b) for a, b in zip(
        state_tensors(st_f) + state_tensors(data_f),
        state_tensors(p_state) + state_tensors(p_data)))
    untimed = [{k: v for k, v in r.items() if k != "solver"}
               for r in (report, p_report)]
    log(f"[12c] final state with the visualizer "
        f"{'bit for bit equal to' if same else 'DIFFERENT from'} the run "
        f"without it (median {report['reprojection_error_median']:.7g} vs "
        f"{p_report['reprojection_error_median']:.7g} px)")
    require(same and untimed[0] == untimed[1],
            "the visualizer changed the calibration")
    hook_s = sum(v[1] for v in hooks.values())
    log(f"[12c] hooks' host seconds {hook_s:.3f} in all: "
        + ", ".join(f"{n[len('update_'):]} {c}x {s_:.3f} s"
                    for n, (c, s_) in sorted(hooks.items()))
        + f"; stages: {json.dumps(times, sort_keys=True)} (without the "
        f"visualizer: {json.dumps(plain_times, sort_keys=True)}) on {smi}")
    return {"launches": per_grid, "report": report}


def state_tensors(obj):
    """Every tensor of a state or of tables, in field order."""
    import torch

    if isinstance(obj, torch.Tensor):
        return [obj]
    if isinstance(obj, (tuple, list)):
        return [t for x in obj for t in state_tensors(x)]
    if dataclasses.is_dataclass(obj):
        return [t for f in dataclasses.fields(obj)
                for t in state_tensors(getattr(obj, f.name))]
    return []


def sharded_optimize(torch, smi, device=None):
    """[12d]: ``optimize`` on the full-size bench problem through
    ``parallel.sharding`` in a one-rank process group (NCCL on the card,
    gloo on the CPU; a free local port), in both step forms (10 LM
    iterations, no early stop, as [5] times them), against the unsharded
    ``optimize`` from the same start.  Gates: all five kernels launched
    in the sharded runs (the two-pass form; the cached-blocks form has no
    cost-only pass, so all but ``project``); at least one all-reduce per CG iteration; the
    histories and the final states equal bit for bit.  Prints the LM it/s
    of both and the host time of one all-reduce of a tangent."""
    import socket

    import torch.distributed as dist

    from camera_calibration_torch import _cuda, problems
    from camera_calibration_torch.ba import lm_pcg
    from camera_calibration_torch.parallel import distributed, sharding

    dev = torch.device("cuda") if device is None else torch.device(device)
    with socket.socket() as s_:
        s_.bind(("127.0.0.1", 0))
        port = s_.getsockname()[1]
    require(distributed.initialize(f"127.0.0.1:{port}", 1, 0, device=dev),
            "the process group did not initialize")
    log(f"[12d] one-rank {dist.get_backend()} group on 127.0.0.1:{port}")
    launches = {}
    try:
        state, data, _ = problems.make_bench_problem(device=dev)
        n_it = 10
        base = lm_pcg.BAOptions(max_pcg_iterations=20, proj_iterations=4,
                                max_lm_iterations=n_it,
                                cost_reduction_threshold=0.0,
                                max_consecutive_rejects=n_it + 1)
        for form, k in (("two-pass", 1), ("cached-blocks", n_it)):
            opts = dataclasses.replace(base, lm_steps_per_call=k)
            data_g = lm_pcg.maybe_grid_layout(data, state, opts)
            shards = sharding.shard_observations(data_g)
            runs = {}
            for label, tables in (("unsharded", data_g), ("sharded", shards),
                                  ("sharded", shards),
                                  ("unsharded", data_g)):
                s0 = problems.perturb_bench_state(state, seed=100)
                _cuda.reset_launches()
                sharding.reset_collectives()
                if dev.type == "cuda":
                    torch.cuda.synchronize()
                t0 = time.perf_counter()
                st, info = lm_pcg.optimize(s0, None, None, opts, data=tables)
                if dev.type == "cuda":
                    torch.cuda.synchronize()
                dt = time.perf_counter() - t0
                runs.setdefault(label, []).append(dict(
                    state=st, history=info["history"], seconds=dt,
                    launches=dict(_cuda.launches),
                    collectives=dict(sharding.collectives)))
            sh, un = runs["sharded"][0], runs["unsharded"][0]
            launches[form] = sh["launches"]
            cg_total = sum(h["pcg_iterations"] for h in sh["history"])
            n_reduce = sh["collectives"].get("all_reduce", 0)
            same = (sh["history"] == un["history"]
                    and all(torch.equal(a, b) for a, b in zip(
                        state_tensors(sh["state"]),
                        state_tensors(un["state"]))))
            rates = {lbl: [len(r["history"]) / r["seconds"] for r in rs]
                     for lbl, rs in runs.items()}
            log(f"[12d] {form}: {len(sh['history'])} LM iterations, "
                f"{cg_total} CG iterations, {n_reduce} all-reduces; sharded "
                f"{'bit for bit equal to' if same else 'DIFFERENT from'} "
                f"unsharded; LM it/s sharded "
                f"{', '.join(f'{r:.3f}' for r in rates['sharded'])}, "
                f"unsharded {', '.join(f'{r:.3f}' for r in rates['unsharded'])}"
                f"; launches {json.dumps(sh['launches'], sort_keys=True)} "
                f"on {smi}")
            # the cached-blocks form has no cost-only pass: no ``project``
            for name in PIPELINE_KERNELS[k > 1:]:
                require(sh["launches"].get(name, 0) > 0,
                        f"[12d] {form}: kernel {name} never launched")
            require(n_reduce >= cg_total, f"[12d] {form}: {n_reduce} "
                    f"all-reduces for {cg_total} CG iterations")
            require(same, f"[12d] {form}: the sharded optimize differs from "
                    "the unsharded one")
        # one all-reduce of a tangent of the bench problem
        shard = sharding.shard_of(shards)
        flat = lm_pcg.zero_tangent(state).ravel()
        if dev.type == "cuda":
            ms = time_ms(torch, lambda: sharding.all_reduce_sum(
                shard, [flat]), reps=100)
        else:
            t0 = time.perf_counter()
            for _ in range(100):
                sharding.all_reduce_sum(shard, [flat])
            ms = (time.perf_counter() - t0) * 10.0
        log(f"[12d] one all-reduce of the bench tangent ({flat.numel()} "
            f"floats): {ms:.4f} ms (events around 100 calls); "
            f"{n_reduce / max(cg_total, 1):.2f} all-reduces per CG iteration "
            f"on {smi}")
    finally:
        dist.destroy_process_group()
    return {"launches": launches}


def device_profile(torch, run, trace_name):
    """Run ``run()`` under ``torch.profiler`` and read the trace: (wall
    µs, device busy µs, kernel launches, host syncs or copies, {kernel
    name: (µs, count)}); busy is None where the profiler saw no kernels."""
    from torch.profiler import ProfilerActivity, profile

    from camera_calibration_torch import _cuda

    _cuda.BUILD_ROOT.mkdir(parents=True, exist_ok=True)
    trace_path = str(_cuda.BUILD_ROOT / trace_name)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = run()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    prof.export_chrome_trace(trace_path)
    with open(trace_path) as f:
        events = json.load(f)
    events = events.get("traceEvents", events) if isinstance(events, dict) else events
    kernels = [e for e in events if e.get("cat") == "kernel" and "dur" in e]
    if not kernels:
        return out, wall_us, None, 0, 0, {}
    spans = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                   for e in kernels)
    busy, end = 0.0, -1.0
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    syncs = sum(1 for e in events if e.get("cat") == "cuda_runtime"
                and ("Synchronize" in e.get("name", "")
                     or "Memcpy" in e.get("name", "")))
    by_name = {}
    for e in kernels:
        tot, cnt = by_name.get(e["name"], (0.0, 0))
        by_name[e["name"]] = (tot + float(e["dur"]), cnt + 1)
    return out, wall_us, busy, len(kernels), syncs, by_name


def log_profile(tag, what, wall_us, busy, n_kernels, syncs, by_name, smi):
    if busy is None:
        log(f"{tag} device time: not measured (the profiler saw no "
            f"kernels); {what} in {wall_us / 1e3:.1f} ms")
        return
    log(f"{tag} profile of {what}: wall "
        f"{wall_us / 1e3:.2f} ms, device busy {busy / 1e3:.2f} ms "
        f"({100.0 * busy / wall_us:.1f}%), {n_kernels} kernel launches, "
        f"{syncs} host syncs/copies, on {smi}")
    for name, (tot, cnt) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]:
        log(f"    {tot / 1e3:8.3f} ms {cnt:6d}x  {name[:100]}")


def profile_step(torch, lm_pcg, state, data, options, smi):
    """Device time of a short two-pass ``optimize`` run under
    ``torch.profiler``: the device's busy share of the wall time, the host
    synchronisations, and the kernels that take the most time (trace in
    ``_build/chip_smoke_trace.json``)."""
    (_, info), *prof = device_profile(
        torch, lambda: lm_pcg.optimize(state, None, None, options, data=data),
        "chip_smoke_trace.json")
    log_profile("[6]", f"{len(info['history'])} two-pass LM iterations",
                *prof, smi)


@contextmanager
def plain_routes(cgc, wc):
    """Route the eight kernel wrappers to their plain versions (for the
    kernel-vs-plain LM step comparison only)."""
    from camera_calibration_torch.ba import schur_cuda as sc
    from camera_calibration_torch.models import noncentral_generic as ncg
    from camera_calibration_torch.models import noncentral_generic_cuda as ncgc

    with mock.patch.object(cgc, "project_grid_coords",
                           cgc.project_grid_coords_plain), \
         mock.patch.object(cgc, "project_blocks", cgc.project_blocks_plain), \
         mock.patch.object(ncgc, "project_points", ncg.project_points), \
         mock.patch.object(wc, "window_apply_j", wc.window_apply_j_plain), \
         mock.patch.object(wc, "window_apply_jtw", wc.window_apply_jtw_plain), \
         mock.patch.object(wc, "window_block_diag",
                           wc.window_block_diag_plain), \
         mock.patch.object(sc, "point_leg", sc.point_leg_plain), \
         mock.patch.object(sc, "pose_leg", sc.pose_leg_plain):
        yield


if __name__ == "__main__":
    sys.exit(main())
