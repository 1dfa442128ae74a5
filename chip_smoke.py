#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Run from the repository root on a machine with a CUDA card and the CUDA
toolkit.  It imports only ``camera_calibration_torch`` (never JAX) and:

1. prints the card's name and power limit;
2. builds the hand-written kernels from ``camera_calibration_torch/csrc``
   and prints what ``ptxas -v`` says of each (registers, shared memory,
   spills);
3. holds every kernel against its plain PyTorch version on the card, at the
   shapes of the benchmark problem's main path (262,144 observations, 16×16
   grid), on a non-square 21×28 grid, on the 45×79 grid of a 1080p camera,
   and with K = 5 window Jacobians;
4. drives the main path: ``optimize`` on the full-size benchmark problem in
   the two-pass form and in the cached-blocks form, with the launch counts
   set to 0 just before and read just after, checks that every kernel ran
   and that the paired cost falls, and compares one LM step through the
   kernels with one through the plain versions;
5. times every kernel, its plain version and, for the two matvecs, a
   torch.sparse product as the library yardstick, with CUDA events around
   calls from Python (``ms``, ``plain_ms``, ``library_ms``), and every
   kernel again as one replay of a CUDA graph of 100 calls (``graph_ms``:
   the card's time alone, without the host's per-call cost); the two
   window reductions also at K = 5 (16×16) and at 45×79; and the LM
   iterations per second of both step forms with the host clock;
6. profiles two LM iterations with ``torch.profiler`` (device busy share,
   host syncs, the kernels that take the most time; the trace goes to
   ``camera_calibration_torch/_build/chip_smoke_trace.json``);
7. prints one JSON line listing every kernel, the ``nvidia-smi`` line of
   the card, and last ``{"ok": true, "device": {...}}``.

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
from contextlib import contextmanager
from unittest import mock

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))

# Published peaks of one H100 SXM (NVIDIA data sheet): HBM bandwidth and
# float32 outside the tensor cores.
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOP_PER_S = 67e12

# FLOP per point of csrc/project.cu, counted from its source: one LM
# iteration (surface + derivatives, 2×2 solve, test-point cost), the final
# cost, and the sensitivities + 64 window-Jacobian values of the blocks form.
FLOP_LM_ITERATION = 550
FLOP_FINAL_COST = 160
FLOP_BLOCKS_TAIL = 850

# Tolerances (see the checks below for the reasons).
WINDOW_REL_TOL = 1e-4
PROJ_PX_TOL = 1e-2
PROJ_FLIP_FRACTION = 1e-3
BLOCKS_REL_TOL = 1e-3
STEP_REL_TOL = 1e-3


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


def bound_ms(nbytes, flops):
    """The least time for the work: bytes over HBM rate or FLOP over the
    float32 rate, whichever is larger; and which one it is."""
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_F32_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


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
    from camera_calibration_torch.ba.state import (
        broadcast_rows, transform_to_camera,
    )
    from camera_calibration_torch.models import central_generic as cg
    from camera_calibration_torch.models import central_generic_cuda as cgc
    from camera_calibration_torch.ops import manifolds

    t_start = time.perf_counter()
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

    # ------------------------------------------ 3. kernels vs plain versions
    rng = np.random.default_rng(0)
    options = lm_pcg.BAOptions(max_pcg_iterations=20, proj_iterations=4)
    state, data, meta = problems.make_bench_problem(device=dev)
    seg = data[0]
    model = state.intrinsics[0]
    n_obs = seg.count
    log(f"[3] bench problem: {n_obs} rows, {meta['n_obs']} valid "
        f"observations, {model.grid_height}x{model.grid_width} grid")

    def projection_inputs(st, sg, mdl):
        x = broadcast_rows(st.points, sg.point, sg.grid_shape, 1)
        x_cam, _ = transform_to_camera(st, sg.imageset, sg.camera, x,
                                       grid_shape=sg.grid_shape)
        norm = torch.linalg.vector_norm(x_cam, dim=-1, keepdim=True)
        d = (x_cam / torch.clamp_min(norm, 1e-18)).contiguous()
        return d, cg.pixel_to_grid(mdl, sg.pixel).contiguous()

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
    d0, g00 = projection_inputs(state, seg, model)
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
    pix = torch.as_tensor(rng.uniform([2, 2], [638, 478], (n2, 2)),
                          dtype=torch.float32, device=dev)
    dirs2, _ = cg.unproject(small, pix)
    warm2 = pix + torch.as_tensor(rng.normal(0, 2.0, (n2, 2)),
                                  dtype=torch.float32, device=dev)
    g02 = cg.pixel_to_grid(small, warm2).contiguous()
    check_project(small, dirs2.contiguous(), g02, 8, f"{gh2}x{gw2}")
    check_blocks(small, dirs2.contiguous(), g02, 8, f"{gh2}x{gw2}")
    # 45x79 is the pipeline's default grid for a 1080p camera (25 px cells);
    # the random inputs of the full-size cases are timed again in [5].
    random_windows = {}
    for k, (hh, ww), nn in ((2, (gh2, gw2), n2), (5, (gh2, gw2), n2),
                            (5, (gh, gw), n_obs), (2, (45, 79), n_obs)):
        jw = torch.as_tensor(rng.normal(0, 1, (32 * k, nn)),
                             dtype=torch.float32, device=dev)
        base = torch.as_tensor(
            np.stack([rng.integers(-3, ww, nn), rng.integers(-3, hh, nn)], 1),
            dtype=torch.int32, device=dev)
        check_window(jw, base, hh, ww, k, f"random {hh}x{ww} K={k}")
        if nn == n_obs:
            random_windows[(hh, ww, k)] = (jw, base)
    log(f"[3] kernel checks passed in {time.perf_counter() - t0:.1f} s")

    # ------------------------------------------------------ 4. main path
    two_pass = dataclasses.replace(options, max_lm_iterations=3)
    cached = dataclasses.replace(two_pass, lm_steps_per_call=3)
    _cuda.reset_launches()
    t0 = time.perf_counter()
    s_two, info_two = lm_pcg.optimize(state, None, None, two_pass, data=data)
    s_cached, info_cached = lm_pcg.optimize(state, None, None, cached,
                                            data=data)
    torch.cuda.synchronize()
    launches = dict(_cuda.launches)
    log(f"[4] main path ran in {time.perf_counter() - t0:.1f} s; launches "
        f"{json.dumps(launches, sort_keys=True)}")
    for name in ("project", "project_blocks", "window_apply_j",
                 "window_apply_jtw", "window_block_diag"):
        require(launches.get(name, 0) > 0, f"kernel {name} never launched")
    for label, info, st in (("two-pass", info_two, s_two),
                            ("cached-blocks", info_cached, s_cached)):
        hist = info["history"]
        for h in hist:
            log(f"    {label} it {h['iteration']}: cost {h['cost']:.6g} -> "
                f"{h['new_cost']:.6g} (paired {h['paired_cost']:.6g} -> "
                f"{h['paired_new_cost']:.6g}) accepted {h['accepted']} "
                f"pcg {h['pcg_iterations']}")
        require(hist and hist[0]["accepted"]
                and hist[0]["paired_new_cost"] < hist[0]["paired_cost"],
                f"{label}: the first step did not lower the paired cost")
        require(tuple(st.points.shape) == tuple(state.points.shape)
                and bool(torch.isfinite(st.points).all())
                and bool(torch.isfinite(st.rig_t_global).all()),
                f"{label}: non-finite or misshapen state")

    # One LM step through the kernels and one through the plain versions,
    # both on the card, from the same state (the reference package's bar).
    lam = torch.tensor(1e-2, dtype=torch.float32, device=dev)
    warm = (seg.pixel,)
    out_k = lm_pcg.lm_step(state, warm, lam, data, options)
    before = dict(_cuda.launches)
    with plain_routes(cgc, wc):
        out_p = lm_pcg.lm_step(state, warm, lam, data, options)
    require(dict(_cuda.launches) == before, "the plain step launched a kernel")
    cost_k, cost_p = float(out_k[5]), float(out_p[5])
    cost_rel = abs(cost_k - cost_p) / max(abs(cost_p), 1e-30)
    dp = (out_k[0].points - out_p[0].points).abs().max()
    pts_rel = float(dp) / float(out_p[0].points.abs().max())
    log(f"    one LM step, kernels vs plain on the card: new cost {cost_k:.6g}"
        f" vs {cost_p:.6g} (rel {cost_rel:.3e}), points max|Δ|/scale "
        f"{pts_rel:.3e}, pcg {out_k[6]} vs {out_p[6]}")
    require(cost_rel <= STEP_REL_TOL and pts_rel <= STEP_REL_TOL,
            "LM step through the kernels disagrees with the plain step")

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
    rows = {
        "project": dict(
            source="camera_calibration_torch/csrc/project.cu",
            replaces="camera_calibration_tpu/models/central_generic_pallas.py:163",
            kern=lambda: cgc.project_grid_coords(model.grid, d0, g00, lo, hi,
                                                 iters, eps),
            plain=lambda: cgc.project_grid_coords_plain(model.grid, d0, g00,
                                                        lo, hi, iters, eps),
            nbytes=n * (3 + 2) * 4 + grid_bytes + n * (2 + 1) * 4,
            flops=loop_flop + FLOP_FINAL_COST * n),
        "project_blocks": dict(
            source="camera_calibration_torch/csrc/project.cu",
            replaces="camera_calibration_tpu/models/central_generic_pallas.py:176",
            kern=lambda: cgc.project_blocks(*blk_args),
            plain=lambda: cgc.project_blocks_plain(*blk_args),
            nbytes=n * (3 + 2) * 4 + 3 * grid_bytes
            + n * (2 + 1 + 6 + 64 + 2) * 4,
            flops=loop_flop + (FLOP_FINAL_COST + FLOP_BLOCKS_TAIL) * n),
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
    kernels = []
    for name, r in rows.items():
        ms = time_ms(torch, r["kern"], reps=100, warmup=5)
        graph_ms = time_ms(torch, r["kern"], reps=100, warmup=1, graph=True)
        plain_ms = time_ms(torch, r["plain"], reps=3, warmup=1)
        library_ms = (time_ms(torch, r["library"], reps=100, warmup=5)
                      if "library" in r else None)
        b_ms, b_by = bound_ms(r["nbytes"], r["flops"])
        lib_txt = "" if library_ms is None else f", torch.sparse {library_ms:.4f} ms"
        log(f"[5] {name}: {ms:.4f} ms, graph {graph_ms:.4f} ms (plain "
            f"{plain_ms:.4f} ms{lib_txt}, bound {b_ms:.4f} ms by {b_by}; "
            f"{launches.get(name, 0)} launches on the main path) on {smi}")
        kernels.append({
            "name": name, "route": "cuda", "source": r["source"],
            "replaces": r["replaces"], "launches": launches.get(name, 0),
            "max_abs_err": max_abs[name], "ms": ms, "graph_ms": graph_ms,
            "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": library_ms,
        })

    # The two reductions beyond the bench shapes, on the random inputs of
    # [3]: K=5 on the bench grid, K=2 on the 1080p default grid.
    for (hh, ww, k), (jw_x, base_x) in random_windows.items():
        nx = jw_x.shape[1]
        ws_x = torch.as_tensor(rng.normal(0, 1, (nx, 2)), dtype=torch.float32,
                               device=dev)
        w_x = torch.as_tensor(rng.uniform(0, 1, nx), dtype=torch.float32,
                              device=dev)
        inside_x = float(wc._window_index(base_x, hh, ww)[1].sum())
        common = jw_x.numel() * 4 + nx * 2 * 4
        for name, fn, nbytes, flops in (
                ("window_apply_jtw",
                 lambda: wc.window_apply_jtw(jw_x, base_x, ws_x, hh, ww, k),
                 common + nx * 2 * 4 + hh * ww * k * 4, 4 * k * inside_x),
                ("window_block_diag",
                 lambda: wc.window_block_diag(jw_x, base_x, w_x, hh, ww, k),
                 common + nx * 4 + hh * ww * k * k * 4,
                 6 * (k * (k + 1) // 2) * inside_x)):
            ms = time_ms(torch, fn, reps=100, warmup=5)
            graph_ms = time_ms(torch, fn, reps=100, warmup=1, graph=True)
            b_ms, b_by = bound_ms(nbytes, flops)
            log(f"[5] {name} random {hh}x{ww} K={k}: {ms:.4f} ms, graph "
                f"{graph_ms:.4f} ms (bound {b_ms:.4f} ms by {b_by}; {nx} "
                f"observations) on {smi}")

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
    log(f"[5] timing took {time.perf_counter() - t0:.1f} s")

    # ------------------------------------------------ 6. where the time goes
    profile_step(torch, lm_pcg, problems.perturb_bench_state(state, seed=101),
                 data, dataclasses.replace(timed, max_lm_iterations=2), smi)
    log(f"[6] whole run {time.perf_counter() - t_start:.1f} s")

    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


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


def profile_step(torch, lm_pcg, state, data, options, smi):
    """Device time of a short two-pass ``optimize`` run under
    ``torch.profiler``: the device's busy share of the wall time, the host
    synchronisations, and the kernels that take the most time."""
    from torch.profiler import ProfilerActivity, profile

    from camera_calibration_torch import _cuda

    _cuda.BUILD_ROOT.mkdir(parents=True, exist_ok=True)
    trace_path = str(_cuda.BUILD_ROOT / "chip_smoke_trace.json")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        _, info = lm_pcg.optimize(state, None, None, options, data=data)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    prof.export_chrome_trace(trace_path)
    with open(trace_path) as f:
        events = json.load(f)
    events = events.get("traceEvents", events) if isinstance(events, dict) else events
    kernels = [e for e in events if e.get("cat") == "kernel" and "dur" in e]
    n_it = len(info["history"])
    if not kernels:
        log(f"[6] device time: not measured (the profiler saw no kernels); "
            f"{n_it} LM iterations in {wall_us / 1e3:.1f} ms")
        return
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
    log(f"[6] profile of {n_it} two-pass LM iterations: wall "
        f"{wall_us / 1e3:.2f} ms, device busy {busy / 1e3:.2f} ms "
        f"({100.0 * busy / wall_us:.1f}%), {len(kernels)} kernel launches, "
        f"{syncs} host syncs/copies, on {smi}")
    for name, (tot, cnt) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]:
        log(f"    {tot / 1e3:8.3f} ms {cnt:6d}x  {name[:100]}")


@contextmanager
def plain_routes(cgc, wc):
    """Route the five kernel wrappers to their plain versions (for the
    kernel-vs-plain LM step comparison only)."""
    with mock.patch.object(cgc, "project_grid_coords",
                           cgc.project_grid_coords_plain), \
         mock.patch.object(cgc, "project_blocks", cgc.project_blocks_plain), \
         mock.patch.object(wc, "window_apply_j", wc.window_apply_j_plain), \
         mock.patch.object(wc, "window_apply_jtw", wc.window_apply_jtw_plain), \
         mock.patch.object(wc, "window_block_diag",
                           wc.window_block_diag_plain):
        yield


if __name__ == "__main__":
    sys.exit(main())
