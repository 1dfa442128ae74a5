#!/usr/bin/env python3
"""The kernels of this checkout against another checkout's, on one NVIDIA
card.

    python3 tools/compare_kernels.py --other DIR [--kernels NAME,...]
        [--windows DIR] [--reps 100] [--rounds 3]

``DIR`` is another checkout of the repository (for example a commit
unpacked with ``git archive``).  The script loads
``camera_calibration_torch`` from both trees, builds both kernel libraries
(each into its own ``_build``), and runs the chosen kernels of both on the
same inputs.  ``--kernels`` picks among ``window_apply_jtw`` and
``window_block_diag`` (the window reductions) and ``project`` and
``project_blocks`` (the projections); all four by default.

- Window reductions: the bench problem's ``j_win``, window bases and
  weights (``lm_pcg.compute_blocks`` on ``problems.make_bench_problem``:
  262,144 rows, 16×16 grid, K = 2) and the NoncentralGeneric twin's
  (``make_noncentral_bench_problem``, K = 5); seeded random inputs with
  uniform window bases at 16×16 K = 2, 45×79 K = 2 and K = 5 (the
  pipeline's default grid for a 1080p camera), 16×16 K = 5 and 21×28
  K = 2 and 5, 262,144 observations each; and, with ``--windows DIR``, every window input
  saved there by ``tools/reduction_phases.py --capture DIR`` (the
  pipelines' own ``j_win`` at their pyramid grids).  Printed: whether the
  trees' outputs are bit-identical (``torch.equal``) and each tree's error
  against a float64 plain reference (max abs error over the largest
  reference value); beside JᵀW·s, the time of torch.sparse CSR's
  J_intrᵀ(W·s) on the same inputs (``chip_smoke.sparse_intrinsics_jacobian``,
  the library yardstick of ``chip_smoke.py`` [5]).
- Projections: the bench problem's directions and warm starts (16×16, 4 LM
  iterations), and 262,144 random pixels of a 640×480 pinhole camera on a
  21×28 grid and of a 1920×1080 one on the 45×79 grid, warm starts 2 px
  off (4 iterations).  Printed: valid-mask flips and max |Δpx| on points
  valid in both, between the trees and of each tree against the plain
  version; for ``project_blocks``, the relative error (max abs error over
  the largest value) of ``p_px`` and ``j_win`` on points valid in both with
  the same window base.  Then the SASS of both trees' projection kernels
  (``cuobjdump -sass`` of the built ``project.o``): instructions, MUFU,
  FCHK, CALL and shared-memory loads, of each whole kernel and of its
  longest innermost loop (the LM loop).

Every row also times both trees in ``--rounds`` turns of other, this,
this, other, by three methods: CUDA events around ``--reps`` calls from
Python (``ms``, as ``chip_smoke.py`` times its ``ms``); around one replay of
a CUDA graph of ``--reps`` calls (``graph_ms``: the host's per-call cost
left out); and the host's clock around ``--reps`` calls that are not waited
for (``host_us``: what the host spends per call, which bounds ``ms`` from
below).  It prints the median and range of each, with the card's
``nvidia-smi`` name and power limit.  The last line is one JSON object
with every row.  It imports no JAX.
"""

from __future__ import annotations

import argparse
import collections
import importlib
import json
import os
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = "camera_calibration_torch"
N_RANDOM = 262_144
WINDOW_KERNELS = ("window_apply_jtw", "window_block_diag")
PROJECTION_KERNELS = ("project", "project_blocks")
PROJ_ITERATIONS = 4


def load_tree(root):
    """``(_cuda, ba.window_cuda, models.central_generic_cuda)`` of the
    package under ``root``, imported beside the one already loaded
    (``sys.modules`` is restored after)."""
    saved = {k: v for k, v in sys.modules.items()
             if k == PKG or k.startswith(PKG + ".")}
    for k in saved:
        del sys.modules[k]
    sys.path.insert(0, root)
    try:
        return (importlib.import_module(PKG + "._cuda"),
                importlib.import_module(PKG + ".ba.window_cuda"),
                importlib.import_module(PKG + ".models.central_generic_cuda"))
    finally:
        sys.path.remove(root)
        for k in [k for k in sys.modules
                  if k == PKG or k.startswith(PKG + ".")]:
            del sys.modules[k]
        sys.modules.update(saved)


def time_ms(torch, fn, reps, graph):
    """Mean milliseconds per call: CUDA events around ``reps`` calls from
    Python, or with ``graph`` around one replay of a CUDA graph holding
    ``reps`` calls (the host's per-call cost left out)."""
    for _ in range(3):
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


def host_us(torch, fn, reps):
    """Microseconds of host time per call of ``fn`` (perf_counter around
    ``reps`` calls that are not waited for): what the host spends to
    enqueue one call."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / reps * 1e6


def times_in_turns(torch, mine, theirs, reps, rounds):
    """Every method, each in ``rounds`` turns of other, this, this, other:
    events (``ms``), graph replay (``graph_ms``) and the host's time per
    call (``host_us``)."""
    times = {}
    methods = (("ms", lambda f: time_ms(torch, f, reps, False)),
               ("graph_ms", lambda f: time_ms(torch, f, reps, True)),
               ("host_us", lambda f: host_us(torch, f, reps)))
    for key, timed in methods:
        t_this, t_other = [], []
        for _ in range(rounds):
            t_other.append(timed(theirs))
            t_this += [timed(mine), timed(mine)]
            t_other.append(timed(theirs))
        times[key + "_this"], times[key + "_other"] = t_this, t_other
    return times


def timing_text(row):
    def side(values):
        return (f"{statistics.median(values):.4f} "
                f"[{min(values):.4f}-{max(values):.4f}]")
    return "; ".join(
        f"{key} this {side(row[key + '_this'])}, other "
        f"{side(row[key + '_other'])}"
        for key in ("ms", "graph_ms", "host_us"))


# ----------------------------------------------------------------- SASS

_INSTR = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;")
_BRA_TARGET = re.compile(r"\bBRA(?:\.\S+)?\s+(?:\S+,\s*)?(0x[0-9a-f]+)")


def parse_sass(text):
    """``{function name: [(address, instruction text), ...]}`` from the
    output of ``cuobjdump -sass``."""
    functions, current = {}, None
    for line in text.splitlines():
        m = re.search(r"Function\s*:\s*(\S+)", line)
        if m:
            current = functions.setdefault(m.group(1), [])
            continue
        m = _INSTR.search(line)
        if m and current is not None:
            current.append((int(m.group(1), 16), m.group(2)))
    return functions


def _opcode(text):
    return next(t for t in text.split() if not t.startswith("@"))


def sass_counts(instructions):
    """Counts of one run of instructions: all but NOP, MUFU, FCHK, CALL,
    LDS (and LDS.128 of them)."""
    ops = [_opcode(t) for _, t in instructions]
    ops = [o for o in ops if o != "NOP"]
    base = collections.Counter(o.split(".")[0] for o in ops)
    return {"instructions": len(ops), "MUFU": base["MUFU"],
            "FCHK": base["FCHK"], "CALL": base["CALL"], "LDS": base["LDS"],
            "LDS.128": sum(1 for o in ops if o.startswith("LDS.128"))}


def innermost_loop(instructions):
    """The instructions of the longest innermost loop (the range from a
    backward branch's target to the branch, holding no other such range),
    or [] if the function has no loop."""
    loops = []
    for pc, text in instructions:
        m = _BRA_TARGET.search(text)
        if m and int(m.group(1), 16) < pc:
            loops.append((int(m.group(1), 16), pc))
    inner = [(a, b) for a, b in loops
             if not any(a <= c and d <= b and (c, d) != (a, b)
                        for c, d in loops)]
    if not inner:
        return []
    a, b = max(inner, key=lambda r: r[1] - r[0])
    return [(pc, t) for pc, t in instructions if a <= pc <= b]


def projection_sass(cuda_mod):
    """Per projection kernel of a built tree: counts of the whole kernel and
    of its LM loop."""
    cuobjdump = str(Path(cuda_mod.nvcc_path()).with_name("cuobjdump"))
    obj = cuda_mod.build() / "project.o"
    out = subprocess.run([cuobjdump, "-sass", str(obj)],
                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                         text=True, timeout=300).stdout
    rows = {}
    for name, instrs in parse_sass(out).items():
        if "project_kernel" not in name:
            continue
        m = re.search(r"project_kernelI((?:L[bi]\d+E)+)E", name)
        args = re.findall(r"L([bi])(\d+)E", m.group(1)) if m else []
        label = ("project_kernel<" + ", ".join(
            ("true" if v == "1" else "false") if t == "b" else v
            for t, v in args) + ">" if m else name)
        rows[label] = {"kernel": sass_counts(instrs),
                       "loop": sass_counts(innermost_loop(instrs))}
    return rows


# ------------------------------------------------------------ the cases


def load_windows(torch, directory):
    """The window inputs saved by ``tools/reduction_phases.py --capture``:
    ``(label, gh, gw, k, j_win, base_xy, weight)`` per ``*.pt`` file, on
    the card, in name order."""
    dev = torch.device("cuda")
    cases = []
    for path in sorted(Path(directory).glob("*.pt")):
        d = torch.load(path, map_location=dev)
        cases.append((d["label"], d["gh"], d["gw"], d["k"], d["j_win"],
                      d["base_xy"], d["weight"]))
    return cases


def window_cases(torch, rng, windows=None):
    """The window reductions' inputs, ``(label, gh, gw, k, j_win, base_xy,
    weight)``: the central and noncentral bench problems' own, seeded
    random ones at 16×16, 45×79 and 21×28 for K = 2 and 5 (16×16 K = 2
    first), and those saved under ``windows``."""
    from camera_calibration_torch import problems
    from camera_calibration_torch.ba import lm_pcg

    dev = torch.device("cuda")

    def f32(a):
        return torch.as_tensor(a, dtype=torch.float32, device=dev)

    options = lm_pcg.BAOptions(max_pcg_iterations=20, proj_iterations=4)
    cases = []
    for label, make, k in (
            ("bench", problems.make_bench_problem, 2),
            ("noncentral bench", problems.make_noncentral_bench_problem, 5)):
        state, data, _ = make(device=dev)
        blocks, _ = lm_pcg.compute_blocks(data, state, (data[0].pixel,),
                                          options)
        model = state.intrinsics[0]
        grid = model.grid if hasattr(model, "grid") else model.direction_grid
        cases.append((label, *grid.shape[:2], k, blocks[0].intr.j_win,
                      blocks[0].intr.base_xy, blocks[0].weight))
    for hh, ww, k in ((16, 16, 2), (45, 79, 2), (16, 16, 5), (45, 79, 5),
                      (21, 28, 2), (21, 28, 5)):
        base = torch.as_tensor(
            np.stack([rng.integers(-3, ww, N_RANDOM),
                      rng.integers(-3, hh, N_RANDOM)], 1),
            dtype=torch.int32, device=dev)
        cases.append(("random", hh, ww, k,
                      f32(rng.normal(0, 1, (32 * k, N_RANDOM))), base,
                      f32(rng.uniform(0, 1, N_RANDOM))))
    if windows:
        cases += load_windows(torch, windows)
    return cases


def window_rows(torch, args, wc, other_wc, smi, f32, rng, names):
    sys.path.insert(0, REPO)
    from chip_smoke import sparse_intrinsics_jacobian

    cases = window_cases(torch, rng, args.windows)
    rows = []
    for label, hh, ww, k, j_win, base, w in cases:
        ws = f32(rng.normal(0, 1, (j_win.shape[1], 2)))
        j64 = j_win.double()
        refs = {
            "window_apply_jtw": (ws, lambda: wc.window_apply_jtw_plain(
                j64, base, ws.double(), hh, ww, k)),
            "window_block_diag": (w, lambda: wc.window_block_diag_plain(
                j64, base, w.double(), hh, ww, k)),
        }
        for name in names:
            per_obs, plain = refs[name]
            ref = plain()
            mine = lambda: getattr(wc, name)(j_win, base, per_obs, hh, ww, k)  # noqa: E731
            theirs = lambda: getattr(other_wc, name)(  # noqa: E731
                j_win, base, per_obs, hh, ww, k)
            got, old = mine(), theirs()
            torch.cuda.synchronize()
            scale = float(ref.abs().max())
            row = {
                "case": f"{label} {hh}x{ww} K={k}", "op": name,
                "n": int(j_win.shape[1]),
                "bit_identical": bool(torch.equal(got, old)),
                "max_abs_diff": float((got - old).abs().max()),
                "rel_err_this": float((got.double() - ref).abs().max()) / scale,
                "rel_err_other": float((old.double() - ref).abs().max()) / scale,
                **times_in_turns(torch, mine, theirs, args.reps,
                                 args.rounds),
            }
            lib_txt = ""
            if name == "window_apply_jtw":
                # the library yardstick: torch.sparse CSR J_intr^T (the
                # build is not timed), once a round beside the turns
                _, jt = sparse_intrinsics_jacobian(torch, j_win, base, hh, ww,
                                                   k)
                lib = lambda: jt @ ws.reshape(-1, 1)  # noqa: E731
                row["library_rel_err"] = _rel(
                    lib().double().reshape(ref.shape), ref)
                for key, graph in (("library_ms", False),
                                   ("library_graph_ms", True)):
                    row[key] = [time_ms(torch, lib, args.reps, graph)
                                for _ in range(args.rounds)]
                lib_txt = (f"; torch.sparse CSR ms "
                           f"{statistics.median(row['library_ms']):.4f}, "
                           f"graph_ms "
                           f"{statistics.median(row['library_graph_ms']):.4f}"
                           f" (rel err {row['library_rel_err']:.3e})")
            rows.append(row)
            print(f"{row['case']} {name}: bit-identical {row['bit_identical']}"
                  f" (max |diff| {row['max_abs_diff']:.3e}); rel err this "
                  f"{row['rel_err_this']:.3e}, other {row['rel_err_other']:.3e};"
                  f" {timing_text(row)}{lib_txt} on {smi}", flush=True)
    return rows


def _rel(got, ref):
    if ref.numel() == 0:
        return 0.0
    return float((got - ref).abs().max()) / max(float(ref.abs().max()), 1e-30)


def projection_rows(torch, args, cgc, other_cgc, smi, rng, names):
    from camera_calibration_torch import problems
    from camera_calibration_torch.models import central_generic as cg
    from camera_calibration_torch.ops import manifolds

    dev = torch.device("cuda")
    state, data, _ = problems.make_bench_problem(device=dev)
    bench = state.intrinsics[0]
    cases = [("bench 16x16", bench,
              *problems.bench_projection_inputs(state, data[0]))]
    for w, h, gw, gh in ((640, 480, 28, 21), (1920, 1080, 79, 45)):
        model = problems.pinhole_model(w, h, gw, gh, device=dev)
        cases.append((f"{w}x{h} {gh}x{gw}", model,
                       *problems.pinhole_projection_inputs(model, N_RANDOM,
                                                           rng)))
    eps = cg.default_eps(torch.float32)
    rows = []
    for label, model, dirs, g0 in cases:
        lo, hi = cg._static_clamp_bounds(model)
        sx, sy = cg.pixel_scale_to_grid_scale(model)
        t1, t2 = (t.contiguous()
                  for t in manifolds.direction_tangents(model.grid))
        gh, gw = model.grid.shape[:2]
        for name in names:
            if name == "project":
                args_ = (model.grid, dirs, g0, lo, hi, PROJ_ITERATIONS, eps)
                fn = "project_grid_coords"
            else:
                args_ = (model.grid, t1, t2, dirs, g0, lo, hi,
                         (1 / sx, 1 / sy), PROJ_ITERATIONS, eps)
                fn = "project_blocks"
            mine = lambda: getattr(cgc, fn)(*args_)  # noqa: E731
            theirs = lambda: getattr(other_cgc, fn)(*args_)  # noqa: E731
            out = {"this": mine(), "other": theirs(),
                   "plain": getattr(cgc, fn + "_plain")(*args_)}
            torch.cuda.synchronize()
            valid = {k: v[1] < 1e4 * eps for k, v in out.items()}

            def compare(a, b):
                both = valid[a] & valid[b]
                dg = (out[a][0] - out[b][0])[both].abs()
                px = (max(float(dg[:, 0].max()) / sx,
                          float(dg[:, 1].max()) / sy) if dg.numel() else 0.0)
                res = {"flips": int((valid[a] != valid[b]).sum()),
                       "max_dpx": px}
                if name == "project_blocks":
                    same = both & (out[a][4] == out[b][4]).all(dim=1)
                    res["p_px_rel"] = _rel(out[a][2][same], out[b][2][same])
                    res["j_win_rel"] = _rel(out[a][3][:, same],
                                            out[b][3][:, same])
                return res

            row = {"case": label, "op": name, "n": int(dirs.shape[0]),
                   "grid": [int(gh), int(gw)],
                   "this_vs_other": compare("this", "other"),
                   "this_vs_plain": compare("this", "plain"),
                   "other_vs_plain": compare("other", "plain"),
                   **times_in_turns(torch, mine, theirs, args.reps,
                                    args.rounds)}
            rows.append(row)
            cmp = "; ".join(
                f"{key} " + ", ".join(
                    f"{k} {v:.3e}" if isinstance(v, float) else f"{k} {v}"
                    for k, v in row[key].items())
                for key in ("this_vs_other", "this_vs_plain",
                            "other_vs_plain"))
            print(f"{label} {name}: {cmp}; "
                  f"{timing_text(row)} on {smi}", flush=True)
    return rows


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--other", required=True,
                        help="another checkout of the repository")
    parser.add_argument("--kernels",
                        default=",".join(WINDOW_KERNELS + PROJECTION_KERNELS),
                        help="comma-separated kernels to compare")
    parser.add_argument("--windows", default=None,
                        help="a directory of window inputs saved by "
                        "tools/reduction_phases.py --capture")
    parser.add_argument("--reps", type=int, default=100)
    parser.add_argument("--rounds", type=int, default=3,
                        help="turns of other, this, this, other per method")
    args = parser.parse_args()
    names = [k for k in args.kernels.split(",") if k]
    unknown = set(names) - set(WINDOW_KERNELS + PROJECTION_KERNELS)
    if unknown:
        parser.error(f"unknown kernels {sorted(unknown)}")

    import torch

    if not torch.cuda.is_available():
        print("compare_kernels: no CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    from camera_calibration_torch import _cuda
    from camera_calibration_torch.ba import window_cuda as wc
    from camera_calibration_torch.models import central_generic_cuda as cgc

    other_cuda, other_wc, other_cgc = load_tree(os.path.abspath(args.other))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        stdout=subprocess.PIPE, text=True, timeout=60).stdout.strip()
    _cuda.build()
    other_cuda.build()
    print(f"card: {smi}; this tree {_cuda.source_hash()}, other tree "
          f"{other_cuda.source_hash()}", flush=True)

    dev = torch.device("cuda")
    rng = np.random.default_rng(0)

    def f32(a):
        return torch.as_tensor(a, dtype=torch.float32, device=dev)

    result = {"card": smi, "rows": []}
    win = [k for k in names if k in WINDOW_KERNELS]
    proj = [k for k in names if k in PROJECTION_KERNELS]
    if win:
        result["rows"] += window_rows(torch, args, wc, other_wc, smi, f32,
                                      rng, win)
    if proj:
        result["rows"] += projection_rows(torch, args, cgc, other_cgc, smi,
                                          rng, proj)
        result["sass"] = {"this": projection_sass(_cuda),
                          "other": projection_sass(other_cuda)}
        for tree, kernels in result["sass"].items():
            for kernel, counts in sorted(kernels.items()):
                print(f"sass {tree} {kernel}: kernel {counts['kernel']}; "
                      f"LM loop {counts['loop']}", flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
