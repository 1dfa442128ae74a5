#!/usr/bin/env python3
"""The window reductions of this checkout against another checkout's, on one
NVIDIA card.

    python3 tools/compare_window_reductions.py --other DIR [--reps 100]

``DIR`` is another checkout of the repository (for example a commit
unpacked with ``git archive``).  The script loads
``camera_calibration_torch`` from both trees, builds both kernel libraries
(each into its own ``_build``), and runs ``window_apply_jtw`` and
``window_block_diag`` of both on the same inputs:

- the bench problem's ``j_win``, window bases and weights
  (``lm_pcg.compute_blocks`` on ``problems.make_bench_problem``: 262,144
  rows, 16×16 grid, K = 2);
- seeded random inputs with uniform window bases: 16×16 K = 2, 45×79 K = 2
  (the pipeline's default grid for a 1080p camera) and 16×16 K = 5, each
  with 262,144 observations.

For each case and op it prints whether the two trees' outputs are
bit-identical (``torch.equal``), each tree's error against a float64 plain
reference (max abs error over the largest reference value), and the time
per call of each tree, in turns (other, this, this, other), by two methods:
CUDA events around ``--reps`` calls from Python (``ms``, as
``chip_smoke.py`` times its ``ms``), and around one replay of a CUDA graph
of ``--reps`` calls (``graph_ms``: the host's per-call cost left out); with
the card's ``nvidia-smi`` name and power limit.  The last line is one JSON
object with every row.  It imports no JAX.

The window reductions are the repo's only kernels with more than one
design measured so far; the script is the parity and speed check for the
next change to ``csrc/window_reduce.cuh`` against the commit before it.
"""

from __future__ import annotations

import argparse
import importlib
import json
import os
import subprocess
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = "camera_calibration_torch"
N_RANDOM = 262_144


def load_tree(root):
    """``(_cuda, ba.window_cuda)`` of the package under ``root``, imported
    beside the one already loaded (``sys.modules`` is restored after)."""
    saved = {k: v for k, v in sys.modules.items()
             if k == PKG or k.startswith(PKG + ".")}
    for k in saved:
        del sys.modules[k]
    sys.path.insert(0, root)
    try:
        return (importlib.import_module(PKG + "._cuda"),
                importlib.import_module(PKG + ".ba.window_cuda"))
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


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--other", required=True,
                        help="another checkout of the repository")
    parser.add_argument("--reps", type=int, default=100)
    args = parser.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("compare_window_reductions: no CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    from camera_calibration_torch import _cuda, problems
    from camera_calibration_torch.ba import lm_pcg
    from camera_calibration_torch.ba import window_cuda as wc

    other_cuda, other_wc = load_tree(os.path.abspath(args.other))
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

    state, data, _ = problems.make_bench_problem(device=dev)
    options = lm_pcg.BAOptions(max_pcg_iterations=20, proj_iterations=4)
    blocks, _ = lm_pcg.compute_blocks(data, state, (data[0].pixel,), options)
    intr = blocks[0].intr
    gh, gw = state.intrinsics[0].grid.shape[:2]
    cases = [("bench", gh, gw, 2, intr.j_win, intr.base_xy, blocks[0].weight)]
    for hh, ww, k in ((16, 16, 2), (45, 79, 2), (16, 16, 5)):
        base = torch.as_tensor(
            np.stack([rng.integers(-3, ww, N_RANDOM),
                      rng.integers(-3, hh, N_RANDOM)], 1),
            dtype=torch.int32, device=dev)
        cases.append(("random", hh, ww, k,
                      f32(rng.normal(0, 1, (32 * k, N_RANDOM))), base,
                      f32(rng.uniform(0, 1, N_RANDOM))))

    rows = []
    for label, hh, ww, k, j_win, base, w in cases:
        ws = f32(rng.normal(0, 1, (j_win.shape[1], 2)))
        j64 = j_win.double()
        ops = (
            ("window_apply_jtw", ws, wc.window_apply_jtw_plain(
                j64, base, ws.double(), hh, ww, k)),
            ("window_block_diag", w, wc.window_block_diag_plain(
                j64, base, w.double(), hh, ww, k)),
        )
        for name, per_obs, ref in ops:
            mine = lambda: getattr(wc, name)(j_win, base, per_obs, hh, ww, k)  # noqa: E731
            theirs = lambda: getattr(other_wc, name)(  # noqa: E731
                j_win, base, per_obs, hh, ww, k)
            got, old = mine(), theirs()
            torch.cuda.synchronize()
            scale = float(ref.abs().max())
            times = {}
            for key, graph in (("ms", False), ("graph_ms", True)):
                t_other = [time_ms(torch, theirs, args.reps, graph)]
                t_this = [time_ms(torch, mine, args.reps, graph),
                          time_ms(torch, mine, args.reps, graph)]
                t_other.append(time_ms(torch, theirs, args.reps, graph))
                times[key + "_this"], times[key + "_other"] = t_this, t_other
            row = {
                "case": f"{label} {hh}x{ww} K={k}", "op": name,
                "n": int(j_win.shape[1]),
                "bit_identical": bool(torch.equal(got, old)),
                "max_abs_diff": float((got - old).abs().max()),
                "rel_err_this": float((got.double() - ref).abs().max()) / scale,
                "rel_err_other": float((old.double() - ref).abs().max()) / scale,
                **times,
            }
            rows.append(row)
            timing = "; ".join(
                f"{key} this {row[key + '_this'][0]:.4f} "
                f"{row[key + '_this'][1]:.4f}, other "
                f"{row[key + '_other'][0]:.4f} {row[key + '_other'][1]:.4f}"
                for key in ("ms", "graph_ms"))
            print(f"{row['case']} {name}: bit-identical {row['bit_identical']}"
                  f" (max |diff| {row['max_abs_diff']:.3e}); rel err this "
                  f"{row['rel_err_this']:.3e}, other {row['rel_err_other']:.3e};"
                  f" {timing} on {smi}", flush=True)
    print(json.dumps({"card": smi, "rows": rows}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
