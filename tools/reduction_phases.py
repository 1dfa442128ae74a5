#!/usr/bin/env python3
"""Where the time of the two window reductions goes, phase by phase, on
one NVIDIA card.

    python3 tools/reduction_phases.py --capture DIR
    python3 tools/reduction_phases.py [--tree DIR] [--windows DIR]
        [--reps 100] [--rounds 3] [--work DIR]

``--capture DIR`` runs the calibration pipeline of ``chip_smoke.py`` [7]
(100 views of a 24×24 board by a 1920×1080 pinhole camera) and the
NoncentralGeneric one of [9b], and saves the window inputs (``j_win``,
window bases, weights) of the first BA stage at each of [7]'s pyramid
grids (25×44, 34×59, 45×79, K = 2) and at [9b]'s final grid (45×79,
K = 5) into ``DIR`` (one ``.pt`` file each, ~40 MB in all).
``tools/compare_kernels.py --windows DIR`` reads the same files.

Otherwise the script splits the time of ``window_apply_jtw`` and
``window_block_diag`` of the checkout ``--tree`` (this one by default)
into phases.  No profiler that splits a kernel works on the card's
machine, so it builds variants of the tree's kernels, each with one more
phase taken out of ``csrc/window_reduce.cuh`` by a textual edit (a loop
bound set to 0, a launch or a store skipped), into copies under
``--work``, and times every variant on the same inputs by one CUDA-graph
replay of ``--reps`` calls, in ``--rounds`` rounds.  A phase's time is
the difference of two variants.  The edits name the source they expect:
the script recognises the tree's layout by its code and refuses a header
it has no edits for.  The inputs are ``tools/compare_kernels.py``'s
window cases (``window_cases``): the central and noncentral bench
problems, random 16×16 and 45×79 at K = 2 and 5, and ``--windows``.

Printed per case and kernel: each variant's graph ms (median and range)
and the phases, with the card's ``nvidia-smi`` name and power limit and
each variant's ``-Xptxas -v`` line for the partial-pass kernels.  The
last line is one JSON object.  It imports no JAX.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]
PKG = "camera_calibration_torch"
HEADER = "csrc/window_reduce.cuh"
KERNELS = ("window_apply_jtw", "window_block_diag")

# The two-pass layout of PR 3 (ballot masks, knot scan; bands since PR 5).
# Each edit is (name, old text, new text); a variant applies the edits of
# its list.
PR3_MARK = "__ballot_sync(\n            0xffffffffu, valid && static_cast<unsigned>(h0 + h - by)"
PR3_EDITS = {
    "sum": ("window_sum_kernel<Op><<<(cols + 31) / 32,",
            "if (cols < 0) window_sum_kernel<Op><<<(cols + 31) / 32,"),
    "write": ("for (int i = t; i < knots * R; i += NT) row[i] = acc[i];",
              "if (acc[t] == 1.2345e-30f) row[t] = acc[t];"),
    "visits": ("for (int knot = first_knot; knot < knots; knot += NT) {",
               "for (int knot = first_knot; knot < 0; knot += NT) {"),
    "row_masks": ("for (int h = 0; h < hb; ++h) {",
                  "for (int h = 0; h < 0; ++h) {"),
    "col_masks": ("for (int w = 0; w < gw; ++w) {",
                  "for (int w = 0; w < 0; ++w) {"),
    "prepare": ("for (int j = t - T; j < 16 * T; j += NT - T) {",
                "for (int j = t - T; j < 0; j += NT - T) {"),
}
PR3_VARIANTS = {
    "full": (),
    "no_sum": ("sum",),
    "no_write": ("sum", "write"),
    "no_visits": ("sum", "write", "visits"),
    "no_masks": ("sum", "write", "visits", "row_masks", "col_masks"),
    "no_prepare": ("sum", "write", "visits", "prepare"),
    "staging": ("sum", "write", "visits", "row_masks", "col_masks",
                "prepare"),
}
# phase: (variant with it, variant without it)
PR3_PHASES = {
    "sum pass": ("full", "no_sum"),
    "partial write": ("no_sum", "no_write"),
    "visits": ("no_write", "no_visits"),
    "masks (beside prepare)": ("no_visits", "no_masks"),
    "prepare (beside masks)": ("no_visits", "no_prepare"),
    "masks and prepare": ("no_visits", "staging"),
    "staging, zeroing, launch": ("staging", None),
}

# The layout of PR 12 (tiles through registers; knot owners on small
# grids, slot classes on larger ones; cluster reduction of the partial
# rows).
CLASS_MARK = "inline bool use_owners(int gh, int gw)"
CLASS_EDITS = {
    "sum": ("window_sum_kernel<Op><<<(cols + 31) / 32,",
            "if (cols < 0) window_sum_kernel<Op><<<(cols + 31) / 32,"),
    "write": ("if (i0 + u * kStep < total) row[i0 + u * kStep] = s[u];",
              "if (s[u] == 1.2345e-30f) row[i0 + u * kStep] = s[u];"),
    "class_visits": ("for (int q = 0; q < kObsBatches; ++q) {",
                     "for (int q = 0; q < 0; ++q) {"),
    "owner_visits": ("      if (own < hb * gw) {\n        const int kh",
                     "      if (own < 0) {\n        const int kh"),
    "row_masks": ("for (int h = 0; h < hb; ++h) {",
                  "for (int h = 0; h < 0; ++h) {"),
    "col_masks": ("for (int w = 0; w < gw; ++w) {",
                  "for (int w = 0; w < 0; ++w) {"),
    "loads": ("if (i + 1 < mine) load_tile(tile_start(i + 1));",
              "if (i + 1 < 0) load_tile(tile_start(i + 1));"),
}
_VISITS = ("sum", "write", "class_visits", "owner_visits")
CLASS_VARIANTS = {
    "full": (),
    "no_sum": ("sum",),
    "no_write": ("sum", "write"),
    "no_visits": _VISITS,
    "no_masks": _VISITS + ("row_masks", "col_masks"),
    "first_tile_only": _VISITS + ("row_masks", "col_masks", "loads"),
}
CLASS_PHASES = {
    "sum pass": ("full", "no_sum"),
    "cluster reduction and partial write": ("no_sum", "no_write"),
    "visits": ("no_write", "no_visits"),
    "masks (owner scheme)": ("no_visits", "no_masks"),
    "tile loads and stores past the first": ("no_masks", "first_tile_only"),
    "first tile, zeroing, launch": ("first_tile_only", None),
}

LAYOUTS = ((PR3_MARK, "PR 3 masks and knot scan", PR3_EDITS, PR3_VARIANTS,
            PR3_PHASES),
           (CLASS_MARK, "knot owners and slot classes", CLASS_EDITS,
            CLASS_VARIANTS, CLASS_PHASES))


def _compare_kernels():
    spec = importlib.util.spec_from_file_location(
        "compare_kernels", Path(__file__).with_name("compare_kernels.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def layout_of(header_text):
    """(name, edits, variants, phases) of the layout a header holds."""
    for mark, name, edits, variants, phases in LAYOUTS:
        if mark in header_text:
            return name, edits, variants, phases
    raise SystemExit(f"reduction_phases: no edits for this {HEADER}")


def apply_edits(text, edits, names):
    """``text`` with the named edits made; each old text must occur
    exactly once."""
    for name in names:
        old, new = edits[name]
        count = text.count(old)
        if count != 1:
            raise SystemExit(f"reduction_phases: edit {name!r} matches "
                             f"{count} times in {HEADER}")
        text = text.replace(old, new)
    return text


def make_variants(tree, work):
    """One copy of ``tree``'s package per variant under ``work``, its
    header edited; returns (layout name, {variant: root}, phases)."""
    src = Path(tree) / PKG
    text = (src / HEADER).read_text()
    name, edits, variants, phases = layout_of(text)
    roots = {}
    for variant, names in variants.items():
        root = Path(work) / variant
        shutil.rmtree(root, ignore_errors=True)
        shutil.copytree(src, root / PKG,
                        ignore=shutil.ignore_patterns("_build", "__pycache__"))
        (root / PKG / HEADER).write_text(apply_edits(text, edits, names))
        roots[variant] = str(root)
    return name, roots, phases


def capture(torch, directory):
    """Run [7]'s and [9b]'s pipelines through ``chip_smoke.py`` and save
    the window inputs of their grids' first BA stages."""
    sys.path.insert(0, str(REPO))
    import chip_smoke

    out = Path(directory)
    out.mkdir(parents=True, exist_ok=True)
    smi = chip_smoke.nvidia_smi_line()
    tag = {"value": "[7]"}

    def window(j_win, base, gh, gw, k, label, w=None, **_):
        grid = f"{gh}x{gw}"
        if tag["value"] == "[9b]" and grid != "45x79":
            return {}
        name = f"{'pipeline' if k == 2 else 'noncentral'}_{grid}_k{k}"
        torch.save({"label": f"{tag['value']} pipeline {grid}",
                    "gh": gh, "gw": gw, "k": k,
                    "j_win": j_win.detach().contiguous().cpu(),
                    "base_xy": base.detach().contiguous().cpu(),
                    "weight": w.detach().contiguous().cpu()},
                   out / f"{name}.pt")
        print(f"capture: {tag['value']} {grid} K={k}: {j_win.shape[1]} rows "
              f"-> {out / (name + '.pt')}", flush=True)
        return {}

    checks = {"window": window, "project": lambda *a, **k: 0.0,
              "blocks": lambda *a, **k: 0.0}
    chip_smoke.calibration_pipeline(torch, smi, chip_smoke.PIPELINE_IMAGESETS,
                                    checks)
    tag["value"] = "[9b]"
    chip_smoke.noncentral_pipeline(torch, smi, checks)
    return smi


def graph_ms(torch, fn, reps):
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(reps):
            fn()
    g.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    g.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def ptxas_lines(cuda_mod):
    """The ``-Xptxas -v`` lines of the reduction kernels of a built
    tree."""
    keep, lines = False, []
    for line in cuda_mod.build_log().splitlines():
        if line.startswith("=="):
            keep = "window_apply_jtw" in line or "window_block_diag" in line
            continue
        if keep and ("Used" in line or "spill" in line):
            lines.append(line.strip())
    return lines


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--capture", default=None,
                        help="run [7] and [9b] and save their window inputs "
                        "into this directory")
    parser.add_argument("--tree", default=str(REPO),
                        help="the checkout whose reductions are split")
    parser.add_argument("--windows", default=None,
                        help="window inputs saved by --capture")
    parser.add_argument("--work", default=None,
                        help="where the variant copies are built (default: "
                        "<this repo>/camera_calibration_torch/_build/phases)")
    parser.add_argument("--reps", type=int, default=100)
    parser.add_argument("--rounds", type=int, default=3)
    args = parser.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("reduction_phases: no CUDA card", file=sys.stderr)
        return 1
    if args.capture:
        t0 = time.perf_counter()
        capture(torch, args.capture)
        print(f"capture: done in {time.perf_counter() - t0:.1f} s",
              flush=True)
        return 0

    ck = _compare_kernels()
    sys.path.insert(0, str(REPO))
    work = Path(args.work or REPO / PKG / "_build" / "phases")
    layout, roots, phases = make_variants(args.tree, work)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        stdout=subprocess.PIPE, text=True, timeout=60).stdout.strip()
    trees = {}
    for variant, root in roots.items():
        cuda_mod, wc, _ = ck.load_tree(root)
        trees[variant] = wc
        t0 = time.perf_counter()
        cuda_mod.build()
        print(f"variant {variant}: built in {time.perf_counter() - t0:.1f} s; "
              + "; ".join(ptxas_lines(cuda_mod)), flush=True)
    print(f"card: {smi}; layout: {layout}; tree {args.tree}", flush=True)

    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    result = {"card": smi, "layout": layout, "rows": []}
    for label, hh, ww, k, j_win, base, w in ck.window_cases(torch, rng,
                                                            args.windows):
        ws = torch.as_tensor(rng.normal(0, 1, (j_win.shape[1], 2)),
                             dtype=torch.float32, device=dev)
        per_obs = {"window_apply_jtw": ws, "window_block_diag": w}
        for name in KERNELS:
            times = {v: [] for v in trees}
            for _ in range(args.rounds):
                for variant, wc in trees.items():
                    fn = (lambda wc=wc: getattr(wc, name)(
                        j_win, base, per_obs[name], hh, ww, k))
                    times[variant].append(graph_ms(torch, fn, args.reps))
            med = {v: statistics.median(t) for v, t in times.items()}
            split = {ph: med[a] - (med[b] if b else 0.0)
                     for ph, (a, b) in phases.items()}
            row = {"case": f"{label} {hh}x{ww} K={k}", "op": name,
                   "n": int(j_win.shape[1]), "graph_ms": times,
                   "phases_ms": split}
            result["rows"].append(row)
            print(f"{row['case']} {name} (N = {row['n']}): "
                  + ", ".join(f"{v} {med[v]:.4f} [{min(t):.4f}-{max(t):.4f}]"
                              for v, t in times.items())
                  + " | phases: "
                  + ", ".join(f"{ph} {ms:.4f}" for ph, ms in split.items())
                  + f" (graph ms) on {smi}", flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
