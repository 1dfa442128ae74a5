#!/usr/bin/env python3
"""Trace the NoncentralGeneric initialization step by step, to find where
two hosts part.

    python3 tools/trace_noncentral_init.py --out A.json [--views 20]
        [--seed 1] [--init_seed 2] [--board 25,19,0.015] [--size 1920,1080]
    python3 tools/trace_noncentral_init.py --compare A.json B.json

The first form builds ``problems.make_noncentral_calibration_dataset``
(by default the dataset of ``chip_smoke.py`` [9b]), writes it to
``dataset.bin`` beside ``--out`` and reads it back (the file keeps the
feature positions in float32), and runs
``init.noncentral_init.NoncentralDenseInitializer`` on what it read, as
``calibrate --dataset_files dataset.bin --model noncentral_generic --seed
<init_seed>`` does, on the CPU in float64.  It records, in call order, every step whose result the run
depends on: the square rasterizer's densified matches (``densify``), each
draw of the initializer's generator (``rng``), the Ramalingam–Sturm
candidates (``rs``), each L-BFGS-B polish of a bootstrap candidate
(``lbfgs``: start, end, cost, iterations), each mirror test
(``handedness``), each P3P seed (``p3p``) and each point-to-line refinement
(``refine``).  Arrays are recorded by a SHA-256 of their bytes, small ones
also by value.  It then records the result's quality against the
dataset's ground truth: per localized view, the rotation (degrees) and
translation (mm) error of its pose relative to the first localized view,
which the camera frame's gauge does not change.  With it go the versions
of Python, NumPy, SciPy, PyTorch and g++ and NumPy's SIMD extensions and
BLAS/LAPACK.

The second form walks two traces in step and prints the first event at
which they differ, what differs there (hash or value, with the largest
absolute difference), how many events differ after it, and both results.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import platform
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = 64  # arrays of at most this many numbers are recorded by value


def digest(a):
    a = np.ascontiguousarray(a)
    h = hashlib.sha256(str(a.dtype).encode() + str(a.shape).encode())
    h.update(a.tobytes())
    return h.hexdigest()[:16]


def describe(a):
    """An array (or a tuple of them) as a JSON-able record."""
    if a is None:
        return None
    if isinstance(a, (tuple, list)):
        return [describe(x) for x in a]
    if isinstance(a, dict):
        return {k: describe(v) for k, v in sorted(a.items())}
    if isinstance(a, (bool, np.bool_)):
        return bool(a)
    if isinstance(a, (int, float, np.integer, np.floating)):
        return float(a)
    a = np.asarray(a)
    if a.dtype == object:
        return str(a)
    rec = {"sha": digest(a), "shape": list(a.shape)}
    if a.size <= SMALL:
        rec["v"] = a.astype(np.float64).ravel().tolist()
    return rec


def environment():
    import scipy
    import torch

    env = {"python": sys.version.split()[0], "numpy": np.__version__,
           "scipy": scipy.__version__, "torch": torch.__version__,
           "machine": platform.machine()}
    try:
        cfg = np.show_config(mode="dicts")
        env["simd"] = cfg.get("SIMD Extensions")
        deps = cfg.get("Build Dependencies", {})
        env["blas"] = {k: {f: deps[k].get(f) for f in ("name", "version")}
                       for k in ("blas", "lapack") if k in deps}
    except (TypeError, AttributeError):
        env["simd"] = None
    try:
        import threadpoolctl

        env["threadpools"] = [
            {k: p.get(k) for k in ("internal_api", "version", "architecture")}
            for p in threadpoolctl.threadpool_info()]
    except ImportError:
        env["threadpools"] = "threadpoolctl not installed"
    try:
        env["g++"] = subprocess.run(
            ["g++", "--version"], capture_output=True, text=True,
            timeout=30).stdout.splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        env["g++"] = None
    return env


class RecordingGenerator:
    """A ``np.random.Generator`` that records every draw it hands out."""

    def __init__(self, rng, events):
        self._rng, self._events = rng, events

    def __getattr__(self, name):
        fn = getattr(self._rng, name)

        def call(*args, **kwargs):
            out = fn(*args, **kwargs)
            self._events.append({"what": "rng", "fn": name,
                                 "out": describe(out)})
            return out
        return call


def trace(args):
    sys.path.insert(0, ROOT)
    import scipy.optimize

    from camera_calibration_torch import problems
    from camera_calibration_torch.init import dense_init as di
    from camera_calibration_torch.init import noncentral_init as ni
    from camera_calibration_torch.io import dataset_bin

    w, h = (int(x) for x in args.size.split(","))
    nx, ny, cell = args.board.split(",")
    t0 = time.perf_counter()
    ds, _, truth = problems.make_noncentral_calibration_dataset(
        seed=args.seed, n_imagesets=args.views, w=w, h=h, nx=int(nx),
        ny=int(ny), cell=float(cell))
    out_dir = os.path.dirname(os.path.abspath(args.out))
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "dataset.bin")
    dataset_bin.save_dataset(path, ds)
    ds = dataset_bin.load_datasets(path)
    feats = np.concatenate([np.stack([f.xy for f in s.features[0]])
                            for s in ds.imagesets])
    events = []

    def wrap(owner, name, what, record):
        fn = getattr(owner, name)

        def wrapped(*a, **k):
            out = fn(*a, **k)
            events.append({"what": what, **record(a, k, out)})
            return out
        setattr(owner, name, wrapped)

    wrap(di, "densify_matches", "densify",
         lambda a, k, out: {"out": describe(out)})
    wrap(ni, "noncentral_planar_relative_pose", "rs",
         lambda a, k, out: {"in": describe(a[0]), "ok": bool(out["ok"]),
                            "out": describe([
                                [c[x] for x in ("r0", "t0", "r1", "t1")]
                                for c in out.get("candidates", [])])})
    wrap(scipy.optimize, "minimize", "lbfgs",
         lambda a, k, out: {"x0": describe(a[1]), "x": describe(out.x),
                            "fun": float(out.fun), "nit": int(out.nit),
                            "nfev": int(out.nfev), "status": int(out.status)})
    wrap(ni, "_field_handedness", "handedness",
         lambda a, k, out: {"out": float(out)})
    wrap(ni, "ransac_p3p", "p3p",
         lambda a, k, out: {"in": describe(a[:2]), "seed": k.get("seed"),
                            "out": describe(None if out is None
                                            else out[:2])})
    wrap(ni, "_refine_point_to_line", "refine",
         lambda a, k, out: {"in": describe(a[:2]), "out": describe(out)})

    init = ni.NoncentralDenseInitializer(
        ds, 0, di.DenseInitOptions(seed=args.init_seed))
    init.rng = RecordingGenerator(init.rng, events)
    res = init.run()
    seconds = time.perf_counter() - t0

    result = {"ok": res is not None}
    if res is not None:
        used = [i for i, u in enumerate(res.image_used) if u]

        def inv(r, t):
            return r.T, -r.T @ t

        def rel(poses, i, j):
            ri, ti = inv(*poses[i])
            rj, tj = poses[j]
            return ri @ rj, ri @ tj + ti

        rot, trans = [], []
        for i in used[1:]:
            ra, ta = rel(res.image_tr_global, used[0], i)
            rb, tb = rel(truth, used[0], i)
            c = np.clip((np.trace(ra.T @ rb) - 1) / 2, -1, 1)
            rot.append(float(np.degrees(np.arccos(c))))
            trans.append(float(1e3 * np.linalg.norm(ta - tb)))
        result.update(
            views_used=len(used), views=len(ds.imagesets),
            pixels_observed=int((res.point_count > 0).sum()),
            pose_rotation_error_deg={"median": float(np.median(rot)),
                                     "max": float(np.max(rot))},
            pose_translation_error_mm={"median": float(np.median(trans)),
                                       "max": float(np.max(trans))},
            point_sum=describe(res.point_sum))
    out = {"environment": environment(), "dataset": describe(feats),
           "seconds": seconds, "result": result, "events": events}
    with open(args.out, "w") as f:
        json.dump(out, f)
    print(json.dumps({"environment": out["environment"],
                      "dataset": out["dataset"]["sha"],
                      "events": len(events), "seconds": round(seconds, 2),
                      "result": {k: v for k, v in result.items()
                                 if k != "point_sum"}}, indent=1))
    return 0


def _diff(a, b, path=""):
    """(what differs, largest absolute difference of values) of two event
    records, or None when they are equal."""
    if isinstance(a, dict) and isinstance(b, dict):
        if a.keys() != b.keys():
            return path + " keys", None
        worst = None
        for k in a:
            d = _diff(a[k], b[k], f"{path}.{k}")
            if d is not None and (worst is None or (d[1] or 0) >= (worst[1] or 0)):
                worst = d
        return worst
    if isinstance(a, list) and isinstance(b, list):
        if len(a) != len(b):
            return path + " length", None
        if all(isinstance(x, (int, float)) for x in a + b):
            gap = max((abs(x - y) for x, y in zip(a, b)), default=0.0)
            return (path, gap) if gap > 0 else None
        worst = None
        for i, (x, y) in enumerate(zip(a, b)):
            d = _diff(x, y, f"{path}[{i}]")
            if d is not None and (worst is None or (d[1] or 0) >= (worst[1] or 0)):
                worst = d
        return worst
    if isinstance(a, float) and isinstance(b, float):
        return (path, abs(a - b)) if a != b else None
    return (path, None) if a != b else None


def compare(pa, pb):
    a, b = (json.load(open(p)) for p in (pa, pb))
    for name, t in (("A", a), ("B", b)):
        print(f"{name}: {json.dumps(t['environment'])}")
    print(f"dataset: {'same' if a['dataset'] == b['dataset'] else 'DIFFERS'}"
          f" ({a['dataset']['sha']} / {b['dataset']['sha']})")
    ea, eb = a["events"], b["events"]
    first, n_diff = None, 0
    for i, (x, y) in enumerate(zip(ea, eb)):
        d = _diff(x, y)
        if d is not None:
            n_diff += 1
            if first is None:
                first = (i, x, y, d)
    print(f"events: {len(ea)} / {len(eb)}; of the first "
          f"{min(len(ea), len(eb))}, {n_diff} differ")
    counts = {}
    for x in ea[:first[0] if first else len(ea)]:
        counts[x["what"]] = counts.get(x["what"], 0) + 1
    if first is None:
        print("no event differs")
    else:
        i, x, y, (where, gap) = first
        print(f"first difference: event {i} ({x['what']}), at {where}"
              + ("" if gap is None else f", largest |difference| {gap:.3e}"))
        print(f"  equal before it: {json.dumps(counts)}")
        print(f"  A: {json.dumps(x)[:600]}")
        print(f"  B: {json.dumps(y)[:600]}")
    for name, t in (("A", a), ("B", b)):
        r = {k: v for k, v in t["result"].items() if k != "point_sum"}
        print(f"{name} result: {json.dumps(r)}")
    return 0


def main():
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--out")
    p.add_argument("--compare", nargs=2, metavar=("A", "B"))
    p.add_argument("--views", type=int, default=20)
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--init_seed", type=int, default=2)
    p.add_argument("--board", default="25,19,0.015")
    p.add_argument("--size", default="1920,1080")
    args = p.parse_args()
    if args.compare:
        return compare(*args.compare)
    if not args.out:
        p.error("--out or --compare is needed")
    return trace(args)


if __name__ == "__main__":
    sys.exit(main())
