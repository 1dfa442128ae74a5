"""Runs one cell of ``BENCHMARK.json`` once and prints its result line.

Everything that belongs to one configuration, traffic mix, unit of work,
metric, work count or set of limits is a file of its own, found by name:

- ``BENCHMARK.json`` names the cell's configuration (its ``file``) and its
  traffic;
- ``calib_bench/traffic/<traffic>.json``: the mix's parameters, and the
  ``unit`` that runs them: ``calib_bench/units/<unit>.py``, whose
  ``setup(config, mix, seed, device)`` returns a job with ``warm()``,
  ``unit()``, ``stats(first)``, ``shapes()``, ``release()``,
  ``compare(draw)`` and ``use_control()``;
- ``calib_bench/metrics/<metric>.py``: ``read(run)`` returns the metric's
  value, or None where the run has nothing to read;
- ``calib_bench/work/<kernel>.py``: ``work(...)`` returns a call's (bytes,
  FLOP);
- ``calib_bench/limits/<cell>.json``: the upper limit of each number the
  check compares.

A run: set-up (the process's start to the first timed unit: torch and the
card, the kernel library from the checkout's build directory, the problem
made on the card from the seed, one short warm unit), then whole units back
to back until ``seconds`` have passed (the window closes at the end of the
unit in progress), then the metrics, then the check against the plain
reference, then the result line.

A run with ``trace`` reports the per-layer metrics.  Its first window runs
as an untraced run's does, and the metrics whose ``source`` is not
``device_trace`` (host clock, program counters) are read from it; a second
window of the same length follows under the benchmark's profiler, and the
``device_trace`` metrics, ``busy_s``, ``window_s`` and the ``breakdown``
are read from that one.
"""

from __future__ import annotations

import collections
import importlib
import importlib.util
import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "camera_calibration_tpu")


class Refused(Exception):
    """A run that must print no result (exit code 2)."""


def load_spec():
    path = ROOT / "BENCHMARK.json"
    if not path.exists():
        raise Refused(f"{path} not found")
    return json.loads(path.read_text())


def find(items, name, what):
    for item in items:
        if item["name"] == name:
            return item
    raise Refused(f"no {what} named {name!r} in BENCHMARK.json")


def load_file_module(path):
    """A module from a file whose name may hold dots (a metric's name)."""
    path = Path(path)
    if not path.exists():
        raise Refused(f"{path} not found")
    spec = importlib.util.spec_from_file_location(
        "calib_bench_file_" + path.stem.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_cell(cell, config_path=None):
    """(spec, workload entry, configuration, traffic mix, unit module) of
    ``cell``, found by the names in BENCHMARK.json."""
    spec = load_spec()
    work = find(spec["workloads"], cell, "workload")
    cfg_entry = find(spec["configs"], work["config"], "configuration")
    cfg = json.loads(Path(config_path or ROOT / cfg_entry["file"])
                     .read_text())
    mix = json.loads((BENCH / "traffic" / f"{work['traffic']}.json")
                     .read_text())
    units = importlib.import_module(f"calib_bench.units.{mix['unit']}")
    return spec, work, cfg, mix, units


def card(work):
    """The first card, where there are as many as the cell asks for."""
    import torch

    if not torch.cuda.is_available():
        raise Refused("no CUDA device: the benchmark runs on the card")
    if torch.cuda.device_count() < int(work["chips"]):
        raise Refused(f"the cell needs {work['chips']} cards, "
                      f"{torch.cuda.device_count()} present")
    return torch.device("cuda", 0)


def metric_names(spec, cell):
    """(end-to-end metrics, per-layer metrics) the cell reports."""
    e2e = [m for m in spec["end_to_end"]
           if cell in m.get("workloads", [cell])]
    names = {m["name"] for m in e2e}
    layer = [m for m in spec["per_layer"]
             if (cell in m["workloads"] if "workloads" in m
                 else m["moves"] in names)]
    return e2e, layer


class Run:
    """What a metric's reader reads."""

    def __init__(self, setup_s, window_s, stats, shapes, launches, trace):
        self.setup_s = setup_s
        self.window_s = window_s
        self.stats = stats
        self.shapes = shapes
        self.launches = launches
        self.trace = trace

    @staticmethod
    def work(kernel):
        return load_file_module(BENCH / "work" / f"{kernel}.py").work


def process_age_s():
    """Seconds since this process started (from the kernel's record of
    its start, in clock ticks since boot)."""
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        start = int(fields[19]) / os.sysconf("SC_CLK_TCK")
        return time.clock_gettime(time.CLOCK_BOOTTIME) - start
    except (OSError, ValueError, IndexError):
        return None


def card_line():
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], stdout=subprocess.PIPE,
            stderr=subprocess.DEVNULL, text=True, timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unknown"


def forbidden_modules():
    return sorted({n.split(".")[0] for n in list(sys.modules)}
                  & set(FORBIDDEN))


def run_cell(cell, seed, seconds, trace, *, device=None, t0=None,
             config_path=None):
    """One run of ``cell``; returns (result dict, check lines).  Without
    ``device`` it runs on the card and refuses to run without one; a test
    passes the CPU and, with ``config_path``, a tiny configuration."""
    import torch

    t0 = time.perf_counter() if t0 is None else t0
    spec, work, cfg, mix, units = load_cell(cell, config_path)
    limits = json.loads((BENCH / "limits" / f"{cell}.json").read_text())
    e2e, layer = metric_names(spec, cell)
    readers = {m["name"]: load_file_module(BENCH / "metrics"
                                           / f"{m['name']}.py")
               for m in (layer if trace else e2e)}
    device = card(work) if device is None else torch.device(device)
    cuda = device.type == "cuda"
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_num_threads(1)  # the host only dispatches: one steady thread
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    from camera_calibration_torch import _cuda

    phases = [("start", time.perf_counter())]
    if cuda:
        _cuda.lib()  # the kernel library: built on a checkout's first run
    phases.append(("card and kernel library", time.perf_counter()))
    job = units.setup(cfg, mix, seed, device)
    sync()
    phases.append(("problem", time.perf_counter()))
    job.warm()
    sync()
    phases.append(("warm unit", time.perf_counter()))

    from calib_bench import trace as tr

    def window(profiler=None):
        """Whole units back to back until ``seconds`` have passed: the
        window's (start, Run), the Run with its trace under ``profiler``."""
        nonlocal setup_s
        first = job.stats()["units"]
        before = collections.Counter(_cuda.launches)
        if profiler is not None:
            profiler.start()
        t_start = time.perf_counter()
        if setup_s is None:
            setup_s = t_start - t0
        while True:
            job.unit()
            sync()
            if time.perf_counter() - t_start >= seconds:
                break
        window_s = time.perf_counter() - t_start
        events = profiler.stop() if profiler is not None else None
        launches = collections.Counter(_cuda.launches)
        launches.subtract(before)
        return Run(setup_s, window_s, job.stats(first), job.shapes(),
                   launches, None if events is None
                   else tr.summarize(events, window_s))

    setup_s = None
    runs = [window()]
    if trace:
        runs.append(window(tr.Profiler() if cuda else None))
    peak = int(torch.cuda.max_memory_allocated(device)) if cuda else 0

    metrics = {}
    about = {m["name"]: m for m in spec["end_to_end"] + spec["per_layer"]}
    for name, reader in readers.items():
        run = runs[-1] if about[name]["source"] == "device_trace" else runs[0]
        value = reader.read(run)
        if value is not None:
            metrics[name] = {"value": value, "unit": about[name]["unit"]}
    summary = runs[-1].trace

    job.release()
    if cuda:
        torch.cuda.empty_cache()
    gen = torch.Generator().manual_seed(int(seed) & ((1 << 63) - 1))

    def draw(n, k):
        return sorted(torch.randperm(n, generator=gen)[:k].tolist())

    t_check = time.perf_counter()
    numbers, notes = job.compare(draw)
    t_check = time.perf_counter() - t_check
    checks = {}
    correct = True
    for name, value in numbers.items():
        limit = limits[name]
        ok = math.isfinite(value) and value <= limit
        correct = correct and ok
        checks[name] = {"value": value, "limit": limit}
    device_info = {
        "platform": "gpu" if cuda else device.type,
        "kind": torch.cuda.get_device_name(device) if cuda else device.type,
        "count": 1, "memory_peak_bytes": peak}
    if summary is not None:
        device_info["busy_s"] = summary["busy_s"]
        device_info["window_s"] = summary["window_s"]
    # a unit that fails raises, and the run prints no result
    result = {"correct": bool(correct),
              "attempted": sum(r.stats["units"] for r in runs),
              "failed": 0, "metrics": metrics, "device": device_info}
    if summary is not None:
        result["breakdown"] = summary["breakdown"]
    result["card"] = card_line() if cuda else "none"
    result["checks"] = checks
    lines = [f"set-up: {name} {b - a:.3f} s" for (_, a), (name, b)
             in zip(phases, phases[1:])]
    lines.append(f"set-up: before the harness (Python, torch, the port's "
                 f"imports) {phases[0][1] - t0:.3f} s")
    for run, kind in zip(runs, ("window", "traced window")):
        counts = {k: v for k, v in run.stats.items() if k != "units"}
        lines.append(f"{kind}: {run.stats['units']} units in "
                     f"{run.window_s:.3f} s ({json.dumps(counts)})")
    lines.append(f"check {t_check:.3f} s")
    lines += notes + [f"check {n}: {c['value']!r} (limit {c['limit']!r})"
                      for n, c in checks.items()]
    return result, lines


def main(argv=None, t0=None):
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    age = process_age_s()
    if age is not None:
        t0 = time.perf_counter() - age
    try:
        result, lines = run_cell(args.workload, args.seed, args.seconds,
                                 bool(args.trace), t0=t0)
    except Refused as e:
        print(f"calib_bench: {e}", file=sys.stderr)
        return 2
    found = forbidden_modules()
    if found:
        print(f"calib_bench: the run loaded {', '.join(found)}",
              file=sys.stderr)
        return 3
    sys.stdout.flush()
    print(json.dumps(result), flush=True)
    for line in lines:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    return 0
