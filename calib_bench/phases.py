"""Where a cell's LM solves spend their time, by the program's spans.

    python3 calib_bench/phases.py --workload <cell> --seed <n> \
        --seconds <s> [--out phases.json]

On the card, after the cell's set-up and warm unit, two windows of whole
units, each ``--seconds`` long:

1. untraced, spans off (as the benchmark's untraced window): LM
   iterations, ``lm_iter_ms``, and the program's host reads by site
   (``tracing.counters()``) per LM iteration;
2. under the benchmark's profiler (``trace.Profiler``) with the program's
   spans on: ``device_idle.ba``, syncs and launches per LM iteration as the
   benchmark's traced window reads them, and the trace joined with the
   spans (``calib_bench/spans.py``): device time, idle time and syncs by
   span, the per-phase metrics, the longest idle gaps named by the span
   open in them, and the share of the card's busy time inside the solves
   that a span under ``ba.solve`` launched.

The profiler starts once a process, as in the benchmark: started a second
time in the same process it runs slower.

Prints one line per span name and per host-read site on standard error and
the whole result as one JSON line on standard output (and in ``--out``).
It needs a program with ``camera_calibration_torch/tracing.py``.
"""

import argparse
import collections
import json
import sys
import time
from pathlib import Path

if __name__ == "__main__":
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from calib_bench import harness  # noqa: E402
from calib_bench import spans as sp  # noqa: E402
from calib_bench import trace as tr  # noqa: E402


def phases(cell, seed, seconds, device=None, config_path=None):
    """The two windows' readings of ``cell`` (see the module's text)."""
    import torch

    from camera_calibration_torch import _cuda, tracing

    _spec, work, cfg, mix, units = harness.load_cell(cell, config_path)
    device = harness.card(work) if device is None else torch.device(device)
    cuda = device.type == "cuda"
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_num_threads(1)
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    if cuda:
        _cuda.lib()
    job = units.setup(cfg, mix, seed, device)
    job.warm()
    sync()

    def window(profiler=None, spans=False):
        first = job.stats()["units"]
        before = tracing.counters()
        if spans:
            tracing.enable()
        if profiler is not None:
            profiler.start()
        t0 = time.perf_counter()
        while True:
            job.unit()
            sync()
            if time.perf_counter() - t0 >= seconds:
                break
        window_s = time.perf_counter() - t0
        events = profiler.stop() if profiler is not None else None
        tracing.disable()
        after = tracing.counters()
        counts = {k: dict(after[k] - before[k]) for k in after}
        return (job.stats(first), window_s, counts, events,
                tracing.take() if spans else [])

    out = {"cell": cell, "seed": seed, "card": harness.card_line()
           if cuda else "none"}
    stats, window_s, counts, _, _ = window()
    n = stats["lm_iterations"]
    out["untraced"] = {
        "units": stats["units"], "lm_iterations": n, "window_s": window_s,
        "lm_iter_ms": 1e3 * window_s / n,
        "host_reads_per_lm_iter": {k: v / n for k, v
                                   in counts["host_reads"].items()},
        "host_reads_per_lm_iter_total": sum(counts["host_reads"].values())
        / n}
    if not cuda:
        return out

    stats, window_s, counts, events, spans = window(tr.Profiler(), True)
    n = stats["lm_iterations"]
    summary = tr.summarize(events, window_s)
    attr = sp.attribute(events, spans)
    iters = [s for s in attr.spans if s.name == "lm.iter"]
    rows = attr.table()
    phases_ns = {name: attr.device_ns(name) for name in
                 ("lm.iter", "lm.blocks", "lm.solve", "lm.cost", "lm.accept",
                  "ba.solve")}
    iter_self = phases_ns["lm.iter"] - sum(
        phases_ns[k] for k in ("lm.blocks", "lm.solve", "lm.cost",
                               "lm.accept"))
    syncs = collections.Counter()
    for i, c in attr.syncs_self.items():
        syncs[attr.spans[i].name if i >= 0 else "(no span)"] += c
    out["spans"] = {
        "lm_iterations": n, "window_s": window_s,
        "lm_iter_ms": 1e3 * window_s / n,
        "device_idle": 100.0 * (1.0 - summary["busy_s"] / window_s),
        "syncs_per_lm_iter": summary["syncs"] / n,
        "launches_per_lm_iter": summary["launches"] / n,
        "host_reads_per_lm_iter": sum(counts["host_reads"].values()) / n,
        "metrics": sp.phase_metrics(attr, n),
        "coverage": attr.coverage,
        "device_ms_per_lm_iter": {k: 1e-6 * v / n
                                  for k, v in phases_ns.items()},
        "lm_iter_self_device_ms_per_lm_iter": 1e-6 * iter_self / n,
        "device_total_ms": 1e-6 * attr.device_total_ns,
        "unmatched_device_ms": 1e-6 * attr.unmatched_device_ns,
        "buffer_idle_ms": 1e-6 * attr.buffer_idle_ns,
        "syncs_per_lm_iter_by_span": {k: v / n for k, v
                                      in syncs.most_common()},
        "lm_iter_host_ms": [1e-6 * (s.end_ns - s.start_ns) for s in iters],
        "idle_gaps": attr.idle_gaps,
        "table": [dict(r, per_lm_iter=r["count"] / n) for r in rows],
        "top_kernels_by_span": _owners(attr)}
    return out


def _owners(attr, top=10):
    """The trace's ``top`` device operations by time, each with the spans
    that launched it (ms)."""
    by_kernel = collections.defaultdict(collections.Counter)
    for i, kernels in attr.kernels_self.items():
        name = attr.spans[i].name if i >= 0 else "(no span)"
        for k, ns in kernels.items():
            by_kernel[k][name] += ns
    ranked = sorted(by_kernel.items(), key=lambda kv: -sum(kv[1].values()))
    return [{"op": k, "ms": 1e-6 * sum(c.values()),
             "spans": {n: 1e-6 * v for n, v in c.most_common(4)}}
            for k, c in ranked[:top]]


def lines(out):
    """The readings as lines for a reader."""
    u = out["untraced"]
    res = [f"untraced: {u['lm_iterations']} LM iterations, lm_iter_ms "
           f"{u['lm_iter_ms']:.3f}, host reads "
           f"{u['host_reads_per_lm_iter_total']:.3f} an LM iteration"]
    res += [f"host reads {site}: {v:.3f} an LM iteration"
            for site, v in sorted(u["host_reads_per_lm_iter"].items())]
    if "spans" not in out:
        return res
    s = out["spans"]
    res.append(f"traced, spans on: lm_iter_ms {s['lm_iter_ms']:.3f}, device "
               f"idle {s['device_idle']:.2f}%, syncs "
               f"{s['syncs_per_lm_iter']:.3f}, launches "
               f"{s['launches_per_lm_iter']:.1f}, host reads "
               f"{s['host_reads_per_lm_iter']:.3f} an LM iteration")
    res.append(f"coverage under ba.solve {s['coverage']!r}; lm.iter self "
               f"device ms {s['lm_iter_self_device_ms_per_lm_iter']:.4f}")
    res += [f"metric {k}: {v:.4f}" for k, v in s["metrics"].items()]
    n = s["lm_iterations"]
    for r in s["table"]:
        top = ", ".join(f"{k[:60]} {1e-6 * v / n:.3f}"
                        for k, v in r["kernels"])
        res.append(
            f"span {r['span']}: {r['per_lm_iter']:.3f} an LM iteration, host "
            f"{1e-6 * r['host_ns'] / n:.3f} ms, self "
            f"{1e-6 * r['self_ns'] / n:.3f} ms, device "
            f"{1e-6 * r['device_ns'] / n:.3f} ms, idle "
            f"{1e-6 * r['idle_ns'] / n:.3f} ms, syncs {r['syncs'] / n:.3f}; "
            f"top: {top}")
    res += [f"gap {g[1] * 1e3:.3f} ms: {g[0]}" for g in s["idle_gaps"]]
    return res


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--out")
    args = ap.parse_args()
    out = phases(args.workload, args.seed, args.seconds)
    for line in lines(out):
        print(line, file=sys.stderr)
    text = json.dumps(out)
    print(text, flush=True)
    if args.out:
        with open(args.out, "a") as f:
            f.write(text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
