"""The benchmark's own profiler around the traced window, and the reduction
of its trace to the numbers the per-layer readers take.

The profiler is PyTorch's (Kineto/CUPTI), driven through its low-level
entry points so that stopping it does not build Python objects for every
event: the trace is read once, here, into arrays.  It records the card's
activity only (kernels, copies and sets, and the CUDA runtime calls that
launch and wait for them), not the host's PyTorch operators, so that the
window it watches runs as close to an untraced one as CUPTI allows.
"""

from __future__ import annotations

import numpy as np
import torch

DEVICE_ACTIVITIES = ("kernel", "gpu_memcpy", "gpu_memset")
TOP = 10
NAME_CHARS = 160  # of a kernel's name in the breakdown (templates run long)


class Profiler:
    """Start with :meth:`start`, stop with :meth:`stop` (returns the
    trace's events)."""

    def __init__(self):
        import torch.autograd.profiler as ap

        self._ap = ap
        self._p = ap.profile(use_kineto=True, use_device="cuda",
                             use_cpu=False)

    def _config(self):
        try:
            return self._p.config(create_trace_id=True)
        except TypeError:  # releases whose config() takes no argument
            return self._p.config()

    def start(self):
        cfg = self._config()
        self._ap._prepare_profiler(cfg, self._p.kineto_activities)
        self._ap._enable_profiler(cfg, self._p.kineto_activities)

    def stop(self):
        torch.cuda.synchronize()
        return self._ap._disable_profiler().events()


def _kind(e):
    """The event's activity: "kernel", "gpu_memcpy", "gpu_memset", or a
    host (runtime) call."""
    try:
        return e.activity_type()
    except AttributeError:  # releases without activity_type()
        pass
    if e.device_type() != torch.autograd.DeviceType.CUDA:
        return "cuda_runtime"
    name = e.name()
    if name.startswith("Memcpy"):
        return "gpu_memcpy"
    if name.startswith("Memset"):
        return "gpu_memset"
    return "kernel"


def summarize(events, window_s):
    """The trace as the readers see it: device busy seconds (the union of
    the intervals in which an operation ran on the device), kernels by
    name (seconds, count), launches, host synchronizations, and the
    ``breakdown`` of the contract (top device operations; longest idle
    gaps, each named by the runtime call the host was in at the gap's
    middle, or "host" where it was in none, and by the device operation
    that ended the gap)."""
    dev, host = [], []
    kernels = {}
    n_kernels = syncs = 0
    for e in events:
        kind = _kind(e)
        name = e.name()
        a, b = e.start_ns(), e.end_ns()
        if kind in DEVICE_ACTIVITIES:
            dev.append((a, b, name))
            if kind == "kernel":
                n_kernels += 1
                t, c = kernels.get(name, (0.0, 0))
                kernels[name] = (t + (b - a) * 1e-9, c + 1)
        elif kind in ("cuda_runtime", "cuda_driver"):
            if "Synchronize" in name:
                syncs += 1
            host.append((a, b, name))
    busy_ns, gaps = 0, []
    if dev:
        dev.sort()
        cur_a, cur_b = dev[0][:2]
        for a, b, name in dev[1:]:
            if a > cur_b:
                busy_ns += cur_b - cur_a
                gaps.append((a - cur_b, cur_b, a, name))
                cur_a, cur_b = a, b
            else:
                cur_b = max(cur_b, b)
        busy_ns += cur_b - cur_a
    gaps.sort(reverse=True)
    at = _HostCalls(host)
    idle = [[f"{at.name((g0 + g1) // 2)} before {after[:80]}", dur * 1e-9]
            for dur, g0, g1, after in gaps[:TOP]]
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:TOP]
    return {
        "busy_s": busy_ns * 1e-9,
        "window_s": window_s,
        "kernels": kernels,
        "launches": n_kernels,
        "syncs": syncs,
        "breakdown": {"device_ops": [[n[:NAME_CHARS], t]
                                     for n, (t, _c) in top],
                      "idle_gaps": idle},
    }


class _HostCalls:
    """Runtime calls, to name what the host was doing at a time."""

    def __init__(self, host):
        self.host = host
        self.starts = np.fromiter((h[0] for h in host), np.int64, len(host))
        self.ends = np.fromiter((h[1] for h in host), np.int64, len(host))

    def name(self, t):
        idx = np.flatnonzero((self.starts <= t) & (t <= self.ends))
        if not idx.size:
            return "host"
        return self.host[idx[np.argmax(self.starts[idx])]][2]


def kernel_seconds(summary, *fragments):
    """(seconds, count) of the kernels whose name holds any fragment."""
    t = c = 0
    for name, (s, n) in summary["kernels"].items():
        if any(f in name for f in fragments):
            t += s
            c += n
    return t, c
