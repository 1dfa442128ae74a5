"""The program's spans laid over the benchmark's device trace.

The port records spans (``camera_calibration_torch/tracing.py``) on the
clock on which the profiler reports the host's runtime calls and the card's
operations (Unix-epoch nanoseconds), so the two can be joined:

- a device operation (kernel, copy, set) belongs to the innermost span that
  was open on the host when its runtime call ran; the two are matched by
  the profiler's correlation id;
- each idle interval of the card (between two device operations) is split
  over the innermost spans open on the host during it, and the part in
  which the host was in the profiler's own ``Activity Buffer Request`` is
  set apart;
- each runtime ``*Synchronize`` call is counted in the innermost span open
  when it ran.

Times of one thread's spans are taken: the thread with the most spans (the
one that runs the LM loop).  :func:`attribute` returns an
:class:`Attribution`; :func:`phase_metrics` reads the per-phase numbers of
an LM solve from it.
"""

from __future__ import annotations

import collections

import numpy as np

from calib_bench import trace as tr

BUFFER_REQUEST = "Buffer Request"


def _wildcard(pattern):
    """A test of span names: ``"lm.solve"`` one name, ``"model.*"`` every
    name with the prefix ``model.``."""
    if pattern.endswith("*"):
        prefix = pattern[:-1]
        return lambda name: name.startswith(prefix)
    return lambda name: name == pattern


class Attribution:
    """Device time, idle time and syncs by span, from :func:`attribute`.

    Per span (by its index in :attr:`spans`): ``device_self`` (ns of device
    operations launched directly under it), ``idle_self`` (ns of card idle
    time while it was the innermost span open, less the profiler's buffer
    requests), ``syncs_self``; ``kernels_self`` (per span, ns by device
    operation name).  Time that falls under no span is counted under the
    index -1."""

    def __init__(self, spans):
        self.spans = spans
        index = {s.id: i for i, s in enumerate(spans)}
        self.parent = [index.get(s.parent, -1) for s in spans]
        self.seg_t, self.seg_s = _segments(spans)
        self.device_self = collections.Counter()
        self.idle_self = collections.Counter()
        self.syncs_self = collections.Counter()
        self.kernels_self = collections.defaultdict(collections.Counter)
        self.buffer_idle_ns = 0
        self.unmatched_device_ns = 0  # device operations with no runtime call
        self.device_total_ns = 0
        self.coverage = None
        self.idle_gaps = []

    def under(self, pattern):
        """Span indices that are, or lie inside, a span whose name matches
        ``pattern`` (see :func:`_wildcard`)."""
        match = _wildcard(pattern)
        memo = {-1: False}

        def inside(i):
            chain = []
            while i not in memo:
                chain.append(i)
                if match(self.spans[i].name):
                    memo[i] = True
                    break
                i = self.parent[i]
            value = memo[i]
            for j in chain:
                memo[j] = value
            return value

        return {i for i in range(len(self.spans)) if inside(i)}

    def device_ns(self, pattern):
        """Device time launched under any span matching ``pattern``,
        nested spans included, each operation counted once."""
        idx = self.under(pattern)
        return sum(v for i, v in self.device_self.items() if i in idx)

    def idle_ns(self, pattern):
        idx = self.under(pattern)
        return sum(v for i, v in self.idle_self.items() if i in idx)

    def count(self, pattern):
        match = _wildcard(pattern)
        return sum(1 for s in self.spans if match(s.name))

    def table(self):
        """One row per span name: count, host ns (inclusive and self),
        device ns (inclusive), idle ns (inclusive), syncs (self), the top
        three device operations launched directly under it (ns)."""
        host = collections.Counter()
        child = collections.Counter()
        count = collections.Counter()
        kernels = collections.defaultdict(collections.Counter)
        syncs = collections.Counter()
        for i, s in enumerate(self.spans):
            dur = s.end_ns - s.start_ns
            host[s.name] += dur
            count[s.name] += 1
            syncs[s.name] += self.syncs_self.get(i, 0)
            kernels[s.name].update(self.kernels_self.get(i, {}))
            if self.parent[i] >= 0:
                child[self.spans[self.parent[i]].name] += dur
        rows = []
        for name in sorted(count, key=lambda n: -host[n]):
            rows.append({
                "span": name, "count": count[name], "host_ns": host[name],
                "self_ns": host[name] - child[name],
                "device_ns": self.device_ns(name),
                "idle_ns": self.idle_ns(name), "syncs": syncs[name],
                "kernels": kernels[name].most_common(3)})
        return rows

    def innermost(self, t):
        """The index of the innermost span open at time ``t``, or -1."""
        k = int(np.searchsorted(self.seg_t, t, side="right")) - 1
        return int(self.seg_s[k]) if k >= 0 else -1


def _one_thread(spans):
    if not spans:
        return []
    thread = collections.Counter(s.thread for s in spans).most_common(1)[0][0]
    return sorted((s for s in spans if s.thread == thread),
                  key=lambda s: (s.start_ns, -s.end_ns))


def _segments(spans):
    """(times, innermost span index from each time on, -1 for none)."""
    seg_t, seg_s, stack = [], [], []
    for i, s in enumerate(spans):
        while stack and spans[stack[-1]].end_ns <= s.start_ns:
            j = stack.pop()
            seg_t.append(spans[j].end_ns)
            seg_s.append(stack[-1] if stack else -1)
        stack.append(i)
        seg_t.append(s.start_ns)
        seg_s.append(i)
    while stack:
        j = stack.pop()
        seg_t.append(spans[j].end_ns)
        seg_s.append(stack[-1] if stack else -1)
    return np.asarray(seg_t, np.int64), np.asarray(seg_s, np.int64)


def _covered(intervals):
    """(merged starts, merged ends, cumulative length before each start)
    of a set of intervals, for :func:`_covered_before`."""
    if not intervals:
        z = np.zeros(0, np.int64)
        return z, z, z
    a = sorted(intervals)
    starts, ends = [a[0][0]], [a[0][1]]
    for x, y in a[1:]:
        if x > ends[-1]:
            starts.append(x)
            ends.append(y)
        else:
            ends[-1] = max(ends[-1], y)
    starts = np.asarray(starts, np.int64)
    ends = np.asarray(ends, np.int64)
    cum = np.concatenate([[0], np.cumsum(ends - starts)[:-1]])
    return starts, ends, cum


def _covered_before(cover, t):
    """Covered length up to time ``t``."""
    starts, ends, cum = cover
    k = int(np.searchsorted(starts, t, side="right")) - 1
    if k < 0:
        return 0
    return int(cum[k] + min(t, ends[k]) - starts[k])


def attribute(events, spans):
    """Join a profiler's events (as ``trace.summarize`` reads them) and the
    program's spans (records with ``name``, ``start_ns``, ``end_ns``,
    ``id``, ``parent``, ``thread``)."""
    spans = _one_thread(list(spans))
    out = Attribution(spans)
    innermost = out.innermost
    launched = {}
    dev, host, buffer = [], [], []
    for e in events:
        kind = tr._kind(e)
        name = e.name()
        a, b = e.start_ns(), e.end_ns()
        if kind in tr.DEVICE_ACTIVITIES:
            dev.append((a, b, name, e.correlation_id()))
            continue
        if BUFFER_REQUEST in name:
            buffer.append((a, b))
        if kind in ("cuda_runtime", "cuda_driver"):
            host.append((a, b, name))
            s = innermost(a)
            launched[e.correlation_id()] = s
            if "Synchronize" in name:
                out.syncs_self[s] += 1

    for a, b, name, corr in dev:
        out.device_total_ns += b - a
        if corr not in launched:
            out.unmatched_device_ns += b - a
            continue
        s = launched[corr]
        out.device_self[s] += b - a
        out.kernels_self[s][name[:tr.NAME_CHARS]] += b - a

    # the card's idle gaps, as trace.summarize finds and names them
    gaps = []
    if dev:
        dev.sort()
        cur_b = dev[0][1]
        for a, b, name, _ in dev[1:]:
            if a > cur_b:
                gaps.append((a - cur_b, cur_b, a, name))
            cur_b = max(cur_b, b)
    cover = _covered(buffer)
    for dur, g0, g1, _ in gaps:
        k0 = int(np.searchsorted(out.seg_t, g0, side="right"))
        k1 = int(np.searchsorted(out.seg_t, g1, side="left"))
        cuts = [g0] + out.seg_t[k0:k1].tolist() + [g1]
        for p0, p1 in zip(cuts, cuts[1:]):
            in_buffer = _covered_before(cover, p1) - _covered_before(cover,
                                                                     p0)
            out.buffer_idle_ns += in_buffer
            out.idle_self[innermost(p0)] += p1 - p0 - in_buffer
    gaps.sort(reverse=True)
    at = tr._HostCalls(host)
    for dur, g0, g1, after in gaps[:tr.TOP]:
        mid = (g0 + g1) // 2
        label = f"{at.name(mid)} before {after[:80]}"
        s = innermost(mid)
        out.idle_gaps.append([f"{spans[s].name}: {label}" if s >= 0
                              else label, dur * 1e-9])

    roots = [s for s in spans if s.name == "ba.solve"]
    if roots and dev:
        lo = min(s.start_ns for s in roots)
        hi = max(s.end_ns for s in roots)
        solve = out.under("ba.solve")
        clip = [(max(a, lo), min(b, hi)) for a, b, _, _ in dev
                if b > lo and a < hi]
        mine = [(max(a, lo), min(b, hi)) for a, b, _, corr in dev
                if b > lo and a < hi and launched.get(corr, -1) in solve]
        busy = _covered(clip)
        owned = _covered(mine)
        busy_ns = int(np.sum(busy[1] - busy[0]))
        if busy_ns:
            out.coverage = int(np.sum(owned[1] - owned[0])) / busy_ns
    return out


# the LM phases whose device time a solve's metrics read, by metric name
PHASES = {"device_ms_per_lm_iter.blocks": "lm.blocks",
          "device_ms_per_lm_iter.solve": "lm.solve",
          "device_ms_per_lm_iter.cost": "lm.cost",
          "device_ms_per_lm_iter.model": "model.*"}


def phase_metrics(attr, lm_iterations):
    """{metric: ms per LM iteration}: device time launched under each LM
    phase, and the card's idle time inside ``lm.solve`` less the profiler's
    buffer requests (``idle_ms_per_lm_iter.solve``); {} where the trace
    holds no LM iteration's spans."""
    if not lm_iterations or not attr.count("lm.iter"):
        return {}
    out = {metric: 1e-6 * attr.device_ns(pattern) / lm_iterations
           for metric, pattern in PHASES.items()}
    out["idle_ms_per_lm_iter.solve"] = (1e-6 * attr.idle_ns("lm.solve")
                                        / lm_iterations)
    return out
