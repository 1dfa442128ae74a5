"""The port's spans and host-read counters (``camera_calibration_torch/
tracing.py``), the ``profile_dir`` trace that carries them, and the
benchmark's join of spans and a device trace (``calib_bench/spans.py``),
on the CPU at a tiny size."""

import collections
import dataclasses
import json
from pathlib import Path

import pytest
import torch
from torch_threads import one_torch_thread  # noqa: F401

from calib_bench import harness
from calib_bench import spans as sp
from calib_bench import trace as tr
from camera_calibration_torch import problems, tracing
from camera_calibration_torch.ba import lm_pcg as T

# one LM iteration; one projection iteration a pass, so each projection
# call reads its loop test once
OPTIONS = T.BAOptions(max_lm_iterations=1, max_pcg_iterations=10,
                      proj_iterations=1, solver="schur")


@pytest.fixture(scope="module")
def problem():
    state, data, _ = problems.make_bench_problem(
        w=64, h=48, gres=8, n_points=48, n_poses=8, device="cpu")
    return state, data


@pytest.fixture(autouse=True)
def spans_off():
    tracing.disable()
    tracing.take()
    yield
    tracing.disable()
    tracing.take()


def _solve(problem, options=OPTIONS, on=False):
    state, data = problem
    if on:
        tracing.enable()
    try:
        return T.optimize(state, None, None, options, data=data)
    finally:
        tracing.disable()


def test_spans_nest_with_one_solve_id_per_optimize(problem):
    _solve(problem, on=True)
    _solve(problem, dataclasses.replace(OPTIONS, max_lm_iterations=2),
           on=True)
    spans = tracing.take()
    by_id = {s.id: s for s in spans}
    roots = [s for s in spans if s.parent is None]
    assert [s.name for s in roots] == ["ba.solve", "ba.solve"]
    assert roots[0].solve != roots[1].solve
    for s in spans:
        if s.parent is not None:
            p = by_id[s.parent]
            assert p.start_ns <= s.start_ns <= s.end_ns <= p.end_ns
            assert s.solve == p.solve and s.thread == p.thread
    names = collections.Counter(s.name for s in spans)
    assert names["lm.iter"] == 3
    for name in ("lm.blocks", "lm.solve", "lm.cost", "lm.accept"):
        assert names[name] == 3
        assert all(by_id[s.parent].name == "lm.iter"
                   for s in spans if s.name == name)
    for name, parent in (("solve.rhs", "lm.solve"), ("solve.pcg", "lm.solve"),
                         ("cg.matvec", "solve.pcg"),
                         ("cg.precond", "solve.pcg"),
                         ("model.blocks", "lm.blocks"),
                         ("model.project", "lm.cost"),
                         ("read.cg.stop", "solve.pcg"),
                         ("read.lm.accept", "lm.accept"),
                         ("read.lm.history", "lm.iter")):
        assert names[name] >= 3
        assert {by_id[s.parent].name for s in spans if s.name == name} \
            == {parent}
    assert tracing.take() == []


def test_spans_off_record_nothing_and_change_no_bit(problem):
    off_state, off = _solve(problem)
    assert tracing.take() == []
    on_state, on = _solve(problem, on=True)
    assert tracing.take()
    assert off["history"] == on["history"]
    for name in ("rig_q_global", "rig_t_global", "cam_q_rig", "cam_t_rig",
                 "points"):
        assert torch.equal(getattr(off_state, name), getattr(on_state, name))
    assert torch.equal(off_state.intrinsics[0].grid,
                       on_state.intrinsics[0].grid)
    assert tracing.span("x") is tracing.span("y")  # the shared null context


def test_span_times_share_the_profilers_clock():
    """A Kineto CPU event profiled inside a span lies inside it: both are
    Unix-epoch nanoseconds."""
    from torch.profiler import ProfilerActivity, profile

    a = torch.ones(1000)
    tracing.enable()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tracing.span("outer"):
            a.mul(2.0)
    tracing.disable()
    (s,) = tracing.take()
    (mul,) = [e for e in prof.profiler.kineto_results.events()
              if e.name() == "aten::mul"]
    assert s.start_ns <= mul.start_ns() <= mul.end_ns() <= s.end_ns
    assert mul.start_ns() - s.start_ns < 10 ** 9


def test_host_reads_by_site_match_a_hand_count(problem):
    """A two-pass LM iteration reads: the CG loop test once per CG
    iteration and once more to stop, the accept once, the history's four
    costs and λ; each projection call (the blocks pass and the cost pass)
    reads its one loop test.  Counted with spans off and on alike."""
    for on in (False, True):
        tracing.reset_host_reads()
        _, info = _solve(problem, on=on)
        (h,) = info["history"]
        cg = h["pcg_iterations"]
        assert 0 < cg < OPTIONS.max_pcg_iterations
        assert dict(tracing.host_reads) == {
            "cg.stop": cg + 1, "lm.accept": 1, "lm.history": 5,
            "cg.project_plain": 2}
        spans = tracing.take()
        assert sum(s.name.startswith("read.") for s in spans) \
            == (sum(tracing.host_reads.values()) if on else 0)
    counts = tracing.counters()
    assert set(counts) == {"host_reads", "launches", "collectives",
                           "native_calls"}
    assert counts["host_reads"] == tracing.host_reads
    assert counts["host_reads"] is not tracing.host_reads


def test_cached_steps_and_warm_start_count_their_reads(problem):
    """Two cached-blocks steps in one scan call: an lm.scan span holding
    two lm.iter spans, the warm-start guard read once a CG solve (the
    first warm-starts from a zero tangent), four history reads a step and
    one λ read a call."""
    options = dataclasses.replace(OPTIONS, max_lm_iterations=2,
                                  lm_steps_per_call=2, cg_warm_start=True)
    tracing.reset_host_reads()
    _, info = _solve(problem, options, on=True)
    assert len(info["history"]) == 2
    spans = tracing.take()
    names = collections.Counter(s.name for s in spans)
    assert names["lm.scan"] == 1 and names["lm.iter"] == 2
    assert names["lm.blocks"] == 1 and names["lm.cost"] == 2
    assert tracing.host_reads["lm.history"] == 2 * 4 + 1
    assert tracing.host_reads["cg.warm_guard"] == 2
    # a CG solve that runs out of iterations skips its last loop test
    assert tracing.host_reads["cg.stop"] == sum(
        k + (k < options.max_pcg_iterations)
        for k in (e["pcg_iterations"] for e in info["history"]))


def test_profile_dir_trace_holds_the_spans(problem, tmp_path):
    """``profile_dir``'s Chrome trace carries the program's spans as user
    annotations around the ATen operators they ran, and leaves spans as
    it found them (off)."""
    _solve(problem, dataclasses.replace(OPTIONS,
                                        profile_dir=str(tmp_path)))
    assert tracing.take() == []
    assert tracing.span("x") is tracing.span("y")  # off: the null context
    trace = json.loads((tmp_path / "lm_trace.json").read_text())
    events = trace["traceEvents"] if isinstance(trace, dict) else trace
    marks = [e for e in events if e.get("cat") == "user_annotation"]
    names = {e["name"] for e in marks}
    assert {"ba.solve", "lm.iter", "lm.blocks", "lm.solve", "solve.pcg",
            "cg.matvec", "lm.cost", "lm.accept", "read.cg.stop"} <= names
    ops = [e for e in events if e.get("cat") == "cpu_op"]
    (solve,) = [e for e in marks if e["name"] == "lm.solve"]
    inside = [e for e in ops if solve["ts"] <= e["ts"]
              and e["ts"] + e["dur"] <= solve["ts"] + solve["dur"]]
    assert any(e["name"] == "aten::einsum" for e in inside)


# ----------------- the benchmark's join of spans and a trace -----------------


class Event:
    """An event as the profiler gives it to ``trace.summarize``."""

    def __init__(self, kind, name, a, b, corr):
        self.kind, self._name, self.a, self.b, self.corr = (kind, name, a, b,
                                                            corr)

    def activity_type(self):
        return self.kind

    def name(self):
        return self._name

    def start_ns(self):
        return self.a

    def end_ns(self):
        return self.b

    def correlation_id(self):
        return self.corr


def _span(name, a, b, id, parent, thread=7):
    return tracing.Span(name, a, b, id, parent, 1, thread)


SPANS = [
    _span("ba.solve", 0, 1000, 1, None),
    _span("lm.iter", 10, 900, 2, 1),
    _span("lm.blocks", 20, 200, 3, 2),
    _span("model.blocks", 30, 150, 4, 3),
    _span("lm.solve", 200, 700, 5, 2),
    _span("read.cg.stop", 600, 690, 6, 5),
    _span("lm.cost", 700, 800, 7, 2),
    _span("lm.accept", 800, 880, 8, 2),
    _span("lm.blocks", 0, 5000, 20, None, thread=8),  # another thread's
]


def _events():
    rt, k = "cuda_runtime", "kernel"
    return [
        Event(rt, "cudaLaunchKernel", 40, 45, 101),  # under model.blocks
        Event(rt, "cudaLaunchKernel", 160, 165, 102),  # lm.blocks
        Event(rt, "Activity Buffer Request", 260, 300, 0),
        Event(rt, "cudaLaunchKernel", 300, 305, 103),  # lm.solve
        Event(rt, "cudaStreamSynchronize", 610, 690, 104),  # read.cg.stop
        Event(rt, "cudaLaunchKernel", 710, 715, 105),  # lm.cost
        Event(rt, "cudaMemcpyAsync", 820, 825, 106),  # lm.accept
        Event(rt, "cudaLaunchKernel", 950, 955, 107),  # ba.solve itself
        Event(rt, "cudaLaunchKernel", 1100, 1105, 108),  # no span
        Event(k, "kernel_a", 50, 100, 101),
        Event(k, "kernel_b", 170, 250, 102),
        Event(k, "kernel_c", 320, 580, 103),
        Event(k, "kernel_h", 570, 590, 998),  # no runtime call
        Event(k, "kernel_d", 720, 790, 105),
        Event("gpu_memcpy", "Memcpy HtoD (Pageable -> Device)", 830, 840,
              106),
        Event(k, "kernel_e", 960, 990, 107),
        Event(k, "kernel_f", 1110, 1120, 108),
        Event(k, "kernel_g", 1130, 1140, 999),  # no runtime call
    ]


def test_join_attributes_device_time_by_correlation_and_nesting():
    attr = sp.attribute(_events(), SPANS)
    assert attr.device_ns("model.blocks") == 50
    assert attr.device_ns("model.*") == 50
    assert attr.device_ns("lm.blocks") == 50 + 80  # model.blocks inside
    assert attr.device_ns("lm.solve") == 260
    assert attr.device_ns("lm.cost") == 70
    assert attr.device_ns("lm.accept") == 10  # the copy
    assert attr.device_ns("lm.iter") == 50 + 80 + 260 + 70 + 10
    assert attr.device_ns("ba.solve") == 470 + 30
    assert attr.device_self[-1] == 10  # kernel_f: launched under no span
    assert attr.unmatched_device_ns == 20 + 10  # kernel_h, kernel_g
    assert attr.device_total_ns == 500 + 10 + 30
    # kernel_h overlaps kernel_c inside the solve and no span launched it
    assert attr.coverage == pytest.approx(500 / 510)
    assert sp.phase_metrics(attr, 2) == pytest.approx({
        "device_ms_per_lm_iter.blocks": 130e-6 / 2,
        "device_ms_per_lm_iter.solve": 260e-6 / 2,
        "device_ms_per_lm_iter.cost": 70e-6 / 2,
        "device_ms_per_lm_iter.model": 50e-6 / 2,
        "idle_ms_per_lm_iter.solve": 140e-6 / 2})
    assert sp.phase_metrics(sp.attribute(_events(), []), 2) == {}


def test_join_splits_idle_gaps_over_spans_less_buffer_requests():
    attr = sp.attribute(_events(), SPANS)
    names = {i: s.name for i, s in enumerate(attr.spans)}
    idle = {names.get(i, None): v for i, v in attr.idle_self.items()}
    assert idle == {"model.blocks": 50, "lm.blocks": 20, "lm.solve": 50,
                    "read.cg.stop": 90, "lm.cost": 30, "lm.accept": 70,
                    "lm.iter": 20, "ba.solve": 70, None: 120}
    assert attr.buffer_idle_ns == 40
    assert attr.idle_ns("lm.solve") == 140
    assert sum(attr.idle_self.values()) + attr.buffer_idle_ns \
        == 70 + 70 + 130 + 40 + 120 + 120 + 10
    rows = {r["span"]: r for r in attr.table()}
    assert rows["lm.solve"]["self_ns"] == 500 - 90
    assert rows["lm.iter"]["device_ns"] == 470
    assert rows["lm.solve"]["kernels"] == [("kernel_c", 260)]
    assert rows["read.cg.stop"]["syncs"] == 1
    assert sum(r["syncs"] for r in rows.values()) == 1


def test_join_keeps_every_existing_reading():
    """The join reads the events and changes none: every metric reader of
    the device trace, ``device_ops`` and the gaps' durations read the
    same; each gap's name gains the span open in it, in front of the
    trace's own name."""
    events = _events()
    before = tr.summarize(events, 2e-6)
    attr = sp.attribute(events, SPANS)
    after = tr.summarize(events, 2e-6)
    assert before == after
    spec = harness.load_spec()
    run = harness.Run(1.0, 2e-6, {"units": 1, "lm_iterations": 2,
                                  "pcg_iterations": 4},
                      {"window": {"n": 10, "gh": 8, "gw": 10, "k": 2,
                                  "elem_bytes": 4}},
                      collections.Counter(), before)
    again = harness.Run(1.0, 2e-6, run.stats, run.shapes, run.launches,
                        after)
    for m in spec["per_layer"]:
        path = Path(harness.BENCH) / "metrics" / f"{m['name']}.py"
        read = harness.load_file_module(path).read
        assert read(run) == read(again)
    gaps = before["breakdown"]["idle_gaps"]
    assert [d for _, d in attr.idle_gaps] == [d for _, d in gaps]
    for (mine, _), (theirs, _) in zip(attr.idle_gaps, gaps):
        assert mine.endswith(theirs)
    assert attr.idle_gaps[0][0] == ("read.cg.stop: cudaStreamSynchronize "
                                    "before kernel_d")
    assert attr.idle_gaps[1][0] == gaps[1][0]  # under no span
