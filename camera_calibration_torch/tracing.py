"""Spans and host-read counters of the port's bundle adjustment.

A span names a phase of the program (``lm.solve``, ``cg.matvec``, ...) and
records when the host was in it:

    with tracing.span("lm.blocks"):
        ...

Spans are off by default: :func:`span` then returns one shared null
context, so a span costs a flag check and allocates nothing.  Between
:func:`enable` and :func:`disable` each span closed appends a
:class:`Span` record to an in-memory list that :func:`take` drains; nothing
is written on the hot path.  Times are ``time.time_ns()``: Unix-epoch
nanoseconds, the clock on which ``torch.profiler`` (Kineto) reports the
host's and the card's events, so a span can be laid over a profiler's trace
and a kernel tied to the span whose runtime call launched it.  A span
opened with ``solve=True`` (``ba.solve``, one per ``lm_pcg.optimize`` call)
starts a new solve id, which the spans inside it carry.

:func:`read` is the program's read of a device value on the host (the CG
loop test, the LM accept, the history's numbers, the projection loops'
tests): it counts the read under its site in :data:`host_reads` whether
spans are on or off, as ``_cuda.launches`` counts launches, and with spans
on it runs inside a leaf span ``read.<site>``.  :func:`counters` returns a
copy of every counter of the program.

While ``lm_pcg.optimize`` writes its ``profile_dir`` trace, the spans are
on and each is also a ``torch.profiler`` user annotation
(:func:`annotated`), so the trace shows them around the operators they ran.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import threading
import time
from typing import NamedTuple

# Host reads of device values, by site (reset with reset_host_reads).
host_reads: collections.Counter = collections.Counter()


class Span(NamedTuple):
    name: str
    start_ns: int  # time.time_ns() at entry
    end_ns: int  # time.time_ns() at exit
    id: int
    parent: int | None  # the id of the span it opened in
    solve: int | None  # the id of the ba.solve span it belongs to
    thread: int  # the thread's native id


_NULL = contextlib.nullcontext()
_state = {"on": False, "annotate": False}
_records: list = []
_ids = itertools.count(1)
_solve_ids = itertools.count(1)
_local = threading.local()


def enable() -> None:
    _state["on"] = True


def disable() -> None:
    _state["on"] = False


def take() -> list:
    """The spans closed since the last call, in the order they closed
    (a child before its parent); the list is emptied."""
    out = _records[:]
    del _records[:len(out)]
    return out


def reset_host_reads() -> None:
    host_reads.clear()


def counters() -> dict:
    """A copy of every counter of the program: ``host_reads``, and the
    kernel launches (``_cuda.launches``), collectives
    (``sharding.collectives``) and native calls (``native.calls``)."""
    from camera_calibration_torch import _cuda, native
    from camera_calibration_torch.parallel import sharding

    return {name: collections.Counter(c) for name, c in (
        ("host_reads", host_reads), ("launches", _cuda.launches),
        ("collectives", sharding.collectives), ("native_calls", native.calls))}


class _Open:
    """A span being recorded."""

    __slots__ = ("name", "solve_root", "id", "parent", "solve", "start",
                 "annotation")

    def __init__(self, name, solve_root):
        self.name = name
        self.solve_root = solve_root

    def __enter__(self):
        stack = getattr(_local, "stack", None)
        if stack is None:
            # the thread's id is read once: it is a system call
            stack = _local.stack = []
            _local.thread = threading.get_native_id()
        top = stack[-1] if stack else None
        self.id = next(_ids)
        self.parent = top.id if top is not None else None
        self.solve = (next(_solve_ids) if self.solve_root
                      else top.solve if top is not None else None)
        self.annotation = None
        if _state["annotate"]:
            import torch

            self.annotation = torch.autograd.profiler.record_function(
                self.name)
            self.annotation.__enter__()
        stack.append(self)
        self.start = time.time_ns()
        return self

    def __exit__(self, *exc):
        end = time.time_ns()
        _local.stack.pop()
        if self.annotation is not None:
            self.annotation.__exit__(*exc)
        _records.append(Span(self.name, self.start, end, self.id, self.parent,
                             self.solve, _local.thread))
        return False


def span(name: str, *, solve: bool = False):
    """A context that records the phase ``name`` while spans are on; with
    ``solve`` it starts a new solve id."""
    if not _state["on"]:
        return _NULL
    return _Open(name, solve)


def read(site: str, value):
    """``value.item()`` (a device scalar read on the host), counted under
    ``site``; inside the span ``read.<site>`` while spans are on."""
    host_reads[site] += 1
    if not _state["on"]:
        return value.item()
    with _Open("read." + site, False):
        return value.item()


@contextlib.contextmanager
def annotated():
    """Spans on, each also a ``torch.profiler`` user annotation, for a
    profiler that runs inside this context.  On exit the switch is as it
    was; spans recorded while it was off are dropped (the profiler's trace
    holds them)."""
    was_on, first = _state["on"], len(_records)
    _state["on"] = _state["annotate"] = True
    try:
        yield
    finally:
        _state["annotate"] = False
        _state["on"] = was_on
        if not was_on:
            del _records[first:]
