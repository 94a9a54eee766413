"""The program's spans and counters: the one tracing module of the port.

``span(name, **attrs)`` times a block and ``count(name, n)`` adds to a
counter, both at a layer boundary of the program.  They record only inside
``recording()``; otherwise each call tests one module-level variable and
returns (``span`` a shared no-op context): it reads no clock, makes no
object of its own and takes no lock.

While a recording is on, spans and counts stay in memory (the
``Recording`` it yields) and nothing is written.  A span's parent is the
innermost span open on its own thread; its step is the innermost
``train.step`` span open on any thread, so work that autograd runs on its
own thread inside a step (the norm's backward) counts towards that step.

Stamps are ``time.time_ns()``: the clock ``torch.profiler`` (kineto)
stamps its host events with, and under which it has CUPTI stamp the device
operations, so spans lie on a profiler trace as they are.  The recorder
never calls ``torch.profiler.record_function``: program spans stay out of
the profiler's own event list.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import os
import threading
import time
from typing import Dict, List, NamedTuple, Optional, Tuple

STEP = "train.step"

# the recording in progress, or None; the only state a call tests when off
_rec: Optional["Recording"] = None


class Span(NamedTuple):
    """A closed span: ``parent`` 0 for none, ``step`` the id of the
    enclosing ``train.step`` span (None outside a step), ``tid`` the OS
    thread id."""
    id: int
    parent: int
    step: Optional[int]
    name: str
    tid: int
    t0_ns: int
    t1_ns: int
    attrs: dict


class Recording:
    """The spans (in the order they closed) and counters (by name and step
    id) recorded while it was on."""

    def __init__(self):
        self.spans: List[Span] = []
        self.counters: Dict[Tuple[str, Optional[int]], int] = {}
        self.step: Optional[int] = None
        self._ids = itertools.count(1)
        self._lock = threading.Lock()
        self._local = threading.local()

    def _stack(self) -> list:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def _count(self, name: str, n: int):
        key = (name, self.step)
        with self._lock:
            self.counters[key] = self.counters.get(key, 0) + n

    def named(self, name: str) -> List[Span]:
        return [s for s in self.spans if s.name == name]

    def write_chrome(self, path: str, base_ns: int):
        """The spans as a chrome-trace file of complete events, ``ts`` in
        us after ``base_ns`` (a profiler export's ``baseTimeNanoseconds``),
        to be laid beside that export in a trace viewer."""
        pid = os.getpid()
        events = [{"ph": "X", "name": s.name, "cat": "srgan_tpu_torch",
                   "pid": pid, "tid": s.tid,
                   "ts": (s.t0_ns - base_ns) / 1e3,
                   "dur": (s.t1_ns - s.t0_ns) / 1e3,
                   "args": {**s.attrs, "span_id": s.id,
                            "parent_id": s.parent, "step_id": s.step}}
                  for s in self.spans]
        with open(path, "w") as f:
            json.dump({"baseTimeNanoseconds": base_ns,
                       "displayTimeUnit": "ms", "traceEvents": events}, f)


class _Span:
    __slots__ = ("rec", "name", "attrs", "id", "parent", "step",
                 "outer_step", "t0")

    def __init__(self, rec: Recording, name: str, attrs: dict):
        self.rec, self.name, self.attrs = rec, name, attrs

    def __enter__(self):
        rec = self.rec
        stack = rec._stack()
        self.id = next(rec._ids)
        self.parent = stack[-1].id if stack else 0
        if self.name == STEP:
            self.outer_step, rec.step = rec.step, self.id
        self.step = rec.step
        stack.append(self)
        self.t0 = time.time_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.time_ns()
        rec = self.rec
        rec._stack().pop()
        if self.name == STEP:
            rec.step = self.outer_step
        rec.spans.append(Span(self.id, self.parent, self.step, self.name,
                              threading.get_native_id(), self.t0, t1,
                              self.attrs))
        return False


_OFF = contextlib.nullcontext()


def span(name: str, **attrs):
    """A context manager timing its block as the span ``name``."""
    rec = _rec
    if rec is None:
        return _OFF
    return _Span(rec, name, attrs)


def count(name: str, n: int = 1):
    """Add ``n`` to the counter ``name`` of the current step."""
    rec = _rec
    if rec is None:
        return
    rec._count(name, n)


@contextlib.contextmanager
def recording():
    """Record every span and count of the process for the block; yields
    the ``Recording``.  One at a time."""
    global _rec
    if _rec is not None:
        raise RuntimeError("a recording is already on")
    rec = _rec = Recording()
    try:
        yield rec
    finally:
        _rec = None
