"""Metrics and profiling (SURVEY.md §5.1/§5.5).

The reference's only observability is wall-clock cadence checks and log
counters (reference trainingServer.py:548-555, peopleCount.py:973-989).
This module gives every subsystem a shared, lock-safe registry of counters,
gauges, and stage timers (count / mean / EWMA / p50 / p95 over a ring
buffer), host spans, plus torch.profiler trace control for on-device
analysis.  Servers expose ``snapshot()`` at ``GET /api/metrics``.

Usage:
    from ..core import metrics
    metrics.counter("frames_processed").inc()
    with metrics.timer("microbatch.dispatch", batch=7):
        ...
    with metrics.span("engine.upload", bytes=n):
        ...
    metrics.gauge("gallery.size").set(n)

Spans: while recording is on (``record_spans(True)``, or for the length of
a device trace), each ``span(name, **attrs)`` block is kept as a ``Span``:
its thread's native id, start and end on ``time.perf_counter_ns()``, the
thread's CPU time inside it (``time.thread_time_ns()``: wall minus CPU is
the time the thread was runnable or blocked, not running), the enclosing
span of the same thread, and its attributes.  ``spans()`` returns them.  At
most ``SPAN_CAP`` are kept; past it the ``spans.dropped`` counter counts the
rest.  With recording off a ``span`` is one flag check and a shared no-op
object.  A timer is a span that also feeds its ``StageTimer``.

A device trace (``start_device_trace`` / ``stop_device_trace``) records
spans while it runs and writes those of its interval into the trace file on
the trace's own clock, as ``fre_span`` events beside the kernels: ranges
opened on the trace thread just after the profiler starts and just before
it stops (``fre.clock``), each with ``perf_counter_ns()`` read on both
sides, give the offset and rate between the two clocks
(``trace_clock()``).  torch.profiler records host ranges only on the thread
that started it, so a span on a serving thread reaches the trace this way
alone.
"""

from __future__ import annotations

import functools
import itertools
import json
import threading
import time
from collections import deque, namedtuple
from contextlib import contextmanager
from typing import Dict

_LOCK = threading.Lock()


class Counter:
    __slots__ = ("value", "_lock")

    def __init__(self):
        self.value = 0
        self._lock = threading.Lock()

    def inc(self, n: int = 1):
        with self._lock:
            self.value += n

    def snapshot(self):
        return self.value


class Gauge:
    __slots__ = ("value", "_lock")

    def __init__(self):
        self.value = 0.0
        self._lock = threading.Lock()

    def set(self, v: float):
        with self._lock:
            self.value = float(v)

    def snapshot(self):
        return self.value


class StageTimer:
    """Latency stats for one pipeline stage (seconds in, ms out)."""

    __slots__ = ("count", "total_s", "ewma_s", "_ring", "_lock")

    def __init__(self, ring: int = 256):
        self.count = 0
        self.total_s = 0.0
        self.ewma_s = None
        self._ring = deque(maxlen=ring)
        self._lock = threading.Lock()

    def observe(self, seconds: float):
        with self._lock:
            self.count += 1
            self.total_s += seconds
            self.ewma_s = (seconds if self.ewma_s is None
                           else 0.9 * self.ewma_s + 0.1 * seconds)
            self._ring.append(seconds)

    def snapshot(self):
        with self._lock:
            if not self.count:
                return {"count": 0}
            ring = sorted(self._ring)
            p = lambda q: ring[min(len(ring) - 1, int(q * len(ring)))] * 1000.0
            return {
                "count": self.count,
                "mean_ms": self.total_s / self.count * 1000.0,
                "ewma_ms": (self.ewma_s or 0.0) * 1000.0,
                "p50_ms": p(0.50),
                "p95_ms": p(0.95),
                "max_ms": ring[-1] * 1000.0,
            }


# ------------------------------------------------------------------- spans
Span = namedtuple("Span", "id name tid start_ns end_ns cpu_ns parent attrs")
SPAN_CAP = 100_000

_recording = False
_spans: list = []          # closed spans, as Span fields
_span_ids = itertools.count(1)
_span_tls = threading.local()
_thread_idents: dict = {}  # native thread id -> threading.get_ident()


class _NoSpan:
    """What ``span`` hands out while recording is off."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NO_SPAN = _NoSpan()


def _thread_stack() -> list:
    """The calling thread's open spans, [native id, span ids...]."""
    stack = getattr(_span_tls, "stack", None)
    if stack is None:
        native = threading.get_native_id()
        _thread_idents[native] = threading.get_ident()
        stack = _span_tls.stack = [native]
    return stack


def _keep(record: tuple) -> None:
    if len(_spans) < SPAN_CAP:
        _spans.append(record)
    else:
        counter("spans.dropped").inc()


class _Span:
    __slots__ = ("name", "attrs", "id", "parent", "t0", "cpu0")

    def __init__(self, name: str, attrs: dict):
        self.name, self.attrs = name, attrs

    def __enter__(self):
        stack = _thread_stack()
        self.parent = stack[-1] if len(stack) > 1 else None
        self.id = next(_span_ids)
        stack.append(self.id)
        self.cpu0 = time.thread_time_ns()
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        cpu = time.thread_time_ns() - self.cpu0
        stack = _span_tls.stack
        stack.pop()
        _keep((self.id, self.name, stack[0], self.t0, t1, cpu, self.parent, self.attrs))
        return False


def span(name: str, **attrs):
    """A context manager recording the block as a span while recording is
    on; otherwise a shared no-op."""
    if not _recording:
        return _NO_SPAN
    return _Span(name, attrs)


def add_span(name: str, start_ns: int, end_ns: int, tid: int, **attrs) -> None:
    """Record a closed interval that no thread spent inside a block (a
    frame's wait in a queue) on thread ``tid`` (a ``thread_id()``), with no
    parent and no CPU time.  Nothing while recording is off."""
    if _recording:
        _keep((next(_span_ids), name, tid, start_ns, end_ns, 0, None, attrs))


def thread_id() -> int:
    """The calling thread's native id, as its spans carry it."""
    return _thread_stack()[0]


def recording() -> bool:
    return _recording


def record_spans(on: bool) -> None:
    """Switch span recording on (a fresh recording: what was kept goes)
    or off (what was kept stays for ``spans()``)."""
    global _recording
    if on and not _recording:
        _spans.clear()
    _recording = bool(on)


def spans() -> list:
    """The spans recorded, as ``Span`` tuples in the order they closed."""
    return [Span(*r) for r in list(_spans)]


def thread_idents() -> dict:
    """Native thread id -> ``threading.get_ident()`` of every thread that
    opened a span (a trace may name a thread by either)."""
    return dict(_thread_idents)


class _TimerSpan:
    """What ``timer(name)`` hands out: a context manager carrying its own
    start time, so concurrent ``with metrics.timer(name):`` blocks from
    different threads never share mutable state.  The per-name StageTimer
    singleton only accumulates statistics.  While recording is on the block
    is also a span of the timer's name, with the timer's attributes."""

    __slots__ = ("_timer", "_name", "_attrs", "_t0", "_span")

    def __init__(self, timer: StageTimer, name: str, attrs: dict):
        self._timer, self._name, self._attrs = timer, name, attrs

    def observe(self, seconds: float):
        self._timer.observe(seconds)

    def __enter__(self):
        self._span = span(self._name, **self._attrs).__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self._timer.observe(time.perf_counter() - self._t0)
        self._span.__exit__(*exc)
        return False

    def snapshot(self):
        return self._timer.snapshot()


_counters: Dict[str, Counter] = {}
_gauges: Dict[str, Gauge] = {}
_timers: Dict[str, StageTimer] = {}


def counter(name: str) -> Counter:
    with _LOCK:
        if name not in _counters:
            _counters[name] = Counter()
        return _counters[name]


def gauge(name: str) -> Gauge:
    with _LOCK:
        if name not in _gauges:
            _gauges[name] = Gauge()
        return _gauges[name]


def timer(name: str, **attrs) -> _TimerSpan:
    with _LOCK:
        if name not in _timers:
            _timers[name] = StageTimer()
        return _TimerSpan(_timers[name], name, attrs)


def snapshot() -> dict:
    with _LOCK:
        return {
            "counters": {k: v.snapshot() for k, v in _counters.items()},
            "gauges": {k: v.snapshot() for k, v in _gauges.items()},
            "timers": {k: v.snapshot() for k, v in _timers.items()},
        }


def reset() -> None:
    """Test hook: drop all registered instruments and recorded spans, and
    stop recording."""
    record_spans(False)
    _spans.clear()
    with _LOCK:
        _counters.clear()
        _gauges.clear()
        _timers.clear()


# ------------------------------------------------------------- device gate
# torch.profiler's CUDA tracing can corrupt the process's heap when a trace
# starts or stops while another thread is calling into CUDA: on an H100
# host (torch 2.11) a stop beside threads serving FaceAnalysis.get now and
# then aborted ("double free or corruption") or segfaulted; trace_stress.py
# counts it.  So every entry point of the port that calls into the card runs
# inside ``device_work()``, and a trace starts and stops with the gate shut:
# no thread inside, none let in, the card idle.  The sections are leaves:
# inside one, a thread neither takes a lock another thread may hold while it
# waits at the gate, nor waits for another thread, so shutting the gate
# cannot deadlock.  A thread already inside passes straight through again.
_gate = threading.Condition()
_gate_inside = 0
_gate_shut = False
_gate_depth = threading.local()


@contextmanager
def device_work():
    """Run the body as device work: it waits while a trace starts or stops."""
    global _gate_inside
    depth = getattr(_gate_depth, "n", 0)
    if not depth:
        with _gate:
            while _gate_shut:
                _gate.wait()
            _gate_inside += 1
    _gate_depth.n = depth + 1
    try:
        yield
    finally:
        _gate_depth.n = depth
        if not depth:
            with _gate:
                _gate_inside -= 1
                if not _gate_inside:
                    _gate.notify_all()


def on_device(fn):
    """Decorator: ``fn`` runs inside :func:`device_work`."""
    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        with device_work():
            return fn(*args, **kwargs)
    return wrapped


@contextmanager
def _device_alone():
    """Shut the gate, wait for the threads inside to leave and for every
    card the process uses to finish its work; reopen it after the body."""
    global _gate_shut
    import torch

    with _gate:
        _gate_shut = True  # one closer: the trace thread
        while _gate_inside:
            _gate.wait()
    try:
        if torch.cuda.is_initialized():
            for i in range(torch.cuda.device_count()):
                if torch.cuda.memory_reserved(i):  # no context made on the others
                    torch.cuda.synchronize(i)
        yield
    finally:
        with _gate:
            _gate_shut = False
            _gate.notify_all()


# ----------------------------------------------------------- torch.profiler
# torch.profiler must be started and stopped on one thread (stopping it from
# another one crashes the process), while the control API starts and stops a
# trace from whichever request threads serve /api/profiler/start and /stop:
# every profiler call runs on one worker thread of this module, with the
# device gate shut.  The trace holds the device's kernels whichever thread
# launches them.
_trace_lock = threading.Lock()
_trace_dir = None
_trace_prof = None
_trace_head = None       # the fre.clock anchors just after prof.start()
_trace_owns_recording = False
_trace_clock = None      # the last written trace's clock, see trace_clock()
_tracer = None
ANCHORS = 5              # fre.clock ranges at each end of a trace


def _on_trace_thread(fn, *args):
    global _tracer
    from concurrent.futures import ThreadPoolExecutor

    with _trace_lock:
        if _tracer is None:
            _tracer = ThreadPoolExecutor(max_workers=1, thread_name_prefix="fre-trace")
        tracer = _tracer
    return tracer.submit(fn, *args).result()


def _anchors() -> list:
    """``ANCHORS`` empty ``fre.clock`` ranges on the trace thread, each as
    (perf_counter_ns just before it opened, just after it closed)."""
    from torch.profiler import record_function

    out = []
    for _ in range(ANCHORS):
        a = time.perf_counter_ns()
        with record_function("fre.clock"):
            pass
        out.append((a, time.perf_counter_ns()))
    return out


def _start(logdir: str) -> bool:
    global _trace_dir, _trace_prof, _trace_head, _trace_owns_recording
    import torch
    from torch.profiler import ProfilerActivity, profile

    if _trace_dir is not None:
        return False
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    with _device_alone():
        prof.start()
        _trace_head = _anchors()
        _trace_owns_recording = not _recording
        record_spans(True)
    _trace_dir, _trace_prof = logdir, prof
    return True


def _stop() -> str | None:
    global _trace_dir, _trace_prof
    import os

    if _trace_dir is None:
        return None
    prof, out = _trace_prof, _trace_dir
    _trace_dir = _trace_prof = None
    with _device_alone():
        tail = _anchors()
        prof.stop()
        if _trace_owns_recording:
            record_spans(False)
    # the file is written with the gate open again: serving resumes beside
    # the export, which only reads what was recorded
    os.makedirs(out, exist_ok=True)
    path = os.path.join(out, f"trace_{os.getpid()}_{int(time.time() * 1e3)}.json")
    prof.export_chrome_trace(path)
    _write_spans(path, _trace_head, tail)
    return out


def _write_spans(path: str, head: list, tail: list) -> None:
    """Map the program's clock onto the trace's from the fre.clock anchors
    (the narrowest at each end) and put the spans that overlap the traced
    interval into the trace file as ``fre_span`` events, at the head of its
    ``traceEvents``; with the anchors missing from the file, write no span
    and keep no clock.  The file is read and written as text, and only the
    anchors' events are parsed: a trace of a busy card runs to tens of MB."""
    global _trace_clock
    import os
    import re

    with open(path) as f:
        text = f.read()
    decoder, marks = json.JSONDecoder(), []
    for m in re.finditer(r'"fre\.clock"', text):
        event, _ = decoder.raw_decode(text, text.rfind("{", 0, m.start()))
        if event.get("name") == "fre.clock" and event.get("ph") == "X":
            marks.append(event)
    marks.sort(key=lambda e: float(e["ts"]))
    at = re.search(r'"traceEvents"\s*:\s*\[', text)
    _trace_clock = None
    if len(marks) != len(head) + len(tail) or at is None:
        return
    pairs = list(zip(head + tail, marks))
    ends = []
    for part in (pairs[:len(head)], pairs[len(head):]):
        (a, b), mark = min(part, key=lambda p: p[0][1] - p[0][0])
        ends.append(((a + b) / 2, float(mark["ts"]) + float(mark.get("dur", 0)) / 2, (b - a) / 2))
    (host0, trace0, err0), (host1, trace1, err1) = ends
    clock = {"host_ns": host0, "trace_us": trace0, "us_per_ns": (trace1 - trace0) / (host1 - host0),
             "start_ns": head[-1][1], "stop_ns": tail[0][0], "error_ns": max(err0, err1)}
    idents = thread_idents()
    pid = os.getpid()
    events = [json.dumps({"ph": "X", "cat": "fre_span", "name": s.name, "pid": pid, "tid": s.tid,
                          "ts": _trace_us(s.start_ns, clock),
                          "dur": (s.end_ns - s.start_ns) * clock["us_per_ns"],
                          "args": {**s.attrs, "span_id": s.id, "parent": s.parent,
                                   "cpu_us": s.cpu_ns / 1e3, "native_tid": s.tid,
                                   "pthread_id": idents.get(s.tid)}}, default=str)
              for s in spans() if s.end_ns > clock["start_ns"] and s.start_ns < clock["stop_ns"]]
    if events:
        rest = text[at.end():]
        text = "".join((text[:at.end()], ", ".join(events),
                        "" if rest.lstrip().startswith("]") else ", ", rest))
        with open(path, "w") as f:
            f.write(text)
    _trace_clock = clock


def _trace_us(ns: int, clock: dict) -> float:
    """A ``perf_counter_ns()`` reading on a trace's clock: microseconds as
    its events' ``ts``."""
    return clock["trace_us"] + (ns - clock["host_ns"]) * clock["us_per_ns"]


def trace_clock() -> dict | None:
    """The last written trace's clock: an anchor pair (``host_ns`` on
    ``perf_counter_ns()``, ``trace_us`` on the trace's ``ts``), the rate
    ``us_per_ns``, the traced interval on the program's clock (``start_ns``
    just after the profiler started, ``stop_ns`` just before it stopped),
    and ``error_ns``, half the wider of the two anchors used.  None before a
    trace, or when the anchors were missing from it."""
    return dict(_trace_clock) if _trace_clock else None


def start_device_trace(logdir: str) -> bool:
    """Begin a torch.profiler trace of the host and, where a card is present,
    its device, and record spans (``record_spans``) while it runs.  False if
    one is active.  Any thread may call it."""
    return _on_trace_thread(_start, logdir)


def stop_device_trace() -> str | None:
    """End the active trace and write it into its logdir as a Chrome trace
    (``trace_<pid>_<ms>.json``) with the spans of its interval as
    ``fre_span`` events; span recording stops unless it was on before the
    trace started.  Returns the logdir (None if none active).  Any thread
    may call it, not only the one that started the trace."""
    return _on_trace_thread(_stop)
