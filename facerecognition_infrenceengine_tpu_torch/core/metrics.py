"""Metrics and profiling (SURVEY.md §5.1/§5.5).

The reference's only observability is wall-clock cadence checks and log
counters (reference trainingServer.py:548-555, peopleCount.py:973-989).
This module gives every subsystem a shared, lock-safe registry of counters,
gauges, and stage timers (count / mean / EWMA / p50 / p95 over a ring
buffer), plus torch.profiler trace control for on-device analysis.  Servers
expose ``snapshot()`` at ``GET /api/metrics``.

Usage:
    from ..core import metrics
    metrics.counter("frames_processed").inc()
    with metrics.timer("engine.detect"):
        ...
    metrics.gauge("gallery.size").set(n)
"""

from __future__ import annotations

import functools
import threading
import time
from collections import deque
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


class _TimerSpan:
    """What ``timer(name)`` hands out: a context manager carrying its own
    start time, so concurrent ``with metrics.timer(name):`` blocks from
    different threads never share mutable state.  The per-name StageTimer
    singleton only accumulates statistics."""

    __slots__ = ("_timer", "_t0")

    def __init__(self, timer: StageTimer):
        self._timer = timer

    def observe(self, seconds: float):
        self._timer.observe(seconds)

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self._timer.observe(time.perf_counter() - self._t0)
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


def timer(name: str) -> _TimerSpan:
    with _LOCK:
        if name not in _timers:
            _timers[name] = StageTimer()
        return _TimerSpan(_timers[name])


def snapshot() -> dict:
    with _LOCK:
        return {
            "counters": {k: v.snapshot() for k, v in _counters.items()},
            "gauges": {k: v.snapshot() for k, v in _gauges.items()},
            "timers": {k: v.snapshot() for k, v in _timers.items()},
        }


def reset() -> None:
    """Test hook: drop all registered instruments."""
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
_tracer = None


def _on_trace_thread(fn, *args):
    global _tracer
    from concurrent.futures import ThreadPoolExecutor

    with _trace_lock:
        if _tracer is None:
            _tracer = ThreadPoolExecutor(max_workers=1, thread_name_prefix="fre-trace")
        tracer = _tracer
    return tracer.submit(fn, *args).result()


def _start(logdir: str) -> bool:
    global _trace_dir, _trace_prof
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
        prof.stop()
    os.makedirs(out, exist_ok=True)
    prof.export_chrome_trace(os.path.join(
        out, f"trace_{os.getpid()}_{int(time.time() * 1e3)}.json"))
    return out


def start_device_trace(logdir: str) -> bool:
    """Begin a torch.profiler trace of the host and, where a card is present,
    its device.  False if one is active.  Any thread may call it."""
    return _on_trace_thread(_start, logdir)


def stop_device_trace() -> str | None:
    """End the active trace and write it into its logdir as a Chrome trace
    (``trace_<pid>_<ms>.json``); returns the logdir (None if none active).
    Any thread may call it, not only the one that started the trace."""
    return _on_trace_thread(_stop)
