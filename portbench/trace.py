"""The traced span of a run: the port's device trace, read back.

The trace is started and stopped only through the port's device gate
(``core.metrics.start_device_trace`` / ``stop_device_trace``): with the gate
shut no thread is inside a device section and the card has finished its
work, so every batch's device work lies wholly inside the trace or wholly
outside it.  The trace holds the card's kernels, copies and memsets, each
with the correlation id of its launch, and the launches (CUDA runtime and
driver calls) with the thread that made them.  The profiler records the
host's own operators only on the thread that started it, so the harness
keeps its spans on the host clock (``serve.py``) and this file reads the
device side alone.
"""

from __future__ import annotations

import glob
import json
import os
from collections import defaultdict
from dataclasses import dataclass

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


@dataclass
class Trace:
    t0: float       # the profiler's span, us on the trace's clock
    t1: float
    busy: list      # merged device intervals, us
    by_name: dict   # device op name -> us
    ops: list       # (start us, end us, name, launching thread id or None)

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) / 1e6

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy) / 1e6

    def kernel_us(self, part: str) -> float:
        """Device time of the ops whose name holds ``part``."""
        return sum(us for name, us in self.by_name.items() if part in name)

    def roles(self, known: dict) -> dict:
        """Thread id -> role for every launching thread: the harness's own
        record (``known``) where the trace's id matches it, else what the
        thread launched (a top-1 kernel: the results thread; a convolution:
        the dispatch thread; only device-to-host copies: the resolver; only
        host-to-device copies: a client)."""
        launched: dict = defaultdict(set)
        for *_, name, tid in self.ops:
            launched[tid].add(name)
        out = {}
        for tid, names in launched.items():
            text = " ".join(names)
            if tid in known:
                out[tid] = known[tid]
            elif "top1_" in text:
                out[tid] = "results"
            elif "conv" in text or "gemm" in text:
                out[tid] = "dispatch"
            elif all("DtoH" in n for n in names):
                out[tid] = "resolve"
            elif all("HtoD" in n for n in names):
                out[tid] = "client"
            else:
                out[tid] = "other"
        return out

    def idle_gaps(self, roles: dict) -> dict:
        """Idle seconds by the thread the card was waiting for: the role
        (``roles``: thread id -> role) of the thread that launched the op
        that ended each gap; "end" for the gap after the last op."""
        out: dict = defaultdict(float)
        at = self.t0
        for a, b, _name, tid in sorted(self.ops):
            if a > at:
                out[roles.get(tid, "other")] += (a - at) / 1e6
            at = max(at, b)
        if self.t1 > at:
            out["end"] += (self.t1 - at) / 1e6
        return dict(out)


def _merge(intervals: list) -> list:
    out: list = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def parse(events: list) -> Trace:
    """Chrome-trace events -> the profiler's span, device time, device ops
    by name, and each op's launching thread."""
    span = [e for e in events if e.get("cat") == "Trace" and "dur" in e]
    device, launches = [], {}
    for e in events:
        if e.get("ph") != "X":
            continue
        cat, args = e.get("cat", ""), e.get("args") or {}
        if cat in DEVICE_CATS:
            a = float(e["ts"])
            device.append((a, a + float(e.get("dur", 0)), e.get("name", ""),
                           args.get("correlation")))
        elif cat in LAUNCH_CATS and "correlation" in args:
            launches[args["correlation"]] = e.get("tid")
    if span:
        t0 = float(span[0]["ts"])
        t1 = t0 + float(span[0]["dur"])
    elif device:
        t0, t1 = min(a for a, *_ in device), max(b for _, b, *_ in device)
    else:
        raise ValueError("the trace holds neither its span nor a device op")
    by_name: dict = defaultdict(float)
    ops = []
    for a, b, name, corr in device:
        by_name[name] += b - a
        ops.append((a, b, name, launches.get(corr)))
    return Trace(t0, t1, _merge([(a, b) for a, b, *_ in device]), dict(by_name), ops)


def read_dir(logdir: str) -> Trace:
    """The one trace file ``stop_device_trace`` wrote into ``logdir``."""
    paths = sorted(glob.glob(os.path.join(logdir, "*.json")))
    if len(paths) != 1:
        raise ValueError(f"expected one trace in {logdir}, found {len(paths)}")
    with open(paths[0]) as f:
        return parse(json.load(f)["traceEvents"])
