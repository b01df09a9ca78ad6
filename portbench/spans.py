"""The port's own spans, as the per-layer readers read them.

While a device trace runs the port records a span at each layer boundary
of its serving path (``core/metrics.span``: name, thread, start and end on
``perf_counter_ns``, the thread's CPU time, the enclosing span, attributes
such as the batch id), and after the trace it keeps the trace's clock:
the traced interval on the program's clock and the map onto the trace's
``ts``.  A reader takes them from ``run.program`` where a run carries them
(a test's synthetic run), else from the port in this process; a port that
keeps no spans gives None, and so does every reader of them.

A batch is the ``microbatch.dispatch`` span of one batch id that lies
wholly inside the traced interval (a dispatch that began before the stop
and waited at the shut device gate runs its children after recording
stopped), with every span below it and below the ``microbatch.resolve``
span of the same id.  A span's self time is its wall time less that of its
children.
"""

from __future__ import annotations

import sys
from collections import defaultdict
from types import SimpleNamespace

ENGINE_MODULES = ("engine.detect", "engine.embed", "engine.attributes", "engine.fused")


def program(run):
    """The port's spans, trace clock, thread ids and timers
    (``SimpleNamespace(spans, clock, idents, timers)``), or None."""
    given = getattr(run, "program", None)
    if given is not None:
        return given
    try:
        from facerecognition_infrenceengine_tpu_torch.core import metrics
    except ImportError:
        return None
    # the benchmark's files also run over an older port, which keeps no spans
    if not all(hasattr(metrics, f) for f in ("spans", "trace_clock", "thread_idents")):
        return None
    return SimpleNamespace(spans=metrics.spans(), clock=metrics.trace_clock(),
                           idents=metrics.thread_idents(),
                           timers=metrics.snapshot()["timers"])


def timer_s(run, name: str):
    """Total seconds of the port's timer ``name`` in this process, or None."""
    p = program(run)
    t = (p.timers if p is not None else {}).get(name, {"count": 0})
    return t["mean_ms"] * t["count"] / 1e3 if t["count"] else None


def traced(run):
    """The program's spans with a trace clock, or None."""
    p = program(run)
    return p if p is not None and p.clock and p.spans else None


def in_interval(p, ns: int) -> bool:
    return p.clock["start_ns"] <= ns <= p.clock["stop_ns"]


def _children(spans: list) -> dict:
    out = defaultdict(list)
    for s in spans:
        if s.parent is not None:
            out[s.parent].append(s)
    return out


def _below(span, children: dict) -> list:
    out, todo = [], [span]
    while todo:
        s = todo.pop()
        out.append(s)
        todo.extend(children.get(s.id, ()))
    return out


def self_ns(span, children: dict) -> int:
    return (span.end_ns - span.start_ns) - sum(c.end_ns - c.start_ns
                                               for c in children.get(span.id, ()))


def batches(p) -> list:
    """The traced batches: ``SimpleNamespace(id, frames, dispatch, spans,
    children)`` with ``spans`` every span below its dispatch and resolve."""
    children = _children(p.spans)
    resolves = {s.attrs.get("batch"): s for s in p.spans if s.name == "microbatch.resolve"}
    out = []
    for d in p.spans:
        if (d.name == "microbatch.dispatch" and in_interval(p, d.start_ns)
                and in_interval(p, d.end_ns)):
            below = _below(d, children)
            r = resolves.get(d.attrs.get("batch"))
            if r is not None:
                below += _below(r, children)
            out.append(SimpleNamespace(id=d.attrs.get("batch"), frames=d.attrs.get("frames", 0),
                                       dispatch=d, spans=below, children=children))
    return out


def self_ms_per_batch(run, names) -> float | None:
    """Mean over the traced batches of the self time of their spans named
    one of ``names``, ms."""
    p = traced(run)
    bs = batches(p) if p else []
    if not bs:
        return None
    total = sum(self_ns(s, b.children) for b in bs for s in b.spans if s.name in names)
    return total / len(bs) / 1e6


def trace_us(ns: int, clock: dict) -> float:
    return clock["trace_us"] + (ns - clock["host_ns"]) * clock["us_per_ns"]


def thread_keys(native: int, ident) -> set:
    """The ids a trace may give a thread: ``serve.thread_keys``' (its native
    id, its pthread id whole and in its low 32 bits, signed or not) and the
    magnitude of the signed low 32 bits, which the card's profiler wrote
    for the runtime calls of a thread whose bit 31 is set."""
    keys = {native}
    if ident is not None:
        low = ident & 0xFFFFFFFF
        signed = low - (1 << 32) if low >= 1 << 31 else low
        keys |= {ident, low, signed, abs(signed)}
    return keys


def idle_by_span(trace, p) -> dict:
    """The traced span's idle seconds put down to what the host was doing:
    each gap between device ops spread over the innermost spans open, during
    the gap, on the thread that launched the op ending it; what no span
    covers is "no span", the gap after the last op "end".

    A trace may name two threads alike: the low 32 bits of their pthread
    ids are equal where their stacks lie a multiple of 4 GiB apart.  The op
    is then put down to the one of them whose latest span still open when
    the op started opened last: the thread at work, not one waiting."""
    by_thread = defaultdict(list)
    for s in p.spans:
        by_thread[s.tid].append((trace_us(s.start_ns, p.clock), trace_us(s.end_ns, p.clock),
                                 s.name))
    for v in by_thread.values():
        v.sort()
    owners = defaultdict(list)  # an id in the trace -> the threads it may name
    for native in sorted(by_thread):
        for key in thread_keys(native, p.idents.get(native)):
            owners[key].append(native)

    def launcher(tid, at_us: float):
        natives = owners.get(tid, ())
        if len(natives) < 2:
            return natives[0] if natives else None
        return max(natives, key=lambda n: max((s[0] for s in by_thread[n]
                                               if s[0] <= at_us < s[1]), default=float("-inf")))

    gaps = defaultdict(list)  # thread -> [(g0, g1)] in time order
    out: dict = defaultdict(float)
    at = trace.t0
    for a, b, _name, tid in sorted(trace.ops):
        if a > at:
            native = launcher(tid, a)
            if native is None:
                out["no span"] += (a - at) / 1e6
            else:
                gaps[native].append((at, a))
        at = max(at, b)
    if trace.t1 > at:
        out["end"] += (trace.t1 - at) / 1e6
    for native, todo in gaps.items():
        spans, nxt, active = by_thread[native], 0, []
        for g0, g1 in todo:
            while nxt < len(spans) and spans[nxt][0] < g1:
                active.append(spans[nxt])
                nxt += 1
            active = [s for s in active if s[1] > g0]
            cuts = sorted({g0, g1} | {x for s in active for x in s[:2] if g0 < x < g1})
            for x, y in zip(cuts, cuts[1:]):
                mid = (x + y) / 2
                open_ = [s for s in active if s[0] <= mid < s[1]]
                name = max(open_, key=lambda s: (s[0], -s[1]))[2] if open_ else "no span"
                out[name] += (y - x) / 1e6
    return dict(out)


def log_idle(by_span: dict) -> None:
    total = sum(by_span.values())
    named = total - by_span.get("no span", 0.0) - by_span.get("end", 0.0)
    parts = ", ".join(f"{k} {v:.4f}" for k, v in sorted(by_span.items(), key=lambda kv: -kv[1]))
    print(f"idle by span (s of {total:.4f}; {100 * named / total if total else 0:.1f}% "
          f"named): {parts}", file=sys.stderr, flush=True)
