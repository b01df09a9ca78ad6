"""The benchmark's readers of the port's spans (``portbench/spans.py`` and
the per-layer metrics over it) on a synthetic run, the idle attribution,
and ``trace.parse`` unmoved by the spans the port writes into a trace."""

import importlib.util
import os
from types import SimpleNamespace

import pytest

from facerecognition_infrenceengine_tpu_torch.core import metrics
from facerecognition_infrenceengine_tpu_torch.core.metrics import Span
from portbench import spans, trace

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MS = 1_000_000  # ns
D, R, C1, C2, M = 100, 101, 102, 103, 104  # dispatch, resolve, two clients, results
D_IDENT = (1 << 40) + (1 << 31) + 5         # dispatch's pthread id: its low 32 bits signed < 0
NEW = ["batcher.queue_wait_ms", "facade.prep_ms", "engine.upload_ms",
       "engine.h2d_mib_per_frame", "engine.launch_ms", "engine.wait_ms", "facade.faces_ms",
       "batcher.dispatch_off_cpu_ms", "gallery.match_ms", "setup.kernel_build_s",
       "setup.engine_init_s", "setup.first_call_s", "device.idle_named_pct"]


def reader(name: str):
    spec = importlib.util.spec_from_file_location(
        f"test_reader_{name}", os.path.join(ROOT, "portbench", "metrics", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _s(id_, name, tid, a_ms, b_ms, parent=None, cpu_ms=None, **attrs):
    cpu = (b_ms - a_ms) if cpu_ms is None else cpu_ms
    return Span(id_, name, tid, int(a_ms * MS), int(b_ms * MS), int(cpu * MS), parent, attrs)


def synthetic_program() -> SimpleNamespace:
    """Batch 1 wholly inside the traced interval (0.5-20 ms), batch 2
    dispatched inside it and ending after it."""
    spans_ = [
        _s(1, "microbatch.dispatch", D, 1.0, 11.0, cpu_ms=6.0, batch=1, frames=2),
        _s(2, "facade.prep", D, 1.0, 3.0, 1),
        _s(3, "engine.upload", D, 3.0, 3.5, 1, bytes=2 * 2**20),
        _s(4, "engine.fused", D, 3.5, 6.5, 1),
        _s(5, "engine.wait", D, 6.5, 8.5, 1, cpu_ms=0.5),
        _s(6, "facade.faces", D, 8.5, 10.0, 1),
        _s(7, "microbatch.resolve", R, 11.0, 11.2, batch=1),
        _s(8, "batcher.queue", C1, 0.2, 1.0, batch=1),
        _s(9, "batcher.queue", C2, 0.5, 1.0, batch=1),
        _s(10, "batcher.queue", C1, 0.1, 0.4, batch=0),  # ended before the interval
        _s(11, "decide.match", M, 12.0, 14.0),
        _s(12, "gallery.match", M, 12.5, 13.5, 11),
        _s(13, "microbatch.dispatch", D, 11.0, 30.0, batch=2, frames=2),
        _s(14, "facade.prep", D, 11.0, 29.0, 13),
    ]
    clock = {"host_ns": 0, "trace_us": 1000.0, "us_per_ns": 1e-3, "start_ns": MS // 2,
             "stop_ns": 20 * MS, "error_ns": 1000.0}
    timers = {"kernels.build": {"count": 2, "mean_ms": 50.0},
              "engine.init": {"count": 1, "mean_ms": 1200.0},
              "engine.first_call": {"count": 4, "mean_ms": 250.0}}
    return SimpleNamespace(spans=spans_, clock=clock, idents={D: D_IDENT, M: None}, timers=timers)


def synthetic_trace() -> trace.Trace:
    """Ops on the trace's clock (1000 us + ns / 1000): two launched by the
    dispatch thread (named by the low 32 bits of its pthread id, signed,
    and by their magnitude), one by the results thread (by its native
    id)."""
    low = D_IDENT & 0xFFFFFFFF
    ops = [(4200.0, 4300.0, "upload", low - (1 << 32)), (4600.0, 7000.0, "conv", (1 << 32) - low),
           (13200.0, 13300.0, "top1", M)]
    return trace.Trace(1500.0, 21000.0, [(a, b) for a, b, *_ in ops],
                       {n: b - a for a, b, n, _ in ops}, ops)


def synthetic_run(**kw) -> SimpleNamespace:
    return SimpleNamespace(program=synthetic_program(), trace=synthetic_trace(), **kw)


EXPECTED = {
    "batcher.queue_wait_ms": (0.8 + 0.5) / 2,
    "facade.prep_ms": 2.0,
    "engine.upload_ms": 0.5,
    "engine.h2d_mib_per_frame": 1.0,
    "engine.launch_ms": 3.0,
    "engine.wait_ms": 2.0,
    "facade.faces_ms": 1.5,
    "batcher.dispatch_off_cpu_ms": (10.0 - 6.0) - (2.0 - 0.5),
    "gallery.match_ms": 1.0,
    "setup.kernel_build_s": 0.1,
    "setup.engine_init_s": 1.2,
    "setup.first_call_s": 1.0,
    "device.idle_named_pct": 100.0 * 2.7 / 16.9,
}


@pytest.mark.parametrize("name", NEW)
def test_each_reader_on_a_synthetic_run(name):
    assert reader(name).read(synthetic_run()) == pytest.approx(EXPECTED[name], rel=1e-9)


def test_the_idle_attribution_follows_the_launching_thread():
    got = spans.idle_by_span(synthetic_trace(), synthetic_program())
    want = {"no span": 6.5e-3, "facade.prep": 2.0e-3, "engine.upload": 0.4e-3,
            "engine.fused": 0.1e-3, "decide.match": 0.2e-3, "end": 7.7e-3}
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k] == pytest.approx(v, abs=1e-9), k


@pytest.mark.parametrize("client_native", [90, 110])
def test_threads_the_trace_names_alike_are_told_apart_by_their_open_spans(client_native):
    """The results thread and a client whose pthread ids lie 4 GiB apart
    share the trace's 32-bit id; the op ending a gap goes to the results
    thread, whose open span opened last, whichever was seen first."""
    ident = (0x7F54 << 32) + 0xD7FFF6C0
    program = SimpleNamespace(
        spans=[_s(1, "decide.match", M, 12.0, 14.0), _s(2, "gallery.match", M, 12.5, 13.5, 1),
               _s(3, "batcher.queue", client_native, 2.0, 13.5, batch=4)],
        clock={"host_ns": 0, "trace_us": 1000.0, "us_per_ns": 1e-3, "start_ns": MS // 2,
               "stop_ns": 20 * MS, "error_ns": 1000.0},
        idents={M: ident, client_native: ident - (1 << 32)}, timers={})
    ops = [(14200.0, 14300.0, "upload", ident & 0xFFFFFFFF)]
    tr = trace.Trace(1500.0, 21000.0, [(14200.0, 14300.0)], {"upload": 100.0}, ops)
    got = spans.idle_by_span(tr, program)
    want = {"no span": 11.5e-3, "decide.match": 0.5e-3, "gallery.match": 0.7e-3, "end": 6.7e-3}
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k] == pytest.approx(v, abs=1e-9), k


def test_a_batch_is_its_dispatch_and_resolve_trees_inside_the_interval():
    (b,) = spans.batches(synthetic_program())
    assert (b.id, b.frames) == (1, 2)
    assert sorted(s.id for s in b.spans) == [1, 2, 3, 4, 5, 6, 7]
    assert spans.self_ns(b.dispatch, b.children) == 1 * MS


@pytest.mark.parametrize("name", NEW)
def test_each_reader_finds_nothing_where_the_port_keeps_no_spans(name, monkeypatch):
    """A port without the recorder (the parent of this benchmark's
    readers), or with no trace taken: None, nothing raised."""
    run = SimpleNamespace(trace=synthetic_trace())
    monkeypatch.delattr(metrics, "spans")
    assert reader(name).read(run) is None
    monkeypatch.undo()
    empty = SimpleNamespace(spans=[], clock=None, idents={}, timers={})
    assert reader(name).read(SimpleNamespace(program=empty, trace=None)) is None


def _fixture_events(with_spans: bool) -> list:
    events = [
        {"ph": "X", "cat": "Trace", "name": "PyTorch Profiler", "ts": 100.0, "dur": 900.0},
        {"ph": "X", "cat": "user_annotation", "name": "fre.clock", "pid": 1, "tid": 9,
         "ts": 101.0, "dur": 1.0},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "pid": 1, "tid": 7,
         "ts": 200.0, "dur": 5.0, "args": {"correlation": 11}},
        {"ph": "X", "cat": "kernel", "name": "k_a", "pid": 0, "tid": 0, "ts": 210.0,
         "dur": 50.0, "args": {"correlation": 11}},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaMemcpyAsync", "pid": 1, "tid": 8,
         "ts": 300.0, "dur": 5.0, "args": {"correlation": 12}},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD", "pid": 0, "tid": 1, "ts": 305.0,
         "dur": 20.0, "args": {"correlation": 12}},
        {"ph": "X", "cat": "kernel", "name": "k_a", "pid": 0, "tid": 0, "ts": 320.0,
         "dur": 10.0, "args": {"correlation": 13}},
    ]
    if with_spans:
        events += [
            {"ph": "X", "cat": "fre_span", "name": "engine.fused", "pid": 1, "tid": 7,
             "ts": 150.0, "dur": 400.0, "args": {"span_id": 3, "parent": 1, "cpu_us": 300.0,
                                                  "native_tid": 7, "pthread_id": 77}},
            {"ph": "X", "cat": "fre_span", "name": "microbatch.dispatch", "pid": 1, "tid": 7,
             "ts": 50.0, "dur": 2000.0, "args": {"batch": 4, "span_id": 1, "parent": None}},
        ]
    return events


def test_trace_parse_reads_the_same_with_and_without_the_ports_spans():
    plain, spanned = trace.parse(_fixture_events(False)), trace.parse(_fixture_events(True))
    for field in ("t0", "t1", "busy", "by_name", "ops"):
        assert getattr(spanned, field) == getattr(plain, field), field
    assert plain.by_name == {"k_a": 60.0, "Memcpy HtoD": 20.0}
    assert plain.ops[0][3] == 7 and plain.ops[2][3] is None
