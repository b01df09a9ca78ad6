"""The port's span recorder (``core/metrics``): spans and their parents, the
batch id across the batcher's threads, recording off, the cap, the clock
anchors and the export into a device trace, and the spans of the serving
path (the int8 passes on a serving thread, the facade, the engine's
entries, the kernel build)."""

import json
import os
import statistics
import threading
import tracemalloc

import numpy as np
import pytest
import torch

from facerecognition_infrenceengine_tpu_torch.core import metrics


@pytest.fixture(autouse=True)
def fresh():
    metrics.reset()
    yield
    metrics.reset()


def _on_thread(fn, *args):
    out = {}
    t = threading.Thread(target=lambda: out.update(value=fn(*args), tid=threading.get_native_id(),
                                                   ident=threading.get_ident()))
    t.start()
    t.join(30)
    assert not t.is_alive()
    return out


def _by_name(spans) -> dict:
    out = {}
    for s in spans:
        out.setdefault(s.name, []).append(s)
    return out


def test_spans_nest_and_name_their_parent_on_their_thread():
    metrics.record_spans(True)
    with metrics.span("outer", batch=4):
        with metrics.span("middle"):
            with metrics.span("inner", bytes=12):
                pass
        with metrics.span("sibling"):
            pass
    other = _on_thread(lambda: metrics.span("elsewhere").__enter__().__exit__(None, None, None))
    got = _by_name(metrics.spans())
    (outer,), (middle,), (inner,), (sibling,) = (got[n] for n in ("outer", "middle", "inner",
                                                                   "sibling"))
    assert outer.parent is None and middle.parent == outer.id == sibling.parent
    assert inner.parent == middle.id
    assert outer.attrs == {"batch": 4} and inner.attrs == {"bytes": 12}
    assert outer.start_ns <= middle.start_ns <= inner.start_ns <= inner.end_ns <= middle.end_ns
    assert middle.end_ns <= sibling.start_ns <= sibling.end_ns <= outer.end_ns
    assert {s.tid for s in (outer, middle, inner, sibling)} == {threading.get_native_id()}
    assert all(0 <= s.cpu_ns for s in metrics.spans())
    (elsewhere,) = got["elsewhere"]
    assert elsewhere.parent is None and elsewhere.tid == other["tid"] != outer.tid
    assert metrics.thread_idents()[other["tid"]] == other["ident"]


def test_a_timer_is_a_span_and_feeds_its_stage_timer():
    with metrics.timer("stage", batch=1):
        pass
    assert metrics.spans() == []  # recording off: the timer alone
    metrics.record_spans(True)
    with metrics.timer("stage", batch=2):
        with metrics.span("child"):
            pass
    assert metrics.snapshot()["timers"]["stage"]["count"] == 2
    got = _by_name(metrics.spans())
    (stage,), (child,) = got["stage"], got["child"]
    assert stage.attrs == {"batch": 2} and child.parent == stage.id


def test_recording_off_records_and_allocates_nothing():
    def calls(n):
        for _ in range(n):
            with metrics.span("engine.upload", bytes=n):
                pass
            with metrics.span("facade.prep"):
                pass
            metrics.add_span("batcher.queue", 1, 2, 7, batch=3)

    calls(100)
    assert metrics.span("a") is metrics.span("b", batch=1)  # one shared no-op
    tracemalloc.start()
    try:
        before, _ = tracemalloc.get_traced_memory()
        tracemalloc.reset_peak()
        calls(10_000)
        after, peak = tracemalloc.get_traced_memory()
    finally:
        tracemalloc.stop()
    assert metrics.spans() == [] and not metrics.recording()
    assert after - before < 1024 and peak - before < 4096  # no allocation a call


def test_the_cap_keeps_the_first_spans_and_counts_the_rest(monkeypatch):
    monkeypatch.setattr(metrics, "SPAN_CAP", 5)
    metrics.record_spans(True)
    for i in range(8):
        with metrics.span("s", i=i):
            pass
    assert [s.attrs["i"] for s in metrics.spans()] == [0, 1, 2, 3, 4]
    assert metrics.snapshot()["counters"]["spans.dropped"] == 3
    metrics.record_spans(False)
    metrics.record_spans(True)  # a fresh recording
    assert metrics.spans() == []


def test_one_batch_id_across_the_dispatch_and_resolver_threads():
    from facerecognition_infrenceengine_tpu_torch.core.config import EngineConfig
    from facerecognition_infrenceengine_tpu_torch.engine.microbatch import MicroBatcher
    from facerecognition_infrenceengine_tpu_torch.models.zoo import (
        FakeFaceAnalysis, encode_fake_face)

    metrics.record_spans(True)
    mb = MicroBatcher(FakeFaceAnalysis(), EngineConfig(microbatch_max=4, frame_queue_depth=4))
    mb.start()
    submitted = {}
    try:
        def camera(c):
            futs = [mb.submit(f"cam{c}", encode_fake_face(10 * c + k)) for k in range(3)]
            return [len(f.result(timeout=30)) for f in futs]

        threads = {}
        for c in range(3):
            out = {}
            t = threading.Thread(target=lambda c=c, out=out: out.update(
                faces=camera(c), tid=threading.get_native_id()))
            t.start()
            threads[c] = (t, out)
        for t, out in threads.values():
            t.join(30)
            assert not t.is_alive() and out["faces"] == [1, 1, 1]
            submitted[out["tid"]] = 3
    finally:
        mb.stop()
    got = _by_name(metrics.spans())
    dispatch = {s.attrs["batch"]: s for s in got["microbatch.dispatch"]}
    resolve = {s.attrs["batch"]: s for s in got["microbatch.resolve"]}
    assert len(dispatch) == len(got["microbatch.dispatch"]) == mb.stats["dispatches"]
    assert set(resolve) == set(dispatch)
    assert sum(s.attrs["frames"] for s in dispatch.values()) == 9
    (dispatch_tid,) = {s.tid for s in dispatch.values()}
    (resolve_tid,) = {s.tid for s in resolve.values()}
    assert dispatch_tid != resolve_tid
    queue = got["batcher.queue"]
    assert len(queue) == 9
    assert {s.tid: sum(1 for q in queue if q.tid == s.tid) for s in queue} == submitted
    for q in queue:
        d = dispatch[q.attrs["batch"]]
        assert q.start_ns <= q.end_ns <= d.start_ns
        assert resolve[q.attrs["batch"]].start_ns >= d.start_ns
    for b, d in dispatch.items():
        assert sum(1 for q in queue if q.attrs["batch"] == b) == d.attrs["frames"]


def test_the_int8_passes_are_spans_on_a_serving_thread():
    from facerecognition_infrenceengine_tpu_torch.ops import int8_conv

    torch.manual_seed(0)
    x = torch.randn(2, 6, 6, 8)
    w8 = torch.randint(-127, 128, (3, 3, 8, 8), dtype=torch.int8)
    metrics.record_spans(True)
    other = _on_thread(lambda: int8_conv.int8_conv2d_nhwc(int8_conv.quantize_act(x, 0.05), w8,
                                                          1, 1))
    got = _by_name(metrics.spans())
    for name in ("int8.quantize", "int8.im2col", "int8.int_mm", "int8.dequantize"):
        assert {s.tid for s in got[name]} == {other["tid"]}, name
    assert "record_function" not in open(int8_conv.__file__).read()


def _trace_events(logdir: str) -> list:
    (name,) = os.listdir(logdir)
    with open(os.path.join(logdir, name)) as f:
        return json.load(f)["traceEvents"]


def test_a_span_on_the_trace_thread_maps_onto_its_profiler_range(tmp_path):
    """The clock anchors: a span opened around a record_function on the
    trace thread lands, on the trace's clock, within 50 us of that range's
    event at both ends (the median of nine such probes: the thread can be
    preempted between the two opens on a loaded host)."""
    logdir = str(tmp_path / "trace")

    def probe():
        for i in range(9):
            with metrics.span("probe", i=i):
                with torch.profiler.record_function(f"probe.range.{i}"):
                    torch.ones(32, 32) @ torch.ones(32, 32)

    assert metrics.start_device_trace(logdir)
    metrics._on_trace_thread(probe)
    metrics.stop_device_trace()
    events = _trace_events(logdir)
    starts, ends = [], []
    for i in range(9):
        (rf,) = [e for e in events if e.get("name") == f"probe.range.{i}"]
        (sp,) = [e for e in events if e.get("cat") == "fre_span" and e["args"].get("i") == i]
        starts.append(abs(sp["ts"] - rf["ts"]))
        ends.append(abs((sp["ts"] + sp["dur"]) - (rf["ts"] + rf["dur"])))
    assert statistics.median(starts) <= 50 and statistics.median(ends) <= 50, (starts, ends)
    clock = metrics.trace_clock()
    assert clock["error_ns"] < 50_000 and clock["start_ns"] < clock["stop_ns"]
    assert abs(clock["us_per_ns"] - 1e-3) < 1e-5


def test_the_trace_file_carries_the_spans_of_its_interval(tmp_path):
    logdir = str(tmp_path / "trace")
    metrics.record_spans(True)
    with metrics.span("before"):
        pass
    assert metrics.start_device_trace(logdir)

    def serve():
        with metrics.span("worker", batch=9):
            with metrics.span("engine.upload", bytes=64):
                torch.ones(8, 8).sum()
        return metrics.thread_id()

    worker = _on_thread(serve)
    metrics.stop_device_trace()
    assert metrics.recording()  # it was on before the trace: stays on
    events = _trace_events(logdir)
    spans = [e for e in events if e.get("cat") == "fre_span"]
    assert sorted(e["name"] for e in spans) == ["engine.upload", "worker"]
    for e in spans:
        assert e["ph"] == "X" and e["pid"] == os.getpid() and e["dur"] >= 0
        assert e["tid"] == e["args"]["native_tid"] == worker["value"] == worker["tid"]
        assert e["args"]["pthread_id"] == worker["ident"]
    up = [e for e in spans if e["name"] == "engine.upload"][0]
    top = [e for e in spans if e["name"] == "worker"][0]
    assert up["args"]["bytes"] == 64 and top["args"]["batch"] == 9
    assert up["args"]["parent"] == top["args"]["span_id"] and top["args"]["parent"] is None
    assert top["ts"] <= up["ts"] and up["ts"] + up["dur"] <= top["ts"] + top["dur"] + 1e-3
    assert not [e for e in events if e.get("cat") == "fre_span" and e["name"] == "before"]
    kinds = {e.get("cat") for e in events} - {"fre_span"}
    metrics.record_spans(False)
    assert metrics.start_device_trace(logdir + "2")
    metrics.stop_device_trace()
    assert not metrics.recording()  # the trace switched it on, and off again
    assert "fre_span" not in kinds


def test_the_serving_path_records_its_layers_and_first_calls():
    """A FaceAnalysis batch with the attribute heads on (the fused path at
    letterbox scale 1): the facade's prep and faces, the upload, the fused
    and attribute modules with their waits; the first call at a shape once."""
    from facerecognition_infrenceengine_tpu_torch.core.config import EngineConfig
    from facerecognition_infrenceengine_tpu_torch.engine.pipeline import FaceEngine
    from facerecognition_infrenceengine_tpu_torch.models.zoo import FaceAnalysis

    cfg = EngineConfig(det_size=(128, 128), max_faces=4, pre_nms_topk=64, dtype="float32")
    engine = FaceEngine(cfg, det_arch="det_2.5g", rec_arch="r18", device="cpu")
    assert metrics.snapshot()["timers"]["engine.init"]["count"] == 1
    app = FaceAnalysis(cfg=cfg, engine=engine, device="cpu")
    app.prepare(det_thresh=0.0)
    frames = [np.random.default_rng(i).integers(0, 256, (128, 128, 3), np.uint8)
              for i in range(2)]
    metrics.record_spans(True)
    first = app.get_batch(frames)
    firsts = metrics.snapshot()["timers"]["engine.first_call"]["count"]
    assert firsts >= 2 and sum(len(f) for f in first) == 8  # detect_align_embed_flat, attributes
    metrics.record_spans(False)
    metrics.record_spans(True)
    with metrics.span("batch"):
        app.get_batch(frames)
    assert metrics.snapshot()["timers"]["engine.first_call"]["count"] == firsts
    got = _by_name(metrics.spans())
    assert "engine.first_call" not in got
    (batch,) = got["batch"]
    for name in ("facade.prep", "facade.faces", "engine.fused", "engine.attributes",
                 "engine.wait"):
        assert got[name], name
    assert {s.parent for s in got["facade.prep"]} == {batch.id}
    (fused,), (attrs,) = got["engine.fused"], got["engine.attributes"]
    waits = {s.parent for s in got["engine.wait"]}
    assert attrs.id in waits and len(got["engine.wait"]) == 2
    assert sum(s.end_ns - s.start_ns for s in got["facade.faces"]) > 0
    assert "engine.upload" not in got  # no card, no copy


def test_loading_a_kernel_library_is_timed(monkeypatch):
    from facerecognition_infrenceengine_tpu_torch.kernels import build

    build.host_lib()  # built and loaded once in this process
    metrics.reset()
    monkeypatch.setattr(build, "_host_lib", None)
    metrics.record_spans(True)
    build.host_lib()
    assert metrics.snapshot()["timers"]["kernels.build"]["count"] == 1
    (s,) = [s for s in metrics.spans() if s.name == "kernels.build"]
    assert s.attrs == {"library": "host"}
