"""The port's ``core/metrics``: every case of tests/test_metrics.py runs
here against ``facerecognition_infrenceengine_tpu_torch`` (the file is read,
re-pointed and executed; it stays as it is), the micro-batcher's counters
and the inference server's ``/api/metrics`` endpoint among them; the
gallery those build is routed to the CPU.  The device trace control uses
torch.profiler."""

import json
import os

import pytest

from test_torch_port_cases import cpu_by_default, exec_port_cases

exec_port_cases("test_metrics.py", globals())


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    cpu_by_default(monkeypatch)


def test_device_trace_writes_a_chrome_trace(tmp_path):
    import torch

    logdir = str(tmp_path / "trace")
    assert metrics.stop_device_trace() is None  # noqa: F821
    assert metrics.start_device_trace(logdir)  # noqa: F821
    assert not metrics.start_device_trace(logdir)  # noqa: F821  (one at a time)
    torch.ones(64, 64) @ torch.ones(64, 64)
    assert metrics.stop_device_trace() == logdir  # noqa: F821
    files = os.listdir(logdir)
    assert len(files) == 1 and files[0].endswith(".json")
    with open(os.path.join(logdir, files[0])) as f:
        assert json.load(f)["traceEvents"]
    assert metrics.stop_device_trace() is None  # noqa: F821


def test_device_trace_starts_and_stops_from_different_threads(tmp_path):
    """/api/profiler/start and /stop arrive on two request threads of the
    control API: the trace is started on one thread, stopped on another,
    and written (torch.profiler itself must start and stop on one thread)."""
    import threading

    logdir = str(tmp_path / "trace")
    got = {}

    def on_a_thread(key, fn, *args):
        t = threading.Thread(target=lambda: got.__setitem__(key, fn(*args)))
        t.start()
        t.join()

    on_a_thread("start", metrics.start_device_trace, logdir)  # noqa: F821
    on_a_thread("again", metrics.start_device_trace, logdir)  # noqa: F821
    on_a_thread("stop", metrics.stop_device_trace)  # noqa: F821
    on_a_thread("none", metrics.stop_device_trace)  # noqa: F821
    assert got == {"start": True, "again": False, "stop": logdir, "none": None}
    (name,) = os.listdir(logdir)
    with open(os.path.join(logdir, name)) as f:
        assert "traceEvents" in json.load(f)


def _in_thread(fn, *args):
    import threading

    t = threading.Thread(target=fn, args=args, daemon=True)
    t.start()
    return t


def test_trace_start_and_stop_wait_for_device_work_to_leave(tmp_path):
    """A trace starts and stops only while no thread is inside device work
    (CUDA tracing corrupts the heap when it starts or stops beside a thread
    calling into the card); device work runs on while the trace records."""
    import threading

    inside, leave = threading.Event(), threading.Event()

    def worker():
        with metrics.device_work():  # noqa: F821
            inside.set()
            leave.wait(10)

    logdir = str(tmp_path / "trace")
    for step in ("start", "stop"):
        inside.clear()
        leave.clear()
        w = _in_thread(worker)
        assert inside.wait(10)
        done = threading.Event()
        call = ((lambda: metrics.start_device_trace(logdir)) if step == "start"  # noqa: F821
                else metrics.stop_device_trace)  # noqa: F821
        c = _in_thread(lambda: (call(), done.set()))
        assert not done.wait(0.3), f"the trace's {step} did not wait for device work"
        leave.set()
        assert done.wait(10)
        w.join(10)
        c.join(10)
        if step == "start":  # the gate is open again while the trace records
            with metrics.device_work():  # noqa: F821
                pass
    (name,) = os.listdir(logdir)
    assert name.endswith(".json")


def test_device_work_waits_while_the_gate_is_shut_and_nests():
    """A thread arriving while the gate is shut waits for it to reopen; a
    thread already inside passes again (no deadlock), and the closer waits
    for it to leave the outer section."""
    import threading

    entered, leave, shut, reopen = (threading.Event() for _ in range(4))
    order = []

    def closer():
        with metrics._device_alone():  # noqa: F821
            order.append("alone")
            shut.set()
            reopen.wait(10)
        order.append("reopened")

    def nested():
        with metrics.device_work():  # noqa: F821
            entered.set()
            leave.wait(10)
            with metrics.device_work():  # noqa: F821  (gate shutting: passes)
                order.append("inner")
        order.append("outer left")

    n = _in_thread(nested)
    assert entered.wait(10)
    c = _in_thread(closer)
    late_in = threading.Event()
    assert not shut.wait(0.2)  # the closer waits for the nested thread
    leave.set()
    assert shut.wait(10)

    def newcomer():
        with metrics.device_work():  # noqa: F821
            late_in.set()

    late = _in_thread(newcomer)
    assert not late_in.wait(0.2)  # shut: a newcomer waits
    reopen.set()
    assert late_in.wait(10)
    for t in (n, c, late):
        t.join(10)
    assert order == ["inner", "outer left", "alone", "reopened"]
    assert metrics._gate_inside == 0 and not metrics._gate_shut  # noqa: F821


def test_the_ports_device_entry_points_run_inside_the_gate():
    """Every entry point that calls into the card is gated: the device
    binding of a serving thread, the engine's, FaceAnalysis's (the resolve
    of an async batch and the capture thread's upload too) and the gallery
    snapshot's."""
    from facerecognition_infrenceengine_tpu_torch.core import device
    from facerecognition_infrenceengine_tpu_torch.engine.gallery import _CompanySnapshot
    from facerecognition_infrenceengine_tpu_torch.engine.pipeline import FaceEngine
    from facerecognition_infrenceengine_tpu_torch.models.zoo import FaceAnalysis

    gated = metrics.on_device(lambda: None).__code__  # noqa: F821
    assert device.bind_thread.__code__ is gated  # (resolve_device: the fixture's stand-in)
    entries = {
        FaceEngine: ["__init__", "_to_device", "detect", "embed_faces", "attributes",
                     "embed_crops", "detect_align_embed", "detect_align_embed_flat",
                     "recalibrate_int8", "detect_align_embed_packed",
                     "detect_align_embed_yuv420", "detect_align_embed_yuv420_flat"],
        FaceAnalysis: ["get_batch", "get_batch_async", "encode_frame",
                       "_faces_from_fused_flat"],
        _CompanySnapshot: ["__init__", "apply_delta", "from_device_matrix", "match"],
    }
    for cls, names in entries.items():
        for name in names:
            fn = getattr(cls, name)
            assert getattr(fn, "__func__", fn).__code__ is gated, f"{cls.__name__}.{name}"


def test_a_snapshot_match_waits_while_the_gate_is_shut():
    import threading

    import numpy as np
    from facerecognition_infrenceengine_tpu_torch.engine.gallery import _CompanySnapshot

    vecs = np.eye(4, 512, dtype=np.float32)
    snap = _CompanySnapshot(list("abcd"), {}, vecs, 512, 8, device="cpu")
    shut, reopen, got = threading.Event(), threading.Event(), []

    def closer():
        with metrics._device_alone():  # noqa: F821
            shut.set()
            reopen.wait(10)

    c = _in_thread(closer)
    assert shut.wait(10)
    m = _in_thread(lambda: got.append(snap.match(vecs[2:3])[1]))
    m.join(0.3)
    assert not got
    reopen.set()
    m.join(10)
    c.join(10)
    assert got == [[["c"]]]
