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
