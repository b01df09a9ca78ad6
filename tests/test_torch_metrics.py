"""The port's ``core/metrics``: the cases of tests/test_metrics.py that need
only the metrics module run here against
``facerecognition_infrenceengine_tpu_torch.core.metrics`` (the file is read,
re-pointed and executed; it stays as it is).  Its micro-batcher and
``/metrics`` endpoint cases wait for the serving host path (ROADMAP Queue 1
item 6).  The device trace control uses torch.profiler."""

import json
import os

from test_torch_port_cases import exec_port_cases

exec_port_cases("test_metrics.py", globals())
del test_microbatcher_reports_metrics  # noqa: F821  (engine/microbatch.py: item 6)
del test_metrics_endpoint  # noqa: F821  (servers/inference_server.py: item 6)


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
