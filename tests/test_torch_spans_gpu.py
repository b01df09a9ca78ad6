"""The port's spans on the device trace's clock, on the card.

Marked ``gpu``; the test decides inside a fixture whether a card is there
and skips with a reason when it is not.  This file imports no JAX, so it
runs on a machine without it:
``python -m pytest --noconftest -m gpu -s tests/test_torch_spans_gpu.py``.
"""

import json
import os
import threading
from collections import Counter

import numpy as np
import pytest
import torch

from facerecognition_infrenceengine_tpu_torch.core import metrics

pytestmark = pytest.mark.gpu

SLACK_US = 50.0


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the trace's device side and its runtime events")
    return torch.device("cuda")


def test_a_serving_threads_launches_lie_inside_the_spans_they_were_made_in(cuda, tmp_path):
    """One ``FaceAnalysis.get_batch`` (all four modules) on a thread that
    did not start the trace, inside ``device_work``.  On the trace's clock,
    within 50 us: each host-to-device copy of that thread lies inside an
    ``engine.upload`` span, one copy to a span; each device-to-host copy
    inside an ``engine.wait`` span; every other kernel launch or copy inside
    a span of the thread, and none of them inside ``facade.prep`` or
    ``facade.faces``, which launch nothing.  Prints the smallest distance of
    a copy to an edge of its span: how far the clock could be off and every
    copy still lie inside its span."""
    from facerecognition_infrenceengine_tpu_torch.core.config import EngineConfig
    from facerecognition_infrenceengine_tpu_torch.models.zoo import FaceAnalysis
    from portbench.spans import thread_keys

    metrics.reset()
    cfg = EngineConfig(det_size=(256, 256), max_faces=8, pre_nms_topk=128)
    app = FaceAnalysis(cfg=cfg, device=cuda)
    app.prepare(det_thresh=0.0)
    rng = np.random.default_rng(5)
    frames = [rng.integers(0, 256, (240, 256, 3), np.uint8) for _ in range(4)]
    app.get_batch(frames)  # first calls outside the trace
    torch.cuda.synchronize()
    logdir = str(tmp_path / "trace")
    worker = {}

    def serve():
        worker.update(native=threading.get_native_id(), ident=threading.get_ident())
        with metrics.device_work():
            worker["faces"] = sum(len(f) for f in app.get_batch(frames))

    assert metrics.start_device_trace(logdir)
    t = threading.Thread(target=serve)
    t.start()
    t.join(120)
    assert not t.is_alive()
    metrics.stop_device_trace()
    assert worker["faces"] == 32
    (name,) = os.listdir(logdir)
    with open(os.path.join(logdir, name)) as f:
        events = json.load(f)["traceEvents"]
    keys = thread_keys(worker["native"], worker["ident"])
    spans = [(float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"]) for e in events
             if e.get("cat") == "fre_span" and e["tid"] == worker["native"]]
    kind = {}  # correlation id -> what the device did for the call
    for e in events:
        corr = (e.get("args") or {}).get("correlation")
        if e.get("cat") == "gpu_memcpy":
            kind[corr] = e["name"].split()[1]  # "Memcpy HtoD (Pageable -> Device)"
        elif e.get("cat") in ("kernel", "gpu_memset"):
            kind[corr] = e["cat"]
    launches = [(float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)),
                 kind[e["args"]["correlation"]], e["name"]) for e in events
                if e.get("cat") in ("cuda_runtime", "cuda_driver") and e.get("tid") in keys
                and (e.get("args") or {}).get("correlation") in kind]
    assert {"engine.fused", "engine.attributes", "engine.upload", "engine.wait"} <= {
        s[2] for s in spans}
    seen = Counter((e.get("cat"), e.get("name"), e.get("tid")) for e in events
                   if e.get("cat") in ("cuda_runtime", "cuda_driver"))
    assert launches, (sorted(keys), seen.most_common(30))

    def offset(launch, span) -> float:
        return max(0.0, span[0] - launch[0], launch[1] - span[1])

    expected = {"HtoD": "engine.upload", "DtoH": "engine.wait"}
    worst, margins, uploads_used = 0.0, [], Counter()
    for launch in launches:
        what = expected.get(launch[2])
        if what is not None:
            s = min((s for s in spans if s[2] == what), key=lambda s: offset(launch, s))
            margins.append(min(launch[0] - s[0], s[1] - launch[1]))
            if what == "engine.upload":
                uploads_used[s] += 1
        else:
            mid = (launch[0] + launch[1]) / 2
            around = [s for s in spans if s[0] - SLACK_US <= mid <= s[1] + SLACK_US]
            assert around, f"{launch[3]} ({launch[2]}) at {launch[0]} lies in no span"
            s = max(around, key=lambda s: (s[0], -s[1]))  # the innermost: the latest to open
            assert s[2] not in ("facade.prep", "facade.faces"), (launch, s)
        worst = max(worst, offset(launch, s))
        assert offset(launch, s) <= SLACK_US, (launch, s)
    assert uploads_used and max(uploads_used.values()) == 1, uploads_used
    assert sum(k == "DtoH" for _, _, k, _ in launches) >= 2
    print(f"spans on the trace clock: {len(launches)} launches and copies of the serving thread "
          f"({len(uploads_used)} uploads, {len(margins) - len(uploads_used)} downloads), worst "
          f"offset from its span {worst:.3f} us; the copies' smallest distance to an edge of "
          f"their span {min(margins):.3f} us; anchor half-width "
          f"{metrics.trace_clock()['error_ns'] / 1e3:.3f} us")
    assert worst <= SLACK_US
