"""The serving host path of the port against the reference: the
micro-batcher, the camera manager, the inference server's control API and
the upload-on-submit transport, on the CPU.

The reference's own cases run against the port (tests/test_torch_port_cases.py):
every case of tests/test_adaptive_streaming.py, the two control-plane cases
of tests/test_servers.py that need only this slice's modules, and the two
non-slow FaceAnalysis cases of tests/test_streaming_bench.py.  Their
galleries and engines are built with no device, which on the port means
``cuda``; an autouse fixture routes that default to the CPU for each test.
"""

import dataclasses
import os
import threading
import time

import cv2
import numpy as np
import pytest
import torch

from facerecognition_infrenceengine_tpu.core import config as ref_config
from facerecognition_infrenceengine_tpu.domain.cameras import (
    CameraManager as RefCameraManager)
from facerecognition_infrenceengine_tpu.engine import microbatch as ref_microbatch
from facerecognition_infrenceengine_tpu.engine.gallery import (
    GalleryManager as RefGalleryManager)
from facerecognition_infrenceengine_tpu.engine.pipeline import (
    FaceEngine as RefFaceEngine)
from facerecognition_infrenceengine_tpu.engine.recognizer import (
    FaceRecognitionProcessor as RefProcessor)
from facerecognition_infrenceengine_tpu.models import zoo as ref_zoo
from facerecognition_infrenceengine_tpu.servers import inference_server as ref_server
from facerecognition_infrenceengine_tpu_torch.core import config
from facerecognition_infrenceengine_tpu_torch.domain.cameras import CameraManager
from facerecognition_infrenceengine_tpu_torch.engine import microbatch
from facerecognition_infrenceengine_tpu_torch.engine.gallery import GalleryManager
from facerecognition_infrenceengine_tpu_torch.engine.pipeline import FaceEngine
from facerecognition_infrenceengine_tpu_torch.engine.recognizer import (
    FaceRecognitionProcessor)
from facerecognition_infrenceengine_tpu_torch.models import zoo
from facerecognition_infrenceengine_tpu_torch.servers import inference_server
from test_torch_gallery import Twin
from test_torch_port_cases import cpu_by_default, exec_port_cases

exec_port_cases("test_adaptive_streaming.py", globals())
exec_port_cases("test_servers.py", globals(),
                only=("test_inference_control_api", "test_capture_is_free_running"))
exec_port_cases("test_streaming_bench.py", globals(),
                only=("test_mixed_yuv_and_raw_batch_does_not_crash",
                      "test_yuv_host_decode_roundtrip"))


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    cpu_by_default(monkeypatch)


# --------------------------------------------------- the process config
SERVING = dict(microbatch_max=4, microbatch_window_ms=3.0, frame_queue_depth=3,
               inflight_batches=2, upload_on_submit=True, stream_profile="auto",
               target_p50_ms=150.0, adapt_interval_s=0.5)


def test_process_config_reaches_every_constructor():
    """Under one set_config, the recognizer, the engine, the facade and the
    batcher built with no cfg read the process config in both packages
    (ROADMAP Queue 3 item 3), and the default comes back afterwards."""
    seen = {}
    for name, mod, build in (
            ("reference", ref_config, lambda: (RefProcessor(gallery=None),
                                               RefFaceEngine().cfg, ref_zoo.FaceAnalysis())),
            ("port", config, lambda: (FaceRecognitionProcessor(gallery=None),
                                      FaceEngine(device="cpu").cfg, zoo.FaceAnalysis()))):
        before = mod.get_config()
        mod.set_config(mod.Config(thresholds=mod.ThresholdConfig(recognition=0.9),
                                  engine=mod.EngineConfig(gallery_dtype="int8", max_faces=8,
                                                          **SERVING)))
        try:
            proc, engine_cfg, app = build()
            batcher_mod = ref_microbatch if name == "reference" else microbatch
            mb = batcher_mod.MicroBatcher(app)
            seen[name] = (proc.recognition_threshold,
                          [(c.gallery_dtype, c.max_faces) for c in (engine_cfg, app.cfg, mb.cfg)],
                          {k: getattr(mb.cfg, k) for k in SERVING},
                          (mb.depth, mb.inflight_limit, mb._adaptive))
        finally:
            mod.set_config(before)
    assert seen["port"] == seen["reference"]
    assert seen["port"] == (0.9, [("int8", 8)] * 3, SERVING, (3, 2, True))
    assert config.get_config() == config.Config()
    assert zoo.FaceAnalysis().cfg == config.EngineConfig()


def test_engine_config_serving_fields_are_the_reference_defaults():
    ref, port = ref_config.EngineConfig(), config.EngineConfig()
    for name in ("microbatch_max", "microbatch_window_ms", "frame_queue_depth",
                 "inflight_batches", "upload_on_submit", "stream_profile",
                 "target_p50_ms", "adapt_interval_s"):
        assert getattr(port, name) == getattr(ref, name)
        assert type(getattr(port, name)) is type(getattr(ref, name))
    ref_fields = {f.name for f in dataclasses.fields(ref)}
    port_fields = {f.name for f in dataclasses.fields(port)}
    # every field of the reference's, the scale modes of ROADMAP Queue 1 item 4
    # among them, with its default and type
    assert ref_fields - port_fields == set()
    for name in ("embed_int8", "det_int8", "packed_stem", "packed_stem_impl"):
        assert getattr(port, name) == getattr(ref, name)
        assert type(getattr(port, name)) is type(getattr(ref, name))


def test_scale_mode_fields_reach_the_engine_config():
    """The three scale-mode fields and packed_stem_impl="xla" go through the
    process config to the facade's EngineConfig, as the serving fields do;
    an unknown packed-stem strategy is refused."""
    modes = dict(embed_int8=True, det_int8=True, packed_stem=True, packed_stem_impl="xla")
    before = config.get_config()
    config.set_config(config.Config(engine=config.EngineConfig(**modes)))
    try:
        got = zoo.FaceAnalysis().cfg
    finally:
        config.set_config(before)
    assert {k: getattr(got, k) for k in modes} == modes
    assert dataclasses.replace(config.EngineConfig(), **modes) == config.EngineConfig(**modes)
    with pytest.raises(ValueError):
        config.EngineConfig(packed_stem_impl="cudnn")


# ------------------------------------------------------------ the cameras
class ReplayCap:
    """A stand-in for cv2.VideoCapture: replays its source's frames once,
    one every 5 ms, then reads nothing."""

    frames: dict = {}

    def __init__(self, source):
        self.queue = list(ReplayCap.frames[source])

    def isOpened(self):
        return True

    def set(self, *_):
        return True

    def read(self):
        time.sleep(0.005)
        if self.queue:
            return True, self.queue.pop(0)
        return False, None

    def release(self):
        pass


def _run_cameras(manager_cls, gallery, face_app, cfg, frames, company_id, monkeypatch):
    """Serve every frame of ``frames`` ({source: [BGR frames]}) through a
    CameraManager -> {(source, k): [(person_id, recognized, similarity,
    bbox)]}, one entry per frame (no frame is dropped: the slots are as deep
    as a source's frames)."""
    ReplayCap.frames = {src: [f.copy() for f in fl] for src, fl in frames.items()}
    monkeypatch.setattr(cv2, "VideoCapture", ReplayCap)
    index = {id(f): (src, k) for src, fl in ReplayCap.frames.items() for k, f in enumerate(fl)}
    decisions, errors = {}, []

    def on_result(source, frame, results):
        decisions[index[id(frame)]] = [(r["person_id"], r["recognized"], r["similarity"],
                                        r["bbox"]) for r in results]

    cm = manager_cls(gallery, face_app=face_app, cfg=cfg, on_result=on_result)
    cm.start_cameras(list(frames), company_id)
    deadline = time.time() + 120
    while len(decisions) < len(index) and time.time() < deadline:
        time.sleep(0.01)
    cm.stop_cameras()
    assert cm.stats["results_dropped"] == 0 and not errors
    assert sorted(decisions) == sorted(index.values()), cm.stats
    return decisions


def _assert_same_decisions(got, want, sim_tol):
    assert sorted(got) == sorted(want)
    for key in want:
        assert len(got[key]) == len(want[key]), key
        for (gp, gr, gs, gb), (wp, wr, ws, wb) in zip(got[key], want[key]):
            assert (gp, gr) == (wp, wr), key
            assert gs == pytest.approx(ws, abs=sim_tol), key
            assert np.abs(np.subtract(gb, wb)).max() <= 1, key


def _twin_cfgs(twin, **engine):
    """The reference's and the port's Config of a Twin, with ``engine``
    fields set; no source ever drops a frame."""
    return (dataclasses.replace(twin.ref_cfg, engine=dataclasses.replace(twin.ref_cfg.engine,
                                                                        **engine)),
            dataclasses.replace(twin.cfg, engine=dataclasses.replace(twin.cfg.engine, **engine)))


def test_camera_manager_with_the_fake_app_decides_as_the_reference(monkeypatch):
    """Three cameras of FakeFaceAnalysis frames (enrolled people at two
    poses, and strangers) through either package's CameraManager ->
    MicroBatcher -> match_faces: the same decision on every frame."""
    twin = Twin()
    for seed in (11, 12, 13):
        twin.enroll(f"E{seed}", zoo.fake_embedding(seed))
    frames = {f"cam{c}": [zoo.encode_fake_face(seed, jitter, size=(120, 160))
                          for seed, jitter in ((11 + c, 0.0), (12, 0.3), (900 + c, 0.0),
                                               (13, 0.1))]
              for c in range(3)}
    ref_cfg, cfg = _twin_cfgs(twin, frame_queue_depth=4)
    want = _run_cameras(RefCameraManager, RefGalleryManager(twin.stores[0][0], ref_cfg),
                        ref_zoo.FakeFaceAnalysis(), ref_cfg, frames, twin.cid, monkeypatch)
    got = _run_cameras(CameraManager, GalleryManager(twin.stores[1][0], cfg),
                       zoo.FakeFaceAnalysis(), cfg, frames, twin.cid, monkeypatch)
    _assert_same_decisions(got, want, 1e-6)
    recognized = [r for rows in want.values() for r in rows if r[1]]
    assert len(recognized) == 9 and sum(len(rows) for rows in want.values()) == 12


KW = dict(det_size=(128, 128), max_faces=4, pre_nms_topk=64, dtype="float32")
ARCH = dict(det_arch="det_2.5g", rec_arch="r18")
THRESH = 0.5
MODULES = ("detection", "recognition")


@pytest.fixture(scope="module")
def engines():
    """det_2.5g + r18 in float32 on a 128x128 canvas: the reference's engine
    and the port's on the CPU, on the reference's variable trees."""
    ref = RefFaceEngine(ref_config.EngineConfig(**KW), **ARCH)
    port = FaceEngine(config.EngineConfig(**KW), det_variables=ref.det_variables,
                      rec_variables=ref.rec_variables, device="cpu", **ARCH)
    return ref, port


def _apps(engines, **engine_kw):
    ref, port = engines
    ref_app = ref_zoo.FaceAnalysis(cfg=ref_config.EngineConfig(**KW, **engine_kw), engine=ref,
                                   allowed_modules=MODULES)
    app = zoo.FaceAnalysis(cfg=config.EngineConfig(**KW, **engine_kw), engine=port,
                           allowed_modules=MODULES)
    for a in (ref_app, app):
        a.prepare(det_thresh=THRESH)
    return ref_app, app


def _frames(seed, n, h=96, w=128):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, (h, w, 3), dtype=np.uint8) for _ in range(n)]


def test_camera_manager_with_the_engine_decides_as_the_reference(engines, monkeypatch):
    """Two cameras of 96x128 frames through the real engines (det_2.5g + r18,
    float32, 128x128 canvas, get_batch_async's fused path): camera 0's first
    two frames' faces are enrolled from the reference's embeddings, so they
    are recognized; every face of every frame gets the reference's decision
    (the same id, score within 1e-4, box within a pixel)."""
    frames = {"cam0": _frames(20, 3), "cam1": _frames(21, 3)}
    ref_app, app = _apps(engines, microbatch_max=2)
    twin = Twin()
    enrolled = [f.normed_embedding for fr in frames["cam0"][:2] for f in ref_app.get(fr)]
    assert enrolled
    for k, vec in enumerate(enrolled):
        twin.enroll(f"E{k}", vec)
    ref_cfg, cfg = _twin_cfgs(twin, frame_queue_depth=3, microbatch_max=2)
    ref_cfg = dataclasses.replace(ref_cfg, thresholds=dataclasses.replace(
        ref_cfg.thresholds, detection=THRESH))
    cfg = dataclasses.replace(cfg, thresholds=dataclasses.replace(cfg.thresholds,
                                                                  detection=THRESH))
    want = _run_cameras(RefCameraManager, RefGalleryManager(twin.stores[0][0], ref_cfg),
                        ref_app, ref_cfg, frames, twin.cid, monkeypatch)
    got = _run_cameras(CameraManager, GalleryManager(twin.stores[1][0], cfg), app, cfg,
                       frames, twin.cid, monkeypatch)
    _assert_same_decisions(got, want, 1e-4)
    mine = [r for k in ((("cam0", 0)), ("cam0", 1)) for r in want[k]]
    assert len(mine) == len(enrolled) and all(r[1] and r[2] >= 0.99 for r in mine)


# -------------------------------------------------------- the control API
def _png(seed, hw=112):
    ok, buf = cv2.imencode(".png", np.random.default_rng(seed).integers(
        0, 255, (hw, hw, 3), dtype=np.uint8))
    assert ok
    return buf.tobytes()


def _drive_routes(server_mod, manager_cls, gallery_cls, fake_cls, store, cfg, cid, logdir,
                  engine_app, monkeypatch):
    """Every route of build_app, in order -> [(route, status, JSON body or
    page bytes, CORS header)]."""
    gallery = gallery_cls(store, cfg)
    cm = manager_cls(gallery, face_app=fake_cls(), cfg=cfg)
    client = server_mod.build_app(gallery, cm).test_client()
    ReplayCap.frames = {"cam0": [zoo.encode_fake_face(11, size=(120, 160))] * 2}
    monkeypatch.setattr(cv2, "VideoCapture", ReplayCap)
    out = []

    def call(method, route, **kw):
        r = client.open(route, method=method, **kw)
        body = r.get_json() if r.data and route != "/" else r.data
        out.append((method, route, r.status_code, body,
                    r.headers.get("Access-Control-Allow-Origin")))
        return body

    call("GET", "/")
    call("GET", "/api/embeddings/stats")
    call("POST", "/api/embeddings/sync", json_body={})
    call("POST", "/api/camera/start", json_body={"sources": [0]})
    call("POST", "/api/camera/start", json_body={"sources": ["cam0"], "company_id": cid})
    call("POST", "/api/camera/stop", json_body={})
    call("POST", "/api/engine/recalibrate-int8", files={})  # the fake has no engine: 503
    cm.face_app = engine_app
    call("POST", "/api/engine/recalibrate-int8", files={})  # no crops: 400
    call("POST", "/api/engine/recalibrate-int8",
         files={"c0": ("c0.png", _png(0), "image/png")})  # not an int8 engine: 400
    call("GET", "/api/metrics")
    call("POST", "/api/profiler/stop", json_body={})
    call("POST", "/api/profiler/start", json_body={"logdir": logdir})
    call("POST", "/api/profiler/start", json_body={"logdir": logdir})
    call("POST", "/api/profiler/stop", json_body={})
    call("OPTIONS", "/api/embeddings/sync")
    call("GET", "/api/no-such-route")
    return out


def test_build_app_answers_every_route_as_the_reference(engines, tmp_path, monkeypatch):
    """The port's inference server and the reference's, on the same gallery
    documents: every route gives the same status code and the same JSON
    keys; the dashboard page is the same bytes; /api/embeddings/stats the
    same counts; /api/engine/recalibrate-int8 with one crop on an engine
    without int8 weights gives 400 and the reference's message."""
    twin = Twin()
    for seed in (11, 12):
        twin.enroll(f"E{seed}", zoo.fake_embedding(seed))
    ref_app, app = _apps(engines)
    runs = [_drive_routes(mod, manager, gallery_cls, fake, store, c, twin.cid,
                          str(tmp_path / name), eng_app, monkeypatch)
            for name, mod, manager, gallery_cls, fake, store, c, eng_app in (
                ("ref", ref_server, RefCameraManager, RefGalleryManager,
                 ref_zoo.FakeFaceAnalysis, twin.stores[0][0], twin.ref_cfg, ref_app),
                ("port", inference_server, CameraManager, GalleryManager,
                 zoo.FakeFaceAnalysis, twin.stores[1][0], twin.cfg, app))]
    want, got = runs
    assert len(got) == len(want) == 16
    for (gm, groute, gstatus, gbody, gcors), (_, _, wstatus, wbody, wcors) in zip(got, want):
        assert (gstatus, gcors) == (wstatus, wcors), (gm, groute)
        if isinstance(wbody, dict):
            assert sorted(gbody) == sorted(wbody), (gm, groute)
    by_route = {(m, r): (s, b) for m, r, s, b, _ in got}
    assert by_route[("GET", "/")] == (200, want[0][3])
    stats = [run[1][3] for run in runs]
    assert all(s["total_embeddings"] == 2 and s["initial_load_complete"] for s in stats)
    assert {k: v for k, v in stats[0].items() if k != "last_sync"} == \
        {k: v for k, v in stats[1].items() if k != "last_sync"}
    for run in runs:
        assert [s for _, _, s, _, _ in run] == [200, 200, 200, 400, 200, 200, 503, 400, 400,
                                                200, 409, 200, 409, 200, 200, 404]
        assert run[8][3] == {"status": "error",
                             "message": "engine was not built with embed_int8"}
    assert [b for _, _, _, b, _ in got if isinstance(b, dict) and "message" in b] == \
        [b for _, _, _, b, _ in want if isinstance(b, dict) and "message" in b]
    assert os.listdir(str(tmp_path / "port"))  # the torch.profiler trace


def test_recalibrate_route_reaches_a_real_int8_engine():
    """/api/engine/recalibrate-int8 with three crops (one at 96x96, resized
    to 112 by the route) on a real embed_int8 engine: the engine's
    calibration becomes "user(3 crops)", its scales are the ones
    ``models/quant.calibrate`` derives from the decoded crops, and the next
    embedding serves with them."""
    from facerecognition_infrenceengine_tpu_torch import native
    from facerecognition_infrenceengine_tpu_torch.models import arcface, quant

    twin = Twin()
    cfg = dataclasses.replace(twin.cfg, engine=config.EngineConfig(**KW, embed_int8=True))
    engine = FaceEngine(cfg.engine, device="cpu", **ARCH)
    assert "int8" in engine.rec_variables
    assert engine._int8_calibration == "synthetic-structured"
    s0 = engine._embed_scales
    probe = np.stack(_frames(41, 2, 112, 112))
    before = engine.embed_crops(probe)
    app = zoo.FaceAnalysis(cfg=cfg.engine, engine=engine, allowed_modules=MODULES)
    gallery = GalleryManager(twin.stores[1][0], cfg)
    cm = CameraManager(gallery, face_app=app, cfg=cfg)
    client = inference_server.build_app(gallery, cm).test_client()
    pngs = [_png(1), _png(2), _png(3, hw=96)]
    r = client.post("/api/engine/recalibrate-int8",
                    files={f"c{k}": (f"c{k}.png", b, "image/png") for k, b in enumerate(pngs)})
    assert r.status_code == 200, r.get_json()
    assert r.get_json() == {"status": "success", "crops": 3, "calibration": "user(3 crops)"}
    assert engine._int8_calibration == "user(3 crops)"
    decoded = [native.decode_image(b) for b in pngs]
    decoded[2] = native.resize_bilinear(decoded[2], 112, 112)
    want = quant.calibrate(engine.embedder, arcface.preprocess(torch.from_numpy(
        np.stack(decoded))), dtype=torch.float32)
    assert engine._embed_scales == want and want != s0
    after = engine.embed_crops(probe)
    assert not np.array_equal(after, before)
    np.testing.assert_array_equal(after, engine.embed_crops(probe))


# ------------------------------------------------------ upload on submit
def _assert_faces_close(got, want):
    assert [len(f) for f in got] == [len(f) for f in want]
    flat_got, flat_want = sum(got, []), sum(want, [])
    assert flat_want
    # tests/test_torch_zoo.py's tolerance: 1e-3 px + 5e-6 of the batch's
    # largest coordinate (the random-weight decode reaches ~1e3 px)
    scale = max(np.abs(np.concatenate([f.bbox.ravel(), f.kps.ravel()])).max() for f in flat_want)
    for g, w in zip(flat_got, flat_want):
        np.testing.assert_allclose(g.bbox, w.bbox, rtol=0, atol=1e-3 + 5e-6 * scale)
        np.testing.assert_allclose(g.kps, w.kps, rtol=0, atol=1e-3 + 5e-6 * scale)
        assert g.det_score == pytest.approx(w.det_score, abs=1e-6)
        assert float(g.normed_embedding @ w.normed_embedding) >= 1 - 1e-4


YUV = dict(stream_transport="yuv420", upload_on_submit=True)


def test_upload_on_submit_uploads_on_encode_and_stacks_on_the_device(engines, monkeypatch):
    """encode_frame returns the pack as a tensor on the engine's device (the
    CPU here); _stack_yuv stacks such packs there, padded with YUV black to
    bucket(n), and never goes through numpy; get_batch on them equals
    get_batch on the host packs and the reference's upload-on-submit."""
    ref_app, app = _apps(engines, **YUV)
    frames = _frames(30, 3)
    packs = [app.encode_frame(f) for f in frames]
    host = [p.numpy().copy() for p in packs]
    assert all(isinstance(p, torch.Tensor) and p.device.type == "cpu" for p in packs)
    assert packs[0].shape == (24, 32, 24) and packs[0].dtype == torch.uint8
    np.testing.assert_array_equal(host[0], np.asarray(ref_app.encode_frame(frames[0])))

    def no_numpy(*_, **__):
        raise AssertionError("a device pack went through numpy")

    with monkeypatch.context() as m:
        m.setattr(torch.Tensor, "numpy", no_numpy)
        m.setattr(torch.Tensor, "__array__", no_numpy)
        stacked = zoo.FaceAnalysis._stack_yuv(packs, KW["det_size"][1])
    assert isinstance(stacked, torch.Tensor) and tuple(stacked.shape) == (4, 24, 32, 24)
    np.testing.assert_array_equal(stacked[:3].numpy(), np.stack(host))
    assert (stacked[3, ..., :16] == 0).all() and (stacked[3, ..., 16:] == 128).all()
    np.testing.assert_array_equal(stacked.numpy(), zoo.FaceAnalysis._stack_yuv(host, 128))

    got = app.get_batch(packs)
    same = app.get_batch(host)
    for g, s in zip(sum(got, []), sum(same, [])):
        np.testing.assert_array_equal(g.bbox, s.bbox)
        np.testing.assert_array_equal(g.normed_embedding, s.normed_embedding)
    _assert_faces_close(got, ref_app.get_batch([ref_app.encode_frame(f) for f in frames]))


def test_device_packs_of_mixed_shapes_and_raw_frames_take_the_host_path(engines):
    """A device pack beside a raw frame that needs a resize: the pack comes
    to the host and is decoded there, and the batch gives the reference's
    faces; device packs of two heights stack on the host."""
    ref_app, app = _apps(engines, **YUV)
    small, big = _frames(31, 1)[0], _frames(32, 1, 192, 256)[0]
    pack = app.encode_frame(small)
    assert isinstance(pack, torch.Tensor) and app.encode_frame(big) is big
    _assert_faces_close(app.get_batch([pack, big]),
                        ref_app.get_batch([ref_app.encode_frame(small), big]))
    short = app.encode_frame(_frames(33, 1, 64, 128)[0])
    stacked = zoo.FaceAnalysis._stack_yuv([pack, short], 128)
    assert isinstance(stacked, np.ndarray) and stacked.shape == (2, 24, 32, 24)
    np.testing.assert_array_equal(stacked[1, :16], short.numpy())
    assert (stacked[1, 16:, :, :16] == 0).all() and (stacked[1, 16:, :, 16:] == 128).all()


def test_microbatcher_serves_uploaded_packs(engines):
    """Two capture threads submit with the encode-and-upload prepare hook;
    the batcher stacks their device packs, dispatches get_batch_async, and
    every future resolves to the faces get_batch gives that frame alone."""
    _, app = _apps(engines, microbatch_max=4, frame_queue_depth=4, **YUV)
    frames = {src: _frames(40 + k, 4) for k, src in enumerate(("cam0", "cam1"))}
    mb = microbatch.MicroBatcher(app, app.cfg)
    mb.start()
    futures = {}
    try:
        def capture(src):
            for k, f in enumerate(frames[src]):
                futures[src, k] = mb.submit(src, f, prepare=app.encode_frame)

        threads = [threading.Thread(target=capture, args=(s,)) for s in frames]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        results = {key: fut.result(timeout=60) for key, fut in futures.items()}
    finally:
        mb.stop()
    assert not any(getattr(f, "dropped", False) for f in futures.values())
    assert mb.stats["frames"] == 8
    for (src, k), faces in results.items():
        _assert_faces_close([faces], app.get_batch([frames[src][k]]))


def test_the_entry_point_serves_and_drains_on_sigterm(tmp_path):
    """``inference_server.main`` in its own process (the gallery routed to
    the CPU): it answers /api/embeddings/stats on the port it was given and
    exits 0 on SIGTERM, as ``python -m ...servers.inference_server`` does on
    the card."""
    import json
    import signal
    import socket
    import subprocess
    import sys
    import urllib.request

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    tests = os.path.dirname(os.path.abspath(__file__))
    script = (f"import sys; sys.path[:0] = [{tests!r}, {os.path.dirname(tests)!r}]\n"
              "from _pytest.monkeypatch import MonkeyPatch\n"
              "from test_torch_port_cases import cpu_by_default\n"
              "cpu_by_default(MonkeyPatch())\n"
              "from facerecognition_infrenceengine_tpu_torch.servers import inference_server\n"
              f"inference_server.main(['--host', '127.0.0.1', '--port', '{port}'])\n")
    env = dict(os.environ, MONGODB_URI="memory://")
    proc = subprocess.Popen([sys.executable, "-c", script], cwd=str(tmp_path), env=env,
                            stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
    opener = urllib.request.build_opener(urllib.request.ProxyHandler({}))
    try:
        deadline = time.time() + 120
        while True:
            try:
                with opener.open(f"http://127.0.0.1:{port}/api/embeddings/stats",
                                 timeout=5) as resp:
                    stats = json.loads(resp.read())
                break
            except OSError:
                assert proc.poll() is None and time.time() < deadline
                time.sleep(0.2)
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=60) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert stats["total_embeddings"] == 0 and stats["initial_load_complete"] is True
    assert os.path.exists(tmp_path / "face_recognition.log")
