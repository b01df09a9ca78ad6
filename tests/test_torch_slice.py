"""The port's serving slice vs the reference, end to end on the CPU:
frames -> FaceEngine.detect_align_embed_flat -> FaceAnalysis faces ->
gallery top-1 -> FaceRecognitionProcessor.match_faces decisions.

det_2.5g + r18 on a 128x128 canvas, float32 on both sides.  Synthetic
weights saturate the detector (most anchor scores are 1.0), so every slot
is valid at the 0.5 threshold and the lowest-index tie order of the top-k
decides which anchors reach NMS.  The raw heads reach ~1e3 there, and the
two f32 forwards part by ~2e-6 of that (summation order), which the decode
multiplies by the stride: boxes and landmarks (up to ~3e3 px) are held to
1e-3 px plus 5e-6 of the largest coordinate of the batch.
"""

import numpy as np
import pytest
import torch

from facerecognition_infrenceengine_tpu.core.config import EngineConfig as JaxEngineConfig
from facerecognition_infrenceengine_tpu.engine.gallery import _CompanySnapshot as JaxSnapshot
from facerecognition_infrenceengine_tpu.engine.pipeline import FaceEngine as JaxFaceEngine
from facerecognition_infrenceengine_tpu.engine.recognizer import (
    FaceRecognitionProcessor as JaxProcessor)
from facerecognition_infrenceengine_tpu.models.zoo import FaceAnalysis as JaxFaceAnalysis
from facerecognition_infrenceengine_tpu.models.zoo import letterbox as jax_letterbox
from facerecognition_infrenceengine_tpu_torch.core.config import Config, EngineConfig, ThresholdConfig
from facerecognition_infrenceengine_tpu_torch.engine.gallery import GalleryManager
from facerecognition_infrenceengine_tpu_torch.engine.pipeline import FaceEngine
from facerecognition_infrenceengine_tpu_torch.engine.recognizer import FaceRecognitionProcessor
from facerecognition_infrenceengine_tpu_torch.models.zoo import FaceAnalysis, letterbox

KW = dict(det_size=(128, 128), max_faces=8, pre_nms_topk=64, dtype="float32")
THRESH = 0.5


@pytest.fixture(scope="module")
def engines():
    jax_engine = JaxFaceEngine(JaxEngineConfig(**KW), det_arch="det_2.5g", rec_arch="r18")
    engine = FaceEngine(EngineConfig(**KW), det_arch="det_2.5g", rec_arch="r18", device="cpu")
    return jax_engine, engine


@pytest.fixture(scope="module")
def frames_bgr():
    rng = np.random.default_rng(0)
    return [rng.integers(0, 256, (96, 128, 3), dtype=np.uint8) for _ in range(2)]


def _close_px(got, want, scale=None):
    scale = np.abs(want).max() if scale is None else scale
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-3 + 5e-6 * scale)


def test_detect_align_embed_flat_matches_reference(engines):
    jax_engine, engine = engines
    canvas = np.random.default_rng(1).integers(0, 256, (2, 128, 128, 3), dtype=np.uint8)
    want = np.asarray(jax_engine.detect_align_embed_flat(canvas, THRESH))
    got = engine.detect_align_embed_flat(canvas, THRESH).numpy()
    assert got.shape == want.shape == (2, 8, 528)
    valid = want[..., 15] > 0.5
    assert valid.sum() > 0
    np.testing.assert_array_equal(got[..., 15] > 0.5, valid)
    _close_px(got[..., :4], want[..., :4])
    _close_px(got[..., 5:15], want[..., 5:15])
    np.testing.assert_allclose(got[..., 4], want[..., 4], rtol=0, atol=1e-6)
    cos = (got[..., 16:][valid] * want[..., 16:][valid]).sum(-1)
    assert np.all(cos >= 1 - 1e-4), cos.min()


def test_face_analysis_and_match_decisions_match_reference(engines, frames_bgr):
    """A gallery built from the reference's embeddings gives identical
    match_faces decisions through both packages."""
    jax_engine, engine = engines
    jax_app = JaxFaceAnalysis(cfg=JaxEngineConfig(**KW), engine=jax_engine,
                              allowed_modules=("detection", "recognition"))
    jax_app.det_thresh = THRESH
    app = FaceAnalysis(cfg=EngineConfig(**KW), engine=engine,
                       allowed_modules=("detection", "recognition"))
    app.prepare(det_thresh=THRESH)
    want_faces = jax_app.get_batch(frames_bgr)
    got_faces = app.get_batch(frames_bgr)
    assert [len(f) for f in got_faces] == [len(f) for f in want_faces]
    scale = max(np.abs(np.concatenate([f.bbox.ravel(), f.kps.ravel()])).max()
                for f in sum(want_faces, []))
    for gf, wf in zip(sum(got_faces, []), sum(want_faces, [])):
        _close_px(gf.bbox, wf.bbox, scale)
        _close_px(gf.kps, wf.kps, scale)
        assert float(gf.normed_embedding @ wf.normed_embedding) >= 1 - 1e-4

    # enroll frame 0's faces (reference embeddings) plus distractors
    enrolled = np.stack([f.normed_embedding for f in want_faces[0]])
    distractors = np.random.default_rng(2).normal(size=(20, 512)).astype(np.float32)
    matrix = np.concatenate([enrolled, distractors])
    matrix /= np.linalg.norm(matrix, axis=1, keepdims=True)
    ids = [f"p{i}" for i in range(len(matrix))]
    meta = {pid: {"type": "employee", "name": pid, "employeeId": pid.upper()} for pid in ids}
    # threshold between self-matches (~1) and the other faces' best scores
    others = np.stack([f.normed_embedding for f in want_faces[1]]) @ enrolled.T
    threshold = (1.0 + float(others.max())) / 2
    cfg = Config(thresholds=ThresholdConfig(recognition=threshold), engine=EngineConfig(**KW))

    class _JaxGallery:  # the reference's snapshot behind its processor
        snap = JaxSnapshot(ids, meta, matrix, 512, 1024)

        def match(self, embs, company_id=None, k=1):
            scores, found = self.snap.match(embs, k=k)
            return scores, found, self.snap.metadata

    jax_proc = JaxProcessor(_JaxGallery(), face_app=jax_app)
    jax_proc.recognition_threshold = threshold
    galleries = GalleryManager(cfg, device="cpu")
    galleries.set_snapshot(ids, meta, matrix, company_id="c1")
    proc = FaceRecognitionProcessor(galleries, face_app=app, cfg=cfg)
    recognized = 0
    for frame, gf, wf in zip(frames_bgr, got_faces, want_faces):
        _, want = jax_proc.match_faces(frame, wf, "c1", draw=False)
        _, got = proc.match_faces(frame, gf, "c1", draw=False)
        assert [r["person_id"] for r in got] == [r["person_id"] for r in want]
        assert [r["recognized"] for r in got] == [r["recognized"] for r in want]
        np.testing.assert_allclose([r["similarity"] for r in got],
                                   [r["similarity"] for r in want], rtol=0, atol=1e-4)
        recognized += sum(r["recognized"] for r in got)
    assert recognized == len(want_faces[0])  # each enrolled face finds itself
    assert len(want_faces[1]) > 0
    # the per-frame entry point: get() then match_faces(), which draws the HUD
    drawn, via_get = proc.recognize_faces(frames_bgr[0].copy(), "c1")
    _, want = jax_proc.match_faces(frames_bgr[0], want_faces[0], "c1", draw=False)
    assert [r["person_id"] for r in via_get] == [r["person_id"] for r in want]
    assert not np.array_equal(drawn, frames_bgr[0])
    # draw=True: the same faces give the reference's HUD, byte for byte
    for frame, wf in zip(frames_bgr, want_faces):
        want_frame, _ = jax_proc.match_faces(frame.copy(), wf, "c1", draw=True)
        got_frame, _ = proc.match_faces(frame.copy(), wf, "c1", draw=True)
        np.testing.assert_array_equal(got_frame, want_frame)


def test_letterbox_matches_reference_at_unit_scale():
    frame = np.random.default_rng(3).integers(0, 256, (480, 640, 3), dtype=np.uint8)
    rgb = frame[..., ::-1]
    want, want_scale = jax_letterbox(rgb, (640, 640))
    got, scale = letterbox(rgb, (640, 640))
    assert scale == want_scale == 1.0
    np.testing.assert_array_equal(got, want)
    # a 720p camera resizes onto the canvas, as the reference's does
    hd = np.random.default_rng(4).integers(0, 256, (720, 1280, 3), dtype=np.uint8)
    want, want_scale = jax_letterbox(hd, (640, 640))
    got, scale = letterbox(hd, (640, 640))
    assert scale == want_scale == 0.5
    np.testing.assert_array_equal(got, want)


def test_unported_packs_and_modules_raise(engines, frames_bgr):
    """MobileFaceNet still raises; the genderage module gives the
    reference's gender and age (and no landmarks) on the same frames."""
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        FaceAnalysis(name="mobile_facenet_v1", device="cpu")
    jax_engine, engine = engines
    modules = ("detection", "recognition", "genderage")
    jax_app = JaxFaceAnalysis(cfg=JaxEngineConfig(**KW), engine=jax_engine,
                              allowed_modules=modules)
    jax_app.det_thresh = THRESH
    app = FaceAnalysis(cfg=EngineConfig(**KW), engine=engine, allowed_modules=modules)
    app.prepare(det_thresh=THRESH)
    want, got = jax_app.get_batch(frames_bgr), app.get_batch(frames_bgr)
    assert [len(f) for f in got] == [len(f) for f in want]
    for gf, wf in zip(sum(got, []), sum(want, [])):
        assert (gf.gender, gf.age) == (wf.gender, wf.age) and gf.gender in (0, 1)
        assert gf.landmark_2d_106 is None and wf.landmark_2d_106 is None


def test_entry_points_default_to_cuda_and_raise_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        FaceEngine(EngineConfig(**KW), det_arch="det_500m", rec_arch="r18")
    with pytest.raises(RuntimeError, match="CUDA"):
        FaceAnalysis(cfg=EngineConfig(**KW)).prepare()
    with pytest.raises(RuntimeError, match="CUDA"):
        GalleryManager()
