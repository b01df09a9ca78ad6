"""FaceAnalysis("buffalo_l") as the reference serves it, on the CPU: the
default four modules, cameras at any letterbox scale, the attribute heads,
the async dispatch, the test double and the HUD, against the reference.

det_2.5g + r18 on a 128x128 canvas in float32, both packages on the same
synthetic weights (the port's engine takes the reference engine's variable
trees).  Frames of 192x256 (letterbox scale 0.5) and 48x64 (scale 2) take
the two-program path -- detect on the canvases, coordinates divided by the
float32 scale, embed and crop the attribute heads from the native frames;
96x128 (scale 1) takes the fused path.  Tolerances are
tests/test_torch_slice.py's: valid slots identical, boxes and landmarks
(5-point and 106-point) within 1e-3 px + 5e-6 of the largest coordinate of
the batch (the synthetic heads reach ~1e3, where f32 summation order moves
the decode by ~2e-6 relative), embeddings >= 1 - 1e-4 cosine (within the
1e-3 budget), gender and age equal.

The 106 landmarks are held on the same boxes: each side's landmarks against
the other package's attribute heads run on its own boxes.  End to end they
part by more than the pixel tolerance on these noise frames: the crops move
with the boxes' last-bit differences, and the random-weight head carries
the noise frames' steep pixel gradients into its output.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

from facerecognition_infrenceengine_tpu.core.config import EngineConfig as JaxEngineConfig
from facerecognition_infrenceengine_tpu.engine.gallery import _CompanySnapshot as JaxSnapshot
from facerecognition_infrenceengine_tpu.engine.pipeline import FaceEngine as JaxFaceEngine
from facerecognition_infrenceengine_tpu.engine.recognizer import (
    FaceRecognitionProcessor as JaxProcessor)
from facerecognition_infrenceengine_tpu.models import zoo as jax_zoo
from facerecognition_infrenceengine_tpu.models.weights import flatten_tree as jax_flatten
from facerecognition_infrenceengine_tpu.models.weights import unflatten_tree
from facerecognition_infrenceengine_tpu.ops import warp2pass as jax_warp
from facerecognition_infrenceengine_tpu_torch.core.config import Config, EngineConfig
from facerecognition_infrenceengine_tpu_torch.core.config import ThresholdConfig
from facerecognition_infrenceengine_tpu_torch.engine.gallery import GalleryManager
from facerecognition_infrenceengine_tpu_torch.engine.pipeline import FaceEngine, bucket
from facerecognition_infrenceengine_tpu_torch.engine.recognizer import FaceRecognitionProcessor
from facerecognition_infrenceengine_tpu_torch.models import zoo
from facerecognition_infrenceengine_tpu_torch.models.zoo import FaceAnalysis
from facerecognition_infrenceengine_tpu_torch.ops import warp2pass, warp_kernel

KW = dict(det_size=(128, 128), max_faces=8, pre_nms_topk=64, dtype="float32")
ARCH = dict(det_arch="det_2.5g", rec_arch="r18")
THRESH = 0.5
ALL = ("detection", "recognition", "genderage", "landmark_2d_106")


@pytest.fixture(scope="module")
def engines():
    ref = JaxFaceEngine(JaxEngineConfig(**KW), **ARCH)
    port = FaceEngine(EngineConfig(**KW), det_variables=ref.det_variables,
                      rec_variables=ref.rec_variables, device="cpu", **ARCH)
    return ref, port


@pytest.fixture(scope="module")
def apps(engines):
    ref, port = engines
    jax_app = jax_zoo.FaceAnalysis(cfg=JaxEngineConfig(**KW), engine=ref)
    jax_app.det_thresh = THRESH
    app = FaceAnalysis(cfg=EngineConfig(**KW), engine=port)
    app.prepare(det_thresh=THRESH)
    return jax_app, app


def _frame(seed, h, w):
    return np.random.default_rng(seed).integers(0, 256, (h, w, 3), dtype=np.uint8)


BATCHES = {
    "scale 0.5": [_frame(1, 192, 256), _frame(2, 192, 256)],
    "scale 2": [_frame(3, 48, 64)],
    "mixed": [_frame(4, 192, 256), _frame(5, 48, 64), _frame(6, 96, 128)],
    "scale 1": [_frame(7, 96, 128), _frame(8, 96, 128)],
}


@pytest.fixture(scope="module")
def served(apps):
    jax_app, app = apps
    return {name: (jax_app.get_batch(frames), app.get_batch(frames))
            for name, frames in BATCHES.items()}


def _close_px(got, want, scale):
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-3 + 5e-6 * scale)


def _assert_faces_match(got_faces, want_faces, modules=ALL, same_boxes=None):
    """Faces of two runs; ``same_boxes`` (the engines and the frames) holds
    the landmarks on the same boxes, else they are compared as they are."""
    assert [len(f) for f in got_faces] == [len(f) for f in want_faces]
    flat_got, flat_want = sum(got_faces, []), sum(want_faces, [])
    assert flat_want
    scale = max(np.abs(np.concatenate([f.bbox.ravel(), f.kps.ravel()])).max() for f in flat_want)
    for gf, wf in zip(flat_got, flat_want):
        _close_px(gf.bbox, wf.bbox, scale)
        _close_px(gf.kps, wf.kps, scale)
        assert gf.det_score == pytest.approx(wf.det_score, abs=1e-6)
        if "recognition" in modules:
            assert float(gf.normed_embedding @ wf.normed_embedding) >= 1 - 1e-4
        if "genderage" in modules:
            assert (gf.gender, gf.age) == (wf.gender, wf.age)
            assert gf.gender in (0, 1)
    if "landmark_2d_106" not in modules:
        return
    got_lm = np.stack([f.landmark_2d_106 for f in flat_got])
    want_lm = np.stack([f.landmark_2d_106 for f in flat_want])
    assert got_lm.shape[1:] == (106, 2)
    lm_scale = max(scale, np.abs(want_lm).max())
    if same_boxes is None:
        _close_px(got_lm, want_lm, lm_scale)
        return
    (ref, port), frames = same_boxes
    crops_from = _attr_input(frames)
    idx = np.asarray([b for b, faces in enumerate(got_faces) for _ in faces], np.int32)
    for faces, lm, other in ((flat_got, got_lm, ref), (flat_want, want_lm, port)):
        gender, age, lm_other = other.attributes(crops_from, idx,
                                                 np.stack([f.bbox for f in faces]))
        np.testing.assert_array_equal(gender, [f.gender for f in faces])
        np.testing.assert_array_equal(age.astype(int), [f.age for f in faces])
        _close_px(lm, lm_other, lm_scale)


def _attr_input(frames):
    """The frames get_batch crops the attribute heads from: the canvases
    when every frame fits at scale 1, else the native RGB frames padded to
    a multiple of 8."""
    rgb = [f[..., ::-1] for f in frames]
    boxed = [zoo.letterbox(f, KW["det_size"]) for f in rgb]
    if all(s == 1.0 for _, s in boxed):
        return np.stack([c for c, _ in boxed] + [np.zeros_like(boxed[0][0])]
                        * (bucket(len(frames)) - len(frames)))
    h = max(f.shape[0] for f in rgb)
    w = max(f.shape[1] for f in rgb)
    out = np.zeros((bucket(len(frames)), h + (-h) % 8, w + (-w) % 8, 3), np.uint8)
    for i, f in enumerate(rgb):
        out[i, :f.shape[0], :f.shape[1]] = f
    return out


def test_default_modules_are_the_reference_pack(apps):
    jax_app, app = apps
    assert app.allowed_modules == jax_app.allowed_modules == ALL
    face = zoo.Face(bbox=np.zeros(4), det_score=1.0, kps=np.zeros((5, 2)))
    assert [f.name for f in dataclasses.fields(face)] == \
        [f.name for f in dataclasses.fields(jax_zoo.Face)]


@pytest.mark.parametrize("name", list(BATCHES))
def test_get_batch_matches_reference(engines, served, name):
    want, got = served[name]
    _assert_faces_match(got, want, same_boxes=(engines, BATCHES[name]))


def test_boxes_rescale_with_the_float32_scale(engines, apps):
    """The two-program path divides canvas coordinates by the codec's
    float32 scale, exactly as the reference does."""
    _, port = engines
    _, app = apps
    frames = BATCHES["scale 0.5"]
    canvases = np.stack([zoo.letterbox(f[..., ::-1], KW["det_size"])[0] for f in frames])
    det = port.detect(canvases, det_threshold=THRESH)
    faces = app.get_batch(frames)
    for b, fl in enumerate(faces):
        boxes = det.boxes[b][det.valid[b]]
        np.testing.assert_array_equal(np.stack([f.bbox for f in fl]), boxes / 0.5)


def test_yuv_transport_takes_the_rgb_path_with_attributes(engines, served):
    ref, port = engines
    frames = BATCHES["scale 1"]
    ycfg = dict(KW, stream_transport="yuv420")
    app = FaceAnalysis(cfg=EngineConfig(**ycfg), engine=port)
    app.det_thresh = THRESH
    jax_app = jax_zoo.FaceAnalysis(cfg=JaxEngineConfig(**ycfg), engine=ref)
    assert not app._yuv_eligible(port, frames) and not jax_app._yuv_eligible(ref, frames)
    assert app.encode_frame(frames[0]).shape == (24, 32, 24)  # the encoder itself still packs
    _assert_faces_match(app.get_batch(frames), served["scale 1"][1])
    two = dict(allowed_modules=("detection", "recognition"))
    assert FaceAnalysis(cfg=EngineConfig(**ycfg), engine=port, **two)._yuv_eligible(port, frames)
    assert jax_zoo.FaceAnalysis(cfg=JaxEngineConfig(**ycfg), engine=ref,
                                **two)._yuv_eligible(ref, frames)
    no_rec = dict(allowed_modules=("detection",))
    assert not FaceAnalysis(cfg=EngineConfig(**ycfg), engine=port,
                            **no_rec)._yuv_eligible(port, frames)


def test_encode_frame_is_the_reference_pack_content_rows(engines):
    ref, port = engines
    ycfg = dict(KW, stream_transport="yuv420")
    app = FaceAnalysis(cfg=EngineConfig(**ycfg), engine=port)
    jax_app = jax_zoo.FaceAnalysis(cfg=JaxEngineConfig(**ycfg), engine=ref)
    for frame in (_frame(9, 96, 128), _frame(10, 94, 128), _frame(11, 128, 100)):
        got = app.encode_frame(frame)
        want = jax_app.encode_frame(frame)
        assert got.shape == want.shape == (-(-frame.shape[0] // 4), 32, 24)
        np.testing.assert_array_equal(got, want)
    for frame in (_frame(12, 192, 256), _frame(13, 48, 64)):  # a resize: unchanged
        assert app.encode_frame(frame) is frame


def test_get_batch_async_resolves_to_get_batch(engines, served):
    _, port = engines
    two = FaceAnalysis(cfg=EngineConfig(**KW), engine=port,
                       allowed_modules=("detection", "recognition"))
    two.det_thresh = THRESH
    frames = BATCHES["scale 1"]
    resolve = two.get_batch_async(frames)  # the fused path: the result stays on the device
    _assert_faces_match(resolve(), two.get_batch(frames), ("detection", "recognition"))
    app = FaceAnalysis(cfg=EngineConfig(**KW), engine=port)
    app.det_thresh = THRESH
    _assert_faces_match(app.get_batch_async(BATCHES["mixed"])(), served["mixed"][1])
    assert app.get_batch_async([])() == []


def test_attributes_host_api_matches_reference(engines):
    ref, port = engines
    frames = np.stack([_frame(14, 96, 128), _frame(15, 96, 128)])
    boxes = np.array([[10, 12, 60, 80], [-20, -10, 150, 120], [40, 30, 44, 33]], np.float32)
    idx = np.array([0, 1, 1], np.int32)
    want = ref.attributes(frames, idx, boxes)
    got = port.attributes(frames, idx, boxes)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    _close_px(got[2], want[2], np.abs(want[2]).max())
    empty = port.attributes(frames, np.zeros(0, np.int32), np.zeros((0, 4), np.float32))
    assert [e.shape for e in empty] == [(0,), (0,), (0, 106, 2)]


@pytest.mark.parametrize("out_size", [96, 112, 192])
def test_bbox_crops_and_pyramid_levels_match_reference(out_size):
    """The attribute heads' crops through K3's plain version at 96 and 192:
    the ROI windows, the levels the pyramid picks (a 192 crop as large as
    the ROI takes a coarser level) and the crops equal the reference's."""
    import torch

    frames = np.stack([_frame(16, 256, 320), _frame(17, 256, 320)])
    boxes = np.array([[10, 20, 60, 90], [100, 50, 300, 250], [-50, -40, 400, 300],
                      [0, 0, 32, 32], [5, 5, 4, 4], [200, 100, 210, 180],
                      [30, 30, 156, 156], [30, 30, 157, 157]], np.float32)
    idx = np.array([0, 1, 0, 1, 0, 1, 0, 1])
    m_inv = warp2pass.boxes_to_affines(torch.from_numpy(boxes), out_size)
    want_m = np.asarray(jax_warp.boxes_to_affines(jnp.asarray(boxes), out_size))
    np.testing.assert_array_equal(m_inv.numpy(), want_m)
    rois, mats = warp2pass.extract_rois_from_affines(torch.from_numpy(frames),
                                                     torch.from_numpy(idx), m_inv, out_size)
    want_rois, want_mats = jax_warp.extract_rois_from_affines(
        jnp.asarray(frames), jnp.asarray(idx), jnp.asarray(want_m), out_size)
    np.testing.assert_array_equal(rois.numpy(), np.asarray(want_rois))
    np.testing.assert_array_equal(mats.numpy(), np.asarray(want_mats))
    levels = warp2pass.pyramid_level(m_inv, out_size).tolist()
    # span = 1.5 * side + 3 px whatever the crop size: side 126 fits level 0, 127 does not
    assert levels[6:] == [0, 1] and levels[2] == 2
    got = warp2pass.warp_boxes_two_pass(torch.from_numpy(frames), torch.from_numpy(idx),
                                        torch.from_numpy(boxes), out_size)
    want = np.asarray(jax_warp.warp_boxes_two_pass(jnp.asarray(frames), jnp.asarray(idx),
                                                   jnp.asarray(boxes), out_size))
    assert got.shape == (8, out_size, out_size, 3)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-3)
    np.testing.assert_array_equal(got.numpy(),
                                  warp_kernel.warp_rois_plain(rois, mats, out_size).numpy())


def test_converted_onnx_heads_raise_instead_of_synthetic(engines, tmp_path, monkeypatch):
    _, port = engines
    engine = FaceEngine(EngineConfig(**KW), device="cpu", **ARCH)
    for name in ("attr_genderage.onnx", "attr_2d106det.onnx"):
        (tmp_path / name).write_bytes(b"")
    monkeypatch.setenv("FRE_WEIGHTS_DIR", str(tmp_path))
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 1 item 3"):
        engine.attributes(np.zeros((1, 64, 64, 3), np.uint8), np.zeros(1, np.int32),
                          np.array([[0, 0, 32, 32]], np.float32))


def _perturbed(variables, seed):
    """The engine's variables with every kernel, BN scale / bias / mean and
    PReLU slope moved, and positive variances: weights the synthetic init
    does not give."""
    rng = np.random.default_rng(seed)
    flat = jax_flatten({k: variables[k] for k in ("params", "batch_stats")})
    out = {}
    for k, v in flat.items():
        v = np.asarray(v, np.float32)
        if k.endswith("var"):
            out[k] = v * rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
        else:
            out[k] = v + 0.05 * rng.normal(size=v.shape).astype(np.float32) * (
                1.0 if v.ndim < 2 else float(np.abs(v).mean()))
    return unflatten_tree(out)


def test_engine_from_reference_variable_trees(engines):
    """FaceEngine(det_variables=, rec_variables=) takes the reference
    engine's flax trees (its derived collections ignored, K4's fold
    recomputed) and gives the reference's outputs."""
    ref, _ = engines
    det_v, rec_v = _perturbed(ref.det_variables, 1), _perturbed(ref.rec_variables, 2)
    jax_engine = JaxFaceEngine(JaxEngineConfig(**KW), det_variables=det_v,
                               rec_variables=rec_v, **ARCH)
    assert "stem_pallas" in jax_engine.det_variables  # a derived collection the port ignores
    engine = FaceEngine(EngineConfig(**KW), det_variables=jax_engine.det_variables,
                        rec_variables=jax_engine.rec_variables, device="cpu", **ARCH)
    synthetic = FaceEngine(EngineConfig(**KW), device="cpu", **ARCH)
    canvas = _frame(18, 128, 128)[None].repeat(2, 0)
    canvas[1] = _frame(19, 128, 128)
    want = np.asarray(jax_engine.detect_align_embed_flat(canvas, THRESH))
    got = engine.detect_align_embed_flat(canvas, THRESH).numpy()
    other = synthetic.detect_align_embed_flat(canvas, THRESH).numpy()
    valid = want[..., 15] > 0.5
    assert valid.sum() > 0
    np.testing.assert_array_equal(got[..., 15] > 0.5, valid)
    _close_px(got[..., :15], want[..., :15], np.abs(want[..., :15]).max())
    cos = (got[..., 16:][valid] * want[..., 16:][valid]).sum(-1)
    assert np.all(cos >= 1 - 1e-4), cos.min()
    assert np.abs(got - other).max() > 1e-2  # the trees were used, not the synthetic init
    crops = np.random.default_rng(20).integers(0, 256, (4, 112, 112, 3), dtype=np.uint8)
    cos = (engine.embed_crops(crops) * np.asarray(jax_engine.embed_crops(crops))).sum(-1)
    assert np.all(cos >= 1 - 1e-4), cos.min()


def test_fake_face_analysis_matches_reference():
    frames = [zoo.encode_fake_face(7, pose_jitter=0.3, bbox=(40, 60, 200, 220)),
              zoo.encode_fake_face(123456, score=0.8, size=(240, 320)),
              np.zeros((10, 10, 3), np.uint8), np.zeros((3, 4, 3), np.uint8)]
    for got_frame, want_frame in zip(frames, [
            jax_zoo.encode_fake_face(7, pose_jitter=0.3, bbox=(40, 60, 200, 220)),
            jax_zoo.encode_fake_face(123456, score=0.8, size=(240, 320))]):
        np.testing.assert_array_equal(got_frame, want_frame)
    np.testing.assert_array_equal(zoo.MARKER, jax_zoo.MARKER)
    got = zoo.FakeFaceAnalysis().get_batch(frames)
    want = jax_zoo.FakeFaceAnalysis().get_batch(frames)
    assert [len(f) for f in got] == [len(f) for f in want] == [1, 1, 0, 0]
    for gf, wf in zip(sum(got, []), sum(want, [])):
        np.testing.assert_array_equal(gf.bbox, wf.bbox)
        np.testing.assert_array_equal(gf.kps, wf.kps)
        np.testing.assert_array_equal(gf.normed_embedding, wf.normed_embedding)
        assert gf.det_score == wf.det_score
    np.testing.assert_array_equal(zoo.fake_embedding(5, 0.7), jax_zoo.fake_embedding(5, 0.7))
    with pytest.raises(ValueError, match="person_seed"):
        zoo.encode_fake_face(1 << 24)


def test_match_faces_draws_the_reference_hud(apps, served):
    """match_faces(draw=True): the same faces through both processors give
    the same decisions and the same frame bytes; recognize_faces draws by
    default."""
    jax_app, app = apps
    want_faces, got_faces = served["mixed"]
    frames = BATCHES["mixed"]
    enrolled = [f.normed_embedding for f in want_faces[0][:3]] + \
        [f.normed_embedding for f in want_faces[2][:2]]
    distractors = np.random.default_rng(21).normal(size=(20, 512)).astype(np.float32)
    matrix = np.concatenate([np.stack(enrolled), distractors])
    matrix /= np.linalg.norm(matrix, axis=1, keepdims=True)
    ids = [f"p{i}" for i in range(len(matrix))]
    kinds = ["employee", "visitor"]
    meta = {pid: {"type": kinds[i % 2], "name": f"Person {i}", "employeeId": f"E{i:03d}"}
            for i, pid in enumerate(ids)}
    threshold = 0.9
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
    kinds_seen = set()
    for frame, wf, gf in zip(frames, want_faces, got_faces):
        want_frame, want = jax_proc.match_faces(frame.copy(), wf, "c1", draw=True)
        got_frame, got = proc.match_faces(frame.copy(), wf, "c1", draw=True)
        assert [r["person_id"] for r in got] == [r["person_id"] for r in want]
        assert not np.array_equal(got_frame, frame)
        np.testing.assert_array_equal(got_frame, want_frame)
        kinds_seen |= {r["person_info"]["type"] for r in got}
        _, own = proc.match_faces(frame.copy(), gf, "c1", draw=True)
        assert [r["person_id"] for r in own] == [r["person_id"] for r in want]
    assert kinds_seen == {"employee", "visitor", "unknown"}
    drawn, results = proc.recognize_faces(frames[2].copy(), "c1")
    assert len(results) == len(want_faces[2]) and not np.array_equal(drawn, frames[2])
