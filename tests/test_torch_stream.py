"""The yuv420 streaming slice vs the reference, end to end on the CPU:
packed / yuv420 frames -> FaceEngine (K4 stem on the packed frames, packed
atlas, K3) -> FaceAnalysis faces -> int8 gallery top-1 (K2).

det_500m + r18 on a 64x64 canvas in float32, both packages on the same
synthetic weights; the reference runs its Pallas stem in the interpreter
(``packed_stem_impl="pallas"``).  Tolerances are tests/test_torch_slice.py's:
valid slots identical, scores 1e-6, embeddings >= 1 - 1e-4 cosine, boxes and
landmarks 1e-3 px + 5e-6 of the largest coordinate (the synthetic heads
reach ~1e3, where f32 summation order moves the decode by ~2e-6 relative).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from facerecognition_infrenceengine_tpu.core.config import EngineConfig as JaxEngineConfig
from facerecognition_infrenceengine_tpu.engine.gallery import _CompanySnapshot as JaxSnapshot
from facerecognition_infrenceengine_tpu.engine.pipeline import FaceEngine as JaxFaceEngine
from facerecognition_infrenceengine_tpu.models.zoo import FaceAnalysis as JaxFaceAnalysis
from facerecognition_infrenceengine_tpu.ops import match_pallas
from facerecognition_infrenceengine_tpu.ops import stem_pallas
from facerecognition_infrenceengine_tpu_torch.core.config import Config, EngineConfig
from facerecognition_infrenceengine_tpu_torch.core.config import ThresholdConfig
from facerecognition_infrenceengine_tpu_torch.engine.gallery import GalleryManager
from facerecognition_infrenceengine_tpu_torch.store import Datastore
from facerecognition_infrenceengine_tpu_torch.engine.pipeline import FaceEngine, bucket
from facerecognition_infrenceengine_tpu_torch.engine.recognizer import FaceRecognitionProcessor
from facerecognition_infrenceengine_tpu_torch.models.zoo import FaceAnalysis
from facerecognition_infrenceengine_tpu_torch.ops import stem_kernel, warp_kernel

KW = dict(det_size=(64, 64), max_faces=4, pre_nms_topk=32, dtype="float32")
STREAM = dict(KW, stream_transport="yuv420", packed_stem_impl="pallas", gallery_dtype="int8")
ARCH = dict(det_arch="det_500m", rec_arch="r18")
THRESH = 0.5


@pytest.fixture(scope="module")
def engines():
    ref = JaxFaceEngine(JaxEngineConfig(**STREAM), **ARCH)
    port = {impl: FaceEngine(EngineConfig(**dict(STREAM, packed_stem_impl=impl)), device="cpu",
                             **ARCH) for impl in ("pallas", "unpack")}
    port["raw_on"] = FaceEngine(EngineConfig(**dict(KW, stem_kernel="on")), device="cpu", **ARCH)
    port["raw_off"] = FaceEngine(EngineConfig(**KW), device="cpu", **ARCH)
    return ref, port


def _frames(seed, n=2, h=64, w=64):
    return np.random.default_rng(seed).integers(0, 256, (n, h, w, 3), dtype=np.uint8)


def _close_px(got, want, scale=None):
    scale = np.abs(want).max() if scale is None else scale
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-3 + 5e-6 * scale)


def _assert_flat_close(got, want):
    valid = want[..., 15] > 0.5
    assert valid.sum() > 0
    np.testing.assert_array_equal(got[..., 15] > 0.5, valid)
    _close_px(got[..., :4], want[..., :4])
    _close_px(got[..., 5:15], want[..., 5:15])
    np.testing.assert_allclose(got[..., 4], want[..., 4], rtol=0, atol=1e-6)
    cos = (got[..., 16:][valid] * want[..., 16:][valid]).sum(-1)
    assert np.all(cos >= 1 - 1e-4), cos.min()


def _flat(outs):
    return FaceEngine._flatten_fused_outputs(outs).numpy()


def test_config_fields():
    cfg = EngineConfig()
    assert (cfg.stem_kernel, cfg.packed_stem_impl, cfg.stream_transport) == ("off", "unpack", "rgb")
    assert cfg.gallery_dtype == "float32"
    assert (cfg.packed_stem, cfg.embed_int8, cfg.det_int8) == (False, False, False)
    assert EngineConfig(packed_stem_impl="xla").packed_stem_impl == "xla"
    with pytest.raises(ValueError, match="packed_stem_impl"):
        EngineConfig(packed_stem_impl="cudnn")
    assert not FaceEngine(EngineConfig(**dict(KW, stem_kernel="auto")), device="cpu",
                          **ARCH)._stem_kernel_raw


def test_packed_unpack_equals_the_raw_path(engines):
    """packed_stem_impl="unpack" is the raw program on the unpacked frames:
    the same outputs bit for bit."""
    _, port = engines
    frames = _frames(1)
    packed = FaceEngine.pack_frames(frames)
    assert packed.shape == (2, 16, 16, 48)
    got = _flat(port["unpack"].detect_align_embed_packed(packed, THRESH))
    want = port["raw_off"].detect_align_embed_flat(frames, THRESH).numpy()
    np.testing.assert_array_equal(got, want)


def test_packed_pallas_matches_reference(engines):
    """K4 stem on the packed frames, backbone from its output, packed atlas
    warp: against the reference's packed program with its Pallas stem."""
    ref, port = engines
    packed = FaceEngine.pack_frames(_frames(2))
    want = np.asarray(ref._flatten_fused_outputs(ref.detect_align_embed_packed(packed, THRESH)))
    before = (stem_kernel.fused_stem.launches, warp_kernel.warp_rois.launches)
    got = _flat(port["pallas"].detect_align_embed_packed(packed, THRESH))
    assert (stem_kernel.fused_stem.launches, warp_kernel.warp_rois.launches) == before  # CPU
    _assert_flat_close(got, want)


def test_yuv420_flat_matches_reference(engines):
    """Content rows (12 of 16) re-padded with YUV black, the yuv mix, then
    the pallas program."""
    ref, port = engines
    rng = np.random.default_rng(3)
    packs = rng.integers(0, 256, (2, 12, 16, 24), dtype=np.uint8)
    want = np.asarray(ref.detect_align_embed_yuv420_flat(packs, THRESH))
    got = port["pallas"].detect_align_embed_yuv420_flat(packs, THRESH).numpy()
    assert got.shape == want.shape == (2, 4, 528)
    _assert_flat_close(got, want)


def test_raw_stem_kernel_route_matches_reference_packed_pallas(engines):
    """stem_kernel="on" runs K4 on the device-packed raw frames; the
    reference's raw route calls its kernel outside the interpreter, so it is
    held against the reference's packed-pallas detect on the same pixels
    (prepare_input(f, uint8) == pad_packed_u8(space_to_depth4(f)))."""
    ref, port = engines
    frames = _frames(4)
    want = ref._detect_packed_impl(ref.det_variables,
                                   stem_pallas.space_to_depth4(jnp.asarray(frames)),
                                   jnp.float32(THRESH))
    got = port["raw_on"].detect(frames, THRESH)
    want = [np.asarray(w) for w in want]
    np.testing.assert_array_equal(got.valid, want[3])
    assert want[3].sum() > 0
    _close_px(got.boxes, want[0])
    _close_px(got.kps, want[2])
    np.testing.assert_allclose(got.scores, want[1], rtol=0, atol=1e-6)


def test_face_analysis_yuv_transport_and_int8_decisions_match_reference(engines):
    """tests/test_models_engine.py's yuv transport case: encode_frame ships
    the content rows, get_batch takes the yuv path; faces against the
    reference's FaceAnalysis on the same transport, then match_faces
    decisions on int8 galleries built from the reference's embeddings."""
    ref, port = engines
    yy, xx = np.mgrid[0:48, 0:64].astype(np.float32)
    smooth = np.clip(np.stack([120 + 70 * np.sin(yy / 23), 110 + 60 * np.cos(xx / 19),
                               100 + 50 * np.sin((xx + yy) / 31)], -1), 0, 255).astype(np.uint8)
    noisy = np.random.default_rng(5).integers(0, 256, (48, 64, 3), dtype=np.uint8)
    frames = [smooth, noisy]
    jax_app = JaxFaceAnalysis(cfg=JaxEngineConfig(**STREAM), engine=ref,
                              allowed_modules=("detection", "recognition"))
    jax_app.det_thresh = THRESH
    app = FaceAnalysis(cfg=EngineConfig(**STREAM), engine=port["pallas"],
                       allowed_modules=("detection", "recognition"))
    app.prepare(det_thresh=THRESH)
    assert app._yuv_eligible(port["pallas"], frames)
    enc = app.encode_frame(smooth)
    assert enc.shape == (12, 16, 24)
    np.testing.assert_array_equal(enc, jax_app.encode_frame(smooth))
    want_faces = jax_app.get_batch(frames)
    got_faces = app.get_batch([enc, noisy])  # a pre-encoded pack and a raw frame
    assert [len(f) for f in got_faces] == [len(f) for f in want_faces]
    assert sum(len(f) for f in want_faces) > 0
    scale = max(np.abs(np.concatenate([f.bbox.ravel(), f.kps.ravel()])).max()
                for f in sum(want_faces, []))
    for gf, wf in zip(sum(got_faces, []), sum(want_faces, [])):
        _close_px(gf.bbox, wf.bbox, scale)
        _close_px(gf.kps, wf.kps, scale)
        assert float(gf.normed_embedding @ wf.normed_embedding) >= 1 - 1e-4

    # int8 gallery: frame 0's faces plus distractors; K2 (plain) against the
    # reference's int8 kernel in the interpreter, as the port serves k = 1
    enrolled = np.stack([f.normed_embedding for f in want_faces[0]])
    distractors = np.random.default_rng(6).normal(size=(20, 512)).astype(np.float32)
    matrix = np.concatenate([enrolled, distractors])
    matrix /= np.linalg.norm(matrix, axis=1, keepdims=True)
    ids = [f"p{i}" for i in range(len(matrix))]
    meta = {pid: {"type": "employee", "name": pid} for pid in ids}
    cfg = Config(thresholds=ThresholdConfig(recognition=0.5), engine=EngineConfig(**STREAM))
    galleries = GalleryManager(Datastore(cfg), cfg, initial_load=False, device="cpu")
    snap = galleries.set_snapshot(ids, meta, matrix, company_id="c1")
    ref_snap = JaxSnapshot(ids, meta, matrix, 512, 1024, dtype="int8")
    np.testing.assert_array_equal(snap.device_matrix.numpy(), np.asarray(ref_snap.device_matrix))
    proc = FaceRecognitionProcessor(galleries, face_app=app, cfg=cfg)
    for frame, gf in zip(frames, got_faces):
        _, results = proc.match_faces(frame, gf, "c1", draw=False)
        embs = np.stack([f.normed_embedding for f in gf])
        q = np.zeros((bucket(len(gf)), 512), np.float32)  # the snapshot's batch
        q[:len(gf)] = embs / np.linalg.norm(embs, axis=1, keepdims=True)
        v_ref, i_ref = match_pallas.gallery_top1_int8(
            jnp.asarray(q), ref_snap.device_matrix, ref_snap.int8_scale, len(ids),
            interpret=True)
        assert [r["person_id"] if r["recognized"] else None for r in results] == [
            ids[j] if v >= 0.5 else None
            for j, v in zip(np.asarray(i_ref)[:len(gf)], np.asarray(v_ref)[:len(gf)])]
        np.testing.assert_array_equal([r["similarity"] for r in results],
                                      np.asarray(v_ref)[:len(gf)])
    _, own = proc.match_faces(frames[0], got_faces[0], "c1", draw=False)
    assert all(r["recognized"] for r in own)  # each enrolled face finds itself
