"""The port's MobileFaceNet (the ``mobile_facenet_v1`` pack) against the
reference's flax module and engine.

The flax tree (the synthetic leaves with random BN scale and bias, running
statistics from a train-mode pass over 32 seeded crops, as
tests/test_torch_bf16.py builds its trees) is loaded into both; the same 8
crops go through each: float32 within 1 - cos 1e-4; bfloat16 misses the
1e-3 budget against flax bfloat16 (2.6e-3, ROADMAP Queue 3) and is held to
round no worse than the reference.  ``FaceAnalysis("mobile_facenet_v1")`` serves
the same frames through both packages and gives the same detections, close
embeddings and the same match decisions.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from facerecognition_infrenceengine_tpu.core.config import EngineConfig as JaxEngineConfig
from facerecognition_infrenceengine_tpu.engine.gallery import _CompanySnapshot as JaxSnapshot
from facerecognition_infrenceengine_tpu.engine.recognizer import (
    FaceRecognitionProcessor as JaxProcessor)
from facerecognition_infrenceengine_tpu.models import arcface as jarcface
from facerecognition_infrenceengine_tpu.models import mobilefacenet as jmobilefacenet
from facerecognition_infrenceengine_tpu.models.weights import unflatten_tree
from facerecognition_infrenceengine_tpu.models.zoo import FaceAnalysis as JaxFaceAnalysis
from facerecognition_infrenceengine_tpu_torch.core.config import (
    Config, EngineConfig, ThresholdConfig)
from facerecognition_infrenceengine_tpu_torch.engine.gallery import GalleryManager
from facerecognition_infrenceengine_tpu_torch.engine.recognizer import FaceRecognitionProcessor
from facerecognition_infrenceengine_tpu_torch.models import arcface, mobilefacenet
from facerecognition_infrenceengine_tpu_torch.models.layers import cast_keep_bn_f32
from facerecognition_infrenceengine_tpu_torch.models.zoo import FaceAnalysis
from facerecognition_infrenceengine_tpu_torch.store import Datastore
from test_torch_bf16 import _trained_tree

KW = dict(det_size=(128, 128), max_faces=8, pre_nms_topk=64, dtype="float32")
THRESH = 0.5  # synthetic weights saturate scores: every slot is valid


def _worst(want, got) -> float:
    cos = (want * got).sum(1) / np.linalg.norm(want, axis=1) / np.linalg.norm(got, axis=1)
    return float((1.0 - cos).max())


@pytest.fixture(scope="module")
def trained():
    """(flat flax tree, 8 crops) with real BN statistics."""
    rng = np.random.default_rng(5)
    stats_crops = rng.integers(0, 256, (32, 112, 112, 3), dtype=np.uint8)
    crops = rng.integers(0, 256, (8, 112, 112, 3), dtype=np.uint8)
    flat = _trained_tree(mobilefacenet.mobilefacenet(), 1,
                         arcface.preprocess(torch.from_numpy(stats_crops)))
    assert np.abs(flat["batch_stats/BatchNorm_0/mean"]).max() > 0.0
    return flat, crops


def test_module_names_and_global_depthwise_conv():
    """Flax names and widths; the global depthwise conv is 7x7 padded by 3
    (groups 512) and its centre tap, as the reference's."""
    m = mobilefacenet.mobilefacenet()
    assert m.num_blocks == 15 and m.gd == 7
    gd = m.ConvBlock_3.Conv_0
    assert gd.kernel_size == (7, 7) and gd.padding == (3, 3) and gd.groups == 512
    assert m.Bottleneck_0.ConvBlock_1.Conv_0.groups == 128  # 64 * expansion 2
    assert not hasattr(m.ConvBlock_3, "PReLU_0") and hasattr(m.ConvBlock_2, "PReLU_0")
    assert m.Dense_0.bias is None and m.BatchNorm_0.num_features == 512
    assert [m.get_submodule(f"Bottleneck_{i}").residual for i in (0, 1, 5, 6)] == [
        False, True, False, True]


def test_float32_matches_flax(trained):
    flat, crops = trained
    jm = jmobilefacenet.mobilefacenet(dtype=jnp.float32)
    want = np.asarray(jm.apply(unflatten_tree(flat), jarcface.preprocess(jnp.asarray(crops))))
    tm = mobilefacenet.mobilefacenet()
    from facerecognition_infrenceengine_tpu_torch.models.weights import load_tree

    load_tree(tm, flat)
    with torch.no_grad():
        got = tm(arcface.preprocess(torch.from_numpy(crops))).numpy()
    assert got.shape == want.shape == (8, 512)
    unit = want / np.linalg.norm(want, axis=1, keepdims=True)
    assert (unit @ unit.T)[~np.eye(8, dtype=bool)].max() < 0.99  # 8 distinct embeddings
    print(f"MobileFaceNet f32 vs flax: max 1-cos {_worst(want, got):.3e}")
    assert _worst(want, got) <= 1e-4


def test_bfloat16_rounds_no_worse_than_the_reference(trained):
    """bf16 against flax bf16 misses the 1e-3 budget (ROADMAP Queue 3): on
    this tree both bf16 forwards sit ~1.8e-2 from the float32 forward, and
    their rounding points, each within a bf16 step a layer, drift apart over
    the 53 conv layers to ~2.6e-3.  What holds, and is pinned: the port's
    bf16 is as close to the float32 forward as the reference's bf16 is, and
    its BatchNorms (the final 512-d one too) stay float32."""
    flat, crops = trained
    x = jarcface.preprocess(jnp.asarray(crops))
    want = np.asarray(jmobilefacenet.mobilefacenet(dtype=jnp.bfloat16).apply(
        unflatten_tree(flat), x))
    f32 = np.asarray(jmobilefacenet.mobilefacenet(dtype=jnp.float32).apply(
        unflatten_tree(flat), x))
    from facerecognition_infrenceengine_tpu_torch.models.weights import load_tree

    tm = cast_keep_bn_f32(load_tree(mobilefacenet.mobilefacenet(), flat), "cpu", torch.bfloat16)
    assert tm.BatchNorm_0.running_var.dtype == torch.float32  # the 512-d BatchNorm1d too
    assert tm.ConvBlock_3.BatchNorm_0.weight.dtype == torch.float32
    assert tm.Dense_0.weight.dtype == torch.bfloat16
    with torch.no_grad():
        got = tm(arcface.preprocess(torch.from_numpy(crops))).numpy()
    print(f"MobileFaceNet bf16 vs flax bf16: max 1-cos {_worst(want, got):.3e}; against "
          f"flax f32: port {_worst(f32, got):.3e}, flax bf16 {_worst(f32, want):.3e}")
    assert _worst(f32, got) <= _worst(f32, want)


def test_bfloat16_dtype_forward_is_the_served_module(trained):
    """``mobilefacenet(dtype=torch.bfloat16)`` (float32 parameters, the
    trainer's eval forward) equals the served module (the float32 module
    cast by ``cast_keep_bn_f32``) bit for bit, so both bf16 paths carry the
    miss the test above pins (ROADMAP Queue 3 item 2: the 1e-3 budget
    against flax bf16 stays unmet; printed, not asserted)."""
    flat, crops = trained
    from facerecognition_infrenceengine_tpu_torch.models.weights import load_tree

    tm = load_tree(mobilefacenet.mobilefacenet(dtype=torch.bfloat16), flat)
    assert {p.dtype for p in tm.parameters()} == {torch.float32}
    served = cast_keep_bn_f32(load_tree(mobilefacenet.mobilefacenet(), flat), "cpu",
                              torch.bfloat16)
    x = arcface.preprocess(torch.from_numpy(crops))
    with torch.no_grad():
        got, want = tm(x), served(x)
    assert got.dtype == want.dtype == torch.float32
    assert torch.equal(got, want)
    ref = np.asarray(jmobilefacenet.mobilefacenet(dtype=jnp.bfloat16).apply(
        unflatten_tree(flat), jarcface.preprocess(jnp.asarray(crops))))
    print(f"MobileFaceNet(dtype=bf16) vs flax bf16: max 1-cos {_worst(ref, got.numpy()):.3e}")


def test_engine_embeds_like_the_reference(trained):
    """FaceEngine(rec_arch="mobilefacenet") with the reference's variables:
    embed_crops through arcface.preprocess, as the reference's engine."""
    from facerecognition_infrenceengine_tpu.engine.pipeline import FaceEngine as JaxFaceEngine
    from facerecognition_infrenceengine_tpu_torch.engine.pipeline import FaceEngine

    flat, crops = trained
    variables = unflatten_tree(flat)
    jax_engine = JaxFaceEngine(JaxEngineConfig(**KW), det_arch="det_500m",
                               rec_arch="mobilefacenet", rec_variables=variables)
    engine = FaceEngine(EngineConfig(**KW), det_arch="det_500m", rec_arch="mobilefacenet",
                        rec_variables=variables, device="cpu")
    assert isinstance(engine.embedder, mobilefacenet.MobileFaceNet)
    want, got = jax_engine.embed_crops(crops[:5]), engine.embed_crops(crops[:5])
    assert got.shape == (5, 512)
    assert _worst(want, got) <= 1e-4
    np.testing.assert_allclose(np.linalg.norm(got, axis=1), 1.0, atol=1e-5)


def test_face_analysis_mobile_facenet_gives_the_reference_decisions():
    """FaceAnalysis("mobile_facenet_v1") in both packages (det_10g +
    MobileFaceNet, synthetic weights, seed 0 / 1): the same valid faces,
    embeddings within 1 - cos 1e-4, and the same match decisions against a
    gallery of frame 0's faces plus distractors."""
    rng = np.random.default_rng(0)
    frames = [rng.integers(0, 256, (96, 128, 3), dtype=np.uint8) for _ in range(2)]
    jax_app = JaxFaceAnalysis(name="mobile_facenet_v1", cfg=JaxEngineConfig(**KW),
                              allowed_modules=("detection", "recognition"))
    jax_app.prepare(det_thresh=THRESH)
    app = FaceAnalysis(name="mobile_facenet_v1", cfg=EngineConfig(**KW), device="cpu",
                       allowed_modules=("detection", "recognition"))
    app.prepare(det_thresh=THRESH)
    assert app._ensure_engine().rec_arch == "mobilefacenet"
    want_faces, got_faces = jax_app.get_batch(frames), app.get_batch(frames)
    assert [len(f) for f in got_faces] == [len(f) for f in want_faces] and got_faces[0]
    for gf, wf in zip(sum(got_faces, []), sum(want_faces, [])):
        np.testing.assert_allclose(gf.bbox, wf.bbox, rtol=0, atol=1e-2)
        assert _worst(wf.normed_embedding[None], gf.normed_embedding[None]) <= 1e-4
    enrolled = np.stack([f.normed_embedding for f in want_faces[0]])
    matrix = np.concatenate([enrolled, np.random.default_rng(2).normal(size=(20, 512))])
    matrix = (matrix / np.linalg.norm(matrix, axis=1, keepdims=True)).astype(np.float32)
    ids = [f"p{i}" for i in range(len(matrix))]
    meta = {pid: {"type": "employee", "name": pid, "employeeId": pid.upper()} for pid in ids}
    others = np.stack([f.normed_embedding for f in want_faces[1]]) @ enrolled.T
    threshold = (1.0 + float(others.max())) / 2
    cfg = Config(thresholds=ThresholdConfig(recognition=threshold), engine=EngineConfig(**KW))

    class _JaxGallery:
        snap = JaxSnapshot(ids, meta, matrix, 512, 1024)

        def match(self, embs, company_id=None, k=1):
            scores, found = self.snap.match(embs, k=k)
            return scores, found, self.snap.metadata

    jax_proc = JaxProcessor(_JaxGallery(), face_app=jax_app)
    jax_proc.recognition_threshold = threshold
    galleries = GalleryManager(Datastore(cfg), cfg, initial_load=False, device="cpu")
    galleries.set_snapshot(ids, meta, matrix, company_id="c1")
    proc = FaceRecognitionProcessor(galleries, face_app=app, cfg=cfg)
    recognized = 0
    for frame, gf, wf in zip(frames, got_faces, want_faces):
        _, want = jax_proc.match_faces(frame, wf, "c1", draw=False)
        _, got = proc.match_faces(frame, gf, "c1", draw=False)
        assert [r["person_id"] for r in got] == [r["person_id"] for r in want]
        assert [r["recognized"] for r in got] == [r["recognized"] for r in want]
        recognized += sum(r["recognized"] for r in got)
    assert recognized == len(want_faces[0])
