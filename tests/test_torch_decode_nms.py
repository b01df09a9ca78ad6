"""Port decode + NMS vs the reference: anchors, box decode, greedy NMS and
the engine's shared decode tail (sigmoid -> decode -> top-k -> NMS)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from facerecognition_infrenceengine_tpu.core.config import EngineConfig as JaxEngineConfig
from facerecognition_infrenceengine_tpu.engine.pipeline import FaceEngine as JaxFaceEngine
from facerecognition_infrenceengine_tpu.ops import nms_padded as jax_nms_padded
from facerecognition_infrenceengine_tpu.ops.anchors import all_anchor_centers as jax_centers
from facerecognition_infrenceengine_tpu_torch.core.config import EngineConfig
from facerecognition_infrenceengine_tpu_torch.engine.pipeline import FaceEngine
from facerecognition_infrenceengine_tpu_torch.ops import anchors, boxes, nms


def _candidates(seed=1, n=64, k=128):
    rng = np.random.default_rng(seed)
    xy = rng.uniform(0, 400, (n, 2))
    wh = rng.uniform(20, 80, (n, 2))
    pb = np.zeros((k, 4), np.float32)
    ps = np.full(k, -np.inf, np.float32)
    pb[:n] = np.concatenate([xy, xy + wh], axis=1)
    ps[:n] = rng.uniform(0.1, 1.0, n)
    return pb, ps


@pytest.mark.parametrize("offset", [1.0, 0.0])
def test_nms_matches_reference(offset):
    """The cases of tests/test_ops_boxes_nms.py: 64 boxes padded to 128."""
    pb, ps = _candidates()
    want = [np.asarray(o) for o in jax_nms_padded(
        jnp.asarray(pb), jnp.asarray(ps), max_out=32, iou_thresh=0.4, iou_offset=offset)]
    got = [o.numpy() for o in nms.nms_padded(
        torch.from_numpy(pb), torch.from_numpy(ps), max_out=32, iou_thresh=0.4,
        iou_offset=offset)]
    np.testing.assert_array_equal(got[3], want[3])                  # valid
    np.testing.assert_array_equal(got[2][want[3]], want[2][want[3]])  # slot order
    np.testing.assert_allclose(got[0], want[0], atol=1e-3)
    np.testing.assert_allclose(got[1], want[1], atol=1e-6)


def test_nms_batched_equals_per_image():
    imgs = [_candidates(seed) for seed in (1, 2, 3)]
    pb = torch.from_numpy(np.stack([b for b, _ in imgs]))
    ps = torch.from_numpy(np.stack([s for _, s in imgs]))
    batched = nms.nms_padded(pb, ps, max_out=16)
    for i in range(3):
        single = nms.nms_padded(pb[i], ps[i], max_out=16)
        for a, b in zip(batched, single):
            torch.testing.assert_close(a[i], b, rtol=0, atol=0)


def test_anchor_layout_and_decode():
    np.testing.assert_array_equal(anchors.all_anchor_centers(640, 640).numpy(),
                                  np.asarray(jax_centers(640, 640)))
    c = torch.tensor([[10.0, 20.0], [100.0, 50.0]])
    d = torch.tensor([[1.0, 2.0, 3.0, 4.0], [10.0, 10.0, 10.0, 10.0]])
    np.testing.assert_allclose(boxes.distance2bbox(c, d).numpy(),
                               [[9, 18, 13, 24], [90, 40, 110, 60]])
    k = boxes.distance2kps(c[:1], torch.tensor([[1.0, -1, 2, 2, 0, 0, -3, 1, 5, 5]]))
    np.testing.assert_allclose(k[0].numpy(), [[11, 19], [12, 22], [10, 20], [7, 21], [15, 25]])


def test_decode_nms_tail_matches_reference():
    """The same raw heads through both engines' _decode_nms: identical
    valid slots and slot order, boxes/kps within 1e-3 px.  Scores are
    spread so that thresholding, top-k ties (equal logits) and suppression
    all occur."""
    kw = dict(det_size=(128, 128), max_faces=16, pre_nms_topk=64, dtype="float32")
    jeng = JaxFaceEngine(JaxEngineConfig(**kw), det_arch="det_500m", rec_arch="r18")
    teng = FaceEngine(EngineConfig(**kw), det_arch="det_500m", rec_arch="r18", device="cpu")
    rng = np.random.default_rng(4)
    a = (16 * 16 + 8 * 8 + 4 * 4) * 2
    logits = rng.normal(0, 2, (2, a, 1)).astype(np.float32)
    logits[:, ::7] = 1.5  # exact ties across many anchors
    bbox = rng.uniform(3.0, 12.0, (2, a, 4)).astype(np.float32)
    kps = rng.normal(0, 1.5, (2, a, 10)).astype(np.float32)
    want = [np.asarray(o) for o in jeng._decode_nms(
        jnp.asarray(logits), jnp.asarray(bbox), jnp.asarray(kps), 0.8)]
    got = [o.numpy() for o in teng._decode_nms(
        torch.from_numpy(logits), torch.from_numpy(bbox), torch.from_numpy(kps), 0.8)]
    assert want[3].sum() > 4 and (~want[3]).sum() > 0
    np.testing.assert_array_equal(got[3], want[3])
    np.testing.assert_allclose(got[0], want[0], atol=1e-3)
    np.testing.assert_allclose(got[1], want[1], atol=1e-6)
    np.testing.assert_allclose(got[2], want[2], atol=1e-3)
