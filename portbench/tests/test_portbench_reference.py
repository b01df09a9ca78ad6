"""The reference against itself at a small size on the CPU."""

import json
import os

import numpy as np
import pytest
import torch

from portbench import check, data, spec
from portbench.reference import codec, yuv
from portbench.reference.pipeline import Reference, canvas_of, fp8_round, int8_queries

TESTS = os.path.dirname(os.path.abspath(__file__))


@pytest.fixture(scope="module")
def tiny():
    torch.manual_seed(0)
    with open(os.path.join(TESTS, "tiny_config.json")) as f:
        config = json.load(f)
    det, rec = data.model_weights(config, 5, "cpu")
    frames = data.camera_frames(3, 96, 128, 5, "cpu")
    canvases = np.stack([canvas_of(f, config["canvas"], "rgb") for f in frames])
    return config, Reference(config, det, rec, "cpu"), canvases


def test_detection_is_independent_of_the_batch(tiny):
    config, ref, canvases = tiny
    whole = ref.detect(canvases)
    for b in range(len(canvases)):
        one = ref.detect(canvases[b:b + 1])
        for key in ("boxes", "scores", "kps", "valid"):
            np.testing.assert_allclose(one[key][0], whole[key][b], rtol=1e-5, atol=1e-3)


def test_slots_are_the_nms_of_the_candidates(tiny):
    config, ref, canvases = tiny
    det = ref.detect(canvases)
    assert det["valid"].all(), "random weights fill every slot"
    for b in range(len(canvases)):
        boxes = det["boxes"][b]
        x1 = np.maximum(boxes[:, None, 0], boxes[None, :, 0])
        y1 = np.maximum(boxes[:, None, 1], boxes[None, :, 1])
        x2 = np.minimum(boxes[:, None, 2], boxes[None, :, 2])
        y2 = np.minimum(boxes[:, None, 3], boxes[None, :, 3])
        inter = np.clip(x2 - x1, 0, None) * np.clip(y2 - y1, 0, None)
        area = (boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1])
        iou = inter / (area[:, None] + area[None, :] - inter)
        np.fill_diagonal(iou, 0)
        assert iou.max() <= config["nms_iou"] + 1e-6
        assert np.all(np.diff(det["scores"][b]) <= 0)


def test_embedding_is_independent_of_the_batch_and_unit(tiny):
    config, ref, canvases = tiny
    det = ref.detect(canvases)
    idx = np.repeat(np.arange(len(canvases)), config["max_faces"])
    kps = det["kps"].reshape(-1, 5, 2)
    whole = ref.embed(canvases, idx, kps)
    np.testing.assert_allclose(np.linalg.norm(whole, axis=1), 1.0, atol=1e-5)
    part = ref.embed(canvases[1:2], np.zeros(config["max_faces"], np.int64),
                     det["kps"][1])
    np.testing.assert_allclose(part, whole[config["max_faces"]:2 * config["max_faces"]],
                               atol=1e-5)


def test_fp8_control_departs_from_float32(tiny):
    config, ref, canvases = tiny
    det = ref.detect(canvases)
    idx = np.zeros(config["max_faces"], np.int64)
    want = ref.embed(canvases[:1], idx, det["kps"][0])
    weights = data.model_weights(config, 5, "cpu")
    got = Reference(config, *weights, "cpu", fp8=True).embed(canvases[:1], idx, det["kps"][0])
    assert np.max(1.0 - np.sum(want * got, axis=1)) > 1e-3
    x = torch.linspace(-3, 3, 101)
    assert 0 < float((fp8_round(x) - x).abs().max()) <= 3 / 448 * 32


def test_yuv_round_trip_canvas():
    frame = data.camera_frames(1, 96, 128, 9, "cpu")[0]
    rgb = canvas_of(frame, (128, 128), "rgb")
    via = canvas_of(frame, (128, 128), "yuv420")
    assert rgb.shape == via.shape and not via[96:].any()
    # the 4:2:0 chroma loss on noise
    assert np.abs(rgb.astype(int) - via.astype(int))[:96].mean() < 20
    pack = codec.pack_yuv420_s2d4_plain(np.ascontiguousarray(frame[..., ::-1]))
    np.testing.assert_array_equal(yuv.yuv420p4_to_rgb_host(pack), via[:96])


def test_gallery_scores_float_and_int8():
    rng = np.random.default_rng(0)
    rows = rng.normal(size=(50, 512)).astype(np.float32)
    q = rng.normal(size=(4, 512)).astype(np.float32)
    g = check.Gallery([f"p{i}" for i in range(50)], rows, "float32", 1.25)
    unit = rows / np.linalg.norm(rows, axis=1, keepdims=True)
    qn = q / np.linalg.norm(q, axis=1, keepdims=True)
    np.testing.assert_allclose(g.scores(q), qn @ unit.T, atol=1e-6)
    g8 = check.Gallery(g.ids, rows, "int8", 1.25)
    q8, qs = int8_queries(qn)
    assert np.abs(q8).max() == 127 and np.abs(g8.q64).max() <= 127
    assert np.array_equal(g8.q64, np.rint(g8.q64))
    np.testing.assert_allclose(g8.scores(q), g.scores(q), atol=0.05)
    assert (np.argmax(g8.scores(q), axis=1) == np.argmax(g.scores(q), axis=1)).all()


def test_judge_reads_zero_for_the_reference_itself(tiny):
    """The reference's own outputs, judged as the port's, read nought."""
    config, ref, canvases = tiny
    traffic = {"recognition_threshold": 0.4, "check_block": 2, "transport": "rgb"}
    frames = data.camera_frames(3, 96, 128, 5, "cpu")
    det = ref.detect(canvases)
    rows = data.distractors(20, 512, 5, "cpu")
    gallery = check.Gallery([f"p{i}" for i in range(20)], rows, "float32", 1.25)
    judged = []
    for b in range(3):
        kps, boxes = det["kps"][b], det["boxes"][b]
        emb = ref.embed(canvases[b:b + 1], np.zeros(len(kps), np.int64), kps)
        faces = [dict(bbox=boxes[k], kps=kps[k], score=float(det["scores"][b][k]), emb=emb[k],
                      gender=None, age=None, lm=None) for k in range(len(kps))]
        judged.append((b, faces, check.reference_decisions(gallery, emb, 0.4)))
    nums = check.judge(ref, gallery, dict(config, attribute_heads=None), traffic, frames,
                       {"port": judged})["port"]
    for name, value in nums.items():
        # pixels move by a batch of two against a batch of three in the convs;
        # the widest face's such move, in units of the probe's median gap,
        # reads about 1e-4 (a sound bf16 port reads 2.5-8.5)
        pixels = name.endswith("_px") or name == "det.box_gap_max_rel"
        assert value <= (1e-2 if pixels else 1e-5), (name, value)
    limits = {k: v for k, v in spec.cell("buffalo_l.crowd")["limits"].items()
              if not k.startswith("attr.")}
    assert check.verdict(nums, limits)[0]


def test_a_detector_draw_that_leaves_a_slot_empty_is_redrawn(monkeypatch):
    """The first draw, made to leave one slot of one frame empty, is drawn
    again from the seed: every seed serves full frames."""
    from portbench import serve

    with open(os.path.join(TESTS, "tiny_config.json")) as f:
        config = json.load(f)
    with open(os.path.join(TESTS, "tiny_traffic.json")) as f:
        traffic = json.load(f)
    real, calls = serve.Reference.detect, []

    def detect(self, canvases):
        out = real(self, canvases)
        calls.append(len(canvases))
        if len(calls) == 1:
            out["valid"][0, -1] = False
        return out

    monkeypatch.setattr(serve.Reference, "detect", detect)
    pool = data.camera_frames(traffic["pool_frames"], *traffic["frame"], 5, "cpu")
    det, draws, _, _ = serve.full_detector(config, traffic, 5, pool, "cpu")
    assert draws == 2
    again = data.detector_weights(config, 5, "cpu", 1)
    assert all(np.array_equal(det[k], again[k]) for k in again)
    assert not all(np.array_equal(det[k], v)
                   for k, v in data.detector_weights(config, 5, "cpu", 0).items())


def _det(shift: float = 0.0, under: bool = False) -> dict:
    """One frame of 8 anchors, the first 4 served; ``shift`` moves every
    box and landmark; ``under`` scores the first anchor under 0.5."""
    rng = np.random.default_rng(3)
    boxes = rng.uniform(0, 600, (1, 8, 4)).astype(np.float32) + shift
    kps = rng.uniform(0, 600, (1, 8, 5, 2)).astype(np.float32) + shift
    scores = np.full((1, 8), 0.9, np.float32)
    if under:
        scores[0, 0] = 0.1
    return dict(valid=np.arange(8)[None] < 4, boxes=boxes, kps=kps, cand_boxes=boxes,
                cand_scores=scores, cand_kps=kps, all_boxes=boxes, all_kps=kps,
                all_scores=scores)


@pytest.mark.parametrize("shift,median,widest", [(0.0, 0.0, 0.0), (10.0, 10.0, 10.0)])
def test_conditioning_reads_the_witness_in_probe_units(shift, median, widest):
    """A witness on the reference's faces reads 0; one moved by 10 pixels
    reads 10 probe medians (the probe sits 1 pixel off)."""
    got = check.conditioning([_det()], [_det(1.0)], [_det(shift)], 0.5, 4)
    assert got == pytest.approx((median, widest), abs=1e-4)


def test_conditioning_reads_a_face_off_the_threshold_as_widest():
    """A served face whose own anchor the reference scores under the
    threshold is read against the nearest anchor over it: far."""
    med, widest = check.conditioning([_det(under=True)], [_det(1.0, under=True)], [_det()],
                                     0.5, 4)
    assert med == 0.0 and widest > 10.0
