"""How ``correct`` is decided: the frames the window resolved, judged
against the plain reference.

A sample of the frames submitted in the window, drawn from the seed once
the window has closed, is judged face by face.  The reference runs on the
same BGR frames, the same weights and the same gallery, and works out the
canvas (and for yuv420 the packs and their decode) itself:

- detection, by itself.  The count: the faces the port served against
  the reference's, summed over the sample's frames, as a share of the
  reference's (``det.count_share_gap``; a frame's count may move by a few
  where rounding changes which of heavily overlapping random boxes survive
  NMS, half of every frame's faces may not).  Suppression, which needs no
  reference: the largest IoU between two of a frame's served boxes, in
  insightface's integer-pixel convention and float64, over the
  configuration's ``nms_iou`` (``det.overlap_excess``).  The threshold:
  the share of served faces whose nearest anchor, of all the canvas's,
  the reference scores under the detection threshold
  (``det.under_share``).  Where the faces lie: each served face (box and
  five landmarks) against the nearest candidate of the reference, in
  pixels, read in units of the median gap of the reference's bf16-weight
  probe (``Reference.detect_probe``): a random detector's sensitivity to
  rounding varies twentyfold from seed to seed, so a gap is read in units
  of what rounding the weights alone to the configuration's bf16 moves.
  The median face against the reference's pre-NMS candidates
  (``det.box_gap_rel``), and the widest face against every anchor the
  reference scores at or over the threshold (``det.box_gap_max_rel``),
  which a minority of faces served from the wrong anchors fails where the
  median passes.  A face moved by less than the widest rounding gap of a
  random detector, or onto the place of another candidate, is not seen;
- the embedding: the reference's warp + embedder at the served face's
  landmarks (the stage after detection, fed the served landmarks so that a
  near-tie the detector breaks otherwise does not change which face is
  compared), as 1 - cos;
- the attribute heads on the served box: the reference's logit gap of the
  served gender, the age, and the 106 landmarks (the median face's widest
  point gap, over the same for the heads' bf16-weight probe);
- the decisions against the reference's scores of the served embedding
  (float64 for a float32 gallery, exact integers for int8): the score gap
  of the chosen person to the best, the reported similarity, and a
  recognized flag that disagrees with the reference's best score (its
  distance to the threshold).

Each number is the widest over the sample unless it is a ``_share`` of
the sample's faces or a ``_rel`` ratio to the probe's median; the cell's
limits file holds its limit.
"""

from __future__ import annotations

import numpy as np
import torch

from .reference.pipeline import Reference, canvas_of, int8_queries, quantize_gallery


def faces_of(port_faces: list) -> list:
    """The port's ``Face`` objects as plain dicts."""
    return [dict(bbox=np.asarray(f.bbox, np.float32), kps=np.asarray(f.kps, np.float32),
                 score=float(f.det_score), emb=np.asarray(f.normed_embedding, np.float32),
                 gender=f.gender, age=f.age,
                 lm=None if f.landmark_2d_106 is None else np.asarray(f.landmark_2d_106))
            for f in port_faces]


def decisions_of(results: list) -> list:
    return [dict(person_id=r["person_id"], similarity=float(r["similarity"]),
                 recognized=bool(r["recognized"])) for r in results]


def _bf16(x: np.ndarray) -> np.ndarray:
    return torch.from_numpy(np.ascontiguousarray(x, np.float32)).bfloat16().double().numpy()


class Gallery:
    """The site's gallery as a decision scores it: ``float32`` and ``int8``
    as the port stores it; ``bfloat16`` and ``int4`` are the precisions
    below them, for the control."""

    def __init__(self, ids: list, matrix: np.ndarray, dtype: str, headroom: float):
        m = np.asarray(matrix, np.float32)
        self.rows = m / np.maximum(np.linalg.norm(m, axis=1, keepdims=True), 1e-12)
        self.ids = list(ids)
        self.row_of = {pid: i for i, pid in enumerate(self.ids)}
        self.dtype = dtype
        if dtype == "int8":
            q, self.scale = quantize_gallery(self.rows, headroom)
            # integer dots below 2**53 are exact in float64, at BLAS speed
            self.q64 = q.astype(np.float64)
        elif dtype == "int4":
            self.scale = max(float(np.abs(self.rows).max()) * headroom / 7.0, 1e-12)
            self.q64 = np.clip(np.rint(self.rows / self.scale), -7, 7).astype(np.float64)
        elif dtype == "bfloat16":
            self.f64 = _bf16(self.rows)
        else:
            self.f64 = self.rows.astype(np.float64)

    def scores(self, embs: np.ndarray) -> np.ndarray:
        """[n, rows] scores of one frame's faces, as the decision defines
        them: the embeddings renormalized as ``match_faces`` does, then the
        cosine (float rows) or the integer dot x both scales."""
        e = np.asarray(embs, np.float32)
        e = e / np.maximum(np.linalg.norm(e, axis=1, keepdims=True), 1e-12)
        if self.dtype == "int8":
            q8, qs = int8_queries(e)
            return (q8.astype(np.float64) @ self.q64.T) * (float(qs) * self.scale)
        if self.dtype == "int4":
            qs = max(float(np.abs(e).max()), 1e-12) / 7.0
            q4 = np.clip(np.rint(e / qs), -7, 7)
            return (q4 @ self.q64.T) * (qs * self.scale)
        if self.dtype == "bfloat16":
            return _bf16(e) @ self.f64.T
        return e.astype(np.float64) @ self.f64.T


def reference_decisions(gallery: Gallery, embs: np.ndarray, threshold: float) -> list:
    """Decisions made by the reference on ``gallery`` (for the control)."""
    out = []
    for row in gallery.scores(embs):
        j = int(np.argmax(row))
        ok = bool(row[j] >= threshold)
        out.append(dict(person_id=gallery.ids[j] if ok else None, similarity=float(row[j]),
                        recognized=ok))
    return out


def _nearest(geo: np.ndarray, cands: np.ndarray) -> tuple:
    """(index, gap) of the candidate of ``cands`` [k, 14] (box xyxy, 5
    landmarks) nearest to ``geo`` [14] by the largest coordinate gap, in
    pixels; (-1, inf) where there is none."""
    if not len(cands):
        return -1, float("inf")
    gaps = np.abs(cands - geo[None]).max(axis=1)
    j = int(np.argmin(gaps))
    return j, float(gaps[j])


def _geo_gap(geo: np.ndarray, cands: np.ndarray) -> float:
    return _nearest(geo, cands)[1]


def _cands(det: dict, b: int) -> np.ndarray:
    live = np.isfinite(det["cand_scores"][b])
    return np.concatenate([det["cand_boxes"][b], det["cand_kps"][b].reshape(-1, 10)], 1)[live]


def _anchors(det: dict, b: int) -> tuple:
    """Every anchor of frame ``b``: its geometry [A, 14] and the reference's
    score [A]."""
    return (np.concatenate([det["all_boxes"][b], det["all_kps"][b].reshape(-1, 10)], 1),
            det["all_scores"][b])


def overlap(boxes: np.ndarray) -> float:
    """The largest IoU between two of ``boxes`` [n, 4] xyxy float64, with
    the integer-pixel offset of 1 that detection NMS uses."""
    if len(boxes) < 2:
        return 0.0
    b = boxes
    lt = np.maximum(b[:, None, :2], b[None, :, :2])
    rb = np.minimum(b[:, None, 2:], b[None, :, 2:])
    wh = np.clip(rb - lt + 1.0, 0.0, None)
    inter = wh[..., 0] * wh[..., 1]
    area = np.clip(b[:, 2] - b[:, 0] + 1.0, 0.0, None) * np.clip(b[:, 3] - b[:, 1] + 1.0, 0.0, None)
    iou = inter / np.maximum(area[:, None] + area[None, :] - inter, 1e-9)
    np.fill_diagonal(iou, 0.0)
    return float(iou.max())


def probe_gaps(ref_det: dict, probe_det: dict, k: int) -> list:
    """The bf16-weight probe's first ``k`` candidates of each frame against
    the reference's candidates (``_geo_gap``)."""
    return [_geo_gap(c, _cands(ref_det, b)) for b in range(len(probe_det["cand_scores"]))
            for c in _cands(probe_det, b)[:k]]


def conditioning(dets: list, probes: list, witnesses: list, thresh: float, k: int) -> tuple:
    """How far rounding to bfloat16 moves a detector draw, read as
    ``det.box_gap_rel`` and ``det.box_gap_max_rel`` read the port, with the
    bf16 witness (``Reference(bf16=True)``) in the port's place: (its median
    served face's gap to the nearest float32 candidate, its widest served
    face's gap to any anchor scored at or over ``thresh``), each over the
    bf16-weight probe's median gap.  ``dets``, ``probes``, ``witnesses``:
    the three detectors' outputs, block by block."""
    probe, near, far = [], [], []
    for det, pr, wi in zip(dets, probes, witnesses):
        probe += probe_gaps(det, pr, k)
        for b in range(len(wi["valid"])):
            v = wi["valid"][b]
            geo = np.concatenate([wi["boxes"][b][v], wi["kps"][b][v].reshape(-1, 10)], 1)
            cands = _cands(det, b)
            every, score = _anchors(det, b)
            near += [_geo_gap(g, cands) for g in geo]
            far += [_geo_gap(g, every[score >= thresh]) for g in geo]
    if not near:
        return float("inf"), float("inf")
    scale = max(float(np.median(probe)), 1e-6)
    return float(np.median(near)) / scale, float(np.max(far)) / scale


class _Memo:
    """The reference's work on one block, shared by every judged set whose
    faces sit at the same landmarks or boxes."""

    def __init__(self, ref: Reference, canvases: np.ndarray):
        self.ref, self.canvases, self.memo = ref, canvases, {}

    def __call__(self, kind: str, idx: np.ndarray, arr: np.ndarray):
        key = (kind, idx.tobytes(), np.ascontiguousarray(arr).tobytes())
        if key not in self.memo:
            fn = getattr(self.ref, kind)
            self.memo[key] = fn(self.canvases, idx, arr)
        return self.memo[key]


def _judge_block(memo: _Memo, det: dict, gallery: Gallery, config: dict, threshold: float,
                 part: list, widen, collect) -> None:
    """One block's numbers (``widen``: the widest; ``collect``: every
    frame's or face's reading, for a sum, a share or a median)."""
    for b, (_, faces, _) in enumerate(part):
        n_ref = int(det["valid"][b].sum())
        collect("det.count_diff", [abs(len(faces) - n_ref)])
        collect("det.count_ref", [n_ref])
        served = np.asarray([f["bbox"] for f in faces], np.float64).reshape(-1, 4)
        widen("det.overlap_excess", max(0.0, overlap(served) - config["nms_iou"]))
    idx = np.asarray([b for b, (_, faces, _) in enumerate(part) for _ in faces], np.int64)
    flat = [f for _, faces, _ in part for f in faces]
    if not flat:
        return
    kps = np.stack([f["kps"] for f in flat]).astype(np.float32)
    boxes = np.stack([f["bbox"] for f in flat]).astype(np.float32)
    cands = [_cands(det, b) for b in range(len(part))]
    anchors = [_anchors(det, b) for b in range(len(part))]
    geo = [np.concatenate([f["bbox"], f["kps"].reshape(-1)]) for f in flat]
    collect("det.box_gap_px", [_geo_gap(g, cands[idx[k]]) for k, g in enumerate(geo)])
    thresh = config["det_thresh"]
    far, under = [], []
    for k, g in enumerate(geo):
        every, score = anchors[idx[k]]
        far.append(_geo_gap(g, every[score >= thresh]))
        under.append(bool(score[_nearest(g, every)[0]] < thresh))
    collect("det.box_far_px", far)
    collect("det.under", under)
    emb_ref = memo("embed", idx, kps)
    emb = np.stack([f["emb"] for f in flat]).astype(np.float64)
    emb /= np.maximum(np.linalg.norm(emb, axis=1, keepdims=True), 1e-12)
    widen("embed.cos_gap", np.max(1.0 - np.sum(emb * emb_ref, axis=1)))
    if config.get("attribute_heads"):
        logits, age, lm = memo("attributes", idx, boxes)
        probe_lm = memo("attributes_probe", idx, boxes)[2]
        gender = np.asarray([f["gender"] for f in flat])
        widen("attr.gender_gap",
              np.max(logits.max(axis=1) - logits[np.arange(len(flat)), gender]))
        widen("attr.age_err", np.max(np.abs(np.asarray([f["age"] for f in flat]) - age)))
        collect("attr.lm_gap_px", list(np.abs(np.stack([f["lm"] for f in flat]) - lm)
                                       .reshape(len(flat), -1).max(1)))
        collect("attr.lm_probe_px", list(np.abs(probe_lm - lm).reshape(len(flat), -1).max(1)))
    widen("decide.top1_gap", 0.0)
    for _, faces, decided in part:
        if not faces:
            continue
        s = gallery.scores(np.stack([f["emb"] for f in faces]))
        for row, d in zip(s, decided):
            top = row.max()
            if d["recognized"]:
                j = gallery.row_of.get(d["person_id"])
                chosen = row[j] if j is not None else -np.inf
                widen("decide.top1_gap", top - chosen)
                widen("decide.sim_err", abs(d["similarity"] - chosen))
            else:
                widen("decide.sim_err", abs(d["similarity"] - top))
            widen("decide.flag_gap",
                  abs(top - threshold) if d["recognized"] != bool(top >= threshold) else 0.0)


def judge(ref: Reference, gallery: Gallery, config: dict, traffic: dict, pool: np.ndarray,
          sets: dict) -> dict:
    """``sets``: {name: [(pool index, face dicts, decision dicts)]}, every
    set over the same frames in the same order -> {name: {number: widest
    value}}.  The reference runs in blocks of ``check_block`` frames."""
    out = {name: {} for name in sets}
    samples = {name: {} for name in sets}  # number -> every face's reading, for medians
    probe: list = []
    block = traffic["check_block"]
    first = next(iter(sets.values()))
    for start in range(0, len(first), block):
        canvases = np.stack([canvas_of(pool[i], config["canvas"], traffic["transport"])
                             for i, _, _ in first[start:start + block]])
        det = ref.detect(canvases)
        probe += probe_gaps(det, ref.detect_probe(canvases), config["max_faces"])
        memo = _Memo(ref, canvases)
        for name, judged in sets.items():
            nums = out[name]

            def widen(key, value, nums=nums):
                nums[key] = max(nums.get(key, 0.0), float(value))

            def collect(key, values, got=samples[name]):
                got.setdefault(key, []).extend(values)

            _judge_block(memo, det, gallery, config, traffic["recognition_threshold"],
                         judged[start:start + block], widen, collect)
    for name, got in samples.items():
        if got.get("det.count_ref"):
            out[name]["det.count_share_gap"] = float(sum(got["det.count_diff"])
                                                     / max(1, sum(got["det.count_ref"])))
        if got.get("det.box_far_px"):
            out[name]["det.box_gap_max_rel"] = float(np.max(got["det.box_far_px"])
                                                     / max(np.median(probe), 1e-6))
            out[name]["det.under_share"] = float(np.mean(got["det.under"]))
        if got.get("det.box_gap_px"):
            out[name]["det.box_gap_rel"] = float(np.median(got["det.box_gap_px"])
                                                 / max(np.median(probe), 1e-6))
        if got.get("attr.lm_gap_px"):
            out[name]["attr.lm_gap_rel"] = float(np.median(got["attr.lm_gap_px"])
                                                 / max(np.median(got["attr.lm_probe_px"]), 1e-6))
    return out


def verdict(nums: dict, limits: dict) -> tuple:
    """(correct, {number: (value, limit)}): every number with a limit at or
    under it; a number that was not read, or is not finite, fails."""
    compared = {name: (nums.get(name, float("nan")), lim) for name, lim in limits.items()}
    ok = all(np.isfinite(v) and v <= lim for v, lim in compared.values())
    return ok, compared
