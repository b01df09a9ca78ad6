"""FaceAnalysis-compatible facade over the port's engine.

The torch form of ``facerecognition_infrenceengine_tpu/models/zoo.py``:
``FaceAnalysis("buffalo_l").prepare(...)`` then ``get(frame)`` /
``get_batch(frames)`` return ``Face`` objects with ``bbox``, ``det_score``,
``kps`` and ``normed_embedding``, computed by one fused detect -> align ->
embed call and one packed [B, F, 528] download per batch.

Ported for the detection + recognition modules and frames whose letterbox
scale is 1.0 -- the 640x480 camera on a 640x640 canvas: the canvas is the
RGB frame copied into the top-left of a zero canvas.  A frame that needs a
resize, other modules and other packs raise ``NotImplementedError`` naming
their ROADMAP item.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field

import numpy as np

from ..core.config import EngineConfig
from ..engine.pipeline import FaceEngine, bucket


@dataclass
class Face:
    bbox: np.ndarray  # [4] xyxy, original frame coords
    det_score: float
    kps: np.ndarray  # [5, 2]
    normed_embedding: np.ndarray = field(default=None)  # [512] unit norm


def letterbox(frame: np.ndarray, canvas_hw: tuple) -> tuple:
    """Top-left anchored letterbox onto a zero canvas -> (canvas uint8, scale).

    Only scale 1.0 (the frame fits the canvas unscaled on its limiting side,
    no resize) is ported; the resizing letterbox is ROADMAP Queue 1 item 7.
    """
    oh, ow = canvas_hw
    h, w = frame.shape[:2]
    scale = min(oh / h, ow / w)
    if scale != 1.0:
        raise NotImplementedError(
            f"a {h}x{w} frame needs a resize onto the {oh}x{ow} canvas (scale "
            f"{scale:.4f}); the resizing letterbox is ROADMAP Queue 1 item 7")
    canvas = np.zeros((oh, ow, 3), np.uint8)
    canvas[:h, :w] = frame
    return canvas, scale


class FaceAnalysis:
    """insightface-style facade; runs on ``device`` (default ``cuda``)."""

    def __init__(self, name: str = "buffalo_l", cfg: EngineConfig | None = None,
                 engine=None, allowed_modules=None, device=None):
        if "facenet" in name:
            raise NotImplementedError(
                f"pack {name!r}: MobileFaceNet is ROADMAP Queue 1 item 11")
        modules = set(allowed_modules or ("detection", "recognition"))
        if modules != {"detection", "recognition"}:
            raise NotImplementedError(
                f"modules {sorted(modules)}: only detection + recognition is ported "
                "(the attribute heads are ROADMAP Queue 1 item 10)")
        self.name = name
        self.cfg = cfg or EngineConfig()
        self.device = device
        self._engine = engine
        self.det_thresh = 0.3

    def prepare(self, ctx_id: int = 0, det_size: tuple | None = None,
                det_thresh: float = 0.3):
        if det_size is not None and tuple(det_size) != tuple(self.cfg.det_size):
            self.cfg = dataclasses.replace(self.cfg, det_size=tuple(det_size))
            self._engine = None
        self.det_thresh = det_thresh
        self._ensure_engine()

    def _ensure_engine(self):
        if self._engine is None:
            self._engine = FaceEngine(self.cfg, rec_arch="r50", device=self.device)
        return self._engine

    def get(self, frame: np.ndarray, max_num: int = 0) -> list:
        """BGR uint8 frame -> list of Face."""
        return self.get_batch([frame], max_num=max_num)[0]

    @staticmethod
    def _faces_from_fused_flat(flat, n: int, max_num: int) -> list:
        """Decode the packed [B, F, 528] output (boxes | score | kps | valid |
        emb) of the first ``n`` frames."""
        flat = flat.cpu().numpy() if hasattr(flat, "cpu") else np.asarray(flat)
        b, f, _ = flat.shape
        boxes, det_scores = flat[..., :4], flat[..., 4]
        kps, valid, emb = flat[..., 5:15].reshape(b, f, 5, 2), flat[..., 15] > 0.5, flat[..., 16:]
        per_frame = []
        for i in range(n):
            faces = [Face(bbox=boxes[i, j], det_score=float(det_scores[i, j]),
                          kps=kps[i, j], normed_embedding=emb[i, j])
                     for j in range(f) if valid[i, j]]
            per_frame.append(faces[:max_num] if max_num else faces)
        return per_frame

    def get_batch(self, frames: list, max_num: int = 0) -> list:
        """Batched BGR frames -> per-frame lists of Face."""
        if not frames:
            return []
        engine = self._ensure_engine()
        stacked = np.zeros((bucket(len(frames)),) + tuple(self.cfg.det_size) + (3,), np.uint8)
        for i, frame in enumerate(frames):
            stacked[i] = letterbox(frame[..., ::-1], self.cfg.det_size)[0]  # BGR -> RGB
        flat = engine.detect_align_embed_flat(stacked, det_threshold=self.det_thresh)
        return self._faces_from_fused_flat(flat, len(frames), max_num)
