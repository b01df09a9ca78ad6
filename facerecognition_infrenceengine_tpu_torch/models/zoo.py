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

With ``EngineConfig.stream_transport="yuv420"`` each frame is encoded on
the host (``encode_frame``: 4:2:0 YUV in s2d4 layout, content rows only,
1.5 B/px) and the batch runs ``detect_align_embed_yuv420_flat``; a batch
mixing packs with raw frames decodes the packs on the host and takes the
raw-RGB path.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field

import numpy as np

from .. import native
from ..core.config import EngineConfig
from ..engine.pipeline import _YUV_BLACK, FaceEngine, bucket
from ..ops.yuv import yuv420p4_to_rgb_host


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

    # ------------------------------------------------------ yuv420 transport
    @staticmethod
    def _is_pack(frame) -> bool:
        return getattr(frame, "ndim", 0) == 3 and frame.shape[-1] == 24

    def _yuv_eligible(self, engine, frames) -> bool:
        """The half-byte transport: configured, and every frame is a pack
        already or fits the canvas at letterbox scale 1.0."""
        if self.cfg.stream_transport != "yuv420" or not engine._has_packed_stem():
            return False
        dh, dw = self.cfg.det_size
        return all(self._is_pack(f) or min(dh / f.shape[0], dw / f.shape[1]) == 1.0
                   for f in frames)

    def encode_frame(self, frame_bgr: np.ndarray) -> np.ndarray:
        """One BGR camera frame -> its yuv420 s2d4 content rows
        [ceil(h/4), W/4, 24]: the rows of ``native.letterbox_yuv420_s2d4``
        that hold the frame (the letterbox puts it at the top-left; later
        rows are padding the device re-creates), packed from a canvas of
        those rows only.  Returns the frame unchanged for the rgb transport
        or a frame that needs a resize."""
        dh, dw = self.cfg.det_size
        h, w = frame_bgr.shape[:2]
        if self.cfg.stream_transport != "yuv420" or min(dh / h, dw / w) != 1.0:
            return frame_bgr
        canvas = np.zeros((min(-(-h // 4) * 4, dh), dw, 3), np.uint8)
        canvas[:h, :w] = frame_bgr[..., ::-1]  # BGR -> RGB
        return native.pack_yuv420_s2d4(canvas)

    @staticmethod
    def _stack_yuv(packs, dw: int) -> np.ndarray:
        """Stack content-row packs into one [bucket(n), rows, dw/4, 24] batch;
        the unfilled area is YUV black."""
        rows = max(p.shape[0] for p in packs)
        stacked = np.empty((bucket(len(packs)), rows, dw // 4, 24), np.uint8)
        stacked[...] = np.asarray(_YUV_BLACK, np.uint8)
        for i, p in enumerate(packs):
            stacked[i, :p.shape[0]] = p
        return stacked

    def _get_batch_fused_yuv(self, engine, frames, max_num: int) -> list:
        packs = [f if self._is_pack(f) else self.encode_frame(f) for f in frames]
        stacked = self._stack_yuv(packs, self.cfg.det_size[1])
        flat = engine.detect_align_embed_yuv420_flat(stacked, det_threshold=self.det_thresh)
        return self._faces_from_fused_flat(flat, len(frames), max_num)

    def _decode_mixed_packs(self, frames: list) -> list:
        """Packs in a batch that cannot take the yuv path are decoded back to
        BGR content rows on the host (the 4:2:0 chroma loss was paid at
        encode), so the raw path sees plain frames."""
        return [np.ascontiguousarray(yuv420p4_to_rgb_host(np.asarray(f))[..., ::-1])
                if self._is_pack(f) else f for f in frames]

    def get_batch(self, frames: list, max_num: int = 0) -> list:
        """Batched BGR frames (or yuv420 packs from ``encode_frame``) ->
        per-frame lists of Face."""
        if not frames:
            return []
        engine = self._ensure_engine()
        if self._yuv_eligible(engine, frames):
            return self._get_batch_fused_yuv(engine, frames, max_num)
        frames = self._decode_mixed_packs(frames)
        stacked = np.zeros((bucket(len(frames)),) + tuple(self.cfg.det_size) + (3,), np.uint8)
        for i, frame in enumerate(frames):
            stacked[i] = letterbox(frame[..., ::-1], self.cfg.det_size)[0]  # BGR -> RGB
        flat = engine.detect_align_embed_flat(stacked, det_threshold=self.det_thresh)
        return self._faces_from_fused_flat(flat, len(frames), max_num)
