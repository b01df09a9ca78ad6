"""The recognition decision and its HUD: detected faces + gallery ->
identities, drawn onto the frame.

The torch form of ``facerecognition_infrenceengine_tpu/engine/recognizer.py``
``FaceRecognitionProcessor``: all faces of a frame are matched against the
company gallery in one top-1 call, then each gets the HUD overlay (a
translucent box, bracketed corners, vertical detection / recognition
confidence bars and an info panel) drawn by the host codec's rasterizer
(``native``) in place.
"""

from __future__ import annotations

import numpy as np

from .. import native
from ..core.config import Config, get_config
from ..models.zoo import FaceAnalysis
from .gallery import GalleryManager

GREEN = (0, 255, 0)
YELLOW = (0, 255, 255)
RED = (0, 0, 255)


def draw_enhanced_bounding_box(frame, bbox, color, person_info, detection_score,
                               recognition_score):
    """Draw one face's HUD onto ``frame`` (made C-contiguous) -> the frame."""
    frame = np.ascontiguousarray(frame)
    h, w = frame.shape[:2]
    x1, y1, x2, y2 = (int(v) for v in bbox)

    # translucent body and bracketed corners
    native.fill_rect(frame, y1, x1, y2, x2, color, alpha=0.15)
    native.draw_rect(frame, y1, x1, y2, x2, color, thick=1)
    native.draw_corners(frame, y1, x1, y2, x2, color, length=15, thick=3)

    # vertical detection (D) and recognition (R) confidence bars
    bar_x, bar_w = x2 + 10, 6
    det_h = int((y2 - y1) * min(float(detection_score), 1.0))
    native.draw_rect(frame, y1, bar_x, y2, bar_x + bar_w, (100, 100, 100), 1)
    native.fill_rect(frame, y2 - det_h, bar_x, y2, bar_x + bar_w, (255, 140, 0))
    native.draw_text(frame, max(0, y1 - 10), max(0, bar_x - 2), "D", (255, 255, 255))
    rec_h = int((y2 - y1) * min(float(recognition_score), 1.0))
    native.draw_rect(frame, y1, bar_x + 12, y2, bar_x + 12 + bar_w, (100, 100, 100), 1)
    native.fill_rect(frame, y2 - rec_h, bar_x + 12, y2, bar_x + 12 + bar_w, color)
    native.draw_text(frame, max(0, y1 - 10), bar_x + 10, "R", (255, 255, 255))

    # info panel below the box, or above it where the frame ends
    if person_info["type"] == "employee":
        info_lines = [f"Name: {person_info['name']}", f"ID: {person_info['employeeId']}",
                      "Type: Employee", f"Score: {recognition_score:.2f}"]
    elif person_info["type"] == "visitor":
        info_lines = [f"Name: {person_info['name']}", "Type: Visitor",
                      f"Score: {recognition_score:.2f}"]
    else:
        info_lines = ["Unknown Person", f"Detection: {detection_score:.2f}"]
    char_w = 6  # 5x7 font + 1 px spacing at scale 1
    panel_w = max(len(line) for line in info_lines) * char_w + 20
    panel_h = len(info_lines) * 12 + 10
    panel_x = max(0, min(x1, w - panel_w))
    panel_y = max(0, y2 + 10)
    if panel_y + panel_h > h:
        panel_y = max(0, y1 - panel_h - 10)
    native.fill_rect(frame, panel_y, panel_x, panel_y + panel_h, panel_x + panel_w,
                     (30, 30, 30), alpha=0.8)
    native.draw_rect(frame, panel_y, panel_x, panel_y + panel_h, panel_x + panel_w, color, 1)
    for i, line in enumerate(info_lines):
        native.draw_text(frame, panel_y + 6 + i * 12, panel_x + 10, line, (255, 255, 255))
    return frame


class FaceRecognitionProcessor:
    def __init__(self, gallery: GalleryManager, face_app=None, cfg: Config | None = None):
        cfg = cfg or get_config()
        self.gallery = gallery
        self.face_app = face_app
        self.detection_threshold = cfg.thresholds.detection
        self.recognition_threshold = cfg.thresholds.recognition

    def _ensure_app(self):
        if self.face_app is None:
            self.face_app = FaceAnalysis()
            self.face_app.prepare(ctx_id=0, det_thresh=self.detection_threshold)
        return self.face_app

    def recognize_faces(self, frame: np.ndarray, company_id: str, draw: bool = True):
        """Detect + match all faces of one BGR frame, drawing the HUD unless
        ``draw`` is False -> (frame, results)."""
        faces = self._ensure_app().get(frame)
        return self.match_faces(frame, faces, company_id, draw=draw)

    def match_faces(self, frame: np.ndarray, faces: list, company_id: str,
                    draw: bool = True):
        """Match detected faces against the gallery: the threshold decision,
        and the HUD drawn for each face when ``draw``.

        Returns (frame, results), one dict per face with bbox, det_score,
        person_id, person_info, similarity and the ``recognized`` flag.
        """
        results = []
        if not faces:
            return frame, results
        embs = np.stack([f.normed_embedding for f in faces])
        embs = embs / np.maximum(np.linalg.norm(embs, axis=1, keepdims=True), 1e-12)
        scores, ids, metadata = self.gallery.match(embs, company_id=company_id)
        for face, score_row, id_row in zip(faces, scores, ids):
            best_score = float(score_row[0])
            best_id = id_row[0]
            # an explicit flag: a legitimate 0.0 score at threshold <= 0 matches
            matched = best_id is not None and best_score >= self.recognition_threshold
            if matched:
                person_info = metadata[best_id]
                color = GREEN if person_info["type"] == "employee" else YELLOW
            else:
                person_info = {"name": "Unknown", "type": "unknown"}
                color = RED
            results.append({
                "bbox": face.bbox.astype(int).tolist(),
                "det_score": face.det_score,
                "person_id": best_id if matched else None,
                "person_info": person_info,
                "similarity": best_score,
                "recognized": matched,
            })
            if draw:
                frame = draw_enhanced_bounding_box(frame, face.bbox.astype(int), color,
                                                   person_info, face.det_score,
                                                   best_score if matched else 0.0)
        return frame, results
