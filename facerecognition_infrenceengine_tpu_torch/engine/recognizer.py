"""The recognition decision: detected faces + gallery -> identities.

The torch form of ``facerecognition_infrenceengine_tpu/engine/recognizer.py``
``FaceRecognitionProcessor`` without the HUD: the reference draws it with its
native rasterizer, which is ROADMAP Queue 1 item 8 for the port.
"""

from __future__ import annotations

import numpy as np

from ..core.config import Config
from ..models.zoo import FaceAnalysis
from .gallery import GalleryManager


class FaceRecognitionProcessor:
    def __init__(self, gallery: GalleryManager, face_app=None, cfg: Config | None = None):
        cfg = cfg or Config()
        self.gallery = gallery
        self.face_app = face_app
        self.detection_threshold = cfg.thresholds.detection
        self.recognition_threshold = cfg.thresholds.recognition

    def _ensure_app(self):
        if self.face_app is None:
            self.face_app = FaceAnalysis()
            self.face_app.prepare(ctx_id=0, det_thresh=self.detection_threshold)
        return self.face_app

    def recognize_faces(self, frame: np.ndarray, company_id: str, draw: bool = False):
        """Detect + match all faces of one BGR frame -> (frame, results)."""
        faces = self._ensure_app().get(frame)
        return self.match_faces(frame, faces, company_id, draw=draw)

    def match_faces(self, frame: np.ndarray, faces: list, company_id: str,
                    draw: bool = False):
        """Match detected faces against the gallery: the threshold decision.

        Returns (frame, results), one dict per face with bbox, det_score,
        person_id, person_info, similarity and the ``recognized`` flag.
        """
        if draw:
            raise NotImplementedError(
                "HUD drawing is not ported (ROADMAP Queue 1 item 8); use draw=False")
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
            person_info = (metadata[best_id] if matched
                           else {"name": "Unknown", "type": "unknown"})
            results.append({
                "bbox": face.bbox.astype(int).tolist(),
                "det_score": face.det_score,
                "person_id": best_id if matched else None,
                "person_info": person_info,
                "similarity": best_score,
                "recognized": matched,
            })
        return frame, results
