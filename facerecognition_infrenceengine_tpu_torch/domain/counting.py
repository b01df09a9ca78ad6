"""Counting-side frame processing and camera stream runtime.

Re-implements the reference's counting ``CameraProcessor`` and
``CameraStreamManager`` (reference peopleCount.py:822-1013): thresholds
rec>=0.45 / definitely-unknown<0.35, frame_skip=2, 10-consecutive-error
camera auto-stop, periodic stale-detection cleanup.  Recognition runs as
one gallery top-1 for all faces of a frame (K1 or K2 on the card), and
frames can flow through the shared MicroBatcher so N cameras feed one
device call.

The port's copy of ``facerecognition_infrenceengine_tpu/domain/counting.py``.
Each camera thread binds to the card of its ``FaceAnalysis`` (or, when it
builds its own at its first frame, of the gallery) before it runs anything
there (``core.device.bind_thread``).
"""

from __future__ import annotations

import logging
import threading
import time

import numpy as np

from ..api.utils import get_current_utc
from ..core.config import Config, get_config
from ..core.device import bind_thread
from ..engine.gallery import GalleryManager
from .campus import CameraType, CampusPeopleManager

logger = logging.getLogger("fre.counting")


class CountingProcessor:
    """reference peopleCount.py:822-896 (CameraProcessor)."""

    def __init__(self, gallery: GalleryManager, manager: CampusPeopleManager,
                 face_app=None, cfg: Config | None = None):
        cfg = cfg or get_config()
        self.gallery = gallery
        self.manager = manager
        self.face_app = face_app
        self.recognition_threshold = cfg.thresholds.counting_recognition  # 0.45
        self.unknown_threshold = cfg.thresholds.definitely_unknown  # 0.35

    def _ensure_app(self):
        if self.face_app is None:
            from ..models.zoo import FaceAnalysis

            self.face_app = FaceAnalysis()
            self.face_app.prepare(ctx_id=0)
        return self.face_app

    def process_faces(self, faces, camera_id: str) -> dict:
        """Fold detected faces into the campus state machine."""
        stats = {"faces": len(faces), "recognized": 0, "unknown": 0}
        if not faces:
            return stats
        # empty-gallery guard (peopleCount.py:850-855): every face would
        # score -1.0 and flood the unknown-person clusters otherwise —
        # here, not just in process_frame, so the micro-batcher path is
        # covered too
        if self.gallery.is_empty():  # O(1), not a full get_stats() rollup
            return stats
        timestamp = get_current_utc()
        embs = np.stack([f.normed_embedding for f in faces])
        embs = embs / np.maximum(np.linalg.norm(embs, axis=1, keepdims=True), 1e-12)
        # counting matches against the WHOLE gallery (peopleCount.py:848 get_all)
        scores, ids, metadata = self.gallery.match(embs, company_id=None)
        for face, score_row, id_row, emb in zip(faces, scores, ids, embs):
            best_score = float(score_row[0])
            best_id = id_row[0]
            if best_id is not None and best_score >= self.recognition_threshold:
                self.manager.process_detection(
                    best_id, metadata[best_id], camera_id, timestamp, best_score)
                stats["recognized"] += 1
            elif best_score < self.unknown_threshold:
                self.manager.process_unknown_detection(
                    camera_id, timestamp, emb,
                    [int(v) for v in face.bbox])
                stats["unknown"] += 1
            # scores in [0.35, 0.45): ambiguous — neither counted nor
            # clustered, mirroring the reference's dead zone
        return stats

    def process_frame(self, frame: np.ndarray, camera_id: str) -> dict:
        app = self._ensure_app()
        faces = app.get(frame)
        return self.process_faces(faces, camera_id)


class CameraStreamManager:
    """reference peopleCount.py:899-1013."""

    def __init__(self, gallery: GalleryManager, manager: CampusPeopleManager,
                 face_app=None, cfg: Config | None = None, batcher=None):
        self.cfg = cfg or get_config()
        self.gallery = gallery
        self.manager = manager
        self.face_app = face_app
        self.batcher = batcher  # optional shared MicroBatcher
        self.running = False
        self.camera_threads: dict = {}

    def start_camera(self, camera_id: str, video_source, campus_id: str,
                     camera_type: CameraType, name: str | None = None):
        if camera_id in self.camera_threads:
            logger.warning("Camera %s already running", camera_id)
            return
        self.manager.register_camera(camera_id, campus_id, camera_type, name)
        self.running = True
        thread = threading.Thread(
            target=self._process_camera,
            args=(camera_id, video_source, camera_type), daemon=True)
        thread.start()
        self.camera_threads[camera_id] = thread

    def _process_camera(self, camera_id, video_source, camera_type):
        import cv2

        bind_thread(getattr(self.face_app, "device", None)
                    or getattr(self.gallery, "device", None))
        processor = CountingProcessor(self.gallery, self.manager,
                                      face_app=self.face_app, cfg=self.cfg)
        cap = cv2.VideoCapture(video_source)
        if not cap.isOpened():
            logger.error("Failed to open camera %s: %s", camera_id, video_source)
            return
        frame_skip = self.cfg.campus.frame_skip
        max_errors = self.cfg.campus.max_camera_errors
        frame_count = 0
        consecutive_errors = 0
        last_cleanup = time.time()
        while self.running:
            try:
                ret, frame = cap.read()
                if not ret:
                    consecutive_errors += 1
                    if consecutive_errors >= max_errors:
                        logger.error("Too many errors on %s, stopping", camera_id)
                        break
                    time.sleep(1)
                    continue
                consecutive_errors = 0
                frame_count += 1
                if frame_count % frame_skip != 0:
                    continue
                if self.batcher is not None:
                    faces = self.batcher.submit(camera_id, frame).result()
                    processor.process_faces(faces, camera_id)
                else:
                    processor.process_frame(frame, camera_id)
                now = time.time()
                if now - last_cleanup >= 10:
                    self.manager.cleanup_stale_detections()
                    last_cleanup = now
            except Exception as e:
                logger.error("Camera loop error on %s: %s", camera_id, e)
                consecutive_errors += 1
                if consecutive_errors >= max_errors:
                    break
                time.sleep(1)
        cap.release()
        logger.info("Stopped camera: %s", camera_id)

    def stop_all(self):
        self.running = False
        for camera_id, thread in self.camera_threads.items():
            thread.join(timeout=5)
        self.camera_threads.clear()
