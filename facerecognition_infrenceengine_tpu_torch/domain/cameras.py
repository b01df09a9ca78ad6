"""Live-recognition camera runtime (the inference server's data plane).

The port's copy of ``facerecognition_infrenceengine_tpu/domain/cameras.py``.
The upstream service spawns one capture process + one recognition process
per camera with mp.Queues (reference infrenceServer.py:565-679).  Here one
process owns the card and cameras are capture threads feeding the shared
MicroBatcher, so N streams batch into one device call.  Capture settings
(640x480@30, buffer 1) and drop-on-full semantics are preserved
(infrenceServer.py:581-584, :594-598); display (cv2.imshow) is optional and
off by default for headless serving, which needs no OpenCV beyond
``cv2.VideoCapture``.

Capture is **free-running**: the capture thread never waits on recognition
(the reference keeps capture unblocked and drops stale frames,
infrenceServer.py:594-598).  Each submitted frame carries a completion
callback; the micro-batcher drops the oldest queued frame per source when a
newer one arrives, and completed recognitions flow through a bounded
results stage (match + HUD + on_result) that likewise drops oldest under
load — so every stage stays live at camera rate even when the device or the
consumer is slower than the cameras.

Four kinds of thread touch the card, all on one device: the capture threads
(the yuv420 encode and, with ``upload_on_submit``, the upload), the
batcher's dispatch and resolver threads, and the results thread (the
gallery's top-1 kernel).
"""

from __future__ import annotations

import functools
import logging
import threading
from collections import deque
from typing import Callable, Dict, List

from ..core import metrics
from ..core.config import Config, get_config
from ..core.device import bind_thread
from ..engine.gallery import GalleryManager
from ..engine.microbatch import MicroBatcher
from ..engine.recognizer import FaceRecognitionProcessor

logger = logging.getLogger("fre.cameras")

_RESULTS_DEPTH = 64  # bounded post-recognition stage; drops oldest on overflow


class CameraManager:
    def __init__(self, gallery: GalleryManager, face_app=None,
                 cfg: Config | None = None, display: bool = False,
                 on_result: Callable | None = None):
        self.cfg = cfg or get_config()
        self.gallery = gallery
        self.face_app = face_app
        self.display = display
        self.on_result = on_result  # callback(source, frame, results)
        self.running = False
        self.threads: List[threading.Thread] = []
        self.batcher: MicroBatcher | None = None
        self.processor: FaceRecognitionProcessor | None = None
        self._results: deque = deque()
        self._results_lock = threading.Lock()
        self._results_event = threading.Event()
        self._results_thread: threading.Thread | None = None
        self.stats: Dict[str, int] = {"frames_captured": 0, "results": 0,
                                      "results_dropped": 0}
        self._generation = 0  # bumped by stop_cameras(); see _capture_loop

    def _ensure_runtime(self):
        if self.face_app is None:
            from ..models.zoo import FaceAnalysis

            self.face_app = FaceAnalysis(cfg=self.cfg.engine)
            self.face_app.prepare(ctx_id=0,
                                  det_thresh=self.cfg.thresholds.detection)
        if self.batcher is None:
            self.batcher = MicroBatcher(self.face_app, self.cfg.engine)
            self.batcher.start()
        if self.processor is None:
            self.processor = FaceRecognitionProcessor(
                self.gallery, face_app=self.face_app, cfg=self.cfg)

    # ------------------------------------------------------------- capture
    def _capture_loop(self, source, company_id: str):
        import cv2

        # generation token: a thread that outlives its stop_cameras() call
        # (cap.read() blocked past the join timeout on a stalled RTSP
        # source) must exit on wake instead of dereferencing the nulled
        # batcher — or, after a restart, running as a DUPLICATE capture
        # loop for the same source
        generation = self._generation
        batcher = self.batcher
        cap = cv2.VideoCapture(source)
        if not cap.isOpened():
            logger.error("Failed to open camera %s", source)
            return
        cap.set(cv2.CAP_PROP_FRAME_WIDTH, 640)
        cap.set(cv2.CAP_PROP_FRAME_HEIGHT, 480)
        cap.set(cv2.CAP_PROP_FPS, 30)
        cap.set(cv2.CAP_PROP_BUFFERSIZE, 1)
        logger.info("Camera %s initialized", source)
        while self.running and generation == self._generation:
            ret, frame = cap.read()
            if not ret:
                continue
            if generation != self._generation or batcher is None:
                break  # stopped while blocked in cap.read()
            self.stats["frames_captured"] += 1
            # Free-running: submit and immediately read the next frame. The
            # batcher's per-source slot drops the oldest undispatched frame
            # if recognition lags (reference drop semantics); completion is
            # handled asynchronously by the results stage.  When the face
            # app exposes a wire-format encoder (yuv420 transport), it runs
            # here on the capture thread via the prepare hook — parallel
            # across cameras, admitted frames only.
            app = batcher.face_app  # local ref: stop() nulls self.batcher
            prep = (app.encode_frame
                    if getattr(getattr(app, "cfg", None), "stream_transport",
                               "rgb") != "rgb" else None)
            future = batcher.submit(source, frame, prepare=prep)
            future.add_done_callback(
                functools.partial(self._enqueue_result, source, company_id,
                                  frame))
        cap.release()
        logger.info("Camera %s released", source)

    # ------------------------------------------------------------- results
    def _enqueue_result(self, source, company_id, frame, future):
        """Runs on the batcher's resolver thread — must stay cheap."""
        if getattr(future, "dropped", False):
            return  # stale frame superseded by a newer capture
        exc = future.exception()
        if exc is not None:
            logger.error("Recognition error on %s: %s", source, exc)
            return
        with self._results_lock:
            if len(self._results) >= _RESULTS_DEPTH:
                self._results.popleft()
                self.stats["results_dropped"] += 1
                metrics.counter("cameras.results_dropped").inc()
            self._results.append((source, company_id, frame, future.result()))
        self._results_event.set()

    def _results_loop(self):
        """Match + HUD + consumer callback, decoupled from capture/dispatch."""
        bind_thread(getattr(self.gallery, "device", None))
        while True:
            self._results_event.wait(timeout=0.1)
            self._results_event.clear()
            while True:
                with self._results_lock:
                    if not self._results:
                        break
                    source, company_id, frame, faces = self._results.popleft()
                # rasterizing the HUD costs real CPU per face — skip it
                # when nobody will see the frame (headless serving via
                # /api/camera/start runs with display=False, on_result=None)
                want_frame = self.display or self.on_result is not None
                _, results = self.processor.match_faces(
                    frame, faces, company_id, draw=want_frame)
                self.stats["results"] += 1
                if self.on_result:
                    self.on_result(source, frame, results)
                if self.display:
                    import cv2

                    cv2.imshow(f"Camera {source}", frame)
                    if cv2.waitKey(1) & 0xFF == ord("q"):
                        self.running = False
            if not self.running:
                with self._results_lock:
                    drained = not self._results
                if drained:
                    break

    # -------------------------------------------------------------- control
    def start_cameras(self, sources: list, company_id: str):
        self._ensure_runtime()
        self.running = True
        self._results_thread = threading.Thread(target=self._results_loop,
                                                daemon=True)
        self._results_thread.start()
        for source in sources:
            t = threading.Thread(target=self._capture_loop,
                                 args=(source, company_id), daemon=True)
            t.start()
            self.threads.append(t)

    def stop_cameras(self):
        self.running = False
        self._generation += 1  # invalidates zombie capture loops
        for t in self.threads:
            t.join(timeout=5)
        self.threads.clear()
        if self.batcher:
            self.batcher.stop()
            self.batcher = None
        if self._results_thread:
            self._results_event.set()
            self._results_thread.join(timeout=5)
            self._results_thread = None
