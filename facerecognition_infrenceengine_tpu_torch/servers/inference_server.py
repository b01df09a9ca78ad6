"""Live recognition server (the reference's ``infrenceServer.py``), on the
card: the port's copy of
``facerecognition_infrenceengine_tpu/servers/inference_server.py``.

Control API (reference infrenceServer.py:685-724): /api/embeddings/stats,
/api/embeddings/sync, /api/camera/start, /api/camera/stop; SIGINT/SIGTERM
drain (:726-731).  The data plane is the camera manager + micro-batcher;
the reference's hardcoded camera list and company id (:742-744) become CLI
flags.

The engine runs on ``cuda``: ``CameraManager`` builds
``FaceAnalysis(cfg=get_config().engine)`` at the first ``/api/camera/start``
and the gallery's snapshots live on the card.

Run: python -m facerecognition_infrenceengine_tpu_torch.servers.inference_server
"""

from __future__ import annotations

import argparse
import signal
import sys

from ..core.config import get_config
from ..core.logging import setup_logging
from ..domain.cameras import CameraManager
from ..engine.gallery import GalleryManager
from ..store.client import get_datastore
from ..store.indexes import init_db
from ..web import App, Response, jsonify, request
from . import dashboard_page


def build_app(gallery: GalleryManager, camera_manager: CameraManager) -> App:
    app = App("inference-server")
    app.enable_cors()  # reference infrenceServer.py:34 CORS(app)

    @app.route("/", methods=["GET"])
    def dashboard():
        # ops dashboard over the control API below (the reference offers
        # only curl against :685-724; this is the same data, self-served)
        return Response(dashboard_page("inference.html"), 200,
                        mimetype="text/html; charset=utf-8")

    @app.route("/api/embeddings/stats", methods=["GET"])
    def get_embedding_stats():
        return jsonify(gallery.get_stats())

    @app.route("/api/embeddings/sync", methods=["POST"])
    def force_sync():
        try:
            gallery.force_sync()
            return jsonify({"status": "success", "message": "Sync completed"})
        except Exception as e:
            return jsonify({"status": "error", "message": str(e)}), 500

    @app.route("/api/camera/start", methods=["POST"])
    def start_camera():
        data = request.get_json(silent=True) or {}
        sources = data.get("sources", [0])
        company_id = data.get("company_id")
        if not company_id:
            return jsonify({"status": "error", "message": "Company ID required"}), 400
        try:
            camera_manager.start_cameras(sources, company_id)
            return jsonify({"status": "success", "message": "Camera started"})
        except Exception as e:
            return jsonify({"status": "error", "message": str(e)}), 500

    @app.route("/api/camera/stop", methods=["POST"])
    def stop_camera():
        try:
            camera_manager.stop_cameras()
            return jsonify({"status": "success", "message": "Camera stopped"})
        except Exception as e:
            return jsonify({"status": "error", "message": str(e)}), 500

    # ---- observability (SURVEY.md §5.1/§5.5; the reference has none) ----
    from ..core import metrics

    @app.route("/api/engine/recalibrate-int8", methods=["POST"])
    def recalibrate_int8():
        """Recalibrate the opt-in int8 embedder's activation scales from
        REAL aligned face crops (multipart images, any field names).

        The build-time calibration is deterministic structured synthetic
        data (engine/pipeline.py _calibration_crops); with converted
        production weights, operators should re-derive scales from a
        handful of real enrollment crops — this route is that hook,
        exposed operationally (engine.recalibrate_int8)."""
        import numpy as np

        from .. import native

        face_app = camera_manager.face_app
        engine = getattr(face_app, "_engine", None) if face_app else None
        if engine is None:
            return jsonify({"status": "error",
                            "message": "engine not initialized yet "
                                       "(start cameras first)"}), 503
        crops = []
        size = engine.cfg.embed_size
        try:
            for key in request.files:
                for f in request.files.getlist(key):
                    img = native.decode_image(f.read())
                    if img.shape[:2] != (size, size):
                        img = native.resize_bilinear(img, size, size)
                    crops.append(img)
        except Exception as e:
            return jsonify({"status": "error",
                            "message": f"bad crop image: {e}"}), 400
        if not crops:
            return jsonify({"status": "error",
                            "message": "no crop images supplied"}), 400
        try:
            engine.recalibrate_int8(np.stack(crops))
        except ValueError as e:  # engine built without embed_int8
            return jsonify({"status": "error", "message": str(e)}), 400
        return jsonify({"status": "success", "crops": len(crops),
                        "calibration": getattr(engine, "_int8_calibration",
                                               None)})

    @app.route("/api/metrics", methods=["GET"])
    def get_metrics():
        return jsonify(metrics.snapshot())

    @app.route("/api/profiler/start", methods=["POST"])
    def profiler_start():
        data = request.get_json(silent=True) or {}
        logdir = data.get("logdir", "/tmp/fre_profile")
        if metrics.start_device_trace(logdir):
            return jsonify({"status": "success", "logdir": logdir})
        return jsonify({"status": "error", "message": "trace already active"}), 409

    @app.route("/api/profiler/stop", methods=["POST"])
    def profiler_stop():
        logdir = metrics.stop_device_trace()
        if logdir is None:
            return jsonify({"status": "error", "message": "no active trace"}), 409
        return jsonify({"status": "success", "logdir": logdir})

    return app


def main(argv=None):
    parser = argparse.ArgumentParser(description="face recognition server (CUDA)")
    parser.add_argument("--host", default="0.0.0.0")
    parser.add_argument("--port", type=int, default=5002)
    parser.add_argument("--company-id", default=None)
    parser.add_argument("--sources", nargs="*", default=[],
                        help="camera indices or RTSP URLs")
    parser.add_argument("--display", action="store_true")
    args = parser.parse_args(argv)

    logger = setup_logging("fre.inference", logfile="face_recognition.log")
    cfg = get_config()
    ds = get_datastore(cfg)
    init_db(ds)

    gallery = GalleryManager(ds, cfg, sync_interval_s=cfg.sync.inference_sync_s)
    gallery.start_sync()
    camera_manager = CameraManager(gallery, cfg=cfg, display=args.display)

    def shutdown(signum, frame):
        logger.info("Shutting down gracefully...")
        camera_manager.stop_cameras()
        gallery.stop_sync()
        sys.exit(0)

    signal.signal(signal.SIGINT, shutdown)
    signal.signal(signal.SIGTERM, shutdown)

    if args.sources and args.company_id:
        sources = [int(s) if s.isdigit() else s for s in args.sources]
        camera_manager.start_cameras(sources, args.company_id)

    app = build_app(gallery, camera_manager)
    logger.info("Inference control API on %s:%d", args.host, args.port)
    app.run(args.host, args.port)


if __name__ == "__main__":
    main()
