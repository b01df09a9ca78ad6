"""Campus entry/exit counting server (the reference's ``peopleCount.py``).

Read-only status API (reference peopleCount.py:1044-1211): /api/status,
/api/campus/<id>/status, /api/person/<id>, /api/campus/<id>/events,
/api/campus/<id>/people, /api/campus/<id>/analytics, /api/campus/<id>/unknown,
/api/analytics/summary — plus the 60 s status banner (:1227-1271) and
graceful shutdown (:1214-1224).  Camera wiring comes from a JSON config file
or flags instead of the reference's hardcoded ``__main__`` list (:1283-1306).

On the card: the port's copy of
``facerecognition_infrenceengine_tpu/servers/people_count.py``.  The gallery
lives on ``cuda``; each camera thread builds its ``FaceAnalysis`` there at
its first frame.

Run: python -m facerecognition_infrenceengine_tpu_torch.servers.people_count
"""

from __future__ import annotations

import argparse
import json
import signal
import sys
import threading
import time
from datetime import timedelta

from ..api.utils import get_current_utc
from ..core.config import get_config
from ..core.logging import setup_logging
from ..domain.campus import CameraType, CampusPeopleManager
from ..domain.counting import CameraStreamManager
from ..engine.gallery import GalleryManager
from ..store.client import get_datastore
from ..store.indexes import init_db
from ..web import App, Response, jsonify, request
from . import dashboard_page


def build_app(people_manager: CampusPeopleManager) -> App:
    app = App("people-count")
    app.enable_cors()  # reference peopleCount.py:33,1018 CORS(app)
    ds = people_manager.ds

    @app.route("/", methods=["GET"])
    def dashboard():
        # web form of the reference's stdout status banner
        # (peopleCount.py:1227-1271), polling the read-only API below
        return Response(dashboard_page("campus.html"), 200,
                        mimetype="text/html; charset=utf-8")

    @app.route("/api/status", methods=["GET"])
    def get_overall_status():
        # reference peopleCount.py:1044-1067
        try:
            all_campuses = people_manager.get_campus_status()
            return jsonify({
                "success": True,
                "data": {
                    "total_inside": sum(c["current_inside"]
                                        for c in all_campuses.values()),
                    "total_entries_today": sum(c["total_entries_today"]
                                               for c in all_campuses.values()),
                    "total_exits_today": sum(c["total_exits_today"]
                                             for c in all_campuses.values()),
                    "campuses": all_campuses,
                    "timestamp": get_current_utc().isoformat(),
                },
            })
        except Exception as e:
            return jsonify({"success": False, "error": str(e)}), 500

    @app.route("/api/campus/<campus_id>/status", methods=["GET"])
    def get_campus_status(campus_id):
        try:
            return jsonify({"success": True,
                            "data": people_manager.get_campus_status(campus_id)})
        except Exception as e:
            return jsonify({"success": False, "error": str(e)}), 500

    @app.route("/api/person/<person_id>", methods=["GET"])
    def get_person(person_id):
        status = people_manager.get_person_status(person_id)
        if status:
            return jsonify({"success": True, "data": status})
        return jsonify({"success": False, "error": "Person not found"}), 404

    @app.route("/api/campus/<campus_id>/events", methods=["GET"])
    def get_campus_events(campus_id):
        try:
            try:
                # clamp: an unbounded limit would dump the whole events
                # collection in one response
                limit = min(max(int(request.args.get("limit", 50)), 1), 1000)
            except ValueError:
                return jsonify({"success": False,
                                "error": "limit must be an integer"}), 400
            query = {"campus_id": campus_id}
            if request.args.get("type"):
                query["event_type"] = request.args["type"]
            events = list(ds.campus_events.find(query)
                          .sort("timestamp", -1).limit(limit))
            for event in events:
                event["_id"] = str(event["_id"])
            return jsonify({"success": True, "data": events,
                            "count": len(events)})
        except Exception as e:
            return jsonify({"success": False, "error": str(e)}), 500

    @app.route("/api/campus/<campus_id>/people", methods=["GET"])
    def get_campus_people(campus_id):
        try:
            status_filter = request.args.get("status", "inside")
            query = {"campus_id": campus_id}
            if status_filter != "all":
                query["status"] = status_filter
            people = list(ds.people_status.find(query))
            for person in people:
                person["_id"] = str(person["_id"])
            return jsonify({"success": True, "data": people,
                            "count": len(people)})
        except Exception as e:
            return jsonify({"success": False, "error": str(e)}), 500

    @app.route("/api/campus/<campus_id>/analytics", methods=["GET"])
    def get_campus_analytics(campus_id):
        try:
            try:
                days = min(max(int(request.args.get("days", 7)), 1), 3650)
            except ValueError:
                return jsonify({"success": False,
                                "error": "days must be an integer"}), 400
            start = get_current_utc() - timedelta(days=days)
            analytics = list(ds.campus_analytics.find({
                "campus_id": campus_id, "date": {"$gte": start}
            }).sort("date", -1))
            for record in analytics:
                record["_id"] = str(record["_id"])
            return jsonify({"success": True, "data": analytics,
                            "count": len(analytics)})
        except Exception as e:
            return jsonify({"success": False, "error": str(e)}), 500

    @app.route("/api/campus/<campus_id>/unknown", methods=["GET"])
    def get_unknown_detections(campus_id):
        try:
            with people_manager.state_lock:
                result = [u.to_dict() for u in
                          people_manager.unknown_people.get(campus_id, {}).values()]
            result.sort(key=lambda x: x["detection_count"], reverse=True)
            return jsonify({
                "success": True, "data": result,
                "total_unique": len(result),
                "total_detections": sum(u["detection_count"] for u in result),
            })
        except Exception as e:
            return jsonify({"success": False, "error": str(e)}), 500

    @app.route("/api/analytics/summary", methods=["GET"])
    def get_analytics_summary():
        try:
            all_campuses = people_manager.get_campus_status()
            summary = {
                "total_campuses": len(all_campuses),
                "total_inside": sum(c["current_inside"]
                                    for c in all_campuses.values()),
                "total_employees_inside": sum(c["employees_inside"]
                                              for c in all_campuses.values()),
                "total_visitors_inside": sum(c["visitors_inside"]
                                             for c in all_campuses.values()),
                "total_entries_today": sum(c["total_entries_today"]
                                           for c in all_campuses.values()),
                "total_exits_today": sum(c["total_exits_today"]
                                         for c in all_campuses.values()),
                "total_unknown_today": sum(c["unknown_detections_today"]
                                           for c in all_campuses.values()),
                "campus_breakdown": all_campuses,
                "timestamp": get_current_utc().isoformat(),
            }
            return jsonify({"success": True, "data": summary})
        except Exception as e:
            return jsonify({"success": False, "error": str(e)}), 500

    from ..core import metrics

    @app.route("/api/metrics", methods=["GET"])
    def get_metrics():
        return jsonify(metrics.snapshot())

    return app


def status_banner_loop(people_manager, interval_s: float, stop_event):
    """reference peopleCount.py:1227-1271."""
    import logging

    logger = logging.getLogger("fre.peoplecount")
    while not stop_event.wait(interval_s):
        for campus_id, stats in people_manager.get_campus_status().items():
            logger.info("%s | inside=%d entries=%d exits=%d unknown=%d",
                        campus_id, stats["current_inside"],
                        stats["total_entries_today"],
                        stats["total_exits_today"],
                        stats["unknown_detections_today"])


def main(argv=None):
    parser = argparse.ArgumentParser(description="Campus people counting server")
    parser.add_argument("--host", default="0.0.0.0")
    parser.add_argument("--port", type=int, default=5003)
    parser.add_argument("--cameras", default=None,
                        help="JSON file: [{camera_id, source, campus_id, type, name}]")
    args = parser.parse_args(argv)

    logger = setup_logging("fre.peoplecount", logfile="campus_management.log")
    cfg = get_config()
    ds = get_datastore(cfg)
    init_db(ds)

    gallery = GalleryManager(ds, cfg, sync_interval_s=cfg.sync.counting_sync_s)
    gallery.start_sync()
    people_manager = CampusPeopleManager(ds, cfg, start_background=True)
    camera_manager = CameraStreamManager(gallery, people_manager, cfg=cfg)

    stop_event = threading.Event()
    banner = threading.Thread(
        target=status_banner_loop,
        args=(people_manager, 60.0, stop_event), daemon=True)
    banner.start()

    def shutdown(signum, frame):
        logger.info("Shutdown signal received")
        stop_event.set()
        camera_manager.stop_all()
        people_manager.stop()
        gallery.stop_sync()
        sys.exit(0)

    signal.signal(signal.SIGINT, shutdown)
    signal.signal(signal.SIGTERM, shutdown)

    if args.cameras:
        with open(args.cameras) as f:
            for cam in json.load(f):
                source = cam["source"]
                if isinstance(source, str) and source.isdigit():
                    source = int(source)
                camera_manager.start_camera(
                    cam["camera_id"], source, cam["campus_id"],
                    CameraType(cam.get("type", "entry")), cam.get("name"))

    app = build_app(people_manager)
    logger.info("People-count API on %s:%d", args.host, args.port)
    app.run(args.host, args.port)


if __name__ == "__main__":
    main()
