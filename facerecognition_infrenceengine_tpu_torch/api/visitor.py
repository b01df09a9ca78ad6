"""Visitor & visits REST API.

Same routes/JSON as the reference blueprint (reference app/api/visitor.py;
per-route citations inline): registration with 3 pose images + optional ID
documents, visit scheduling with overlap check and pass PNG generation,
check-in/check-out state machine, QR verification (actually decoding — the
reference's decode is broken by construction, visitor.py:1040-1052),
visit CRUD, host/area analytics, duplicate cleanup, embedding serving.

Deliberate bug fix vs reference: check-in/check-out/update/delete look up
visits by ``{'visitId': ...}`` though visits are keyed by ``_id``
(reference visitor.py:698,736,955,978 vs :634) — those lookups can never
match; we key by ``_id`` (accepting the hex string in the URL).

The port's copy of ``facerecognition_infrenceengine_tpu/api/visitor.py``.
"""

from __future__ import annotations

import re
from datetime import datetime, timedelta

from ..core.config import Config
from ..domain.passes import generate_visitor_pass, qr_decode
from ..store.client import Datastore
from ..store.objectid import ObjectId
from ..web import Blueprint, Response, jsonify, request
from .constants import POSES
from .docmodels import build_visit_doc, build_visitor_doc
from .embeddings import deserialize_embedding, store_embedding
from .utils import (
    error_response,
    format_datetime,
    get_current_utc,
    parse_datetime,
    validate_email_format,
    validate_phone_format,
    validate_required_fields,
)

ID_DOCUMENTS = ["pan_card", "aadhar_card", "driving_license", "passport"]


def validate_visitor_data(data: dict) -> list:
    """reference visitor.py:911-943."""
    errors = []
    if data.get("visitorType") and data["visitorType"] not in (
            "individual", "group", "contractor"):
        errors.append("Invalid visitor type. Must be one of: individual, group, contractor")
    if data.get("idType") and data["idType"] not in (
            "passport", "driving_license", "aadhar", "pan_card"):
        errors.append("Invalid ID type. Must be one of: passport, driving_license, aadhar, pan_card")
    if data.get("idType") and data.get("idNumber"):
        idn = data["idNumber"]
        if data["idType"] == "aadhar" and not re.fullmatch(r"\d{12}", idn):
            errors.append("Invalid Aadhar number format. Must be 12 digits")
        elif data["idType"] == "pan_card" and not re.fullmatch(r"[A-Z]{5}\d{4}[A-Z]", idn):
            errors.append("Invalid PAN card format")
        elif data["idType"] == "driving_license" and not re.fullmatch(
                r"[A-Z]{2}\d{2}\d{4}\d{7}", idn):
            errors.append("Invalid driving license format")
    if data.get("expectedArrival") and data.get("expectedDeparture"):
        try:
            arrival = parse_datetime(data["expectedArrival"])
            departure = parse_datetime(data["expectedDeparture"])
            if departure <= arrival:
                errors.append("Expected departure must be after expected arrival")
        except ValueError:
            errors.append("Invalid date format for expected arrival/departure")
    return errors


def _stringify_visit(visit: dict) -> dict:
    """ObjectIds -> str, datetimes -> ISO (reference visitor.py:661-672)."""
    out = {}
    for key, value in visit.items():
        if isinstance(value, ObjectId):
            out[key] = str(value)
        elif isinstance(value, list) and value and all(
                isinstance(v, ObjectId) for v in value):
            out[key] = [str(v) for v in value]
        elif isinstance(value, datetime):
            out[key] = format_datetime(value)
        else:
            out[key] = value
    return out


def make_visitor_bp(ds: Datastore, cfg: Config) -> Blueprint:
    bp = Blueprint("visitor")

    def find_visit(visit_id: str):
        """By _id (fixing the reference's visitId bug), tolerating bad hex."""
        if ObjectId.is_valid(visit_id):
            visit = ds.visits.find_one({"_id": ObjectId(visit_id)})
            if visit:
                return visit
        return ds.visits.find_one({"visitId": visit_id})

    def has_overlapping_visit(visitor_id, new_start, new_end,
                              exclude_visit_id=None) -> bool:
        # reference visitor.py:181-189; exclude_visit_id lets a reschedule
        # overlap the visit's own current window
        try:
            vid = ObjectId(str(visitor_id))
        except Exception:
            return False
        query = {
            "visitorId": vid,
            "status": {"$in": ["scheduled", "checked_in"]},
            "$or": [{"expectedArrival": {"$lt": new_end},
                     "expectedDeparture": {"$gt": new_start}}],
        }
        if exclude_visit_id is not None:
            query["_id"] = {"$ne": exclude_visit_id}
        return ds.visits.find_one(query) is not None

    # ------------------------------------------------------------ register
    @bp.route("/register", methods=["POST"])
    def register_visitor():
        # reference visitor.py:35-179
        try:
            required = ["companyId", "visitorName", "phone", "hostEmployeeId"]
            ok, msg = validate_required_fields(request.form, required)
            if not ok:
                return error_response(msg, 400)
            data = {f: request.form[f] for f in required}
            optional = ["visitorType", "idType", "idNumber", "email",
                        "organization", "purpose", "status", "blacklisted"]
            data.update({k: request.form[k] for k in optional if k in request.form})
            errors = validate_visitor_data(data)
            if errors:
                return error_response("\n".join(errors), 400)
            if not ObjectId.is_valid(data["companyId"]):
                return error_response("Invalid companyId format.", 400)

            host = None
            if ObjectId.is_valid(data["hostEmployeeId"]):
                host = ds.employee_info.find_one({
                    "_id": ObjectId(data["hostEmployeeId"]),
                    "companyId": ObjectId(data["companyId"]),
                    "status": "active", "blacklisted": False})
            if host is None:
                host = ds.employee_info.find_one({
                    "employeeId": data["hostEmployeeId"],
                    "companyId": ObjectId(data["companyId"]),
                    "status": "active", "blacklisted": False})
            if not host:
                return error_response("Host employee not found or not active.", 400)
            # normalize to the employee's _id so build_visitor_doc can store an
            # ObjectId ref even when the caller sent a business employeeId
            data["hostEmployeeId"] = str(host["_id"])

            if data.get("email") and not validate_email_format(data["email"]):
                return error_response("Invalid email format.", 400)
            if not validate_phone_format(data["phone"]):
                return error_response("Invalid phone number format.", 400)

            # Validate the attached embedding BEFORE any write (mirrors
            # employee register): a rejected blob must not leave orphaned
            # GridFS images, a visitor doc, and queued jobs behind a 400.
            embedding_attached = request.form.get(
                "embeddingAttached", "false").lower() == "true"
            embedding_version = request.form.get("embeddingVersion")
            emb_bytes = emb_filename = None
            if embedding_attached:
                if not embedding_version or "embedding" not in request.files:
                    return error_response(
                        "embeddingVersion and embedding file required when "
                        "embeddingAttached is true")
                if embedding_version not in cfg.api.allowed_models:
                    return error_response("Embedding model not allowed.", 400)
                emb_file = request.files.get("embedding")
                emb_bytes = emb_file.read()
                emb_filename = emb_file.filename
                try:
                    deserialize_embedding(emb_bytes)
                except Exception:
                    return error_response(
                        "Attached embedding is not a valid embedding vector.",
                        400)

            image_dict = {}
            for position in POSES:  # left/right/center all required (:78)
                if position not in request.files:
                    return error_response(
                        f"Visitor face image for {position} position is required.", 400)
                face = request.files.get(position)
                image_dict[position] = ds.visitor_images.put(
                    face.read(),
                    filename=f"{data['companyId']}_{position}_face.jpg",
                    metadata={"companyId": data["companyId"],
                              "type": f"face_image_{position}",
                              "timestamp": get_current_utc()})

            document_dict = {}
            for doc_type in ID_DOCUMENTS:
                if doc_type in request.files:
                    doc_file = request.files.get(doc_type)
                    document_dict[doc_type] = ds.visitor_images.put(
                        doc_file.read(),
                        filename=f"{data['companyId']}_{doc_type}.jpg",
                        metadata={"companyId": data["companyId"],
                                  "type": f"{doc_type}_image",
                                  "timestamp": get_current_utc()})

            visitor_doc = build_visitor_doc(data, image_dict, {}, document_dict)
            visitor_id = ds.visitors.insert_one(visitor_doc).inserted_id

            embeddings_dict = {}
            for model in cfg.api.allowed_models:
                if embedding_attached and model == embedding_version:
                    # the worker would recompute this model from the pose
                    # images and overwrite the client's attached 'done'
                    # entry — same skip the employee route performs
                    continue
                ds.embedding_jobs.insert_one({
                    "employeeId": ObjectId(str(host["_id"])),
                    "companyId": ObjectId(data["companyId"]),
                    "visitorId": visitor_id,
                    "model": model,
                    "status": "queued",
                    "createdAt": get_current_utc(),
                    "params": {},
                })
                embeddings_dict[model] = {"status": "queued",
                                          "queuedAt": get_current_utc()}

            if embedding_attached:
                emb_entry = store_embedding(
                    ds, emb_bytes, emb_filename,
                    {"companyId": data["companyId"],
                     "visitorId": str(visitor_id),
                     "model": embedding_version, "type": "embedding",
                     "timestamp": get_current_utc()},
                    embedding_version, bucket="visitor")
                emb_entry["status"] = "done"
                emb_entry["finishedAt"] = get_current_utc()
                embeddings_dict[embedding_version] = emb_entry

            ds.visitors.update_one({"_id": visitor_id},
                                   {"$set": {"visitorEmbeddings": embeddings_dict}})
            return jsonify({
                "message": "Visitor registration successful",
                "_id": str(visitor_id),
                "embeddingStatus": {k: v.get("status", "unknown")
                                    for k, v in embeddings_dict.items()},
            }), 201
        except Exception as e:
            return error_response(str(e), 500)

    # ------------------------------------------------------ schedule visit
    @bp.route("/<visitor_id>/schedule-visit", methods=["POST"])
    def schedule_visit(visitor_id):
        # reference visitor.py:594-687
        if not request.is_json:
            return error_response("Request must be application/json", 415)
        data = request.get_json() or {}
        try:
            ok, msg = validate_required_fields(
                data, ["companyId", "hostEmployeeId", "expectedArrival"])
            if not ok:
                return error_response(msg, 400)
            try:
                arrival = parse_datetime(data["expectedArrival"])
                new_end = (parse_datetime(data["expectedDeparture"])
                           if data.get("expectedDeparture") else None)
            except (ValueError, TypeError):
                return error_response("Invalid datetime format.", 400)
            if new_end is None:
                # a zero-length window would make verify-qr reject the pass
                # as expired the instant it's scanned; default to a 1-hour
                # visit (documented deliberate choice)
                new_end = arrival + timedelta(hours=1)
            if new_end <= arrival:
                return error_response(
                    "expectedDeparture must be after expectedArrival", 400)

            # `or` (not a default arg): an explicit empty visitorIds list
            # must fall back to the URL visitor, not IndexError below
            visitor_ids = data.get("visitorIds") or [visitor_id]
            try:
                visitor_obj_ids = [ObjectId(str(v)) for v in visitor_ids]
            except Exception:
                return error_response("Invalid visitor ID in visitorIds", 400)
            if not ObjectId.is_valid(str(data["companyId"])):
                return error_response("Invalid companyId format.", 400)
            company_obj_id = ObjectId(data["companyId"])
            # accept a business employeeId for the host exactly like
            # /register does — the same client value must not 500 here
            host = None
            if ObjectId.is_valid(str(data["hostEmployeeId"])):
                host = ds.employee_info.find_one({
                    "_id": ObjectId(str(data["hostEmployeeId"])),
                    "companyId": company_obj_id})
            if host is None:
                host = ds.employee_info.find_one({
                    "employeeId": data["hostEmployeeId"],
                    "companyId": company_obj_id})
            if host is None:
                return error_response("Host employee not found.", 400)
            host_obj_id = host["_id"]

            # every visitor in the group must exist, belong to the company,
            # and be free in the window — not just the URL visitor
            for oid in visitor_obj_ids:
                v_doc = ds.visitors.find_one({"_id": oid})
                if not v_doc:
                    return error_response(f"Visitor {oid} not found", 404)
                if str(v_doc.get("companyId")) != str(company_obj_id):
                    return error_response(
                        f"Visitor {oid} does not belong to the company", 403)
                if has_overlapping_visit(oid, arrival, new_end):
                    return error_response(
                        "Visitor already has an overlapping visit.", 409)

            visit_doc = build_visit_doc(
                visitor_obj_ids[0] if len(visitor_obj_ids) == 1 else visitor_obj_ids,
                company_obj_id, host_obj_id, data.get("purpose", ""),
                arrival, new_end, approved=bool(data.get("approved")))
            visit_doc["accessAreas"] = data.get("accessAreas", [])
            visit_doc["visitType"] = data.get("visitType", "single")
            visit_id = ds.visits.insert_one(visit_doc).inserted_id

            visitor = ds.visitors.find_one({"_id": visitor_obj_ids[0]})
            host = ds.employee_info.find_one({"_id": host_obj_id})

            face_bytes = None
            img_id = (visitor or {}).get("visitorImages", {}).get("center")
            if img_id:
                try:
                    face_bytes = ds.visitor_images.get(ObjectId(str(img_id))).read()
                except Exception:
                    face_bytes = None
            png = generate_visitor_pass(visitor or {}, host or {}, data,
                                        visit_id, arrival, new_end, face_bytes)
            qr_id = ds.visitor_images.put(
                png, filename=f"visit_pass_{visit_id}.png",
                metadata={"type": "visit_pass", "visitId": str(visit_id),
                          "timestamp": get_current_utc(),
                          "ttl": new_end or arrival})
            ds.visits.update_one({"_id": visit_id}, {"$set": {"qrCode": qr_id}})
            for vid in visitor_obj_ids:
                ds.visitors.update_one({"_id": vid},
                                       {"$push": {"visits": str(visit_id)}})
            visit = ds.visits.find_one({"_id": visit_id})
            return jsonify({"message": "Visit scheduled successfully",
                            "visit": _stringify_visit(visit)}), 201
        except Exception as e:
            return error_response(str(e), 500)

    # ------------------------------------------------------- check-in/out
    @bp.route("/visits/<visit_id>/check-in", methods=["POST"])
    def check_in(visit_id):
        # reference visitor.py:689-725 (visit lookup fixed, see module doc)
        data = request.get_json(silent=True) or {}
        if "checkInMethod" not in data:
            return error_response("Check-in method is required.", 400)
        visit = find_visit(visit_id)
        if not visit:
            return error_response("Visit not found.", 404)
        if visit["status"] != "scheduled":
            return error_response("Visit is not in scheduled state.", 400)
        ds.visits.update_one({"_id": visit["_id"]}, {"$set": {
            "status": "checked_in",
            "checkInMethod": data["checkInMethod"],
            "actualArrival": get_current_utc(),
            "lastUpdated": get_current_utc()}})
        return jsonify({"message": "Check-in successful", "visitId": visit_id}), 200

    @bp.route("/visits/<visit_id>/check-out", methods=["POST"])
    def check_out(visit_id):
        # reference visitor.py:727-763
        data = request.get_json(silent=True) or {}
        if "checkOutMethod" not in data:
            return error_response("Check-out method is required.", 400)
        visit = find_visit(visit_id)
        if not visit:
            return error_response("Visit not found.", 404)
        if visit["status"] != "checked_in":
            return error_response("Visit is not checked in.", 400)
        ds.visits.update_one({"_id": visit["_id"]}, {"$set": {
            "status": "checked_out",
            "checkOutMethod": data["checkOutMethod"],
            "actualDeparture": get_current_utc(),
            "lastUpdated": get_current_utc()}})
        return jsonify({"message": "Check-out successful", "visitId": visit_id}), 200

    # -------------------------------------------------------------- lists
    @bp.route("", methods=["GET"])
    def get_visitors():
        # reference visitor.py:765-789
        company_id = request.args.get("companyId")
        if not company_id:
            return error_response("companyId is required", 400)
        fetch_embeddings = request.args.get("fetchEmbeddings", "false").lower() == "true"
        visitors = list(ds.visitors.find({"companyId": ObjectId(company_id)}))
        base_url = cfg.api.url_prefix
        out = []
        for visitor in visitors:
            visitor = _stringify_visit(visitor)
            if fetch_embeddings:
                for model, emb in (visitor.get("visitorEmbeddings") or {}).items():
                    if emb.get("embeddingId"):
                        emb["downloadUrl"] = (
                            f"{base_url}/visitors/embeddings/{emb['embeddingId']}")
            out.append(visitor)
        return jsonify({"visitors": out}), 200

    @bp.route("/visits", methods=["GET"])
    def get_visits():
        # reference visitor.py:791-826
        query = {}
        if request.args.get("companyId"):
            query["companyId"] = ObjectId(request.args["companyId"])
        if request.args.get("visitorId"):
            query["visitorId"] = ObjectId(request.args["visitorId"])
        if request.args.get("status"):
            query["status"] = request.args["status"]
        visits = []
        for visit in ds.visits.find(query):
            had_qr = isinstance(visit.get("qrCode"), ObjectId)
            visit = _stringify_visit(visit)
            if had_qr:
                # reference visitor.py:820 emits "/bharatlytics/v1/visits/qr/…"
                # but its blueprint routes live under the /visitors mount (the
                # registration is absent from the snapshot) — that URL cannot
                # resolve.  Emit the path the route actually serves.
                visit["qrCodeUrl"] = (
                    f"{cfg.api.url_prefix}/visitors/visits/qr/{visit['_id']}")
            visits.append(visit)
        return jsonify({"visits": visits}), 200

    @bp.route("/visits/qr/<visit_id>", methods=["GET"])
    def get_visit_qr(visit_id):
        # reference visitor.py:828-844
        try:
            visit = ds.visits.find_one({"_id": ObjectId(visit_id)})
        except Exception:
            return error_response("QR code not found", 404)
        if not visit or not visit.get("qrCode"):
            return error_response("QR code not found", 404)
        try:
            qr_file = ds.visitor_images.get(ObjectId(str(visit["qrCode"])))
        except Exception:
            return error_response("QR code not found", 404)
        return Response(qr_file.read(), 200, {
            "Content-Disposition": f"inline; filename=qr_{visit_id}.png"
        }, mimetype="image/png")

    # ------------------------------------------------------------ cleanup
    @bp.route("/cleanup-duplicates", methods=["POST"])
    def cleanup_duplicates():
        # reference visitor.py:846-883
        company_id = request.form.get("companyId")
        if not company_id:
            return error_response("companyId is required", 400)
        try:
            hours = int(request.form.get("hours", 24))
        except ValueError:
            return error_response("Hours must be between 1 and 168", 400)
        if hours < 1 or hours > 168:
            return error_response("Hours must be between 1 and 168", 400)
        cutoff = get_current_utc() - timedelta(hours=hours)
        count = 0
        for visitor in ds.visitors.find({
                "companyId": ObjectId(company_id),
                "status": "pending_duplicate_removal",
                "visitorEmbeddings.buffalo_l.finishedAt": {"$lt": cutoff}}):
            ds.visitors.delete_one({"_id": visitor["_id"]})
            count += 1
        return jsonify({
            "message": f"Successfully cleaned up {count} duplicate visitors",
            "deleted_count": count,
            "hours_threshold": hours,
            "companyId": company_id,
        }), 200

    # ----------------------------------------------------- embeddings info
    @bp.route("/<visitor_id>/embeddings", methods=["GET"])
    def get_visitor_embeddings(visitor_id):
        # reference visitor.py:885-909 (queries visitorId field; we also
        # accept the _id hex since registration returns _id)
        company_id = request.args.get("companyId")
        if not company_id:
            return error_response("companyId is required", 400)
        visitor = ds.visitors.find_one({"companyId": ObjectId(company_id),
                                        "visitorId": visitor_id})
        if not visitor and ObjectId.is_valid(visitor_id):
            visitor = ds.visitors.find_one({"companyId": ObjectId(company_id),
                                            "_id": ObjectId(visitor_id)})
        if not visitor:
            return error_response("Visitor not found", 404)
        embeddings = {m: _stringify_visit(e) if isinstance(e, dict) else e
                      for m, e in (visitor.get("visitorEmbeddings") or {}).items()}
        return jsonify({"visitorId": visitor_id, "companyId": company_id,
                        "embeddings": embeddings}), 200

    # -------------------------------------------------------- visit CRUD
    @bp.route("/visits/<visit_id>", methods=["PATCH"])
    def update_visit(visit_id):
        # reference visitor.py:945-975
        data = request.get_json(silent=True) or {}
        update_fields = {f: data[f] for f in
                         ("purpose", "expectedArrival", "expectedDeparture",
                          "accessAreas", "visitType", "status") if f in data}
        if not update_fields:
            return error_response("No valid fields to update.", 400)
        visit = find_visit(visit_id)
        if not visit:
            return error_response("Visit not found.", 404)
        if "expectedArrival" in update_fields or "expectedDeparture" in update_fields:
            vid = visit["visitorId"]
            if isinstance(vid, list):
                vid = vid[0]
            try:
                new_start = parse_datetime(update_fields.get(
                    "expectedArrival", visit["expectedArrival"]))
                new_end = parse_datetime(update_fields.get(
                    "expectedDeparture",
                    visit.get("expectedDeparture", visit["expectedArrival"])))
            except (ValueError, TypeError):
                # a malformed date string is the client's error, not a 500
                return error_response("Invalid datetime format.", 400)
            if new_end <= new_start:
                # an arrival-only update may not invert the stored window:
                # verify-qr would then reject the pass at every instant
                return error_response(
                    "expectedDeparture must be after expectedArrival", 400)
            if has_overlapping_visit(vid, new_start, new_end,
                                     exclude_visit_id=visit["_id"]):
                return error_response("Visitor already has an overlapping visit.", 409)
            if "expectedArrival" in update_fields:
                update_fields["expectedArrival"] = new_start
            if "expectedDeparture" in update_fields:
                update_fields["expectedDeparture"] = new_end
        update_fields["lastUpdated"] = get_current_utc()
        ds.visits.update_one({"_id": visit["_id"]}, {"$set": update_fields})
        return jsonify({"message": "Visit updated successfully"}), 200

    @bp.route("/visits/<visit_id>", methods=["DELETE"])
    def delete_visit(visit_id):
        # reference visitor.py:977-985 (cancel, not hard delete)
        visit = find_visit(visit_id)
        if not visit:
            return error_response("Visit not found.", 404)
        ds.visits.update_one({"_id": visit["_id"]},
                             {"$set": {"status": "cancelled",
                                       "cancelledAt": get_current_utc()}})
        return jsonify({"message": "Visit cancelled successfully"}), 200

    # ---------------------------------------------------------- analytics
    @bp.route("/visits/analytics/host", methods=["GET"])
    def visits_per_host():
        # reference visitor.py:987-1000 (ObjectIds stringified here so the
        # response is serializable — SURVEY.md §8)
        company_id = request.args.get("companyId")
        if not company_id or not ObjectId.is_valid(company_id):
            return error_response("companyId is required", 400)
        rows = ds.visits.aggregate([
            {"$match": {"companyId": ObjectId(company_id)}},
            {"$group": {"_id": "$hostEmployeeId", "count": {"$sum": 1}}},
            {"$sort": {"count": -1}},
        ])
        return jsonify([{"_id": str(r["_id"]), "count": r["count"]} for r in rows])

    @bp.route("/visits/analytics/area", methods=["GET"])
    def visits_per_area():
        # reference visitor.py:1002-1017
        company_id = request.args.get("companyId")
        if not company_id or not ObjectId.is_valid(company_id):
            return error_response("companyId is required", 400)
        rows = ds.visits.aggregate([
            {"$match": {"companyId": ObjectId(company_id)}},
            {"$unwind": "$accessAreas"},
            {"$group": {"_id": "$accessAreas", "count": {"$sum": 1}}},
            {"$sort": {"count": -1}},
        ])
        return jsonify([{"_id": r["_id"], "count": r["count"]} for r in rows])

    # ------------------------------------------------------------ verify
    @bp.route("/visits/verify-qr", methods=["POST"])
    def verify_qr():
        # reference visitor.py:1018-1110 — same contract, working decoder
        if "qrCode" not in request.files:
            return error_response("QR code image is required", 400)
        qr_file = request.files.get("qrCode")
        if not qr_file or qr_file.filename == "":
            return error_response("No file selected", 400)
        access_zone = request.form.get("accessZone")
        visit_id = qr_decode(qr_file.read())
        if not visit_id:
            return error_response("Could not decode QR code", 400)
        if not ObjectId.is_valid(visit_id):
            return error_response("Invalid QR code format", 400)
        visit = ds.visits.find_one({"_id": ObjectId(visit_id)})
        if not visit:
            return error_response("Visit not found", 404)
        if visit["status"] not in ("scheduled", "checked_in"):
            return error_response("Visit is not in a valid state", 400)
        current = get_current_utc()
        arrival = visit["expectedArrival"]
        departure = visit.get("expectedDeparture") or arrival
        if current < arrival:
            return error_response("Visit has not started yet", 400)
        if current > departure:
            return error_response("Visit has expired", 400)
        if access_zone and visit.get("accessAreas"):
            if access_zone not in visit["accessAreas"]:
                return error_response("QR code not valid for this access zone", 400)
        return jsonify({"message": "QR code is valid",
                        "visit": _stringify_visit(visit)}), 200

    # ------------------------------------------------------ blob serving
    @bp.route("/embeddings/<embedding_id>", methods=["GET"])
    def serve_visitor_embedding(embedding_id):
        # reference visitor.py:1112-1138
        try:
            file = ds.visitor_embeddings.get(ObjectId(embedding_id))
        except Exception:
            return error_response("Embedding not found", 404)
        filename = file.filename or str(embedding_id)
        mimetype = "text/plain" if filename.endswith(".txt") else "application/octet-stream"
        return Response(file.read(), 200, {
            "Content-Disposition": f"inline; filename={filename}"
        }, mimetype=mimetype)

    return bp
