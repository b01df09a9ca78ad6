"""Employee REST API.

Same routes, parameters, status codes, and JSON shapes as the reference
blueprint (reference app/api/employee.py; per-route citations inline):
multipart registration with three pose images → GridFS → employee doc
upsert → one embedding job queued per allowed model; listing with
image/embedding download URLs; image/embedding byte serving; PATCH update
with email/phone uniqueness; soft/hard delete incl. GridFS cleanup;
duplicate cleanup; audit logs behind a token stub; per-IP rate limiting.

The port's copy of ``facerecognition_infrenceengine_tpu/api/employee.py``.
"""

from __future__ import annotations

import threading
import time
from collections import defaultdict
from datetime import timedelta

from ..core.config import Config
from ..store.client import Datastore
from ..store.objectid import ObjectId
from ..web import Blueprint, Response, jsonify, request
from .constants import POSES
from .docmodels import build_employee_doc
from .embeddings import (deserialize_embedding, get_embedding_file,
                         store_embedding)
from .utils import (
    company_query,
    error_response,
    fill_employee_fields,
    format_datetime,
    get_current_utc,
    get_optional_fields,
    is_unique_email,
    is_unique_phone,
    validate_email_format,
    validate_phone_format,
    validate_poses,
    validate_required_fields,
)


class RateLimiter:
    """Sliding-window per-IP limit (reference employee.py:51-72), with the
    lock the reference forgot (SURVEY.md §8)."""

    def __init__(self, limit: int = 100, period_s: float = 60.0):
        self.limit = limit
        self.period = period_s
        self._hits: dict = defaultdict(list)
        self._lock = threading.Lock()

    def allow(self, ip: str) -> bool:
        now = time.time()
        with self._lock:
            window = now - self.period
            # prune idle IPs occasionally so the dict doesn't grow with
            # client churn (one full sweep per ~1000 calls amortizes fine)
            self._calls = getattr(self, "_calls", 0) + 1
            if self._calls % 1000 == 0:
                for stale in [k for k, v in self._hits.items()
                              if not v or v[-1] <= window]:
                    del self._hits[stale]
            hits = [t for t in self._hits[ip] if t > window]
            if len(hits) >= self.limit:
                self._hits[ip] = hits
                return False
            hits.append(now)
            self._hits[ip] = hits
            return True


def make_employee_bp(ds: Datastore, cfg: Config) -> Blueprint:
    bp = Blueprint("employee")
    limiter = RateLimiter(cfg.api.rate_limit_requests, cfg.api.rate_limit_window_s)

    def log_security_event(event_type: str, ip: str, path: str):
        # reference employee.py:55-62
        ds.security_events.insert_one({
            "timestamp": get_current_utc(), "event": event_type,
            "ip": ip, "path": path,
        })

    def log_audit(action, employee_id, company_id, before, after):
        # reference employee.py:30-39; we log ids not full docs to avoid the
        # reference's habit of dumping embedded ObjectIds wholesale
        def slim(doc):
            if not doc:
                return None
            return {k: str(v) if isinstance(v, ObjectId) else v
                    for k, v in doc.items()
                    if k not in ("employeeImages", "employeeEmbeddings")}

        ds.audit_logs.insert_one({
            "user": "system",
            "timestamp": get_current_utc(),
            "action": action,
            "employeeId": employee_id,
            "companyId": str(company_id),
            "before": slim(before),
            "after": slim(after),
        })

    def rate_gate():
        ip = request.remote_addr or "?"
        if not limiter.allow(ip):
            log_security_event("rate_limit", ip, request.path)
            return error_response("Too Many Requests", 429)
        return None

    # ------------------------------------------------------------ register
    @bp.route("/register", methods=["POST"])
    def register_employee():
        # reference employee.py:89-220
        gate = rate_gate()
        if gate:
            return gate
        try:
            required = ["employeeId", "employeeName", "companyId"]
            ok, msg = validate_required_fields(request.form, required)
            if not ok:
                return error_response(msg, 400)
            ok, msg = validate_poses(request.files)
            if not ok:
                return error_response(msg, 400)
            data = {f: request.form[f] for f in required}
            optional = ["gender", "joiningDate", "employeeEmail", "employeeMobile",
                        "employeeDesignation", "employeeReportingId", "status",
                        "blacklisted"]
            data.update(get_optional_fields(request.form, optional))
            data["blacklisted"] = str(data.get("blacklisted", "false")).lower() == "true"
            if not ObjectId.is_valid(data["companyId"]):
                return error_response("Invalid companyId format.", 400)

            if data.get("employeeEmail"):
                if not validate_email_format(data["employeeEmail"]):
                    return error_response("Invalid email format.", 400)
                if not is_unique_email(ds.employee_info, data["companyId"],
                                       data["employeeEmail"],
                                       exclude_employee_id=data["employeeId"]):
                    return error_response("Email must be unique within the company.", 409)
            if data.get("employeeMobile"):
                if not validate_phone_format(data["employeeMobile"]):
                    return error_response(
                        "Invalid phone number format. Must be 10 digits.", 400)
                if not is_unique_phone(ds.employee_info, data["companyId"],
                                       data["employeeMobile"],
                                       exclude_employee_id=data["employeeId"]):
                    return error_response(
                        "Phone number must be unique within the company.", 409)

            existing = ds.employee_info.find_one(
                company_query(data["companyId"], employeeId=data["employeeId"]))
            if existing:
                buffalo = (existing.get("employeeEmbeddings", {})
                           .get("buffalo_l", {}).get("status"))
                emp_status = existing.get("status")
                # an ARCHIVED (soft-deleted) employee may re-register even
                # though its old embeddings read 'done' — otherwise archival
                # would permanently block the id with a misleading
                # "is active" 409 and the only recovery would be hard delete
                if emp_status == "active" or (
                        buffalo in ("done", "active")
                        and emp_status != "archived"):
                    return error_response(
                        "Employee with this ID already exists in the company "
                        "and is active.", 409)
                if emp_status == "pending_duplicate_removal":
                    return error_response(
                        "Duplicate employee cannot be re-registered as active. "
                        "Please contact admin or cleanup duplicates.", 409)

            embedding_attached = request.form.get(
                "embeddingAttached", "false").lower() == "true"
            embedding_version = request.form.get("embeddingVersion")
            emb_bytes = emb_filename = None
            if embedding_attached:
                # Validate BEFORE any write: a rejected blob must not leave a
                # half-registered employee (images/doc) behind.
                if not embedding_version or "embedding" not in request.files:
                    return error_response(
                        "embeddingVersion and embedding file required when "
                        "embeddingAttached is true")
                if embedding_version not in cfg.api.allowed_models:
                    return error_response("Embedding model not allowed.", 400)
                emb_file = request.files.get("embedding")
                emb_bytes = emb_file.read()
                emb_filename = emb_file.filename
                # The blob is later unpickled by the gallery/worker — only a
                # plain numeric vector may pass (core/serialization
                # restricted unpickler; a crafted pickle must be rejected
                # here, not executed later).
                try:
                    deserialize_embedding(emb_bytes)
                except Exception:
                    return error_response(
                        "Attached embedding is not a valid embedding vector.",
                        400)
            embeddings_dict: dict = {}
            image_dict: dict = {}

            for pose in POSES:
                file = request.files.get(pose)
                img_bytes = file.read()
                if not img_bytes:
                    return error_response(f"Empty image file for pose: {pose}", 400)
                image_id = ds.employee_images.put(
                    img_bytes,
                    filename=f"{data['companyId']}_{data['employeeId']}_{pose}.jpg",
                    metadata={
                        "companyId": data["companyId"],
                        "employeeId": data["employeeId"],
                        "pose": pose,
                        "type": "image",
                        "timestamp": get_current_utc(),
                    })
                image_dict[pose] = image_id

            # Re-registration replaces the biometric data wholesale: the new
            # pose images supersede the old ones and every model re-enrolls.
            # Delete the superseded GridFS blobs so they don't orphan.
            if existing:
                for old_id in (existing.get("employeeImages") or {}).values():
                    try:
                        ds.employee_images.delete(ObjectId(str(old_id)))
                    except Exception:
                        pass
                for entry in (existing.get("employeeEmbeddings") or {}).values():
                    if entry.get("embeddingId"):
                        try:
                            ds.employee_embeddings.delete(
                                ObjectId(str(entry["embeddingId"])))
                        except Exception:
                            pass

            employee_doc = build_employee_doc(data, image_dict, embeddings_dict)
            ds.employee_info.update_one(
                {"companyId": ObjectId(data["companyId"]),
                 "employeeId": data["employeeId"]},
                {"$set": employee_doc},
                upsert=True,
            )
            employee = ds.employee_info.find_one(
                {"companyId": ObjectId(data["companyId"]),
                 "employeeId": data["employeeId"]})

            if embedding_attached:
                emb_entry = store_embedding(
                    ds, emb_bytes, emb_filename,
                    {"companyId": data["companyId"],
                     "employeeId": data["employeeId"],
                     "model": embedding_version, "type": "embedding",
                     "timestamp": get_current_utc()},
                    embedding_version)
                emb_entry["status"] = "done"
                emb_entry["finishedAt"] = get_current_utc()
                embeddings_dict[embedding_version] = emb_entry
                ds.employee_info.update_one(
                    {"companyId": ObjectId(data["companyId"]),
                     "employeeId": data["employeeId"]},
                    {"$set": {f"employeeEmbeddings.{embedding_version}": emb_entry}})

            # Queue one embedding job per allowed model (employee.py:163-178),
            # except: (a) the model whose embedding the client just attached —
            # the worker would recompute from pose images and overwrite the
            # attached 'done' entry; (b) models with a job already queued for
            # this employee — re-registering mid-enrollment must not stack
            # duplicate jobs (reference employee.py:164-165 guard); the
            # existing queued job reads the *new* pose images when it runs.
            for model in cfg.api.allowed_models:
                if embedding_attached and model == embedding_version:
                    continue
                already_queued = ds.embedding_jobs.find_one({
                    "employeeId": employee["_id"],
                    "model": model,
                    "status": "queued",
                    # visitor jobs carry the HOST employee's _id plus a
                    # visitorId; without this exclusion a pending visitor
                    # job would satisfy the dedupe and the employee's own
                    # enrollment job would never be queued
                    "visitorId": {"$exists": False},
                })
                if not already_queued:
                    ds.embedding_jobs.insert_one({
                        "employeeId": employee["_id"],
                        "companyId": ObjectId(data["companyId"]),
                        "model": model,
                        "status": "queued",
                        "createdAt": get_current_utc(),
                        "params": {},
                    })
                embeddings_dict[model] = {"status": "queued",
                                          "queuedAt": get_current_utc()}

            # persist queued-status entries on the doc so the worker and
            # later reads see them (the reference builds embeddings_dict after
            # the doc insert and loses it — we keep the doc authoritative)
            if embeddings_dict:
                ds.employee_info.update_one(
                    {"companyId": ObjectId(data["companyId"]),
                     "employeeId": data["employeeId"]},
                    {"$set": {f"employeeEmbeddings.{m}": e
                              for m, e in embeddings_dict.items()}})

            log_audit("register", data["employeeId"], data["companyId"],
                      existing, employee_doc)
            return jsonify({
                "message": "Employee registration queued",
                "employeeId": data["employeeId"],
                "embeddingStatus": {k: v.get("status", "unknown")
                                    for k, v in embeddings_dict.items()},
            }), 200
        except Exception as e:  # mirror reference catch-all (employee.py:218-220)
            return error_response(str(e), 500)

    # ---------------------------------------------------------------- list
    @bp.route("/", methods=["GET"])
    def get_employee():
        # reference employee.py:222-295
        gate = rate_gate()
        if gate:
            return gate
        company_id = request.args.get("companyId")
        if not company_id:
            return error_response("companyId is required", 400)
        employee_id = request.args.get("employeeId")
        fetch_embeddings = request.args.get("fetchEmbeddings", "false").lower() == "true"
        embedding_version = request.args.get("embeddingVersion")
        fetch_images = request.args.get("fetchImages", "false").lower() == "true"
        fields = request.args.get("fields")
        field_list = [f.strip() for f in fields.split(",")] if fields else None

        query = company_query(company_id)
        if employee_id:
            query["employeeId"] = employee_id
        query["status"] = {"$ne": "archived"}
        employees = list(ds.employee_info.find(query))
        base_url = cfg.api.url_prefix

        results = []
        for employee in employees:
            result = fill_employee_fields(employee)
            if field_list:
                result = {k: v for k, v in result.items()
                          if k in field_list or k in ("employeeId", "companyId")}
            if fetch_images:
                result["employeeImages"] = {
                    pose: f"{base_url}/employees/images/{img_id}"
                    for pose, img_id in employee.get("employeeImages", {}).items()
                }
            if fetch_embeddings:
                result["employeeEmbeddings"] = {}
                emb_dict = employee.get("employeeEmbeddings", {})
                models = ([embedding_version] if embedding_version
                          else list(emb_dict))
                for model in models:
                    emb = emb_dict.get(model)
                    if emb and emb.get("embeddingId"):
                        result["employeeEmbeddings"][model] = {
                            "downloadUrl":
                                f"{base_url}/employees/embeddings/{emb['embeddingId']}",
                            "status": emb.get("status", "unknown"),
                            "createdAt": format_datetime(emb.get("createdAt")),
                            "finishedAt": format_datetime(emb.get("finishedAt")),
                        }
            results.append(result)
        return jsonify(results), 200

    # -------------------------------------------------------------- serving
    @bp.route("/images/<image_id>", methods=["GET"])
    def serve_employee_image(image_id):
        # reference employee.py:297-306
        try:
            file = ds.employee_images.get(ObjectId(image_id))
            return Response(file.read(), 200, {
                "Content-Disposition": f"inline; filename={image_id}.jpg"
            }, mimetype="image/jpeg")
        except Exception:
            return error_response("Image not found", 404)

    @bp.route("/embeddings/<embedding_id>", methods=["GET"])
    def serve_employee_embedding(embedding_id):
        # reference employee.py:308-339
        if not ObjectId.is_valid(embedding_id):
            return error_response("Invalid embedding ID format", 400)
        try:
            file = get_embedding_file(ds, embedding_id)
        except Exception:
            return error_response("Embedding not found", 404)
        filename = file.filename or str(embedding_id)
        mimetype = "text/plain" if filename.endswith(".txt") else "application/octet-stream"
        return Response(file.read(), 200, {
            "Content-Disposition": f"inline; filename={filename}"
        }, mimetype=mimetype)

    # --------------------------------------------------------------- update
    @bp.route("/update", methods=["PATCH"])
    def update_employee():
        # reference employee.py:341-394
        gate = rate_gate()
        if gate:
            return gate
        data = request.get_json(silent=True) if request.is_json else request.form
        data = data or {}
        ok, msg = validate_required_fields(data, ["employeeId", "companyId"])
        if not ok:
            return error_response(msg, 400)
        employee_id = data["employeeId"]
        company_id = data["companyId"]
        employee = ds.employee_info.find_one(
            company_query(company_id, employeeId=employee_id))
        if employee:
            buffalo = (employee.get("employeeEmbeddings", {})
                       .get("buffalo_l", {}).get("status"))
            if (buffalo == "duplicate"
                    or employee.get("status") == "pending_duplicate_removal"):
                if "status" in data:
                    return error_response(
                        "Cannot update status of a duplicate employee. "
                        "Please contact admin or cleanup duplicates.", 409)
        update_fields = {}
        for key in ("employeeName", "gender", "blacklisted", "joiningDate",
                    "status", "employeeEmail", "employeeMobile",
                    "employeeDesignation", "employeeReportingId"):
            if key in data:
                value = data[key]
                if key == "blacklisted":
                    value = (value.lower() == "true" if isinstance(value, str)
                             else bool(value))
                update_fields[key] = value
        if "employeeEmail" in update_fields:
            if not validate_email_format(update_fields["employeeEmail"]):
                return error_response("Invalid email format.", 400)
            if not is_unique_email(ds.employee_info, company_id,
                                   update_fields["employeeEmail"],
                                   exclude_employee_id=employee_id):
                return error_response("Email must be unique within the company.", 409)
        if "employeeMobile" in update_fields:
            if not validate_phone_format(update_fields["employeeMobile"]):
                return error_response(
                    "Invalid phone number format. Must be 10 digits.", 400)
            if not is_unique_phone(ds.employee_info, company_id,
                                   update_fields["employeeMobile"],
                                   exclude_employee_id=employee_id):
                return error_response(
                    "Phone number must be unique within the company.", 409)
        update_fields["lastUpdated"] = get_current_utc()
        result = ds.employee_info.update_one(
            company_query(company_id, employeeId=employee_id),
            {"$set": update_fields})
        if result.matched_count == 0:
            return error_response("Employee not found", 404)
        after = ds.employee_info.find_one(
            company_query(company_id, employeeId=employee_id))
        log_audit("update", employee_id, company_id, employee, after)
        return jsonify({"message": "Employee updated successfully"}), 200

    # --------------------------------------------------------------- delete
    @bp.route("/delete", methods=["DELETE"])
    def delete_employee():
        # reference employee.py:396-459
        gate = rate_gate()
        if gate:
            return gate
        data = request.get_json(silent=True) if request.is_json else request.form
        data = data or {}
        ok, msg = validate_required_fields(data, ["employeeId", "companyId"])
        if not ok:
            return error_response(msg, 400)
        employee_id = data["employeeId"]
        company_id = data["companyId"]
        mode = str(data.get("mode", "soft")).lower()
        reason = data.get("reason", "user_request")
        employee = ds.employee_info.find_one(
            company_query(company_id, employeeId=employee_id))
        if not employee:
            return error_response("Employee not found", 404)
        if mode == "soft":
            ds.employee_info.update_one(
                company_query(company_id, employeeId=employee_id),
                {"$set": {"status": "archived",
                          "deletedAt": get_current_utc(),
                          "deletedReason": reason}})
            log_audit("delete", employee_id, company_id, employee, None)
            return jsonify(
                {"message": "Employee soft deleted (archived) successfully"}), 200
        if mode == "hard":
            for img_id in employee.get("employeeImages", {}).values():
                try:
                    ds.employee_images.delete(img_id)
                except Exception:
                    pass
            for emb in employee.get("employeeEmbeddings", {}).values():
                if emb.get("embeddingId"):
                    try:
                        ds.employee_embeddings.delete(emb["embeddingId"])
                    except Exception:
                        pass
            ds.employee_info.delete_one(
                company_query(company_id, employeeId=employee_id))
            log_audit("delete", employee_id, company_id, employee, None)
            return jsonify({"message": "Employee hard deleted successfully"}), 200
        return error_response('Invalid delete mode. Use "soft" or "hard".', 400)

    # ------------------------------------------------------------- cleanup
    @bp.route("/cleanup-duplicates", methods=["POST"])
    def cleanup_duplicates():
        # reference employee.py:461-498
        gate = rate_gate()
        if gate:
            return gate
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
        query = company_query(company_id, status="pending_duplicate_removal")
        query["employeeEmbeddings.buffalo_l.finishedAt"] = {"$lt": cutoff}
        count = 0
        for emp in ds.employee_info.find(query):
            ds.employee_info.delete_one({"_id": emp["_id"]})
            count += 1
        return jsonify({
            "message": f"Successfully cleaned up {count} duplicate employees",
            "deleted_count": count,
            "hours_threshold": hours,
            "companyId": company_id,
        }), 200

    # ----------------------------------------------------------- audit logs
    @bp.route("/audit-logs", methods=["GET"])
    def get_audit_logs():
        # reference employee.py:500-517 (token-stub auth :75-83)
        if not request.headers.get("X-Auth-Token"):
            log_security_event("unauthorized", request.remote_addr or "?",
                               request.path)
            return error_response("Unauthorized", 401)
        query = {}
        if request.args.get("employeeId"):
            query["employeeId"] = request.args["employeeId"]
        if request.args.get("companyId"):
            query["companyId"] = request.args["companyId"]
        logs = list(ds.audit_logs.find(query).sort("timestamp", -1))
        for log in logs:
            log["_id"] = str(log["_id"])
            log["timestamp"] = format_datetime(log["timestamp"])
        return jsonify(logs), 200

    @bp.route("/employees/page", methods=["GET"])
    def employee_page():
        # reference employee.py:519-521 renders an employees.html template
        # that is absent from the snapshot; here the admin UI's employees
        # workspace is that page, so serve it (same-origin /ui assets).
        # Rate-limited like every other employee route: the reference
        # throttles the whole blueprint via before_request (employee.py:85-87).
        gate = rate_gate()
        if gate:
            return gate
        from ..web.ui import ui_page
        return ui_page("employees.html")

    return bp
