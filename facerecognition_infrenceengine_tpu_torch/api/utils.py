"""Request/validation helpers.

The reference imports these from a top-level ``utils`` module missing from
the snapshot (reference app/api/employee.py:5-9, visitor.py:4-8,
entity.py:19); every contract below is reconstructed from its call sites,
cited per function.

The port's copy of ``facerecognition_infrenceengine_tpu/api/utils.py``.
"""

from __future__ import annotations

import datetime
import re

from ..store.objectid import ObjectId
from ..web import jsonify
from .constants import POSES

# --------------------------------------------------------------- date/time
def get_current_utc() -> datetime.datetime:
    """UTC now (naive, like the reference's ``datetime.utcnow`` usage in
    db/seed_templates.py:181 — keeps Mongo comparisons homogeneous)."""
    return datetime.datetime.now(datetime.timezone.utc).replace(tzinfo=None)


def parse_datetime(value) -> datetime.datetime:
    """Parse ISO-8601-ish strings to naive UTC (used for joiningDate,
    expectedArrival etc.; reference app/models/models.py:19,53-54)."""
    if isinstance(value, datetime.datetime):
        dt = value
    elif isinstance(value, (int, float)):
        dt = datetime.datetime.fromtimestamp(
            value, datetime.timezone.utc).replace(tzinfo=None)
    else:
        s = str(value).strip().replace("Z", "+00:00")
        try:
            dt = datetime.datetime.fromisoformat(s)
        except ValueError:
            for fmt in ("%Y-%m-%d", "%Y-%m-%d %H:%M:%S", "%d/%m/%Y", "%m/%d/%Y"):
                try:
                    dt = datetime.datetime.strptime(s, fmt)
                    break
                except ValueError:
                    continue
            else:
                raise ValueError(f"unparseable datetime: {value!r}")
    if dt.tzinfo is not None:
        dt = dt.astimezone(datetime.timezone.utc).replace(tzinfo=None)
    return dt


def format_datetime(value) -> str | None:
    """ISO-8601 string for responses (reference employee.py:516)."""
    if value is None:
        return None
    if isinstance(value, str):
        return value
    return value.isoformat()


# -------------------------------------------------------------- validation
def error_response(message: str, status: int = 400):
    """Uniform error JSON (the reference passes (msg, code) everywhere,
    e.g. employee.py:95)."""
    return jsonify({"error": message}), status


def validate_required_fields(data, required_fields):
    """-> (ok, message). data is a form/json mapping (employee.py:92-95)."""
    missing = [f for f in required_fields
               if f not in data or data.get(f) in (None, "")]
    if missing:
        return False, f"Missing required fields: {', '.join(missing)}"
    return True, ""


def validate_poses(files):
    """All three pose images must be present (employee.py:96-98)."""
    missing = [p for p in POSES if p not in files or not files.get(p)]
    if missing:
        return False, f"Missing image for pose: {', '.join(missing)}"
    return True, ""


def get_optional_fields(data, optional_fields) -> dict:
    """Subset of present optional fields (employee.py:100-104)."""
    return {f: data[f] for f in optional_fields if f in data and data.get(f) != ""}


UNICODE_EMAIL_REGEX = re.compile(r"^[^@\s]+@[^@\s]+\.[^@\s]+$", re.UNICODE)


def validate_email_format(email) -> bool:
    return isinstance(email, str) and bool(UNICODE_EMAIL_REGEX.match(email))


def validate_phone_format(phone) -> bool:
    """10 digits (reference employee.py:114,377 error text)."""
    return isinstance(phone, str) and bool(re.fullmatch(r"\d{10}", phone))


def _coerce_company(company_id):
    """Company ids are stored as ObjectId by the doc builders but arrive as
    strings; match either (the reference is inconsistent — register queries
    ObjectId (employee.py:156) while update queries the raw string
    (employee.py:382), a latent bug we paper over by matching both)."""
    if isinstance(company_id, ObjectId):
        return {"$in": [company_id, str(company_id)]}
    if isinstance(company_id, str) and ObjectId.is_valid(company_id):
        return {"$in": [ObjectId(company_id), company_id]}
    return company_id


def company_query(company_id, **extra) -> dict:
    q = {"companyId": _coerce_company(company_id)}
    q.update(extra)
    return q


def is_unique_email(collection, company_id, email, exclude_employee_id=None) -> bool:
    q = company_query(company_id, employeeEmail=email)
    if exclude_employee_id:
        q["employeeId"] = {"$ne": exclude_employee_id}
    return collection.find_one(q) is None


def is_unique_phone(collection, company_id, phone, exclude_employee_id=None) -> bool:
    q = company_query(company_id, employeeMobile=phone)
    if exclude_employee_id:
        q["employeeId"] = {"$ne": exclude_employee_id}
    return collection.find_one(q) is None


def fill_employee_fields(employee: dict) -> dict:
    """Shape an employee doc for list responses (employee.py:257): all the
    business fields, with ids stringified and GridFS dicts omitted (URLs are
    added by the caller when requested)."""
    out = {
        "employeeId": employee.get("employeeId"),
        "employeeName": employee.get("employeeName"),
        "companyId": str(employee.get("companyId")),
        "status": employee.get("status"),
        "blacklisted": employee.get("blacklisted", False),
        "registrationDate": format_datetime(employee.get("registrationDate")),
        "lastUpdated": format_datetime(employee.get("lastUpdated")),
    }
    for key in ("gender", "joiningDate", "employeeEmail", "employeeMobile",
                "employeeDesignation", "employeeReportingId"):
        if key in employee:
            val = employee[key]
            out[key] = format_datetime(val) if key == "joiningDate" else val
    if "_id" in employee:
        out["_id"] = str(employee["_id"])
    return out


def update_embedding_status(collection, query: dict, model: str, status: str,
                            extra: dict | None = None) -> None:
    """Set employeeEmbeddings.<model>.status (+fields) on a person doc —
    the status transitions the worker drives (trainingServer.py:279-295)."""
    fields = {f"employeeEmbeddings.{model}.status": status,
              "lastUpdated": get_current_utc()}
    for k, v in (extra or {}).items():
        fields[f"employeeEmbeddings.{model}.{k}"] = v
    collection.update_one(query, {"$set": fields})


def to_object_id(value):
    """Coerce to ObjectId, passing through existing ones."""
    return value if isinstance(value, ObjectId) else ObjectId(str(value))
