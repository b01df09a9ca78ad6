"""Company REST API.

Routes/fields per the reference blueprint (reference app/api/company.py,
citations inline).  Two deliberate deviations from reference bugs:

- the reference wraps its error helper as ``jsonify(error_response(...))``
  here but returns it directly elsewhere (inconsistent with the missing
  ``utils`` contract); we emit the same ``{"error": msg}`` JSON everywhere.
- ``/designations`` and ``/infrastructure`` update by ``{'companyId': id}``
  (reference company.py:168,179) although companies are keyed by ``_id`` —
  those endpoints could never match; we key by ``_id``.

The port's copy of ``facerecognition_infrenceengine_tpu/api/company.py``.
"""

from __future__ import annotations

import re

import datetime

from ..store.client import Datastore
from ..store.objectid import ObjectId
from ..web import Blueprint, jsonify, request
from .utils import error_response, get_current_utc, validate_required_fields


def build_company_doc(data: dict) -> dict:
    """reference company.py:22-44."""
    scheme = data.get("colorScheme", {}) or {}
    return {
        "companyName": data["companyName"],
        "createdAt": get_current_utc(),
        "lastUpdated": get_current_utc(),
        "status": data.get("status", "active"),
        "logo": data.get("logo", ""),
        "colorScheme": {
            "primary": scheme.get("primary", "#000000"),
            "secondary": scheme.get("secondary", "#ffffff"),
            "accent": scheme.get("accent", "#cccccc"),
            "background": scheme.get("background", "#f0f0f0"),
            "text": scheme.get("text", "#333333"),
        },
        "hqAddress": data.get("hqAddress", ""),
        "hqEmail": data.get("hqEmail", ""),
        "website": data.get("website", ""),
        "phone": data.get("phone", ""),
        "designations": data.get("designations", []),
        "infrastructure": data.get("infrastructure", {}),
        "adminUsers": data.get("adminUsers", []),
    }


SEED_COMPANY = {
    # reference company.py:63-81 (the /seed fixture)
    "companyName": "Bhagwati Product Limited",
    "status": "active",
    "logo": "https://example.com/logo.png",
    "colorScheme": {"primary": "#0000ff", "secondary": "#ffffff",
                    "accent": "#cccccc", "background": "#f0f0f0",
                    "text": "#333333"},
    "hqAddress": "123 Main St, City, Country",
    "hqEmail": "hq@bhagwati.com",
    "website": "https://bhagwati.com",
    "phone": "1234567890",
    "designations": ["Manager", "Engineer"],
    "infrastructure": {"type": "Manufacturing"},
    "adminUsers": ["admin1", "admin2"],
}


def make_company_bp(ds: Datastore, cfg=None) -> Blueprint:
    bp = Blueprint("company")
    companies = ds.companies

    def _stringify(doc: dict) -> dict:
        doc["_id"] = str(doc["_id"])
        return doc

    @bp.route("", methods=["POST"])
    def create_company():
        # reference company.py:46-59
        data = request.get_json(silent=True) or {}
        ok, msg = validate_required_fields(data, ["companyName"])
        if not ok:
            return error_response(msg, 400)
        if companies.find_one({"companyName": data["companyName"]}):
            return error_response("Company name already exists.", 409)
        doc = build_company_doc(data)
        result = companies.insert_one(doc)
        doc["_id"] = str(result.inserted_id)
        return jsonify({"message": "Company created", "company": doc}), 201

    @bp.route("/seed", methods=["POST"])
    def seed_company():
        # reference company.py:61-95
        data = dict(SEED_COMPANY)
        existing = companies.find_one({"companyName": data["companyName"]})
        if existing:
            companies.update_one({"companyName": data["companyName"]},
                                 {"$set": data})
            doc = companies.find_one({"companyName": data["companyName"]})
            return jsonify({"message": "Company updated",
                            "company": _stringify(doc)}), 200
        doc = build_company_doc(data)
        result = companies.insert_one(doc)
        doc["_id"] = str(result.inserted_id)
        return jsonify({"message": "Company seeded", "company": doc}), 201

    @bp.route("", methods=["GET"])
    def list_companies():
        # reference company.py:97-114
        query = {}
        if request.args.get("name"):
            # literal substring search: unescaped metacharacters would 500
            query["companyName"] = {"$regex": re.escape(request.args["name"]),
                                    "$options": "i"}
        if request.args.get("status"):
            query["status"] = request.args["status"]
        out = [_stringify(c) for c in companies.find(query)]
        return jsonify({"companies": out}), 200

    @bp.route("/<company_id>", methods=["GET"])
    def get_company(company_id):
        # reference company.py:116-125
        if not ObjectId.is_valid(company_id):
            return error_response("Invalid company ID", 400)
        company = companies.find_one({"_id": ObjectId(company_id)})
        if not company:
            return error_response("Company not found", 404)
        return jsonify({"company": _stringify(company)}), 200

    @bp.route("/<company_id>", methods=["PATCH"])
    def update_company(company_id):
        # reference company.py:127-149
        if not ObjectId.is_valid(company_id):
            return error_response("Invalid company ID", 400)
        data = request.get_json(silent=True) or {}
        company = companies.find_one({"_id": ObjectId(company_id)})
        if not company:
            return error_response("Company not found", 404)
        allowed = ("companyName", "status", "logo", "colorScheme", "hqAddress",
                   "hqEmail", "website", "phone", "designations",
                   "infrastructure", "adminUsers")
        update_fields = {f: data[f] for f in allowed if f in data}
        if update_fields:
            update_fields["lastUpdated"] = get_current_utc()
            companies.update_one({"_id": ObjectId(company_id)},
                                 {"$set": update_fields})
        updated = companies.find_one({"_id": ObjectId(company_id)})
        return jsonify({"message": "Company updated",
                        "company": _stringify(updated)}), 200

    @bp.route("/<company_id>", methods=["DELETE"])
    def delete_company(company_id):
        # reference company.py:151-160, admin-token stub :12-19
        if not request.headers.get("X-Admin-Token"):
            return error_response("Admin privileges required", 401)
        if not ObjectId.is_valid(company_id):
            return error_response("Invalid company ID", 400)
        result = companies.delete_one({"_id": ObjectId(company_id)})
        if result.deleted_count == 0:
            return error_response("Company not found", 404)
        return jsonify({"message": "Company deleted successfully"}), 200

    @bp.route("/<company_id>/designations", methods=["POST"])
    def update_designations(company_id):
        # reference company.py:162-171 (keyed by _id here; see module doc)
        data = request.get_json(silent=True) or {}
        designations = data.get("designations")
        if not isinstance(designations, list):
            return error_response("Designations must be a list", 400)
        if not ObjectId.is_valid(company_id):
            return error_response("Invalid company ID", 400)
        result = companies.update_one(
            {"_id": ObjectId(company_id)},
            {"$set": {"designations": designations,
                      "lastUpdated": get_current_utc()}})
        if result.matched_count == 0:
            return error_response("Company not found", 404)
        return jsonify({"message": "Designations updated",
                        "designations": designations}), 200

    @bp.route("/<company_id>/infrastructure", methods=["POST"])
    def update_infrastructure(company_id):
        # reference company.py:173-182 (keyed by _id here; see module doc)
        data = request.get_json(silent=True) or {}
        infrastructure = data.get("infrastructure")
        if not isinstance(infrastructure, dict):
            return error_response("Infrastructure must be a dict", 400)
        if not ObjectId.is_valid(company_id):
            return error_response("Invalid company ID", 400)
        result = companies.update_one(
            {"_id": ObjectId(company_id)},
            {"$set": {"infrastructure": infrastructure,
                      "lastUpdated": get_current_utc()}})
        if result.matched_count == 0:
            return error_response("Company not found", 404)
        return jsonify({"message": "Infrastructure updated",
                        "infrastructure": infrastructure}), 200

    return bp
