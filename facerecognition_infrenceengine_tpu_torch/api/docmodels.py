"""Mongo document builders.

Re-implementation of the reference's ``app/models/models.py`` contracts
(field names/defaults cited per builder).  The reference file has a latent
bug — it calls ``parse_datetime`` without importing it (reference
app/models/models.py:19) — fixed here by construction.

The port's copy of ``facerecognition_infrenceengine_tpu/api/docmodels.py``.
"""

from __future__ import annotations

from ..store.objectid import ObjectId
from .utils import get_current_utc, parse_datetime


def build_employee_doc(data: dict, image_dict: dict, embeddings_dict: dict) -> dict:
    """reference app/models/models.py:5-24."""
    doc = {
        "employeeId": data["employeeId"],
        "employeeName": data["employeeName"],
        "companyId": ObjectId(data["companyId"]),
        "employeeImages": image_dict,
        "employeeEmbeddings": embeddings_dict,
        "lastUpdated": get_current_utc(),
        "status": data.get("status", "active"),
        "registrationDate": get_current_utc(),
        "blacklisted": data.get("blacklisted", False),
    }
    if data.get("gender"):
        doc["gender"] = data["gender"]
    if data.get("joiningDate"):
        doc["joiningDate"] = parse_datetime(data["joiningDate"])
    for key in ("employeeEmail", "employeeMobile", "employeeDesignation",
                "employeeReportingId"):
        if data.get(key):
            doc[key] = data[key]
    return doc


def build_embedding_entry(embedding_id, corrupt: bool = False) -> dict:
    """reference app/models/models.py:26-33."""
    now = get_current_utc()
    return {"embeddingId": embedding_id, "createdAt": now, "updatedAt": now,
            "corrupt": corrupt}


def build_visitor_doc(data: dict, image_dict: dict, embeddings_dict: dict,
                      document_dict: dict | None = None) -> dict:
    """reference app/models/models.py:35-58."""
    return {
        "visitorName": data["visitorName"],
        "companyId": ObjectId(data["companyId"]),
        "visitorImages": image_dict,
        "visitorEmbeddings": embeddings_dict,
        "visitorDocuments": document_dict or {},
        "lastUpdated": get_current_utc(),
        "status": data.get("status", "active"),
        "registrationDate": get_current_utc(),
        "visitorType": data.get("visitorType", "individual"),
        "idType": data.get("idType"),
        "idNumber": data.get("idNumber"),
        "phone": data.get("phone"),
        "email": data.get("email"),
        "organization": data.get("organization"),
        "purpose": data.get("purpose"),
        "hostEmployeeId": ObjectId(data["hostEmployeeId"]) if data.get("hostEmployeeId") else None,
        "expectedArrival": parse_datetime(data["expectedArrival"]) if data.get("expectedArrival") else None,
        "expectedDeparture": parse_datetime(data["expectedDeparture"]) if data.get("expectedDeparture") else None,
        "blacklisted": data.get("blacklisted", False),
        "visits": [],
    }


def build_visit_doc(visitor_id, company_id, host_employee_id, purpose,
                    expected_arrival, expected_departure, approved=False) -> dict:
    """reference app/models/models.py:60-80."""
    return {
        "visitorId": visitor_id,
        "companyId": ObjectId(company_id),
        "hostEmployeeId": host_employee_id,
        "purpose": purpose,
        "status": "scheduled",
        "expectedArrival": expected_arrival,
        "expectedDeparture": expected_departure,
        "actualArrival": None,
        "actualDeparture": None,
        "checkInMethod": None,
        "checkOutMethod": None,
        "createdAt": get_current_utc(),
        "lastUpdated": get_current_utc(),
        "qrCode": None,
        "accessAreas": [],
        "notes": [],
        "visitType": "single",
        "approvedByHost": bool(approved),
    }


def build_entity_definition_doc(data: dict) -> dict:
    """reference app/models/models.py:82-112."""
    if not isinstance(data.get("structure"), dict):
        raise ValueError("Entity definition structure must be a dictionary")
    if "relationships" not in data or not isinstance(data["relationships"], list):
        raise ValueError("Entity definition must include valid relationships array")
    for rel in data["relationships"]:
        if not all(k in rel for k in ("parentType", "childType", "cardinality")):
            raise ValueError(
                "Each relationship must specify parentType, childType, and cardinality"
            )
    return {
        "companyId": ObjectId(data["companyId"]),
        "name": data["name"],
        "description": data.get("description", ""),
        "structure": {
            "entityTypes": data["structure"].get("entityTypes", {}),
            "allowedAttributes": data["structure"].get("allowedAttributes", {}),
            "validations": data["structure"].get("validations", {}),
        },
        "relationships": data["relationships"],
        "status": data.get("status", "active"),
        "templateRef": ObjectId(data["templateRef"]) if data.get("templateRef") else None,
        "createdAt": get_current_utc(),
        "updatedAt": get_current_utc(),
        "version": data.get("version", "1.0"),
    }


def build_entity_doc(data: dict) -> dict:
    """reference app/models/models.py:114-135."""
    return {
        "name": data["name"],
        "type": data["type"],
        "definitionId": ObjectId(data["definitionId"]),
        "companyId": ObjectId(data["companyId"]),
        "parentId": ObjectId(data["parentId"]) if data.get("parentId") else None,
        "path": data.get("path", []),
        "attributes": data.get("attributes", {}),
        "manager": {"employeeId": None, "assignedAt": None, "status": "vacant"},
        "metadata": data.get("metadata", {}),
        "tags": data.get("tags", []),
        "status": data.get("status", "active"),
        "createdAt": get_current_utc(),
        "updatedAt": get_current_utc(),
    }


def build_asset_doc(data: dict, asset_type: str) -> dict:
    """reference app/models/models.py:137-149."""
    return {
        "name": data["name"],
        "type": asset_type,
        "entityId": ObjectId(data["entityId"]),
        "orgId": ObjectId(data["orgId"]),
        "metadata": data.get("metadata", {}),
        "createdAt": get_current_utc(),
        "updatedAt": get_current_utc(),
        "status": data.get("status", "active"),
    }


def build_entity_template_doc(data: dict) -> dict:
    """reference app/models/models.py:151-169."""
    return {
        "name": data["name"],
        "description": data.get("description", ""),
        "type": data["type"],
        "structure": {
            "entityTypes": data["structure"]["entityTypes"],
            "defaultAttributes": data["structure"].get("defaultAttributes", {}),
            "defaultValidations": data["structure"].get("defaultValidations", {}),
        },
        "relationships": data["relationships"],
        "metadata": data.get("metadata", {}),
        "createdAt": get_current_utc(),
        "updatedAt": get_current_utc(),
        "version": data.get("version", "1.0"),
        "status": data.get("status", "active"),
    }


def build_entity_clone_doc(template_entity: dict, company_id, parent_id=None,
                           name_prefix: str = "") -> dict:
    """reference app/models/models.py:171-185."""
    return {
        "name": (name_prefix + template_entity["name"]) if name_prefix else template_entity["name"],
        "type": template_entity["type"],
        "companyId": ObjectId(company_id),
        "parentId": ObjectId(parent_id) if parent_id else None,
        "metadata": template_entity.get("metadata", {}),
        "tags": template_entity.get("tags", []),
        "createdAt": get_current_utc(),
        "updatedAt": get_current_utc(),
        "templateRef": template_entity.get("_id"),
        "path": [],
    }
