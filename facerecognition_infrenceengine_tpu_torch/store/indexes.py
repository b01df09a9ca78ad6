"""Index creation and template seeding.

Mirrors the reference's startup behavior: per-collection single-field
indexes (reference db/__init__.py:42-83) and idempotent, version-aware
seeding of the two built-in entity templates (reference
db/seed_templates.py:163-207).  The template *data* — entity types,
required attributes, allowed values, code regexes, relationship
cardinality — is a wire-format contract consumed by the entity API and the
frontend, so it is reproduced field-for-field.
"""

from __future__ import annotations

import datetime

from .client import Datastore

INDEX_SPEC = {
    # collection attr -> indexed fields (reference db/__init__.py:42-83)
    "entities": ["companyId", "parentId", "path", "type"],
    "employee_info": ["companyId", "employeeId", "email", "phone"],
    "visitors": ["companyId", "visitorId", "email", "phone"],
    "visits": ["companyId", "visitorId", "employeeId", "visitDate", "status"],
    "entity_templates": ["type", "status"],
    "entity_definitions": ["companyId", "status"],
    "embedding_jobs": ["status", "createdAt", "companyId", "employeeId", "visitorId"],
}


def _entity_type(description, required, allowed=None, designation=None):
    out = {"description": description, "requiredAttributes": required,
           "allowedValues": allowed or {}}
    if designation:
        out["designation"] = designation
    return out


def _rel(parent, child, cardinality=None, max_children=None):
    out = {"parentType": parent, "childType": child}
    if cardinality:
        out["cardinality"] = cardinality
    if max_children is not None:
        out["constraints"] = {"maxChildren": max_children}
    return out


def default_templates() -> list:
    manufacturing = {
        "name": "Manufacturing Plant",
        "type": "manufacturing",
        "description": "Standard template for manufacturing facilities with "
                       "plants, lines, and workstations",
        "version": "1.0",
        "structure": {
            "entityTypes": {
                "business_unit": _entity_type(
                    "Business Unit", ["buCode"],
                    {"type": ["production", "sales", "rd"]}, "BU_HEAD"),
                "plant": _entity_type(
                    "Manufacturing plant facility", ["location", "plantCode"],
                    {"type": ["production", "assembly", "warehouse"]}, "PLANT_HEAD"),
                "department": _entity_type(
                    "Department within plant", ["departmentCode"],
                    {"category": ["production", "quality", "maintenance", "logistics"]},
                    "DEPT_HEAD"),
                "line": _entity_type(
                    "Production or assembly line", ["lineCode", "capacity"],
                    None, "LINE_SUPERVISOR"),
                "workstation": _entity_type(
                    "Individual workstation or machine", ["stationCode", "status"],
                    {"status": ["active", "inactive", "maintenance"]},
                    "STATION_OPERATOR"),
            },
            "defaultAttributes": {
                "business_unit": ["buCode", "type", "region", "revenue_target"],
                "plant": ["location", "plantCode", "type", "capacity", "operatingHours"],
                "department": ["departmentCode", "category", "shift"],
                "line": ["lineCode", "capacity", "product", "cycleTime"],
                "workstation": ["stationCode", "status", "efficiency"],
            },
            "defaultValidations": {
                "buCode": "^BU\\d{3}$",
                "plantCode": "^PLT\\d{3}$",
                "departmentCode": "^DEP\\d{3}$",
                "lineCode": "^LN\\d{3}$",
                "stationCode": "^WS\\d{3}$",
            },
        },
        "relationships": [
            _rel("business_unit", "plant", cardinality="one_to_many"),
            _rel("plant", "department", cardinality="one_to_many"),
            _rel("department", "line", cardinality="one_to_many"),
            _rel("line", "workstation", cardinality="one_to_many"),
        ],
    }
    office = {
        "name": "Office Building",
        "type": "office",
        "description": "Template for office buildings with floors, zones, "
                       "and workspaces",
        "version": "1.0",
        "structure": {
            "entityTypes": {
                "building": _entity_type(
                    "Office building", ["buildingCode", "address"],
                    {"type": ["corporate", "regional", "branch"]}),
                "floor": _entity_type("Building floor", ["floorNumber"]),
                "zone": _entity_type(
                    "Floor zone or area", ["zoneCode", "purpose"],
                    {"purpose": ["workspace", "meeting", "utility", "recreation"]}),
                "workspace": _entity_type(
                    "Individual workspace or room", ["workspaceId", "type"],
                    {"type": ["desk", "office", "meeting_room", "utility_room"]}),
            },
            "defaultAttributes": {
                "building": ["buildingCode", "address", "type", "totalFloors", "capacity"],
                "floor": ["floorNumber", "capacity", "facilities"],
                "zone": ["zoneCode", "purpose", "area", "capacity"],
                "workspace": ["workspaceId", "type", "capacity", "equipment"],
            },
            "defaultValidations": {
                "buildingCode": "^BLD\\d{3}$",
                "floorNumber": "^\\d{1,2}$",
                "zoneCode": "^Z\\d{3}$",
                "workspaceId": "^WS\\d{4}$",
            },
        },
        "relationships": [
            _rel("building", "floor", max_children=50),
            _rel("floor", "zone", max_children=10),
            _rel("zone", "workspace", max_children=50),
        ],
    }
    return [manufacturing, office]


def seed_templates(ds: Datastore) -> int:
    """Insert/update built-in templates; returns number created."""
    now = datetime.datetime.now(datetime.timezone.utc)
    created = 0
    for template in default_templates():
        template = dict(template)
        template["status"] = "active"
        template["updatedAt"] = now
        existing = ds.entity_templates.find_one(
            {"name": template["name"], "type": template["type"]}
        )
        if existing is None:
            template["createdAt"] = now
            ds.entity_templates.insert_one(template)
            created += 1
        elif existing.get("version") != template["version"]:
            ds.entity_templates.update_one(
                {"_id": existing["_id"]},
                {"$set": {**template,
                          "previousVersion": existing.get("version"),
                          "updatedAt": now}},
            )
    return created


def init_db(ds: Datastore) -> None:
    """Create indexes + seed templates (reference db/__init__.py:38-117)."""
    for attr, fields in INDEX_SPEC.items():
        coll = getattr(ds, attr)
        for field in fields:
            coll.create_index([(field, 1)], background=True)
    seed_templates(ds)
