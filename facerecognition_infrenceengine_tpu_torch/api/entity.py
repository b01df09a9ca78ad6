"""Entity-hierarchy REST API (org-modeling engine).

Same surface as the reference blueprint (reference app/api/entity.py;
citations inline): entity definitions (custom + from template), entities as
a materialized-path tree (create/update/children/descendants/ancestors/
move/recursive delete), assets linking employees to entities, manager
assignment (writes the definition's designation back onto the employee),
employee search/reportees/reporting-tree, Cytoscape graph elements, and
template read/clone.

Wire-format note: the reference returns entity reads through bson
``json_util`` (reference entity.py:770-772), i.e. MongoDB extended JSON —
ObjectIds as ``{"$oid": ...}`` and datetimes as ``{"$date": epoch_ms}``.
``_extended_json`` reproduces that for the endpoints that used it, so the
frontend's parsers keep working.

The port's copy of ``facerecognition_infrenceengine_tpu/api/entity.py``.
"""

from __future__ import annotations

import datetime
import re

from ..core.config import Config
from ..store.client import Datastore
from ..store.objectid import ObjectId
from ..web import Blueprint, jsonify, request
from .docmodels import build_asset_doc, build_entity_definition_doc, build_entity_doc
from .utils import get_current_utc


def _extended_json(value):
    """bson json_util-style encoding (legacy $date as epoch millis)."""
    if isinstance(value, ObjectId):
        return {"$oid": str(value)}
    if isinstance(value, datetime.datetime):
        epoch = datetime.datetime(1970, 1, 1, tzinfo=value.tzinfo) if value.tzinfo \
            else datetime.datetime(1970, 1, 1)
        return {"$date": int((value - epoch).total_seconds() * 1000)}
    if isinstance(value, dict):
        return {k: _extended_json(v) for k, v in value.items()}
    if isinstance(value, list):
        return [_extended_json(v) for v in value]
    return value


def validate_entity_name(name) -> bool:
    """reference entity.py:25-31."""
    return isinstance(name, str) and 0 < len(name.strip()) and len(name) <= 100


def make_entity_bp(ds: Datastore, cfg: Config | None = None) -> Blueprint:
    bp = Blueprint("entity")

    entities = ds.entities
    assets = ds.assets
    employees = ds.employee_info
    companies = ds.companies
    templates = ds.entity_templates
    definitions = ds.entity_definitions

    def company_exists(company_id) -> bool:
        # reference entity.py:33-40
        try:
            oid = ObjectId(company_id) if isinstance(company_id, str) else company_id
        except Exception:
            return False
        return companies.find_one({"_id": oid}) is not None

    def validate_entity_against_definition(entity_data, definition,
                                           exclude_id=None):
        # reference entity.py:43-87; exclude_id keeps an UPDATE of an
        # existing child from counting itself against maxChildren
        entity_type = entity_data["type"]
        etypes = definition["structure"]["entityTypes"]
        if entity_type not in etypes:
            return False, f"Entity type '{entity_type}' not allowed in definition"
        for attr in etypes.get(entity_type, {}).get("requiredAttributes", []):
            if attr not in entity_data.get("attributes", {}):
                return False, (f"Required attribute '{attr}' missing for type "
                               f"'{entity_type}'")
        allowed = etypes.get(entity_type, {}).get("allowedValues", {})
        for attr, value in entity_data.get("attributes", {}).items():
            if attr in allowed and value not in allowed[attr]:
                return False, (f"Invalid value for attribute '{attr}': must be "
                               f"one of {allowed[attr]}")
        # Regex validations: the reference stores structure.validations /
        # defaultValidations but never applies them (reference
        # entity.py:43-87) — here the declared data model is enforced (e.g.
        # plantCode ^PLT\d{3}$ in the seeded templates, db/seed_templates.py).
        validations = {
            **definition["structure"].get("defaultValidations", {}),
            **definition["structure"].get("validations", {}),
            # per-type validations (what the definition editor writes and
            # template clones store per entity type, entity.py:666)
            **etypes.get(entity_type, {}).get("validations", {}),
        }
        for attr, pattern in validations.items():
            value = entity_data.get("attributes", {}).get(attr)
            if value is None:
                continue
            try:
                matches = re.fullmatch(pattern, str(value)) is not None
            except re.error:
                continue  # malformed pattern in the definition: skip, not 500
            if not matches:
                return False, (f"Attribute '{attr}' value {value!r} does not "
                               f"match validation pattern {pattern!r}")
        if entity_data.get("parentId"):
            parent = entities.find_one({"_id": ObjectId(str(entity_data["parentId"]))})
            if not parent:
                return False, "Parent entity not found"
            for rel in definition["relationships"]:
                if (rel["parentType"] == parent["type"]
                        and rel["childType"] == entity_type):
                    max_children = rel.get("constraints", {}).get("maxChildren")
                    if max_children:
                        count_query = {"parentId": parent["_id"],
                                       "type": entity_type}
                        if exclude_id is not None:
                            count_query["_id"] = {"$ne": ObjectId(str(exclude_id))}
                        count = entities.count_documents(count_query)
                        if count >= max_children:
                            return False, (f"Maximum number of {entity_type} "
                                           f"children reached for this "
                                           f"{parent['type']}")
                    break
            else:
                return False, (f"Invalid parent-child relationship: "
                               f"{parent['type']} -> {entity_type}")
        return True, None

    def company_context_error(entity_id=None, employee_id=None):
        """reference entity.py:915-950 (decorator re-expressed as a check)."""
        company_id = request.args.get("companyId")
        if not company_id and request.is_json:
            company_id = (request.get_json(silent=True) or {}).get("companyId")
        if not company_id:
            return None, (jsonify({"error": "Company ID is required"}), 400)
        if entity_id:
            try:
                entity = entities.find_one({"_id": ObjectId(entity_id)})
            except Exception:
                entity = None
            if not entity:
                return None, (jsonify({"error": "Entity not found"}), 404)
            if str(entity["companyId"]) != str(company_id):
                return None, (jsonify({"error": "Access denied: Entity does not "
                                                "belong to the company"}), 403)
        if employee_id:
            emp = employees.find_one({"employeeId": employee_id,
                                      "companyId": ObjectId(company_id)})
            if not emp:
                return None, (jsonify({"error": "Access denied: Employee not "
                                                "found in company"}), 403)
        return company_id, None

    # ------------------------------------------------- entity definitions
    @bp.route("/entity-definitions", methods=["POST"])
    def create_entity_definition():
        # reference entity.py:89-116
        data = request.get_json(silent=True)
        if not data:
            return jsonify({"error": "No data provided"}), 400
        required = ["name", "companyId", "structure", "relationships"]
        if not all(f in data for f in required):
            return jsonify({"error": f"Missing required fields: {required}"}), 400
        if not company_exists(data["companyId"]):
            return jsonify({"error": "Invalid company ID"}), 404
        try:
            doc = build_entity_definition_doc(data)
        except ValueError as e:
            return jsonify({"error": f"Failed to create entity definition: {e}"}), 500
        result = definitions.insert_one(doc)
        return jsonify({"id": str(result.inserted_id),
                        "message": "Entity definition created successfully"}), 201

    @bp.route("/entity-definitions/<definition_id>", methods=["GET"])
    def get_entity_definition(definition_id):
        # reference entity.py:118-136
        try:
            definition = definitions.find_one({"_id": ObjectId(definition_id)})
        except Exception:
            definition = None
        if not definition:
            return jsonify({"error": "Entity definition not found"}), 404
        definition["_id"] = str(definition["_id"])
        definition["companyId"] = str(definition["companyId"])
        if definition.get("templateRef"):
            definition["templateRef"] = str(definition["templateRef"])
        return jsonify(definition)

    @bp.route("/entity-definitions", methods=["GET"])
    def get_entity_definitions():
        # reference entity.py:138-165
        company_id = request.args.get("companyId")
        if not company_id:
            return jsonify({"error": "companyId is required"}), 400
        if not company_exists(company_id):
            return jsonify({"error": "Invalid company ID"}), 404
        out = []
        for definition in definitions.find({"companyId": ObjectId(company_id),
                                            "status": "active"}):
            definition["_id"] = str(definition["_id"])
            definition["companyId"] = str(definition["companyId"])
            if definition.get("templateRef"):
                definition["templateRef"] = str(definition["templateRef"])
            out.append(definition)
        return jsonify(out)

    @bp.route("/entity-definitions/<definition_id>", methods=["PUT"])
    def update_entity_definition(definition_id):
        # reference entity.py:167-193
        data = request.get_json(silent=True)
        if not data:
            return jsonify({"error": "No data provided"}), 400
        try:
            existing = definitions.find_one({"_id": ObjectId(definition_id)})
        except Exception:
            existing = None
        if not existing:
            return jsonify({"error": "Entity definition not found"}), 404
        data = dict(data)
        data.pop("_id", None)
        if "companyId" in data:
            data["companyId"] = ObjectId(str(data["companyId"]))
        data["updatedAt"] = get_current_utc()
        result = definitions.update_one({"_id": ObjectId(definition_id)},
                                        {"$set": data})
        return jsonify({"message": "Entity definition updated successfully",
                        "modified": result.modified_count > 0})

    @bp.route("/entity-definitions/from-template", methods=["POST"])
    def create_definition_from_template():
        # reference entity.py:612-658
        data = request.get_json(silent=True)
        if not data:
            return jsonify({"error": "No data provided"}), 400
        required = ["templateId", "companyId", "name"]
        if not all(f in data for f in required):
            return jsonify({"error": f"Missing required fields: {required}"}), 400
        if not company_exists(data["companyId"]):
            return jsonify({"error": "Invalid company ID"}), 404
        try:
            template = templates.find_one({"_id": ObjectId(data["templateId"])})
        except Exception:
            template = None
        if not template:
            return jsonify({"error": "Template not found"}), 404
        doc = {
            "name": data["name"],
            "companyId": ObjectId(data["companyId"]),
            "templateRef": template["_id"],
            "description": data.get("description", template.get("description", "")),
            "structure": data.get("structure", template["structure"]),
            "relationships": data.get("relationships", template["relationships"]),
            "status": "active",
            "createdAt": get_current_utc(),
            "updatedAt": get_current_utc(),
            "version": template.get("version", "1.0"),
            "customizations": data.get("customizations", {}),
        }
        result = definitions.insert_one(doc)
        return jsonify({
            "id": str(result.inserted_id),
            "message": "Entity definition created from template successfully"}), 201

    # ------------------------------------------------------------ entities
    @bp.route("/entities", methods=["POST"])
    def create_entity():
        # reference entity.py:195-253
        data = request.get_json(silent=True)
        if not data:
            return jsonify({"error": "No data provided"}), 400
        required = ["name", "type", "companyId", "definitionId"]
        if not all(f in data for f in required):
            return jsonify({"error": f"Missing required fields: {required}"}), 400
        if not validate_entity_name(data["name"]):
            return jsonify({"error": "Invalid entity name. Must be non-empty "
                                     "string with max length 100"}), 400
        if not company_exists(data["companyId"]):
            return jsonify({"error": "Invalid company ID"}), 404
        try:
            definition = definitions.find_one({"_id": ObjectId(data["definitionId"]),
                                               "status": "active"})
        except Exception:
            definition = None
        if not definition:
            return jsonify({"error": "Entity definition not found or inactive"}), 404
        ok, err = validate_entity_against_definition(data, definition)
        if not ok:
            return jsonify({"error": f"Entity validation failed: {err}"}), 400
        if data.get("parentId"):
            try:
                parent = entities.find_one({"_id": ObjectId(data["parentId"])})
            except Exception as e:
                return jsonify({"error": f"Invalid parentId: {e}"}), 400
            if not parent:
                return jsonify({"error": "Parent entity not found"}), 404
            if str(parent["companyId"]) != data["companyId"]:
                return jsonify({"error": "Parent entity must belong to the same "
                                         "company"}), 400
            data["path"] = parent["path"] + [parent["_id"]]
        else:
            data["path"] = []
        result = entities.insert_one(build_entity_doc(data))
        return jsonify({"id": str(result.inserted_id),
                        "message": "Entity created successfully"}), 201

    @bp.route("/entities/<entity_id>", methods=["PUT"])
    def update_entity(entity_id):
        # reference entity.py:255-297
        data = request.get_json(silent=True)
        if not data:
            return jsonify({"error": "No data provided"}), 400
        try:
            existing = entities.find_one({"_id": ObjectId(entity_id)})
        except Exception:
            existing = None
        if not existing:
            return jsonify({"error": "Entity not found"}), 404
        definition = definitions.find_one({"_id": existing["definitionId"],
                                           "status": "active"})
        if not definition:
            return jsonify({"error": "Entity definition not found or inactive"}), 404
        merged = {**existing, **data}
        ok, err = validate_entity_against_definition(merged, definition,
                                                     exclude_id=existing["_id"])
        if not ok:
            return jsonify({"error": f"Entity validation failed: {err}"}), 400
        data = dict(data)
        data.pop("_id", None)
        data.pop("path", None)  # materialized path is derived, never client-set
        if "companyId" in data:
            # coerce to ObjectId (like definition updates do): the store
            # deliberately never matches str against ObjectId, so a string
            # companyId would silently detach the entity from every
            # tenant-scoped query
            if not ObjectId.is_valid(str(data["companyId"])):
                return jsonify({"error": "Invalid companyId format"}), 400
            data["companyId"] = ObjectId(str(data["companyId"]))
        if "parentId" in data:
            # Re-parenting changes the materialized path of the whole
            # subtree — same rules and rewriting as /entities/<id>/move
            # (a verbatim $set would corrupt descendants/ancestors/delete).
            new_parent_id = data.pop("parentId")
            move_err = _reparent(existing, new_parent_id)
            if move_err is not None:
                return move_err
        data["updatedAt"] = get_current_utc()
        result = entities.update_one({"_id": ObjectId(entity_id)}, {"$set": data})
        return jsonify({"message": "Entity updated successfully",
                        "modified": result.modified_count > 0})

    def _reparent(entity, new_parent_id):
        """Shared re-parent: validates and rewrites the subtree's paths.
        Returns an error response tuple, or None on success."""
        if new_parent_id is None:
            new_parent, new_path = None, []
        else:
            try:
                new_parent = entities.find_one({"_id": ObjectId(str(new_parent_id))})
            except Exception:
                new_parent = None
            if not new_parent:
                return jsonify({"error": "New parent entity not found"}), 404
            if entity["_id"] == new_parent["_id"]:
                return jsonify({"error": "Cannot move entity under itself"}), 400
            if entity["_id"] in new_parent["path"]:
                return jsonify({"error": "Cannot move entity to its own "
                                         "descendant"}), 400
            new_path = new_parent["path"] + [new_parent["_id"]]
        old_path = entity["path"]
        entities.update_one({"_id": entity["_id"]}, {"$set": {
            "parentId": new_parent["_id"] if new_parent else None,
            "path": new_path, "updatedAt": get_current_utc()}})
        for desc in entities.find({"path": entity["_id"]}):
            new_desc_path = new_path + desc["path"][len(old_path):]
            entities.update_one({"_id": desc["_id"]}, {"$set": {
                "path": new_desc_path, "updatedAt": get_current_utc()}})
        return None

    @bp.route("/entities", methods=["GET"])
    def get_entities():
        # reference entity.py:314-337 (extended-JSON response, :770-772)
        company_id = request.args.get("companyId")
        if not company_id:
            return jsonify({"error": "companyId is required"}), 400
        try:
            oid = ObjectId(company_id)
        except Exception as e:
            return jsonify({"error": f"Invalid company ID format: {e}"}), 400
        if not companies.find_one({"_id": oid}):
            return jsonify({"error": "Company not found"}), 404
        return jsonify(_extended_json(list(entities.find({"companyId": oid}))))

    @bp.route("/entities/templates", methods=["GET"])
    def get_entity_templates():
        # reference entity.py:299-312
        out = []
        for template in templates.find({"status": "active"}):
            template["_id"] = str(template["_id"])
            out.append(template)
        return jsonify(_extended_json(out))

    @bp.route("/entities/<entity_id>", methods=["GET"])
    def get_entity(entity_id):
        # reference entity.py:408-416
        try:
            entity = entities.find_one({"_id": ObjectId(entity_id)})
        except Exception:
            entity = None
        if not entity:
            return jsonify({"error": "Entity not found"}), 404
        return jsonify(_extended_json(entity))

    @bp.route("/entities/<entity_id>/children", methods=["GET"])
    def get_children(entity_id):
        # reference entity.py:418-427
        query = {"parentId": ObjectId(entity_id)}
        if request.args.get("type"):
            query["type"] = request.args["type"]
        return jsonify(_extended_json(list(entities.find(query))))

    @bp.route("/entities/<entity_id>/descendants", methods=["GET"])
    def get_descendants(entity_id):
        # reference entity.py:429-432
        return jsonify(_extended_json(
            list(entities.find({"path": ObjectId(entity_id)}))))

    @bp.route("/entities/<entity_id>/ancestors", methods=["GET"])
    def get_ancestors(entity_id):
        # reference entity.py:434-441
        try:
            entity = entities.find_one({"_id": ObjectId(entity_id)})
        except Exception:
            entity = None
        if not entity:
            return jsonify({"error": "Entity not found"}), 404
        return jsonify(_extended_json(
            list(entities.find({"_id": {"$in": entity["path"]}}))))

    @bp.route("/entities/<entity_id>", methods=["DELETE"])
    def delete_entity(entity_id):
        # reference entity.py:443-457 (recursive delete + asset cleanup)
        try:
            oid = ObjectId(entity_id)
        except Exception:
            return jsonify({"error": "Invalid entity ID"}), 400
        entities.delete_many({"$or": [{"_id": oid}, {"path": oid}]})
        assets.delete_many({"entityId": oid})
        return jsonify({"success": True})

    @bp.route("/entities/<entity_id>/move", methods=["POST"])
    def move_entity(entity_id):
        # reference entity.py:556-610 (path rewriting for the subtree)
        data = request.get_json(silent=True)
        if not data or "newParentId" not in data:
            return jsonify({"error": "New parent ID is required"}), 400
        try:
            entity = entities.find_one({"_id": ObjectId(entity_id)})
        except Exception:
            return jsonify({"error": "Invalid entity ID"}), 400
        if not entity:
            return jsonify({"error": "Entity not found"}), 404
        err = _reparent(entity, data["newParentId"])
        if err is not None:
            return err
        return jsonify({"message": "Entity moved successfully"})

    # -------------------------------------------------------------- assets
    @bp.route("/assets", methods=["POST"])
    def create_asset():
        # reference entity.py:459-505
        data = request.get_json(silent=True)
        if not data:
            return jsonify({"error": "No data provided"}), 400
        required = ["name", "entityId"]
        if not all(f in data for f in required):
            return jsonify({"error": f"Missing required fields: {required}"}), 400
        try:
            entity = entities.find_one({"_id": ObjectId(data["entityId"])})
        except Exception as e:
            return jsonify({"error": f"Invalid entityId: {e}"}), 400
        if not entity:
            return jsonify({"error": "Entity not found"}), 404
        if entity.get("companyId") and not company_exists(str(entity["companyId"])):
            return jsonify({"error": "Invalid company access"}), 403
        # the reference reads entity['orgId'] which entities never carry
        # (entity.py:484 vs build_entity_doc) — use companyId as the org ref
        data["orgId"] = str(entity["companyId"])
        data.setdefault("metadata", {})
        if data.get("type") == "employee":
            employee = employees.find_one({"employeeId": data.get("employeeId"),
                                           "companyId": entity.get("companyId")})
            if not employee:
                return jsonify({"error": "Employee not found"}), 404
            data["metadata"]["employeeRef"] = str(employee["_id"])
            # the employee-listing/search endpoints key on
            # metadata.employeeId; the /entities/<id>/employees creation
            # path sets it, so this path must too or those endpoints
            # KeyError-500 on assets created here
            data["metadata"]["employeeId"] = data.get("employeeId")
        asset_doc = build_asset_doc(data, data.get("type", "generic"))
        result = assets.insert_one(asset_doc)
        return jsonify({"id": str(result.inserted_id),
                        "message": "Asset created successfully"}), 201

    @bp.route("/entities/<entity_id>/assets", methods=["GET"])
    def get_entity_assets(entity_id):
        # reference entity.py:507-552
        try:
            entity = entities.find_one({"_id": ObjectId(entity_id)})
        except Exception:
            entity = None
        if not entity:
            return jsonify({"error": "Entity not found"}), 404
        asset_type = request.args.get("type")
        include_emp = request.args.get(
            "include_employee_details", "false").lower() == "true"
        tree = list(entities.find({"$or": [{"_id": ObjectId(entity_id)},
                                           {"path": ObjectId(entity_id)}]}))
        entity_ids = [e["_id"] for e in tree]
        query = {"entityId": {"$in": entity_ids}}
        if asset_type:
            query["type"] = asset_type
        out = []
        for asset in assets.find(query):
            asset["_id"] = str(asset["_id"])
            asset["entityId"] = str(asset["entityId"])
            asset["orgId"] = str(asset.get("orgId"))
            if include_emp and asset.get("type") == "employee":
                ref = asset.get("metadata", {}).get("employeeRef")
                if ref:
                    employee = employees.find_one({"_id": ObjectId(ref)})
                    if employee:
                        employee["_id"] = str(employee["_id"])
                        employee["companyId"] = str(employee["companyId"])
                        employee.pop("employeeImages", None)
                        emb = employee.pop("employeeEmbeddings", None)
                        if emb is not None:
                            employee["employeeEmbeddings"] = _extended_json(emb)
                        asset["employeeDetails"] = _extended_json(employee)
            out.append(asset)
        return jsonify(out)

    @bp.route("/entities/<entity_id>/employees", methods=["POST"])
    def link_employee_to_entity(entity_id):
        # reference entity.py:339-406
        data = request.get_json(silent=True)
        if not data or "employeeId" not in data:
            return jsonify({"error": "Employee ID is required"}), 400
        try:
            entity = entities.find_one({"_id": ObjectId(entity_id)})
        except Exception:
            entity = None
        if not entity:
            return jsonify({"error": "Entity not found"}), 404
        employee = employees.find_one({"employeeId": data["employeeId"],
                                       "companyId": entity["companyId"]})
        if not employee:
            return jsonify({"error": "Employee not found or does not belong to "
                                     "the same company"}), 404
        existing_asset = assets.find_one({
            "type": "employee",
            "metadata.employeeId": employee["employeeId"],
            "orgId": entity["companyId"]})
        if existing_asset:
            assets.update_one({"_id": existing_asset["_id"]}, {"$set": {
                "entityId": ObjectId(entity_id),
                "updatedAt": get_current_utc()}})
            message = "Employee reassigned to new entity"
        else:
            asset_data = {
                "name": employee["employeeName"],
                "entityId": entity_id,
                "orgId": str(entity["companyId"]),
                "metadata": {
                    "employeeId": employee["employeeId"],
                    "employeeRef": str(employee["_id"]),
                    "designation": employee.get("employeeDesignation", ""),
                    "email": employee.get("employeeEmail", ""),
                    "mobile": employee.get("employeeMobile", ""),
                },
            }
            assets.insert_one(build_asset_doc(asset_data, "employee"))
            message = "Employee linked to entity"
        return jsonify({"message": message, "entityId": str(entity_id),
                        "employeeId": data["employeeId"]})

    # ------------------------------------------------------------- manager
    @bp.route("/entities/<entity_id>/manager", methods=["PUT"])
    def assign_manager(entity_id):
        # reference entity.py:777-843
        data = request.get_json(silent=True)
        if not data or "employeeId" not in data:
            return jsonify({"error": "employeeId is required"}), 400
        try:
            entity = entities.find_one({"_id": ObjectId(entity_id)})
        except Exception:
            entity = None
        if not entity:
            return jsonify({"error": "Entity not found"}), 404
        definition = definitions.find_one({"_id": entity["definitionId"]})
        if not definition:
            return jsonify({"error": "Entity definition not found"}), 404
        etype = entity["type"]
        designation = (definition["structure"]["entityTypes"]
                       .get(etype, {}).get("designation"))
        employee = employees.find_one({"employeeId": data["employeeId"],
                                       "companyId": entity["companyId"]})
        if not employee:
            return jsonify({"error": "Employee not found or does not belong to "
                                     "this company"}), 404
        emp_set = {"lastUpdated": get_current_utc()}  # employee schema's
        # timestamp field (fill_employee_fields/update/register), not the
        # entity schema's updatedAt
        if designation is not None:
            # a definition whose entityType carries no designation must not
            # erase the employee's existing one with None
            emp_set["employeeDesignation"] = designation
        employees.update_one({"_id": employee["_id"]}, {"$set": emp_set})
        result = entities.update_one({"_id": ObjectId(entity_id)}, {"$set": {
            "manager": {"employeeId": data["employeeId"],
                        "assignedAt": get_current_utc(), "status": "filled"},
            "updatedAt": get_current_utc()}})
        if result.modified_count == 0:
            return jsonify({"error": "Failed to update entity"}), 500
        return jsonify({"message": "Manager assigned successfully",
                        "entityId": str(entity_id), "designation": designation})

    @bp.route("/entities/<entity_id>/manager", methods=["DELETE"])
    def remove_manager(entity_id):
        # reference entity.py:845-877
        try:
            entity = entities.find_one({"_id": ObjectId(entity_id)})
        except Exception:
            entity = None
        if not entity:
            return jsonify({"error": "Entity not found"}), 404
        result = entities.update_one({"_id": ObjectId(entity_id)}, {"$set": {
            "manager": {"employeeId": None, "assignedAt": None,
                        "status": "vacant"},
            "updatedAt": get_current_utc()}})
        if result.modified_count == 0:
            return jsonify({"error": "Failed to remove manager"}), 500
        return jsonify({"message": "Manager removed successfully",
                        "entityId": str(entity_id)})

    @bp.route("/entities/<entity_id>/manager", methods=["GET"])
    def get_entity_manager(entity_id):
        # reference entity.py:879-911
        try:
            entity = entities.find_one({"_id": ObjectId(entity_id)})
        except Exception:
            entity = None
        if not entity:
            return jsonify({"error": "Entity not found"}), 404
        definition = definitions.find_one({"_id": entity["definitionId"]})
        if not definition:
            return jsonify({"error": "Entity definition not found"}), 404
        etype = entity["type"]
        designation = (definition["structure"]["entityTypes"]
                       .get(etype, {}).get("designation"))
        manager_info = entity.get("manager", {"status": "vacant"})
        if manager_info.get("employeeId"):
            # scope by company: employeeId is a business key, unique only
            # per company — an unscoped lookup can leak another tenant's doc
            employee = employees.find_one(
                {"employeeId": manager_info["employeeId"],
                 "companyId": entity["companyId"]})
            if employee:
                manager_info["employeeName"] = employee.get("employeeName")
                manager_info["employeeEmail"] = employee.get("employeeEmail")
        return jsonify(_extended_json({
            "entityId": str(entity_id), "entityType": etype,
            "designation": designation, "manager": manager_info}))

    # ----------------------------------------------------------- templates
    def generate_cytoscape_elements(template):
        # reference entity.py:660-697
        elements = []
        for etype, config in template["structure"].get("entityTypes", {}).items():
            elements.append({
                "data": {"id": etype, "label": etype, "type": "entity_type",
                         "description": config.get("description", ""),
                         "attributes": config.get("requiredAttributes", []),
                         "validations": config.get("validations", {})},
                "classes": ["entity-type"],
            })
        for rel in template.get("relationships", []):
            if "parentType" in rel and "childType" in rel:
                constraints = rel.get("constraints", {})
                elements.append({
                    "data": {
                        "id": f"{rel['parentType']}-{rel['childType']}",
                        "source": rel["parentType"],
                        "target": rel["childType"],
                        "label": (f"{constraints.get('minChildren', '0')}.."
                                  f"{constraints.get('maxChildren', '∞')}"),
                        "relationship": "parent-child",
                        "constraints": constraints,
                    },
                    "classes": ["relationship"],
                })
        return elements

    @bp.route("/entity-templates/<template_id>", methods=["GET"])
    def get_template(template_id):
        # reference entity.py:699-707
        try:
            template = templates.find_one({"_id": ObjectId(template_id)})
        except Exception:
            template = None
        if not template:
            return jsonify({"error": "Template not found"}), 404
        template["graphElements"] = generate_cytoscape_elements(template)
        return jsonify(_extended_json(template))

    @bp.route("/entity-templates", methods=["GET"])
    def get_templates():
        # reference entity.py:709-723
        out = []
        for template in templates.find({"status": "active"}):
            template["_id"] = str(template["_id"])
            template["graphElements"] = generate_cytoscape_elements(template)
            out.append(template)
        return jsonify(_extended_json(out))

    @bp.route("/entities/templates/<template_id>/clone", methods=["POST"])
    def clone_template(template_id):
        # reference entity.py:725-768
        data = request.get_json(silent=True)
        if not data:
            return jsonify({"error": "No data provided"}), 400
        required = ["name", "companyId"]
        if not all(f in data for f in required):
            return jsonify({"error": f"Missing required fields: {required}"}), 400
        try:
            template = templates.find_one({"_id": ObjectId(template_id)})
        except Exception:
            template = None
        if not template:
            return jsonify({"error": "Template not found"}), 404
        new_template = {**template,
                        "_id": ObjectId(),
                        "name": data["name"],
                        "companyId": ObjectId(data["companyId"]),
                        "clonedFrom": str(template["_id"]),
                        "createdAt": get_current_utc(),
                        "updatedAt": get_current_utc(),
                        "status": "active"}
        result = templates.insert_one(new_template)
        return jsonify({"id": str(result.inserted_id),
                        "message": "Template cloned successfully"}), 201

    # --------------------------------------------------- employee queries
    @bp.route("/entities/<entity_id>/employees", methods=["GET"])
    def get_entity_employees(entity_id):
        # reference entity.py:954-1031
        company_id, err = company_context_error(entity_id=entity_id)
        if err:
            return err
        entity = entities.find_one({"_id": ObjectId(entity_id),
                                    "companyId": ObjectId(company_id)})
        include_sub = request.args.get(
            "include_sub_entities", "true").lower() == "true"
        entity_query = {"companyId": ObjectId(company_id),
                        "$or": [{"_id": ObjectId(entity_id)}]}
        if include_sub:
            entity_query["$or"].append({"path": ObjectId(entity_id)})
        tree = list(entities.find(entity_query))
        entity_ids = [e["_id"] for e in tree]
        employee_assets = list(assets.find({
            "entityId": {"$in": entity_ids}, "type": "employee"}))
        # .get: assets written before metadata.employeeId was always set
        # (or by external writers) must not 500 the whole listing
        employee_ids = [a.get("metadata", {}).get("employeeId")
                        for a in employee_assets]
        active = list(employees.find({
            "employeeId": {"$in": [e for e in employee_ids if e]},
            "status": "active"}))
        enhanced = []
        for employee in active:
            asset = next(
                (a for a in employee_assets
                 if a.get("metadata", {}).get("employeeId")
                 == employee["employeeId"]),
                None)
            if asset:
                emp_entity = next((e for e in tree if e["_id"] == asset["entityId"]),
                                  None)
                if emp_entity:
                    enhanced.append({
                        "employeeId": employee["employeeId"],
                        "employeeName": employee["employeeName"],
                        "employeeEmail": employee.get("employeeEmail"),
                        "employeeMobile": employee.get("employeeMobile"),
                        "employeeDesignation": employee.get("employeeDesignation"),
                        "entity": {"id": str(emp_entity["_id"]),
                                   "name": emp_entity["name"],
                                   "type": emp_entity["type"]},
                    })
        return jsonify({"entityId": str(entity_id),
                        "entityName": entity["name"],
                        "entityType": entity["type"],
                        "totalEmployees": len(enhanced),
                        "employees": enhanced})

    @bp.route("/employees/<employee_id>/reportees", methods=["GET"])
    def get_employee_reportees(employee_id):
        # reference entity.py:1033-1087
        company_id, err = company_context_error(employee_id=employee_id)
        if err:
            return err
        manager = employees.find_one({"employeeId": employee_id,
                                      "companyId": ObjectId(company_id)})
        reportees = list(employees.find({
            "employeeReportingId": employee_id,
            "companyId": ObjectId(company_id),
            "status": "active"}))
        enhanced = []
        for reportee in reportees:
            asset = assets.find_one({"type": "employee",
                                     "metadata.employeeId": reportee["employeeId"],
                                     "orgId": ObjectId(company_id)})
            entity = entities.find_one({"_id": asset["entityId"]}) if asset else None
            if entity:
                enhanced.append({
                    "employeeId": reportee["employeeId"],
                    "employeeName": reportee["employeeName"],
                    "employeeEmail": reportee.get("employeeEmail"),
                    "employeeMobile": reportee.get("employeeMobile"),
                    "employeeDesignation": reportee.get("employeeDesignation"),
                    "entity": {"id": str(entity["_id"]), "name": entity["name"],
                               "type": entity["type"]},
                })
        return jsonify({"managerId": employee_id,
                        "managerName": manager["employeeName"],
                        "managerDesignation": manager.get("employeeDesignation"),
                        "totalReportees": len(enhanced),
                        "reportees": enhanced})

    @bp.route("/employees/search", methods=["GET"])
    def search_employees():
        # reference entity.py:1089-1183
        company_id, err = company_context_error()
        if err:
            return err
        query = {"companyId": ObjectId(company_id), "status": "active"}
        search_term = request.args.get("search")
        if search_term:
            escaped = re.escape(search_term)  # literal substring search
            query["$or"] = [
                {"employeeName": {"$regex": escaped, "$options": "i"}},
                {"employeeEmail": {"$regex": escaped, "$options": "i"}},
                {"employeeId": {"$regex": escaped, "$options": "i"}},
            ]
        if request.args.get("designation"):
            query["employeeDesignation"] = request.args["designation"]
        reporting_to = request.args.get("reportingTo")
        if reporting_to:
            manager = employees.find_one({"employeeId": reporting_to,
                                          "companyId": ObjectId(company_id)})
            if not manager:
                return jsonify({"error": "Invalid reporting manager"}), 400
            query["employeeReportingId"] = reporting_to
        found = list(employees.find(query))
        entity_type = request.args.get("entityType")
        if entity_type:
            typed = list(entities.find({"type": entity_type,
                                        "companyId": ObjectId(company_id)}))
            typed_ids = [e["_id"] for e in typed]
            typed_assets = list(assets.find({"entityId": {"$in": typed_ids},
                                             "type": "employee"}))
            allowed = {a.get("metadata", {}).get("employeeId")
                       for a in typed_assets}
            found = [e for e in found if e["employeeId"] in allowed]
        enhanced = []
        for employee in found:
            asset = assets.find_one({"type": "employee",
                                     "metadata.employeeId": employee["employeeId"],
                                     "orgId": ObjectId(company_id)})
            entity = entities.find_one({"_id": asset["entityId"]}) if asset else None
            if entity:
                enhanced.append({
                    "employeeId": employee["employeeId"],
                    "employeeName": employee["employeeName"],
                    "employeeEmail": employee.get("employeeEmail"),
                    "employeeMobile": employee.get("employeeMobile"),
                    "employeeDesignation": employee.get("employeeDesignation"),
                    "reportingTo": employee.get("employeeReportingId"),
                    "entity": {"id": str(entity["_id"]), "name": entity["name"],
                               "type": entity["type"]},
                })
        return jsonify({"totalEmployees": len(enhanced), "employees": enhanced})

    @bp.route("/employees/reporting-tree/<employee_id>", methods=["GET"])
    def get_reporting_tree(employee_id):
        # reference entity.py:1185-1250
        company_id, err = company_context_error(employee_id=employee_id)
        if err:
            return err
        employee = employees.find_one({"employeeId": employee_id,
                                       "companyId": ObjectId(company_id)})

        def manager_chain(emp):
            chain = []
            current = emp
            while current.get("employeeReportingId"):
                manager = employees.find_one({
                    "employeeId": current["employeeReportingId"],
                    "companyId": ObjectId(company_id)})
                if not manager or manager["employeeId"] in [
                        e["employeeId"] for e in chain]:
                    break
                chain.append({"employeeId": manager["employeeId"],
                              "employeeName": manager["employeeName"],
                              "designation": manager.get("employeeDesignation")})
                current = manager
            return chain

        def reportees_tree(emp, seen=None):
            # cycle guard: employeeReportingId is caller-settable, so A->B->A
            # (or self-reporting) must terminate, not recurse to a 500
            seen = set(seen or ()) | {emp["employeeId"]}
            out = []
            for reportee in employees.find({
                    "employeeReportingId": emp["employeeId"],
                    "companyId": ObjectId(company_id),
                    "status": "active"}):
                if reportee["employeeId"] in seen:
                    continue
                out.append({"employeeId": reportee["employeeId"],
                            "employeeName": reportee["employeeName"],
                            "designation": reportee.get("employeeDesignation"),
                            "reportees": reportees_tree(reportee, seen)})
            return out

        return jsonify({
            "employee": {"employeeId": employee["employeeId"],
                         "employeeName": employee["employeeName"],
                         "designation": employee.get("employeeDesignation")},
            "managementChain": manager_chain(employee),
            "reportees": reportees_tree(employee),
        })

    return bp
