"""Embedded Mongo-compatible document store.

The reference uses MongoDB as datastore, job queue, and inter-process state
bus (SURVEY.md §5.8): collections + GridFS (reference db/__init__.py:8-26),
atomic claim via ``update_many`` (trainingServer.py:499-508), delta sync on
``lastUpdated`` (infrenceServer.py:210-232), batched ``bulk_write``
(peopleCount.py:547-587).  pymongo is not available here, so this module is
a real in-process implementation of the pymongo surface those call sites
need — query/update operator semantics match MongoDB for the supported
subset, all mutations are atomic under one lock per database, and documents
are deep-copied across the API boundary so callers can never alias store
state.

``store.client.get_database`` transparently returns a real pymongo database
instead when a ``mongodb://`` URI is configured and pymongo is importable,
so production deployments keep the reference's exact persistence layer.
"""

from __future__ import annotations

import atexit
import copy
import os
import pickle
import re
import threading
from typing import Any, Iterable

from .objectid import ObjectId


class DuplicateKeyError(Exception):
    pass


class BulkWriteError(Exception):
    def __init__(self, details):
        super().__init__(str(details))
        self.details = details


class WriteError(Exception):
    """A single write was rejected (pymongo.errors.WriteError analogue)."""


# ----------------------------------------------------------------- results
class InsertOneResult:
    def __init__(self, inserted_id):
        self.inserted_id = inserted_id
        self.acknowledged = True


class InsertManyResult:
    def __init__(self, inserted_ids):
        self.inserted_ids = inserted_ids
        self.acknowledged = True


class UpdateResult:
    def __init__(self, matched, modified, upserted_id=None):
        self.matched_count = matched
        self.modified_count = modified
        self.upserted_id = upserted_id
        self.acknowledged = True


class DeleteResult:
    def __init__(self, deleted):
        self.deleted_count = deleted
        self.acknowledged = True


class BulkWriteResult:
    def __init__(self, inserted, matched, modified, deleted, upserted):
        self.inserted_count = inserted
        self.matched_count = matched
        self.modified_count = modified
        self.deleted_count = deleted
        self.upserted_count = upserted
        self.acknowledged = True


# ------------------------------------------------------------ bulk requests
class InsertOne:
    def __init__(self, document):
        self.document = document


class UpdateOne:
    def __init__(self, filter, update, upsert=False):
        self.filter = filter
        self.update = update
        self.upsert = upsert


class UpdateMany(UpdateOne):
    pass


class DeleteOne:
    def __init__(self, filter):
        self.filter = filter


class DeleteMany(DeleteOne):
    pass


class ReplaceOne:
    def __init__(self, filter, replacement, upsert=False):
        self.filter = filter
        self.replacement = replacement
        self.upsert = upsert


# --------------------------------------------------------------- matching
def _get_path(doc: Any, path: str):
    """Resolve a dotted path; returns (found, value)."""
    cur = doc
    for part in path.split("."):
        if isinstance(cur, dict):
            if part not in cur:
                return False, None
            cur = cur[part]
        elif isinstance(cur, list):
            if part.isdigit():
                i = int(part)
                if i >= len(cur):
                    return False, None
                cur = cur[i]
            else:
                # Mongo matches array-of-docs field traversal; collect values.
                vals = []
                for item in cur:
                    if isinstance(item, dict) and part in item:
                        vals.append(item[part])
                if not vals:
                    return False, None
                cur = vals
        else:
            return False, None
    return True, cur


def _cmp_key(v):
    """Total-order key for heterogeneous sort (None < numbers < str < other)."""
    if v is None:
        return (0, 0)
    if isinstance(v, bool):
        return (1, int(v))
    if isinstance(v, (int, float)):
        return (1, v)
    if isinstance(v, str):
        return (2, v)
    if isinstance(v, ObjectId):
        return (3, str(v))
    try:
        return (4, str(v))
    except Exception:
        return (5, 0)


def _safe_cmp(a, b) -> int | None:
    try:
        if a is None or b is None:
            return None
        if type(a) is bool or type(b) is bool:
            if type(a) is not type(b):
                return None
        if isinstance(a, (int, float)) and isinstance(b, (int, float)):
            return (a > b) - (a < b)
        if isinstance(a, str) and isinstance(b, str):
            return (a > b) - (a < b)
        if isinstance(a, ObjectId) and isinstance(b, ObjectId):
            return (a > b) - (a < b)
        if type(a) is type(b):
            return (a > b) - (a < b)
    except TypeError:
        return None
    return None


def _expr_truthy(v) -> bool:
    """MongoDB aggregation truthiness: null/missing, false, and numeric
    zero are falsy; EVERYTHING else — including '' and [] — is truthy."""
    if v is None or v is False:
        return False
    if isinstance(v, (int, float)) and not isinstance(v, bool) and v == 0:
        return False
    return True


def _values_equal(a, b) -> bool:
    # NO ObjectId<->hex-string coercion: pymongo never matches a string
    # against an ObjectId field, and the laxity would let call sites that
    # forget ObjectId() work in dev and silently miss on real MongoDB.
    if isinstance(a, ObjectId) != isinstance(b, ObjectId):
        return False
    return a == b


_BSON_TYPE_NAMES = {
    1: "double", 2: "string", 3: "object", 4: "array", 5: "binData",
    6: "undefined", 7: "objectId", 8: "bool", 9: "date", 10: "null",
    11: "regex", 12: "dbPointer", 13: "javascript", 14: "symbol",
    15: "javascriptWithScope", 16: "int", 17: "timestamp", 18: "long",
    19: "decimal", -1: "minKey", 127: "maxKey",
}


def _bson_type_of(v) -> str:
    import datetime

    if v is None:
        return "null"
    if isinstance(v, bool):
        return "bool"
    if isinstance(v, int):
        return "int"  # python ints carry no 32/64 split; "long" aliases
    if isinstance(v, float):
        return "double"
    if isinstance(v, str):
        return "string"
    if isinstance(v, list):
        return "array"
    if isinstance(v, dict):
        return "object"
    if isinstance(v, ObjectId):
        return "objectId"
    if isinstance(v, datetime.datetime):
        return "date"
    if isinstance(v, bytes):
        return "binData"
    return type(v).__name__


def _bson_type_matches(v, wanted) -> bool:
    if isinstance(wanted, int):  # numeric BSON type codes
        if wanted not in _BSON_TYPE_NAMES:
            # MongoDB errors on invalid numeric type codes rather than
            # silently never-matching.
            raise ValueError(f"Invalid numerical type code: {wanted}")
        wanted = _BSON_TYPE_NAMES[wanted]
    t = _bson_type_of(v)
    if wanted == "number":
        return t in ("int", "long", "double")
    if wanted in ("int", "long") and t in ("int", "long"):
        return True  # python int answers for both integer widths
    return t == wanted


def _match_value(value, cond, exists: bool) -> bool:
    """Match one field value against a condition (operator dict or literal)."""
    if isinstance(cond, dict) and any(k.startswith("$") for k in cond):
        for op, arg in cond.items():
            if op == "$eq":
                if not _match_value(value, arg, exists):
                    return False
            elif op == "$ne":
                if _match_value(value, arg, exists):
                    return False
            elif op in ("$gt", "$gte", "$lt", "$lte"):
                c = _safe_cmp(value, arg)
                if c is None:
                    return False
                if op == "$gt" and not c > 0:
                    return False
                if op == "$gte" and not c >= 0:
                    return False
                if op == "$lt" and not c < 0:
                    return False
                if op == "$lte" and not c <= 0:
                    return False
            elif op == "$in":
                # array fields match on the whole array OR any element
                # (MongoDB's array-equality branch of $in), same as $type
                vals = [value] + value if isinstance(value, list) else [value]
                if not any(_values_equal(v, a) for v in vals for a in arg):
                    return False
            elif op == "$nin":
                vals = [value] + value if isinstance(value, list) else [value]
                if any(_values_equal(v, a) for v in vals for a in arg):
                    return False
            elif op == "$exists":
                if bool(arg) != exists:
                    return False
            elif op == "$regex":
                flags = re.IGNORECASE if "i" in str(cond.get("$options", "")) else 0
                if not isinstance(value, str) or not re.search(arg, value, flags):
                    return False
            elif op == "$options":
                continue
            elif op == "$not":
                if _match_value(value, arg, exists):
                    return False
            elif op == "$size":
                if not isinstance(value, list) or len(value) != arg:
                    return False
            elif op == "$elemMatch":
                if not isinstance(value, list):
                    return False
                if not any(_match_doc(v, arg) if isinstance(v, dict)
                           else _match_value(v, arg, True) for v in value):
                    return False
            elif op == "$all":
                vals = [value] + value if isinstance(value, list) else [value]
                if not all(any(_values_equal(v, a) for v in vals) for a in arg):
                    return False
            elif op == "$type":
                if not exists:
                    return False
                wanted = arg if isinstance(arg, list) else [arg]
                # array fields match on the array itself OR any element
                # (docs.mongodb.com $type querying-by-array-type)
                vals = [value] + value if isinstance(value, list) \
                    else [value]
                if not any(_bson_type_matches(v, w)
                           for v in vals for w in wanted):
                    return False
            else:
                raise ValueError(f"unsupported query operator {op}")
        return True
    # literal match (including array-contains semantics)
    if not exists:
        return cond is None
    if isinstance(value, list) and not isinstance(cond, list):
        return any(_values_equal(v, cond) for v in value)
    return _values_equal(value, cond)


def _match_doc(doc: dict, query: dict) -> bool:
    for key, cond in query.items():
        if key == "$or":
            if not any(_match_doc(doc, q) for q in cond):
                return False
        elif key == "$and":
            if not all(_match_doc(doc, q) for q in cond):
                return False
        elif key == "$nor":
            if any(_match_doc(doc, q) for q in cond):
                return False
        elif key == "$expr":
            # aggregation expression over the whole document; the match
            # uses aggregation truthiness (docs.mongodb.com $expr)
            if not _expr_truthy(Collection._resolve_expr(doc, cond)):
                return False
        else:
            exists, value = _get_path(doc, key)
            if not _match_value(value, cond, exists):
                return False
    return True


# ---------------------------------------------------------------- updates
def _set_path(doc: dict, path: str, value):
    parts = path.split(".")
    cur = doc
    for p in parts[:-1]:
        if isinstance(cur, list) and p.isdigit():
            cur = cur[int(p)]
            continue
        if p not in cur or cur[p] is None:
            cur[p] = {}
        elif not isinstance(cur[p], (dict, list)):
            # MongoDB raises here; silently replacing a scalar intermediate
            # with {} would destroy data on a buggy dotted-path update
            raise WriteError(
                f"Cannot create field {parts[parts.index(p) + 1]!r} in "
                f"element {{{p}: {cur[p]!r}}}")
        cur = cur[p]
    if isinstance(cur, list) and parts[-1].isdigit():
        cur[int(parts[-1])] = value
    else:
        cur[parts[-1]] = value


def _unset_path(doc: dict, path: str):
    parts = path.split(".")
    cur = doc
    for p in parts[:-1]:
        if isinstance(cur, dict) and p in cur:
            cur = cur[p]
        else:
            return
    if isinstance(cur, dict):
        cur.pop(parts[-1], None)


def _apply_update(doc: dict, update: dict, *, on_insert: bool = False) -> bool:
    """Apply update operators in place; returns True if doc changed."""
    changed = False
    if not any(k.startswith("$") for k in update):
        # whole-document replacement
        _id = doc.get("_id")
        doc.clear()
        doc.update(copy.deepcopy(update))
        if _id is not None:
            # preserve the original _id; when there was none (replacement
            # UPSERT whose filter carried no _id) leave the key absent so
            # the upsert path's setdefault(ObjectId()) can assign a real
            # one — setdefault-ing None here would store _id=None and
            # collide every such upsert on the same None key
            doc.setdefault("_id", _id)
        return True
    for op, fields in update.items():
        if op == "$setOnInsert":
            if on_insert:
                for path, val in fields.items():
                    _set_path(doc, path, copy.deepcopy(val))
                    changed = True
            continue
        if op == "$set":
            for path, val in fields.items():
                exists, cur = _get_path(doc, path)
                if not exists or cur != val:
                    _set_path(doc, path, copy.deepcopy(val))
                    changed = True
        elif op == "$unset":
            for path in fields:
                exists, _ = _get_path(doc, path)
                if exists:
                    _unset_path(doc, path)
                    changed = True
        elif op == "$inc":
            for path, val in fields.items():
                if not isinstance(val, (int, float)) or isinstance(val, bool):
                    raise WriteError(
                        "Cannot increment with non-numeric argument: "
                        f"{{{path}: {val!r}}}")
                exists, cur = _get_path(doc, path)
                # null errors too (docs.mongodb.com $inc); only a MISSING
                # field seeds from zero
                if exists and (not isinstance(cur, (int, float))
                               or isinstance(cur, bool)):
                    raise WriteError(
                        f"Cannot apply $inc to a value of non-numeric type "
                        f"at {path}")
                _set_path(doc, path, (cur if exists else 0) + val)
                changed = True
        elif op == "$push":
            for path, val in fields.items():
                exists, cur = _get_path(doc, path)
                arr = cur if exists and isinstance(cur, list) else []
                if isinstance(val, dict) and "$each" in val:
                    unknown = set(val) - {"$each", "$slice", "$sort",
                                          "$position"}
                    if unknown:
                        raise WriteError(
                            f"Unrecognized clause in $push: {unknown.pop()}")
                    each = [copy.deepcopy(v) for v in val["$each"]]
                    # MongoDB modifier order: $position, then $sort, then
                    # $slice (docs.mongodb.com $push behavior).
                    pos = val.get("$position")
                    if pos is None:
                        arr = arr + each
                    elif pos < 0:
                        p = max(len(arr) + pos, 0)
                        arr = arr[:p] + each + arr[p:]
                    else:
                        arr = arr[:pos] + each + arr[pos:]
                    if "$sort" in val:
                        s = val["$sort"]
                        if isinstance(s, dict):  # sort array-of-docs by keys
                            for k, direction in reversed(list(s.items())):
                                arr.sort(
                                    key=lambda v: _cmp_key(
                                        _get_path(v, k)[1]),
                                    reverse=direction < 0)
                        else:  # 1 / -1: whole-element sort
                            arr.sort(key=_cmp_key, reverse=s < 0)
                    if "$slice" in val:
                        s = val["$slice"]
                        arr = arr[s:] if s < 0 else arr[:s]
                else:
                    arr = arr + [copy.deepcopy(val)]
                _set_path(doc, path, arr)
                changed = True
        elif op == "$addToSet":
            for path, val in fields.items():
                exists, cur = _get_path(doc, path)
                arr = cur if exists and isinstance(cur, list) else []
                if not any(_values_equal(v, val) for v in arr):
                    _set_path(doc, path, arr + [copy.deepcopy(val)])
                    changed = True
        elif op == "$pull":
            for path, val in fields.items():
                exists, cur = _get_path(doc, path)
                if exists and isinstance(cur, list):
                    if isinstance(val, dict) and any(k.startswith("$") for k in val):
                        new = [v for v in cur if not _match_value(v, val, True)]
                    elif isinstance(val, dict):
                        new = [v for v in cur
                               if not (isinstance(v, dict) and _match_doc(v, val))]
                    else:
                        new = [v for v in cur if not _values_equal(v, val)]
                    if len(new) != len(cur):
                        _set_path(doc, path, new)
                        changed = True
        elif op == "$mul":
            for path, val in fields.items():
                if not isinstance(val, (int, float)) or isinstance(val, bool):
                    raise WriteError(
                        "Cannot multiply with non-numeric argument: "
                        f"{{{path}: {val!r}}}")
                exists, cur = _get_path(doc, path)
                numeric = isinstance(cur, (int, float)) \
                    and not isinstance(cur, bool)
                if exists and not numeric:
                    raise WriteError(
                        f"Cannot apply $mul to a value of non-numeric type "
                        f"at {path}")
                # missing field: MongoDB creates it as zero of the
                # multiplier's numeric type (docs.mongodb.com $mul)
                _set_path(doc, path, (cur * val) if exists else val * 0)
                changed = True
        elif op == "$rename":
            for path, new_path in fields.items():
                if not isinstance(new_path, str) or not new_path:
                    raise WriteError(
                        "The 'to' field for $rename must be a non-empty "
                        "string")
                if path == new_path:
                    raise WriteError(
                        "The source and target field for $rename must "
                        "differ")
                exists, cur = _get_path(doc, path)
                if not exists:
                    continue  # missing source: $rename is a no-op
                _unset_path(doc, path)
                _set_path(doc, new_path, cur)
                changed = True
        elif op == "$pop":
            for path, val in fields.items():
                if val not in (1, -1):
                    raise WriteError(
                        "$pop expects 1 or -1, found: " + repr(val))
                exists, cur = _get_path(doc, path)
                if not exists:
                    continue  # missing field: no-op
                if not isinstance(cur, list):
                    raise WriteError(
                        f"Path '{path}' contains an element of non-array "
                        "type")
                if cur:
                    _set_path(doc, path, cur[1:] if val == -1 else cur[:-1])
                    changed = True
        elif op == "$pullAll":
            for path, vals in fields.items():
                if not isinstance(vals, list):
                    raise WriteError("$pullAll requires an array argument")
                exists, cur = _get_path(doc, path)
                if not exists:
                    continue
                if not isinstance(cur, list):
                    raise WriteError(
                        f"Cannot apply $pullAll to a non-array value at "
                        f"{path}")
                # exact-value equality only — $pullAll does NOT take query
                # conditions, unlike $pull (docs.mongodb.com $pullAll)
                new = [v for v in cur
                       if not any(_values_equal(v, x) for x in vals)]
                if len(new) != len(cur):
                    _set_path(doc, path, new)
                    changed = True
        elif op == "$currentDate":
            import datetime

            for path in fields:
                _set_path(doc, path, datetime.datetime.now(datetime.timezone.utc))
                changed = True
        elif op == "$min":
            for path, val in fields.items():
                exists, cur = _get_path(doc, path)
                if not exists or _safe_cmp(val, cur) == -1:
                    _set_path(doc, path, copy.deepcopy(val))
                    changed = True
        elif op == "$max":
            for path, val in fields.items():
                exists, cur = _get_path(doc, path)
                if not exists or _safe_cmp(val, cur) == 1:
                    _set_path(doc, path, copy.deepcopy(val))
                    changed = True
        else:
            raise ValueError(f"unsupported update operator {op}")
    return changed


def _project(doc: dict, projection: dict | None) -> dict:
    if not projection:
        # find() already snapshot-copied the doc for this cursor; a second
        # deepcopy here would double the cost of every unprojected read.
        return doc
    include_id = projection.get("_id", 1)
    fields = {k: v for k, v in projection.items() if k != "_id"}
    inclusive = any(v for v in fields.values()) if fields else bool(include_id)
    out: dict
    if inclusive:
        out = {}
        for path, flag in fields.items():
            if flag:
                exists, val = _get_path(doc, path)
                if exists:
                    _set_path(out, path, copy.deepcopy(val))
        if include_id and "_id" in doc:
            out["_id"] = doc["_id"]
    else:
        out = copy.deepcopy(doc)
        for path, flag in fields.items():
            if not flag:
                _unset_path(out, path)
        if not include_id:
            out.pop("_id", None)
    return out


# ----------------------------------------------------------------- cursor
class Cursor:
    def __init__(self, docs: list, projection=None):
        self._docs = docs
        self._projection = projection
        self._sort = None
        self._skip = 0
        self._limit = None

    def sort(self, key_or_list, direction: int = 1) -> "Cursor":
        if isinstance(key_or_list, str):
            self._sort = [(key_or_list, direction)]
        else:
            self._sort = list(key_or_list)
        return self

    def skip(self, n: int) -> "Cursor":
        self._skip = n
        return self

    def limit(self, n: int) -> "Cursor":
        self._limit = n
        return self

    def _resolved(self) -> list:
        docs = self._docs
        if self._sort:
            for key, direction in reversed(self._sort):
                docs = sorted(
                    docs,
                    key=lambda d: _cmp_key(_get_path(d, key)[1]),
                    reverse=direction < 0,
                )
        if self._skip:
            docs = docs[self._skip:]
        # pymongo semantics: limit(0) = no limit; negative = |n| cap
        if self._limit:
            docs = docs[: abs(self._limit)]
        return [_project(d, self._projection) for d in docs]

    def __iter__(self):
        return iter(self._resolved())

    def __len__(self):
        return len(self._resolved())

    def __getitem__(self, i):
        return self._resolved()[i]


# ------------------------------------------------------------- collection
class Collection:
    def __init__(self, db: "Database", name: str):
        self._db = db
        self.name = name
        self._docs: dict = {}  # _id-key -> doc
        self._indexes: list = []
        self._unique: list = []  # list of tuple(field names)
        # equality hash maps per leftmost index field (Mongo's prefix rule):
        # field -> {hashable value key -> set of _id-keys}, or None once a
        # multikey/unhashable value disables that field's map (scans resume)
        self._field_maps: dict = {}

    # -- helpers
    @property
    def _lock(self):
        return self._db._lock

    @staticmethod
    def _id_key(_id):
        return str(_id) if isinstance(_id, ObjectId) else _id

    # -- equality hash indexes (leftmost field of each created index)
    @staticmethod
    def _hkey(value):
        # aligns with _values_equal: ObjectId never collides with its hex
        # string; everything else compares with plain ==
        return ("oid", str(value)) if isinstance(value, ObjectId) else value

    def _index_add(self, key, doc):
        for field, m in self._field_maps.items():
            if m is None:
                continue
            exists, val = _get_path(doc, field)
            if not exists:
                continue
            if isinstance(val, (list, dict)):
                # multikey/unhashable: disable this field's map for good —
                # array-contains equality semantics can't key a hash map
                self._field_maps[field] = None
                continue
            try:
                m.setdefault(self._hkey(val), set()).add(key)
            except TypeError:
                self._field_maps[field] = None

    def _index_remove(self, key, doc):
        for field, m in self._field_maps.items():
            if m is None:
                continue
            exists, val = _get_path(doc, field)
            if not exists or isinstance(val, (list, dict)):
                continue
            try:
                bucket = m.get(self._hkey(val))
            except TypeError:
                continue
            if bucket is not None:
                bucket.discard(key)
                if not bucket:
                    m.pop(self._hkey(val), None)

    def _rebuild_indexes(self):
        self._field_maps = {ix["fields"][0]: {} for ix in self._indexes
                            if ix["fields"] and ix["fields"][0] != "_id"}
        for key, doc in self._docs.items():
            self._index_add(key, doc)

    def _candidates(self, filter: dict | None) -> list:
        """(key, doc) pairs that can possibly match ``filter``.

        Point-lookup fast paths (callers still run ``_match_doc`` on the
        result — the maps only narrow, semantics stay with the matcher):
        1. an equality ``_id`` filter resolves through the _id-keyed dict
           (``_id_key`` collapses ObjectId/str for keying while
           ``_values_equal`` keeps them distinct);
        2. an equality filter on an indexed leftmost field resolves through
           that field's hash map (Mongo's index prefix rule) — e.g. the
           campus flush loop's {person_id, campus_id} updates and the job
           queue's {status: queued} claims stop scanning the collection.
        ``None`` equality bypasses the maps: a literal None also matches
        documents missing the field entirely (_match_value)."""
        if filter:
            fid = filter.get("_id")
            if fid is not None and not isinstance(fid, (dict, list)):
                try:
                    doc = self._docs.get(self._id_key(fid))
                except TypeError:  # unhashable exotic _id — scan
                    return list(self._docs.items())
                return [(self._id_key(fid), doc)] if doc is not None else []
            best = None
            for field, m in self._field_maps.items():
                if m is None:
                    continue
                val = filter.get(field)
                if val is None or isinstance(val, (dict, list)):
                    continue
                try:
                    keys = m.get(self._hkey(val), ())
                except TypeError:
                    continue
                # most selective applicable map wins (e.g. prefer a
                # companyId bucket over a huge status=queued bucket)
                if best is None or len(keys) < len(best):
                    best = keys
                    if not best:
                        break
            if best is not None:
                return [(k, self._docs[k]) for k in list(best)
                        if k in self._docs]
        return list(self._docs.items())

    def _check_unique(self, doc, exclude_key=None):
        for fields in self._unique:
            probe = {}
            for f in fields:
                exists, val = _get_path(doc, f)
                # non-sparse unique index semantics: a missing field is
                # indexed as null, so two docs both omitting every indexed
                # field ARE duplicates (MongoDB raises E11000 on the
                # second) — do not skip the all-None probe
                probe[f] = val if exists else None
            # narrow through the lead-field hash map when usable (every
            # created index registers one): insert cost drops from O(docs)
            # to O(bucket); comparisons below keep exact semantics
            candidates = None
            lead = fields[0]
            m = self._field_maps.get(lead)
            pl = probe.get(lead)
            if m is not None and pl is not None and not isinstance(pl, (dict, list)):
                try:
                    keys = m.get(self._hkey(pl), ())
                except TypeError:
                    keys = None
                if keys is not None:
                    candidates = [(k, self._docs[k]) for k in list(keys)
                                  if k in self._docs]
            if candidates is None:
                candidates = self._docs.items()
            for key, other in candidates:
                if key == exclude_key:
                    continue
                if all(_values_equal(_get_path(other, f)[1], probe[f]) for f in fields):
                    raise DuplicateKeyError(
                        f"E11000 duplicate key error collection: "
                        f"{self._db.name}.{self.name} index: {fields}"
                    )

    # -- inserts
    def insert_one(self, document: dict) -> InsertOneResult:
        with self._lock:
            doc = copy.deepcopy(document)
            doc.setdefault("_id", ObjectId())
            key = self._id_key(doc["_id"])
            if key in self._docs:
                raise DuplicateKeyError(f"duplicate _id {doc['_id']}")
            self._check_unique(doc)
            self._docs[key] = doc
            self._index_add(key, doc)
            self._db._mark_dirty()
            # mirror pymongo: inserted _id is visible on the caller's dict
            document.setdefault("_id", doc["_id"])
            return InsertOneResult(doc["_id"])

    def insert_many(self, documents: Iterable[dict]) -> InsertManyResult:
        ids = []
        for d in documents:
            ids.append(self.insert_one(d).inserted_id)
        return InsertManyResult(ids)

    # -- reads
    def find(self, filter: dict | None = None, projection: dict | None = None) -> Cursor:
        with self._lock:
            filter = filter or {}
            docs = [d for _, d in self._candidates(filter)
                    if _match_doc(d, filter)]
            # deep-copy happens at projection time in Cursor._resolved
            return Cursor([copy.deepcopy(d) for d in docs], projection)

    def find_one(self, filter: dict | None = None, projection: dict | None = None,
                 sort=None):
        cur = self.find(filter, projection)
        if sort:
            cur = cur.sort(sort)
        for doc in cur.limit(1):
            return doc
        return None

    def count_documents(self, filter: dict | None = None) -> int:
        filter = filter or {}
        with self._lock:
            return sum(1 for _, d in self._candidates(filter)
                       if _match_doc(d, filter))

    def estimated_document_count(self) -> int:
        return len(self._docs)

    def distinct(self, key: str, filter: dict | None = None) -> list:
        out = []
        for doc in self.find(filter):
            exists, val = _get_path(doc, key)
            if exists:
                vals = val if isinstance(val, list) else [val]
                for v in vals:
                    if not any(_values_equal(v, o) for o in out):
                        out.append(v)
        return out

    # -- updates
    def _update(self, filter, update, upsert, many) -> UpdateResult:
        with self._lock:
            matched = modified = 0
            for key, doc in self._candidates(filter):
                if _match_doc(doc, filter):
                    matched += 1
                    work = copy.deepcopy(doc)
                    if _apply_update(work, update):
                        self._check_unique(work, exclude_key=key)
                        # direct comparison, not _id_key: the key fn
                        # collapses ObjectId and its hex string, which
                        # would let a $set silently retype _id to str and
                        # orphan the doc from ObjectId-equality lookups
                        if work.get("_id") != doc.get("_id"):
                            raise ValueError("_id is immutable")
                        self._index_remove(key, doc)
                        self._docs[key] = work
                        self._index_add(key, work)
                        self._db._mark_dirty()
                        modified += 1
                    if not many:
                        break
            if matched == 0 and upsert:
                base: dict = {}
                # seed from equality conditions in the filter
                for k, v in filter.items():
                    if not k.startswith("$") and not (
                        isinstance(v, dict) and any(s.startswith("$") for s in v)
                    ):
                        _set_path(base, k, copy.deepcopy(v))
                _apply_update(base, update, on_insert=True)
                base.setdefault("_id", ObjectId())
                idk = self._id_key(base["_id"])
                if idk in self._docs:
                    # filter pinned an EXISTING _id but its other
                    # conditions didn't match: MongoDB raises E11000
                    # rather than replacing the existing document
                    raise DuplicateKeyError(
                        f"E11000 duplicate key error: _id {base['_id']!r}")
                self._check_unique(base)
                self._docs[idk] = base
                self._index_add(idk, base)
                self._db._mark_dirty()
                return UpdateResult(0, 0, upserted_id=base["_id"])
            return UpdateResult(matched, modified)

    def update_one(self, filter, update, upsert=False) -> UpdateResult:
        return self._update(filter, update, upsert, many=False)

    def update_many(self, filter, update, upsert=False) -> UpdateResult:
        return self._update(filter, update, upsert, many=True)

    def replace_one(self, filter, replacement, upsert=False) -> UpdateResult:
        return self._update(filter, replacement, upsert, many=False)

    def find_one_and_update(self, filter, update, upsert=False,
                            return_document=False, sort=None):
        """return_document: False = BEFORE (pymongo default), True = AFTER."""
        with self._lock:
            candidates = [
                (k, d) for k, d in self._candidates(filter)
                if _match_doc(d, filter)
            ]
            if sort and candidates:
                for key, direction in reversed(
                    [(sort, 1)] if isinstance(sort, str) else list(sort)
                ):
                    candidates.sort(
                        key=lambda kd: _cmp_key(_get_path(kd[1], key)[1]),
                        reverse=direction < 0,
                    )
            if candidates:
                key, doc = candidates[0]
                before = copy.deepcopy(doc)
                work = copy.deepcopy(doc)
                if _apply_update(work, update):
                    if work.get("_id") != doc.get("_id"):
                        raise ValueError("_id is immutable")
                    self._check_unique(work, exclude_key=key)
                    self._index_remove(key, doc)
                    self._docs[key] = work
                    self._index_add(key, work)
                    self._db._mark_dirty()
                return copy.deepcopy(work) if return_document else before
            if upsert:
                res = self._update(filter, update, upsert=True, many=False)
                if return_document and res.upserted_id is not None:
                    return self.find_one({"_id": res.upserted_id})
            return None

    def find_one_and_replace(self, filter, replacement, upsert=False,
                             return_document=False, sort=None):
        if any(k.startswith("$") for k in replacement):
            raise ValueError("replacement can not include $ operators")
        return self.find_one_and_update(filter, replacement, upsert=upsert,
                                        return_document=return_document,
                                        sort=sort)

    def find_one_and_delete(self, filter, sort=None):
        """Atomically remove and return one matching document (pymongo
        find_one_and_delete); None when nothing matches."""
        with self._lock:
            candidates = [(k, d) for k, d in self._candidates(filter)
                          if _match_doc(d, filter)]
            if sort and candidates:
                for key, direction in reversed(
                    [(sort, 1)] if isinstance(sort, str) else list(sort)
                ):
                    candidates.sort(
                        key=lambda kd: _cmp_key(_get_path(kd[1], key)[1]),
                        reverse=direction < 0,
                    )
            if not candidates:
                return None
            key, doc = candidates[0]
            self._index_remove(key, doc)
            del self._docs[key]
            self._db._mark_dirty()
            return doc

    # -- deletes
    def delete_one(self, filter) -> DeleteResult:
        with self._lock:
            for key, doc in self._candidates(filter):
                if _match_doc(doc, filter):
                    self._index_remove(key, doc)
                    del self._docs[key]
                    self._db._mark_dirty()
                    return DeleteResult(1)
            return DeleteResult(0)

    def delete_many(self, filter) -> DeleteResult:
        with self._lock:
            victims = [(k, d) for k, d in self._candidates(filter)
                       if _match_doc(d, filter)]
            for k, d in victims:
                self._index_remove(k, d)
                del self._docs[k]
            if victims:
                self._db._mark_dirty()
            return DeleteResult(len(victims))

    # -- bulk
    def bulk_write(self, requests: list, ordered: bool = True) -> BulkWriteResult:
        """pymongo semantics: ordered=True stops at the first error;
        ordered=False attempts every request.  Either way errors surface as
        BulkWriteError carrying per-op details, never a bare exception."""
        inserted = matched = modified = deleted = upserted = 0
        errors = []
        for i, req in enumerate(requests):
            try:
                if isinstance(req, InsertOne):
                    self.insert_one(req.document)
                    inserted += 1
                elif isinstance(req, UpdateMany):
                    r = self.update_many(req.filter, req.update, req.upsert)
                    matched += r.matched_count
                    modified += r.modified_count
                    upserted += 1 if r.upserted_id is not None else 0
                elif isinstance(req, UpdateOne):
                    r = self.update_one(req.filter, req.update, req.upsert)
                    matched += r.matched_count
                    modified += r.modified_count
                    upserted += 1 if r.upserted_id is not None else 0
                elif isinstance(req, ReplaceOne):
                    r = self.replace_one(req.filter, req.replacement, req.upsert)
                    matched += r.matched_count
                    modified += r.modified_count
                    upserted += 1 if r.upserted_id is not None else 0
                elif isinstance(req, DeleteMany):
                    deleted += self.delete_many(req.filter).deleted_count
                elif isinstance(req, DeleteOne):
                    deleted += self.delete_one(req.filter).deleted_count
                else:
                    raise TypeError(f"unsupported bulk request {type(req)}")
            except TypeError:
                raise
            except Exception as e:
                errors.append({"index": i, "errmsg": str(e)})
                if ordered:
                    break
        if errors:
            raise BulkWriteError({
                "writeErrors": errors,
                "nInserted": inserted, "nMatched": matched,
                "nModified": modified, "nRemoved": deleted,
                "nUpserted": upserted,
            })
        return BulkWriteResult(inserted, matched, modified, deleted, upserted)

    # -- indexes (tracked; unique is enforced)
    def create_index(self, keys, unique: bool = False, **kwargs) -> str:
        if isinstance(keys, str):
            fields = (keys,)
        else:
            fields = tuple(k if isinstance(k, str) else k[0] for k in keys)
        name = kwargs.get("name") or "_".join(f"{f}_1" for f in fields)
        with self._lock:
            self._indexes.append({"name": name, "fields": fields, "unique": unique,
                                  **{k: v for k, v in kwargs.items() if k != "name"}})
            if unique and fields not in self._unique:
                self._unique.append(fields)
            lead = fields[0] if fields else None
            if lead and lead != "_id" and lead not in self._field_maps:
                self._field_maps[lead] = {}
                for key, doc in self._docs.items():
                    # single-field add for just the new map
                    exists, val = _get_path(doc, lead)
                    if not exists:
                        continue
                    if isinstance(val, (list, dict)):
                        self._field_maps[lead] = None
                        break
                    try:
                        self._field_maps[lead].setdefault(
                            self._hkey(val), set()).add(key)
                    except TypeError:
                        self._field_maps[lead] = None
                        break
            self._db._mark_dirty()
        return name

    def index_information(self) -> dict:
        return {ix["name"]: ix for ix in self._indexes}

    def drop(self):
        # pymongo: dropping a collection also drops its indexes
        with self._lock:
            self._docs.clear()
            self._indexes.clear()
            self._unique.clear()
            self._field_maps.clear()
            self._db._mark_dirty()

    # -- aggregate (subset: $match, $sort, $skip, $limit, $project, $group,
    #    $unwind, $count)
    def aggregate(self, pipeline: list) -> list:
        # a leading $match seeds through find() (index-narrowed, copies
        # matches only) instead of deep-copying the whole collection
        if pipeline and next(iter(pipeline[0])) == "$match":
            docs = [d for d in self.find(pipeline[0]["$match"])]
            pipeline = pipeline[1:]
        else:
            docs = [d for d in self.find({})]
        for stage in pipeline:
            (op, arg), = stage.items()
            if op == "$match":
                docs = [d for d in docs if _match_doc(d, arg)]
            elif op == "$sort":
                for key, direction in reversed(list(arg.items())):
                    docs.sort(key=lambda d: _cmp_key(_get_path(d, key)[1]),
                              reverse=direction < 0)
            elif op == "$skip":
                docs = docs[arg:]
            elif op == "$limit":
                docs = docs[:arg]
            elif op == "$project":
                docs = [self._project_stage(d, arg) for d in docs]
            elif op == "$unwind":
                path = arg if isinstance(arg, str) else arg["path"]
                path = path.lstrip("$")
                out = []
                for d in docs:
                    exists, val = _get_path(d, path)
                    if exists and isinstance(val, list):
                        for v in val:
                            nd = copy.deepcopy(d)
                            _set_path(nd, path, v)
                            out.append(nd)
                    elif exists and val is not None:
                        # MongoDB >= 3.2: non-array values pass through as
                        # a single element (missing/null/[] drop the doc)
                        out.append(d)
                docs = out
            elif op == "$count":
                docs = [{arg: len(docs)}]
            elif op == "$group":
                docs = self._group(docs, arg)
            elif op in ("$addFields", "$set"):
                # $set is the 4.2+ alias for $addFields
                for d in docs:
                    for path, expr in arg.items():
                        _set_path(d, path,
                                  copy.deepcopy(self._resolve_expr(d, expr)))
            elif op == "$replaceRoot":
                out = []
                for d in docs:
                    root = self._resolve_expr(d, arg["newRoot"])
                    if not isinstance(root, dict):
                        raise ValueError(
                            "'newRoot' expression must evaluate to an "
                            f"object, found: {root!r}")
                    out.append(copy.deepcopy(root))
                docs = out
            elif op == "$lookup":
                foreign = self._db[arg["from"]].find({})
                fdocs = list(foreign)
                ffield, lfield = arg["foreignField"], arg["localField"]
                for d in docs:
                    _, lval = _get_path(d, lfield)  # missing joins as null
                    # array localField: match per element AND the whole
                    # array (MongoDB equality-match semantics)
                    lvals = ([lval] + lval) if isinstance(lval, list) \
                        else [lval]
                    def _fmatch(f):
                        fval = _get_path(f, ffield)[1]
                        # foreign arrays use array-contains equality, like
                        # a find() equality match
                        fvals = ([fval] + fval) if isinstance(fval, list) \
                            else [fval]
                        return any(_values_equal(fv, v)
                                   for fv in fvals for v in lvals)
                    d[arg["as"]] = [copy.deepcopy(f) for f in fdocs
                                    if _fmatch(f)]
            else:
                raise ValueError(f"unsupported aggregate stage {op}")
        return docs

    @staticmethod
    def _resolve_expr(doc, expr):
        if isinstance(expr, str) and expr.startswith("$$"):
            if expr == "$$ROOT":
                return doc
            raise ValueError(f"unsupported aggregation variable {expr}")
        if isinstance(expr, str) and expr.startswith("$"):
            return _get_path(doc, expr[1:])[1]
        if isinstance(expr, list):
            return [Collection._resolve_expr(doc, e) for e in expr]
        if isinstance(expr, dict):
            if len(expr) == 1 and next(iter(expr)).startswith("$"):
                op, arg = next(iter(expr.items()))
                return Collection._eval_expr_op(doc, op, arg)
            # compound _id specs: {"d": "$day", ...} resolve per field
            return {k: Collection._resolve_expr(doc, v)
                    for k, v in expr.items()}
        return expr

    @staticmethod
    def _eval_expr_op(doc, op, arg):
        """Aggregation expression operators (docs.mongodb.com aggregation
        expressions): arithmetic/string ops return null when any operand
        is null or missing; boolean ops use MongoDB truthiness (null,
        false, and 0 are falsy — '' and [] are TRUTHY, unlike Python)."""
        r = Collection._resolve_expr
        if op == "$literal":
            return copy.deepcopy(arg)
        if op == "$cond":  # lazy: only the taken branch is evaluated
            if isinstance(arg, dict):
                cond, then, els = arg["if"], arg["then"], arg["else"]
            else:
                cond, then, els = arg
            return r(doc, then if _expr_truthy(r(doc, cond)) else els)
        if op == "$ifNull":  # first non-null expression, lazily
            for e in arg[:-1]:
                v = r(doc, e)
                if v is not None:
                    return v
            return r(doc, arg[-1])
        if op == "$and":
            return all(_expr_truthy(r(doc, e)) for e in arg)
        if op == "$or":
            return any(_expr_truthy(r(doc, e)) for e in arg)
        if op == "$not":
            e = arg[0] if isinstance(arg, list) else arg
            return not _expr_truthy(r(doc, e))
        if op in ("$add", "$subtract", "$multiply", "$divide", "$mod"):
            vals = [r(doc, e) for e in arg]
            if any(v is None for v in vals):
                return None
            for v in vals:
                if not isinstance(v, (int, float)) or isinstance(v, bool):
                    raise ValueError(
                        f"{op} only supports numeric types, not "
                        f"{type(v).__name__}")
            if op == "$add":
                return sum(vals)
            if op == "$multiply":
                out = 1
                for v in vals:
                    out *= v
                return out
            if vals[1] == 0 and op in ("$divide", "$mod"):
                raise ValueError(f"can't {op[1:]} by zero")
            if op == "$subtract":
                return vals[0] - vals[1]
            if op == "$divide":
                return vals[0] / vals[1]
            # $mod keeps the DIVIDEND's sign (C-style, like MongoDB), not
            # Python's divisor-sign semantics: $mod: [-5, 3] is -2, not 1.
            rem = abs(vals[0]) % abs(vals[1])
            return rem if vals[0] >= 0 else -rem
        if op == "$concat":
            vals = [r(doc, e) for e in arg]
            if any(v is None for v in vals):
                return None
            if not all(isinstance(v, str) for v in vals):
                raise ValueError("$concat only supports strings")
            return "".join(vals)
        if op in ("$toUpper", "$toLower"):
            v = r(doc, arg[0] if isinstance(arg, list) else arg)
            s = "" if v is None else v
            if not isinstance(s, str):
                raise ValueError(f"{op} only supports strings")
            return s.upper() if op == "$toUpper" else s.lower()
        if op in ("$eq", "$ne", "$gt", "$gte", "$lt", "$lte", "$cmp"):
            a, b = (r(doc, e) for e in arg)
            if op == "$eq":
                return _values_equal(a, b)
            if op == "$ne":
                return not _values_equal(a, b)
            c = _safe_cmp(a, b)
            if c is None:  # cross-type: order by BSON type class, coarsely
                c = _safe_cmp(_cmp_key(a), _cmp_key(b)) or 0
            if op == "$cmp":
                return c
            return {"$gt": c > 0, "$gte": c >= 0,
                    "$lt": c < 0, "$lte": c <= 0}[op]
        if op == "$size":
            v = r(doc, arg[0] if isinstance(arg, list) else arg)
            if not isinstance(v, list):
                raise ValueError("The argument to $size must be an array")
            return len(v)
        if op == "$arrayElemAt":
            a, i = (r(doc, e) for e in arg)
            if a is None:
                return None
            if not isinstance(a, list):
                raise ValueError("$arrayElemAt's first argument must be an "
                                 "array")
            return a[i] if -len(a) <= i < len(a) else None
        if op == "$in":
            v, a = (r(doc, e) for e in arg)
            if not isinstance(a, list):
                raise ValueError("$in requires an array as a second "
                                 "argument")
            return any(_values_equal(v, x) for x in a)
        raise ValueError(f"unsupported expression operator {op}")

    @staticmethod
    def _group_key(gid):
        """Type-aware key: str(1) == str('1') must NOT merge groups."""
        if isinstance(gid, dict):
            return ("dict",) + tuple(
                (k, Collection._group_key(v)) for k, v in sorted(gid.items(),
                                                                 key=str))
        return (type(gid).__name__, str(gid))

    def _project_stage(self, doc, spec):
        """Aggregation $project: plain include/exclude flags delegate to
        the find()-path _project; computed values — '$field' references
        and operator-expression dicts — are evaluated per MongoDB (any
        computed field forces inclusive mode).  Previously expression
        values were silently treated as truthy include flags, returning
        plausible-but-wrong rows with the renamed/computed field dropped."""
        def is_expr(v):
            return (isinstance(v, str) and v.startswith("$")) or (
                isinstance(v, dict) and any(k.startswith("$") for k in v))

        fields = {k: v for k, v in spec.items() if k != "_id"}
        computed = {k for k, v in fields.items() if is_expr(v)}
        if not computed:
            return _project(doc, spec)
        out: dict = {}
        for path, v in fields.items():
            if path in computed:
                if isinstance(v, str):
                    # bare field reference: drop the output field when the
                    # referenced path is missing (MongoDB semantics)
                    exists, val = _get_path(doc, v[1:])
                    if exists:
                        _set_path(out, path, copy.deepcopy(val))
                else:
                    _set_path(out, path, copy.deepcopy(
                        self._resolve_expr(doc, v)))
            elif v:
                exists, val = _get_path(doc, path)
                if exists:
                    _set_path(out, path, copy.deepcopy(val))
        if spec.get("_id", 1) and "_id" in doc:
            out["_id"] = doc["_id"]
        return out

    def _group(self, docs, spec) -> list:
        groups: dict = {}
        order: list = []
        for d in docs:
            gid = self._resolve_expr(d, spec["_id"])
            key = self._group_key(gid)
            if key not in groups:
                groups[key] = {"_id": gid, "__docs": []}
                order.append(key)
            groups[key]["__docs"].append(d)
        out = []
        for key in order:
            g = groups[key]
            row = {"_id": g["_id"]}
            for field, agg in spec.items():
                if field == "_id":
                    continue
                (aop, aarg), = agg.items()
                vals = [self._resolve_expr(d, aarg) for d in g["__docs"]]
                if aop == "$sum":
                    # bool excluded: {"$sum": True} is a NON-numeric
                    # literal to MongoDB (returns 0), not a 1-per-doc count
                    if (isinstance(aarg, (int, float))
                            and not isinstance(aarg, bool)):
                        row[field] = aarg * len(vals)
                    else:
                        row[field] = sum(
                            v for v in vals
                            if isinstance(v, (int, float)) and not isinstance(v, bool)
                        )
                elif aop == "$avg":
                    nums = [v for v in vals if isinstance(v, (int, float))
                            and not isinstance(v, bool)]
                    row[field] = sum(nums) / len(nums) if nums else None
                elif aop == "$min":
                    row[field] = min((v for v in vals if v is not None),
                                     key=_cmp_key, default=None)
                elif aop == "$max":
                    row[field] = max((v for v in vals if v is not None),
                                     key=_cmp_key, default=None)
                elif aop == "$first":
                    row[field] = vals[0] if vals else None
                elif aop == "$last":
                    row[field] = vals[-1] if vals else None
                elif aop == "$push":
                    row[field] = vals
                elif aop == "$addToSet":
                    uniq = []
                    for v in vals:
                        if not any(_values_equal(v, u) for u in uniq):
                            uniq.append(v)
                    row[field] = uniq
                else:
                    raise ValueError(f"unsupported group accumulator {aop}")
            out.append(row)
        return out


class Database:
    """In-process database; optional snapshot persistence.

    ``persist_dir`` (the ``file://<dir>`` URI form) makes the database
    durable: state loads from ``<dir>/<name>.pkl`` at startup, a background
    thread writes a consistent snapshot (atomic rename) whenever there were
    mutations, and an atexit hook flushes on shutdown.  This is SINGLE-
    process persistence — the embedded store lives in one process's memory;
    deployments that need the reference's multi-process sharing use a
    ``mongodb://`` URI (store.client swaps in pymongo transparently).
    """

    FLUSH_INTERVAL_S = 2.0

    def __init__(self, name: str = "bharatlytics", persist_dir: str = ""):
        self.name = name
        self._lock = threading.RLock()
        self._flush_lock = threading.Lock()
        self._flush_seq = 0
        self._flushed_seq = 0
        self._collections: dict[str, Collection] = {}
        self._persist_dir = persist_dir
        self._dirty = False
        self._closed = False
        if persist_dir:
            os.makedirs(persist_dir, exist_ok=True)
            self._snapshot_path = os.path.join(persist_dir, f"{name}.pkl")
            self._load_snapshot()
            flusher = threading.Thread(target=self._flush_loop, daemon=True,
                                       name=f"fre-store-flush-{name}")
            flusher.start()
            atexit.register(self.flush)

    def _mark_dirty(self):
        # callers hold self._lock
        self._dirty = True

    def _load_snapshot(self):
        if not os.path.exists(self._snapshot_path):
            return
        with open(self._snapshot_path, "rb") as f:
            state = pickle.load(f)
        for cname, payload in state.items():
            col = self[cname]
            col._docs = payload["docs"]
            col._indexes = payload["indexes"]
            col._unique = payload["unique"]
            col._rebuild_indexes()  # hash maps are derived, never persisted

    def flush(self):
        """Write a consistent snapshot if anything changed (atomic rename)."""
        if not self._persist_dir:
            return
        with self._lock:
            if not self._dirty:
                return
            state = {cname: {"docs": col._docs, "indexes": col._indexes,
                             "unique": col._unique}
                     for cname, col in self._collections.items()}
            blob = pickle.dumps(state)  # serialize under the lock: consistent
            self._dirty = False
            self._flush_seq += 1
            seq = self._flush_seq
        # _flush_lock serializes writers (the periodic flusher vs
        # close()/atexit): two threads sharing one fixed tmp path would
        # interleave writes into the same inode and os.replace could then
        # publish a corrupt snapshot that bricks the next startup.  The
        # unique suffix additionally protects against multi-PROCESS writers
        # on a shared file:// dir (os.replace stays atomic either way).
        # The sequence check closes the remaining ordering race: two
        # flushes can serialize in one order but reach the file lock in the
        # other, and publishing the OLDER snapshot last would silently roll
        # back the writes the newer one carried (each snapshot is a
        # superset of every earlier one — state only accretes under
        # self._lock — so skipping a stale write loses nothing).
        with self._flush_lock:
            if seq <= self._flushed_seq:
                return  # a newer snapshot already reached the disk
            tmp = (f"{self._snapshot_path}.{os.getpid()}."
                   f"{threading.get_ident()}.tmp")
            try:
                with open(tmp, "wb") as f:
                    f.write(blob)
                os.replace(tmp, self._snapshot_path)
                self._flushed_seq = seq
            finally:
                if os.path.exists(tmp):
                    try:
                        os.unlink(tmp)
                    except OSError:
                        pass

    def _flush_loop(self):
        import time

        while not self._closed:
            time.sleep(self.FLUSH_INTERVAL_S)
            try:
                self.flush()
            except Exception:
                pass  # a failed periodic flush must not kill the thread

    def close(self):
        self._closed = True
        self.flush()

    def __getitem__(self, name: str) -> Collection:
        with self._lock:
            if name not in self._collections:
                self._collections[name] = Collection(self, name)
            return self._collections[name]

    def __getattr__(self, name: str) -> Collection:
        if name.startswith("_"):
            raise AttributeError(name)
        return self[name]

    def list_collection_names(self) -> list:
        return list(self._collections)

    def drop_collection(self, name: str):
        with self._lock:
            if self._collections.pop(name, None) is not None:
                # the next snapshot must omit the dropped collection even if
                # nothing else mutates before shutdown
                self._mark_dirty()

    def command(self, cmd):
        if cmd == "ping" or cmd == {"ping": 1}:
            return {"ok": 1}
        if cmd == "serverStatus" or cmd == {"serverStatus": 1}:
            with self._lock:
                return {
                    "ok": 1,
                    "db": self.name,
                    "persisted": bool(self._persist_dir),
                    "collections": {
                        name: len(col._docs)
                        for name, col in self._collections.items()
                    },
                }
        raise ValueError(f"unsupported command {cmd}")
