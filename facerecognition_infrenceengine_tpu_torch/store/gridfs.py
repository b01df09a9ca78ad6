"""GridFS-compatible binary buckets over the document store.

The reference keeps enrollment photos and pickled embedding vectors in four
GridFS buckets (reference db/__init__.py:19-26: employee/visitor x
images/embeddings), reads them back with ``fs.get(ObjectId).read()``
(infrenceServer.py:269, trainingServer.py:219) and stores with
``fs.put(data, filename=..., **metadata)`` (app/api/employee.py:133-151,
trainingServer.py:384-398).  This implements that surface over two
collections (``<bucket>.files`` holding metadata, ``<bucket>.chunks``
holding the bytes), mirroring real GridFS document layout so a pymongo
backend sees identical structure.
"""

from __future__ import annotations

import datetime
import hashlib

from .objectid import ObjectId

CHUNK_SIZE = 255 * 1024


class NoFile(Exception):
    pass


class GridOut:
    def __init__(self, file_doc: dict, data: bytes):
        self._data = data
        self._pos = 0
        self._id = file_doc["_id"]
        self.filename = file_doc.get("filename")
        self.length = file_doc.get("length", len(data))
        self.upload_date = file_doc.get("uploadDate")
        self.metadata = file_doc.get("metadata")
        # reference code reads arbitrary metadata attributes off GridOut
        for k, v in file_doc.items():
            if k not in ("_id", "chunkSize") and not hasattr(self, k):
                try:
                    setattr(self, k, v)
                except Exception:
                    pass

    def read(self, size: int = -1) -> bytes:
        if size < 0:
            out = self._data[self._pos:]
            self._pos = len(self._data)
        else:
            out = self._data[self._pos: self._pos + size]
            self._pos += len(out)
        return out

    def seek(self, pos: int):
        self._pos = pos

    @property
    def _file(self):
        return {"_id": self._id, "filename": self.filename, "length": self.length}


class GridFS:
    def __init__(self, database, collection: str = "fs"):
        self._files = database[f"{collection}.files"]
        self._chunks = database[f"{collection}.chunks"]

    def put(self, data: bytes, **kwargs) -> ObjectId:
        if hasattr(data, "read"):
            data = data.read()
        if isinstance(data, str):
            data = data.encode("utf-8")
        file_id = kwargs.pop("_id", None) or ObjectId()
        doc = {
            "_id": file_id,
            "length": len(data),
            "chunkSize": CHUNK_SIZE,
            "uploadDate": datetime.datetime.now(datetime.timezone.utc),
            "md5": hashlib.md5(data).hexdigest(),
        }
        doc.update(kwargs)
        # files doc first: a duplicate _id must fail BEFORE any chunks land
        # (chunks-first would leave interleaved chunks under the same
        # files_id and corrupt subsequent reads)
        self._files.insert_one(doc)
        n = 0
        for off in range(0, max(len(data), 1), CHUNK_SIZE):
            # addressable chunk _id so reads are O(chunks-of-this-file)
            # point lookups, not a scan of the whole bucket (a 1M-embedding
            # gallery load would otherwise be quadratic); files_id/n stay
            # for GridFS layout compatibility and legacy snapshots
            self._chunks.insert_one(
                {"_id": self._chunk_id(file_id, n), "files_id": file_id,
                 "n": n, "data": data[off: off + CHUNK_SIZE]}
            )
            n += 1
        return file_id

    @staticmethod
    def _chunk_id(file_id, n: int) -> str:
        return f"{file_id}:{n}"

    @staticmethod
    def _n_chunks(length: int) -> int:
        return max(1, -(-length // CHUNK_SIZE))

    def get(self, file_id) -> GridOut:
        file_id = ObjectId(file_id) if not isinstance(file_id, ObjectId) else file_id
        doc = self._files.find_one({"_id": file_id})
        if doc is None:
            raise NoFile(f"no file in gridfs with _id {file_id}")
        parts = []
        for n in range(self._n_chunks(doc.get("length", 0))):
            c = self._chunks.find_one({"_id": self._chunk_id(file_id, n)})
            if c is None:
                parts = None  # legacy layout (pre-addressable chunk ids)
                break
            parts.append(c["data"])
        if parts is None:
            chunks = self._chunks.find({"files_id": file_id}).sort("n", 1)
            parts = [c["data"] for c in chunks]
        return GridOut(doc, b"".join(parts))

    def delete(self, file_id):
        file_id = ObjectId(file_id) if not isinstance(file_id, ObjectId) else file_id
        doc = self._files.find_one({"_id": file_id})
        self._files.delete_many({"_id": file_id})
        deleted = 0
        if doc is not None:
            for n in range(self._n_chunks(doc.get("length", 0))):
                deleted += self._chunks.delete_one(
                    {"_id": self._chunk_id(file_id, n)}).deleted_count
        if doc is None or deleted < self._n_chunks(doc.get("length", 0)):
            self._chunks.delete_many({"files_id": file_id})  # legacy sweep

    def exists(self, file_id_or_query) -> bool:
        if isinstance(file_id_or_query, dict):
            return self._files.find_one(file_id_or_query) is not None
        try:
            fid = ObjectId(file_id_or_query)
        except Exception:
            return False
        return self._files.find_one({"_id": fid}) is not None

    def find(self, query: dict | None = None):
        for doc in self._files.find(query or {}):
            yield self.get(doc["_id"])

    def find_one(self, query: dict | None = None):
        doc = self._files.find_one(query or {})
        return self.get(doc["_id"]) if doc else None

    def list(self) -> list:
        return [d.get("filename") for d in self._files.find({})]
