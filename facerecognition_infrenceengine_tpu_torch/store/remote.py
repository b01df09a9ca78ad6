"""Client proxy for the embedded store served over a socket.

The reference's three entry-point processes (inference, training/enrollment,
people-count) coordinate exclusively through one shared MongoDB — the job
queue's atomic claim (reference trainingServer.py:491-513), gallery delta
sync on ``lastUpdated`` (infrenceServer.py:210-232), and batched state
writes (peopleCount.py:547-587) all assume a single database every process
can reach.  The embedded store (``documents.py``) is in-process memory, so
on its own it only supports single-process deployments; real multi-process
deployments would need a ``mongodb://`` URI and pymongo.

``fre://host:port`` closes that gap hermetically: ``store.server`` hosts one
embedded :class:`~.documents.Database` (optionally ``file://``-persisted)
behind a tiny length-prefixed-frame protocol, and this module's
:class:`RemoteDatabase` exposes the same pymongo-shaped surface the rest of
the framework already codes against.  Every RPC executes under the server
database's lock, so cross-process semantics (atomic job claims, unique
indexes, consistent bulk writes) are identical to the in-process store.

Wire format: 4-byte big-endian length + pickle.  Pickles are decoded with a
restricted unpickler on BOTH sides — only document data types (datetime,
ObjectId, numpy scalars/arrays) and this package's bulk-request classes
resolve; anything else raises, so a hostile peer cannot reach arbitrary
constructors.  An optional shared token (``FRE_STORE_TOKEN``) must be
presented as the first frame when the server has one configured.
"""

from __future__ import annotations

import io
import os
import pickle
import socket
import struct
import threading

from . import documents
from .objectid import ObjectId

MAX_FRAME_BYTES = 256 * 1024 * 1024  # > any legitimate doc batch
_LEN = struct.Struct(">I")

#: (module, qualname) pairs the restricted unpickler resolves.  Data types
#: that legitimately appear inside documents, plus the store's own request/
#: error classes.  Nothing here has import- or call-time side effects.
_SAFE_CLASSES = {
    ("datetime", "datetime"),
    ("datetime", "date"),
    ("datetime", "time"),
    ("datetime", "timedelta"),
    ("datetime", "timezone"),
    (f"{__package__}.objectid", "ObjectId"),
    (f"{__package__}.documents", "InsertOne"),
    (f"{__package__}.documents", "UpdateOne"),
    (f"{__package__}.documents", "UpdateMany"),
    (f"{__package__}.documents", "DeleteOne"),
    (f"{__package__}.documents", "DeleteMany"),
    (f"{__package__}.documents", "ReplaceOne"),
    # numpy scalars/arrays occasionally ride inside docs (scores, means)
    ("numpy", "ndarray"),
    ("numpy", "dtype"),
    ("numpy.core.multiarray", "_reconstruct"),
    ("numpy._core.multiarray", "_reconstruct"),
    ("numpy.core.multiarray", "scalar"),
    ("numpy._core.multiarray", "scalar"),
    ("numpy.core.numeric", "_frombuffer"),
    ("numpy._core.numeric", "_frombuffer"),
}


class _RestrictedUnpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if (module, name) in _SAFE_CLASSES:
            return super().find_class(module, name)
        raise pickle.UnpicklingError(
            f"refusing to unpickle {module}.{name} (not an allowed store "
            "data type)")


def dumps(obj) -> bytes:
    return pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)


def loads(blob: bytes):
    return _RestrictedUnpickler(io.BytesIO(blob)).load()


def send_frame(sock: socket.socket, payload: bytes) -> None:
    sock.sendall(_LEN.pack(len(payload)) + payload)


def recv_frame(sock: socket.socket) -> bytes | None:
    """One frame, or None on clean EOF at a frame boundary."""
    header = _recv_exact(sock, _LEN.size, eof_ok=True)
    if header is None:
        return None
    (n,) = _LEN.unpack(header)
    if n > MAX_FRAME_BYTES:
        raise ConnectionError(f"frame of {n} bytes exceeds MAX_FRAME_BYTES")
    return _recv_exact(sock, n)


def _recv_exact(sock: socket.socket, n: int, eof_ok: bool = False):
    buf = b""
    while len(buf) < n:
        part = sock.recv(n - len(buf))
        if not part:
            if eof_ok and not buf:
                return None
            raise ConnectionError("peer closed mid-frame")
        buf += part
    return buf


class RemoteStoreError(RuntimeError):
    """Server-side failure that has no local exception class."""


# errors re-raised by name with their original message
_ERROR_CLASSES = {
    "DuplicateKeyError": documents.DuplicateKeyError,
    "WriteError": documents.WriteError,
    "ValueError": ValueError,
    "TypeError": TypeError,
    "KeyError": KeyError,
}


#: methods safe to replay after a connection loss mid-call (pure reads)
_IDEMPOTENT = frozenset({
    "__find__", "count_documents", "estimated_document_count", "distinct",
    "aggregate", "index_information", "list_collection_names", "command",
})


class RemoteDatabase:
    """pymongo-shaped client for a ``store.server`` instance.

    One socket, one outstanding request at a time (a lock serializes
    callers); one transparent reconnect on a broken connection.  Collection
    handles are plain views — all state lives on the server.
    """

    def __init__(self, host: str, port: int, name: str = "bharatlytics",
                 token: str | None = None, timeout: float = 30.0):
        self.name = name
        self._addr = (host, port)
        self._token = token if token is not None else os.environ.get(
            "FRE_STORE_TOKEN", "")
        self._timeout = timeout
        self._lock = threading.Lock()
        self._sock: socket.socket | None = None
        self._connect()

    # -- wire
    def _connect(self):
        sock = socket.create_connection(self._addr, timeout=self._timeout)
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        send_frame(sock, dumps(("auth", self._token)))
        blob = recv_frame(sock)
        if blob is None:
            raise ConnectionError("store server closed during handshake")
        status = loads(blob)
        if status != ("ok", "authed"):
            raise ConnectionError(f"store server rejected handshake: {status}")
        self._sock = sock

    def _call(self, collection: str | None, method: str, *args, **kwargs):
        request = dumps((self.name, collection, method, args, kwargs))
        with self._lock:
            for attempt in (0, 1):
                if self._sock is None:
                    self._connect()
                sent = False
                try:
                    send_frame(self._sock, request)
                    sent = True
                    blob = recv_frame(self._sock)
                    if blob is None:
                        raise ConnectionError("store server closed connection")
                    break
                except (ConnectionError, OSError):
                    try:
                        if self._sock is not None:
                            self._sock.close()
                    finally:
                        self._sock = None
                    # One transparent reconnect, but never blind
                    # at-least-once for writes: a frame that never fully left cannot have
                    # executed (length-prefixed), and pure reads are safe to
                    # replay regardless.  A WRITE that was fully sent may
                    # already have applied server-side — retrying could
                    # double-apply (e.g. $inc) — so that one error surfaces
                    # and the caller decides.
                    if attempt or (sent and method not in _IDEMPOTENT):
                        raise
        status = loads(blob)
        if status[0] == "ok":
            return status[1]
        _, kind, message, details = status
        if kind == "BulkWriteError":
            raise documents.BulkWriteError(details)
        cls = _ERROR_CLASSES.get(kind)
        if cls is not None:
            raise cls(message)
        raise RemoteStoreError(f"{kind}: {message}")

    # -- database surface
    def __getitem__(self, name: str) -> "RemoteCollection":
        return RemoteCollection(self, name)

    def __getattr__(self, name: str) -> "RemoteCollection":
        if name.startswith("_"):
            raise AttributeError(name)
        return self[name]

    def list_collection_names(self) -> list:
        return self._call(None, "list_collection_names")

    def drop_collection(self, name: str):
        self._call(None, "drop_collection", name)

    def command(self, cmd):
        return self._call(None, "command", cmd)

    def flush(self):
        self._call(None, "flush")

    def close(self):
        with self._lock:
            if self._sock is not None:
                try:
                    self._sock.close()
                finally:
                    self._sock = None


class RemoteCursor:
    """Mirrors ``documents.Cursor``: lazy sort/skip/limit, resolved in one
    RPC so ordering/pagination happen next to the data.

    Like pymongo (and unlike the embedded Cursor, which snapshots matches
    at ``find()`` time), the query executes when the cursor is first
    consumed — writes between ``find()`` and iteration are visible."""

    def __init__(self, col: "RemoteCollection", filter, projection):
        self._col = col
        self._filter = filter or {}
        self._projection = projection
        self._sort = None
        self._skip = 0
        self._limit = None

    def sort(self, key_or_list, direction: int = 1) -> "RemoteCursor":
        if isinstance(key_or_list, str):
            self._sort = [(key_or_list, direction)]
        else:
            self._sort = [tuple(kv) for kv in key_or_list]
        return self

    def skip(self, n: int) -> "RemoteCursor":
        self._skip = n
        return self

    def limit(self, n: int) -> "RemoteCursor":
        self._limit = n
        return self

    def _resolved(self) -> list:
        return self._col._db._call(
            self._col.name, "__find__", self._filter, self._projection,
            self._sort, self._skip, self._limit)

    def __iter__(self):
        return iter(self._resolved())

    def __len__(self):
        return len(self._resolved())

    def __getitem__(self, i):
        return self._resolved()[i]


class RemoteCollection:
    def __init__(self, db: RemoteDatabase, name: str):
        self._db = db
        self.name = name

    # reads
    def find(self, filter: dict | None = None, projection: dict | None = None):
        return RemoteCursor(self, filter, projection)

    def find_one(self, filter: dict | None = None,
                 projection: dict | None = None, sort=None):
        cur = self.find(filter, projection)
        if sort:
            cur = cur.sort(sort)
        for doc in cur.limit(1):
            return doc
        return None

    def count_documents(self, filter: dict | None = None) -> int:
        return self._db._call(self.name, "count_documents", filter or {})

    def estimated_document_count(self) -> int:
        return self._db._call(self.name, "estimated_document_count")

    def distinct(self, key: str, filter: dict | None = None) -> list:
        return self._db._call(self.name, "distinct", key, filter)

    def aggregate(self, pipeline: list) -> list:
        return self._db._call(self.name, "aggregate", pipeline)

    # writes — results are reconstructed from plain tuples so the wire
    # never carries result classes
    def insert_one(self, document: dict):
        inserted_id = self._db._call(self.name, "insert_one", document)
        document.setdefault("_id", inserted_id)  # mirror pymongo
        return documents.InsertOneResult(inserted_id)

    def insert_many(self, docs) -> documents.InsertManyResult:
        docs = list(docs)
        ids = self._db._call(self.name, "__insert_many__", docs)
        for d, _id in zip(docs, ids):  # mirror pymongo: ids visible on inputs
            d.setdefault("_id", _id)
        return documents.InsertManyResult(ids)

    def _update_result(self, triple) -> documents.UpdateResult:
        return documents.UpdateResult(*triple)

    def update_one(self, filter, update, upsert=False):
        return self._update_result(
            self._db._call(self.name, "update_one", filter, update, upsert))

    def update_many(self, filter, update, upsert=False):
        return self._update_result(
            self._db._call(self.name, "update_many", filter, update, upsert))

    def replace_one(self, filter, replacement, upsert=False):
        return self._update_result(
            self._db._call(self.name, "replace_one", filter, replacement,
                           upsert))

    def find_one_and_update(self, filter, update, upsert=False,
                            return_document=False, sort=None):
        return self._db._call(self.name, "find_one_and_update", filter,
                              update, upsert, return_document, sort)

    def find_one_and_replace(self, filter, replacement, upsert=False,
                             return_document=False, sort=None):
        return self._db._call(self.name, "find_one_and_replace", filter,
                              replacement, upsert, return_document, sort)

    def find_one_and_delete(self, filter, sort=None):
        return self._db._call(self.name, "find_one_and_delete", filter, sort)

    def delete_one(self, filter) -> documents.DeleteResult:
        return documents.DeleteResult(
            self._db._call(self.name, "delete_one", filter))

    def delete_many(self, filter) -> documents.DeleteResult:
        return documents.DeleteResult(
            self._db._call(self.name, "delete_many", filter))

    def bulk_write(self, requests: list, ordered: bool = True):
        return documents.BulkWriteResult(
            *self._db._call(self.name, "bulk_write", requests, ordered))

    # indexes / admin
    def create_index(self, keys, unique: bool = False, **kwargs) -> str:
        return self._db._call(self.name, "create_index", keys,
                              unique=unique, **kwargs)

    def index_information(self) -> dict:
        return self._db._call(self.name, "index_information")

    def drop(self):
        self._db._call(self.name, "drop")
