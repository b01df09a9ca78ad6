"""Socket server hosting the embedded store for multi-process deployments.

The reference deploys three cooperating processes against one MongoDB Atlas
database (SURVEY.md §0, §5.8).  With no pymongo in the image, this server is
what lets this framework's own entry points (api_server, inference_server,
training_server, people_count) run as separate OS processes that still share
one datastore — hermetically, with the embedded store's exact operator
semantics.  Point every process at ``MONGODB_URI=fre://host:port`` and run:

    python -m facerecognition_infrenceengine_tpu_torch.store.server \
        --listen 127.0.0.1:27027 --uri file:///var/lib/fre-store

Protocol, framing, and the restricted unpickler live in ``remote.py`` (one
module owns the wire so both ends stay in lockstep).  Each request executes
a single Collection/Database method under the embedded database's lock, so
every cross-process guarantee the in-process store gives (atomic job
claims, unique indexes, ordered bulk writes) holds across processes too.
One thread per connection; the store itself is thread-safe.
"""

from __future__ import annotations

import argparse
import hmac
import os
import signal
import socket
import threading

from . import documents, remote
from .documents import Cursor, Database

# Database methods a client may invoke (collection=None in the request).
_DB_METHODS = {"list_collection_names", "drop_collection", "command", "flush"}


def _result_payload(value):
    """Map store results onto plain wire values (no result classes cross)."""
    if isinstance(value, documents.InsertOneResult):
        return value.inserted_id
    if isinstance(value, documents.UpdateResult):
        return (value.matched_count, value.modified_count, value.upserted_id)
    if isinstance(value, documents.DeleteResult):
        return value.deleted_count
    if isinstance(value, documents.BulkWriteResult):
        return (value.inserted_count, value.matched_count,
                value.modified_count, value.deleted_count,
                value.upserted_count)
    if isinstance(value, Cursor):
        return list(value)
    return value


class StoreServer:
    def __init__(self, host: str = "127.0.0.1", port: int = 27027,
                 persist_dir: str = "", token: str | None = None):
        self._host = host
        self._port = port
        self._persist_dir = persist_dir
        self._token = token if token is not None else os.environ.get(
            "FRE_STORE_TOKEN", "")
        self._dbs: dict[str, Database] = {}
        self._dbs_lock = threading.Lock()
        self._listener: socket.socket | None = None
        self._stopping = threading.Event()
        self._threads: list[threading.Thread] = []
        self._conns: set[socket.socket] = set()
        self._conns_lock = threading.Lock()

    # -- lifecycle
    def start(self) -> tuple[str, int]:
        """Bind + start the accept thread; returns the bound (host, port)
        (port 0 resolves to the kernel-assigned port — used by tests)."""
        listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        listener.bind((self._host, self._port))
        listener.listen(64)
        self._listener = listener
        self._port = listener.getsockname()[1]
        t = threading.Thread(target=self._accept_loop, daemon=True,
                             name="fre-store-accept")
        t.start()
        self._threads.append(t)
        return self._host, self._port

    def stop(self):
        self._stopping.set()
        # shutdown() BEFORE close(): close() alone does not wake a thread
        # blocked in accept()/recv() — the kernel holds the socket open for
        # the duration of the blocked syscall, leaving the port LISTENing
        # after stop() and a same-port restart in EADDRINUSE
        if self._listener is not None:
            try:
                try:
                    self._listener.shutdown(socket.SHUT_RDWR)
                except OSError:
                    pass
                self._listener.close()
            finally:
                self._listener = None
        with self._conns_lock:
            conns, self._conns = list(self._conns), set()
        for conn in conns:
            try:
                conn.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                conn.close()
            except OSError:
                pass
        with self._dbs_lock:
            for db in self._dbs.values():
                db.close()  # flushes file:// snapshots

    def serve_forever(self):
        self.start()
        print(f"# fre-store serving on {self._host}:{self._port}"
              f"{' (persisted: ' + self._persist_dir + ')' if self._persist_dir else ''}",
              flush=True)
        self._stopping.wait()

    # -- internals
    def _database(self, name: str) -> Database:
        with self._dbs_lock:
            if name not in self._dbs:
                self._dbs[name] = Database(name,
                                           persist_dir=self._persist_dir)
            return self._dbs[name]

    def _accept_loop(self):
        while not self._stopping.is_set():
            try:
                listener = self._listener
                if listener is None:  # stop() ran between the event check
                    return            # and the attribute read
                conn, _ = listener.accept()
            except OSError:
                return  # listener closed
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            # a dying connection (FIN_WAIT) must not block a server restart
            # on the same port: every socket on the port needs REUSEADDR
            conn.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            with self._conns_lock:
                self._conns.add(conn)
            t = threading.Thread(target=self._serve_client, args=(conn,),
                                 daemon=True, name="fre-store-conn")
            t.start()

    def _serve_client(self, conn: socket.socket):
        with conn:
            try:
                if not self._handshake(conn):
                    return
                while not self._stopping.is_set():
                    blob = remote.recv_frame(conn)
                    if blob is None:
                        return  # client hung up cleanly
                    remote.send_frame(conn, self._handle(blob))
            except (ConnectionError, OSError):
                return  # dead peer; per-connection state is nothing
            finally:
                with self._conns_lock:
                    self._conns.discard(conn)

    def _handshake(self, conn: socket.socket) -> bool:
        blob = remote.recv_frame(conn)
        if blob is None:
            return False
        try:
            kind, token = remote.loads(blob)
        except Exception:
            return False
        if kind != "auth" or not hmac.compare_digest(
                str(token), str(self._token)):
            remote.send_frame(conn, remote.dumps(
                ("err", "AuthError", "bad token", None)))
            return False
        remote.send_frame(conn, remote.dumps(("ok", "authed")))
        return True

    def _handle(self, blob: bytes) -> bytes:
        try:
            db_name, collection, method, args, kwargs = remote.loads(blob)
            db = self._database(db_name)
            if collection is None:
                if method not in _DB_METHODS:
                    raise ValueError(f"unsupported database method {method}")
                value = getattr(db, method)(*args, **kwargs)
            elif method == "__insert_many__":
                # one frame for the whole batch (client-side insert_many);
                # embedded insert_many is per-doc under the db lock, same
                # stop-at-first-error semantics as pymongo ordered inserts
                value = db[collection].insert_many(args[0]).inserted_ids
            elif method == "__find__":
                filter, projection, sort, skip, limit = args
                cur = db[collection].find(filter, projection)
                if sort:
                    cur = cur.sort(sort)
                if skip:
                    cur = cur.skip(skip)
                if limit is not None:
                    cur = cur.limit(limit)
                value = list(cur)
            elif method.startswith("_"):
                raise ValueError(f"unsupported collection method {method}")
            else:
                value = getattr(db[collection], method)(*args, **kwargs)
            return remote.dumps(("ok", _result_payload(value)))
        except documents.BulkWriteError as e:
            return remote.dumps(("err", "BulkWriteError", str(e), e.details))
        except Exception as e:  # semantics errors ride back to the caller
            return remote.dumps(("err", type(e).__name__, str(e), None))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        description="Serve the embedded store to multiple processes "
                    "(MONGODB_URI=fre://host:port on the clients)")
    p.add_argument("--listen", default="127.0.0.1:27027",
                   metavar="HOST:PORT")
    p.add_argument("--uri", default="memory://",
                   help="backing store: memory:// or file:///dir")
    p.add_argument("--token", default=None,
                   help="shared secret (default: $FRE_STORE_TOKEN)")
    args = p.parse_args(argv)
    host, _, port = args.listen.rpartition(":")
    persist_dir = ""
    if args.uri.startswith("file://"):
        persist_dir = args.uri[len("file://"):]
    elif not args.uri.startswith("memory"):
        p.error(f"unsupported backing uri {args.uri!r} "
                "(the server IS the network layer; memory:// or file:// only)")
    server = StoreServer(host or "127.0.0.1", int(port),
                         persist_dir=persist_dir, token=args.token)
    for sig in (signal.SIGINT, signal.SIGTERM):
        signal.signal(sig, lambda *_: server.stop())
    server.serve_forever()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
