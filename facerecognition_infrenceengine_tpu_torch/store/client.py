"""Datastore selection: embedded store or real MongoDB.

The reference connects straight to MongoDB Atlas with hardcoded credentials
(reference app/config/config.py:8) and builds collection/GridFS handles at
import time (db/__init__.py:8-26).  Here the backend is chosen from config:
a ``mongodb://`` URI uses pymongo when importable; anything else (default
``memory://``) uses the embedded store — the same API either way.
"""

from __future__ import annotations

import threading

from ..core.config import Config, get_config
from . import documents, gridfs

_lock = threading.Lock()
_instances: dict = {}


def _make_backend(cfg: Config):
    """-> (db, make_fs, update_one_cls) for the chosen backend.

    ``update_one_cls`` is the bulk-op request type the backend's
    ``bulk_write`` accepts — pymongo rejects the embedded store's UpdateOne
    and vice versa, so writers must use ``Datastore.UpdateOne``.
    """
    uri = cfg.db.mongodb_uri
    if uri.startswith("mongodb"):
        try:
            import pymongo
            import gridfs as real_gridfs

            client = pymongo.MongoClient(uri)
            db = client[cfg.db.database_name]
            return (db, lambda name: real_gridfs.GridFS(db, collection=name),
                    pymongo.UpdateOne)
        except ImportError:
            raise RuntimeError(
                "MONGODB_URI is set to a mongodb:// URI but pymongo is not "
                "installed; install pymongo or use memory://"
            )
    if uri.startswith("fre://"):
        # shared embedded store served by store.server — the hermetic way to
        # run api/inference/training/people_count as separate OS processes
        # against one datastore (the reference's Atlas topology, SURVEY §0)
        from . import remote

        hostport = uri[len("fre://"):].rstrip("/")
        if ":" in hostport:
            host, _, port = hostport.rpartition(":")
        else:
            # bare hostname (fre://localhost): rpartition would shove the
            # hostname into the port slot and int() would crash
            host, port = hostport, ""
        db = remote.RemoteDatabase(host or "127.0.0.1", int(port or 27027),
                                   name=cfg.db.database_name)
        return (db, lambda name: gridfs.GridFS(db, collection=name),
                documents.UpdateOne)
    persist_dir = ""
    if uri.startswith("file://"):
        persist_dir = uri[len("file://"):] or cfg.db.persist_dir
    elif cfg.db.persist_dir:
        persist_dir = cfg.db.persist_dir
    db = documents.Database(cfg.db.database_name, persist_dir=persist_dir)
    return (db, lambda name: gridfs.GridFS(db, collection=name),
            documents.UpdateOne)


class Datastore:
    """All collection and GridFS handles (reference db/__init__.py:8-26)."""

    def __init__(self, cfg: Config | None = None):
        cfg = cfg or get_config()
        self.cfg = cfg
        self.db, make_fs, self.UpdateOne = _make_backend(cfg)

        # Collections (reference db/__init__.py:10-18)
        self.companies = self.db["companies"]
        self.entities = self.db["entities"]
        self.assets = self.db["assets"]
        self.employee_info = self.db["employeeInfo"]
        self.entity_templates = self.db["entityTemplates"]
        self.entity_definitions = self.db["entityDefinitions"]
        self.embedding_jobs = self.db["embeddingJobs"]
        self.visitors = self.db["visitors"]
        self.visits = self.db["visits"]
        self.audit_logs = self.db["auditLogs"]
        self.security_events = self.db["securityEvents"]

        # GridFS buckets — bucket names match the reference so real-Mongo
        # deployments share data (reference db/__init__.py:22-26)
        self.employee_images = make_fs("employee_images")
        self.employee_embeddings = make_fs("employee_embeddings")
        self.visitor_images = make_fs("visitor_images")
        self.visitor_embeddings = make_fs("visitor_embeddings")

        # peopleCount collections (reference peopleCount.py:217-220)
        self.people_status = self.db["people_status"]
        self.campus_events = self.db["campus_events"]
        self.campus_analytics = self.db["campus_analytics"]
        self.unknown_detections = self.db["unknown_detections"]
        # beyond-reference: persisted unknown clusters (the reference loses
        # them on restart, peopleCount.py:231; SURVEY §5.4)
        self.unknown_clusters = self.db["unknown_clusters"]


def get_datastore(cfg: Config | None = None, fresh: bool = False) -> Datastore:
    """Process-wide singleton per database name (embedded backend), so the
    API, workers, and engines in one process share state like the reference's
    processes share one Mongo."""
    cfg = cfg or get_config()
    key = (cfg.db.mongodb_uri, cfg.db.database_name)
    if fresh:
        return Datastore(cfg)
    with _lock:
        if key not in _instances:
            _instances[key] = Datastore(cfg)
        return _instances[key]


def reset_datastores() -> None:
    """Testing hook: drop all embedded singletons."""
    with _lock:
        _instances.clear()
