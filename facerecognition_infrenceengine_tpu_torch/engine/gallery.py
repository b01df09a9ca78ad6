"""Device-resident gallery: per-company snapshots, the top-1 match, and the
store-backed ``GalleryManager`` that keeps them in sync.

The torch form of ``facerecognition_infrenceengine_tpu/engine/gallery.py``.
A per-company snapshot holds ids, metadata and a padded power-of-two-capacity
[capacity, 512] matrix whose first ``size`` rows are live (a prefix mask,
never read by the top-1 kernels).  A k == 1 match runs K1
(``ops/match_kernel.gallery_top1``, f32 / bf16) or K2
(``gallery_top1_int8``, an int8 matrix with one global scale); k > 1 runs
``cosine_topk`` on the float (for int8, dequantized) matrix, as the
reference does off its TPU.  A float32 snapshot scores in true f32 on the
card: K1 accumulates with FFMA, and the snapshot keeps no bf16 or TF32 copy
(the reference caches a bf16 scoring copy on a TPU only, where its f32
matmul rounds to bf16 anyway).

``GalleryManager`` loads every active, non-blacklisted employee and every
visitor with a finished buffalo_l embedding from the datastore, L2-normalizes
them and keeps them in sync by ``lastUpdated`` delta polling on a background
thread, with the reference's filters: inactive or blacklisted employees
leave, hard-deleted ids leave through an existence audit, and cached
snapshots evolve by O(delta) row scatters (``apply_delta``).
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Dict, Tuple

import numpy as np
import torch

from ..core import metrics
from ..core.clock import get_current_utc
from ..core.config import Config, get_config
from ..core.device import resolve_device
from ..core.serialization import deserialize_embedding
from ..ops.match_kernel import gallery_top1, gallery_top1_int8, quantize_gallery
from ..ops.matching import cosine_topk
from ..store.client import Datastore
from ..store.objectid import ObjectId
from .pipeline import bucket

logger = logging.getLogger("fre.gallery")

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _normalize(vec: np.ndarray) -> np.ndarray:
    vec = np.asarray(vec, np.float32).reshape(-1)
    n = np.linalg.norm(vec)
    return vec / n if n > 0 else vec


def _next_capacity(n: int, block: int) -> int:
    cap = block
    while cap < n:
        cap *= 2
    return cap


def _prefix_mask(cap: int, n: int, device) -> torch.Tensor:
    """[cap] bool mask of a contiguous prefix of n live rows."""
    return torch.arange(cap, device=device) < n


def _scatter_rows(matrix: torch.Tensor, rows: np.ndarray, vals: np.ndarray) -> torch.Tensor:
    """A copy of ``matrix`` with ``rows`` set to ``vals``.  Only the delta's
    rows cross from the host; the copy is made on the device so snapshots
    stay value-immutable (a matcher holding the old one keeps a consistent
    (ids, matrix) pair).  The reference pads the row count to a power-of-two
    bucket to bound its compiled scatter shapes; eager torch needs no bucket."""
    dev = matrix.device
    out = matrix.clone()
    out.index_copy_(0, torch.from_numpy(rows.astype(np.int64)).to(dev),
                    torch.from_numpy(vals).to(dev, matrix.dtype))
    return out


class _CompanySnapshot:
    """Per-company device view: ids + padded matrix + prefix-valid mask.

    Snapshots are value-immutable: ``apply_delta`` returns a new snapshot
    with its own matrix, so matchers holding the old one are unaffected.
    """

    full_builds = 0  # O(delta) sync tests pin this

    @metrics.on_device
    def __init__(self, ids, metadata, matrix, embed_dim: int, block: int,
                 dtype: str = "float32", device=None):
        if dtype not in _DTYPES and dtype != "int8":
            raise ValueError(f"gallery dtype {dtype!r}")
        _CompanySnapshot.full_builds += 1
        self.ids = list(ids)
        self.metadata = metadata
        self.embed_dim = embed_dim
        self.block = block
        self.dtype = dtype
        n = len(self.ids)
        cap = _next_capacity(max(n, 1), block)
        padded = np.zeros((cap, embed_dim), np.float32)
        if n:
            padded[:n] = matrix
        device = resolve_device(device)
        self.int8_scale = None
        if dtype == "int8":
            q, self.int8_scale = quantize_gallery(padded, headroom=1.25)
            self.device_matrix = torch.from_numpy(q).to(device)
        else:
            self.device_matrix = torch.from_numpy(padded).to(device, _DTYPES[dtype])
        self.device_valid = _prefix_mask(cap, n, device)
        self.size = n
        self.row_of = {pid: i for i, pid in enumerate(self.ids)}

    @classmethod
    def _evolved(cls, src: "_CompanySnapshot", ids, row_of, metadata, device_matrix,
                 device_valid, size):
        snap = object.__new__(cls)
        snap.ids = ids
        snap.row_of = row_of
        snap.metadata = metadata
        snap.embed_dim = src.embed_dim
        snap.block = src.block
        snap.dtype = src.dtype
        snap.int8_scale = src.int8_scale
        snap.device_matrix = device_matrix
        snap.device_valid = device_valid
        snap.size = size
        return snap

    @metrics.on_device
    def apply_delta(self, updates: dict, meta_updates: dict, removals,
                    get_vec) -> "_CompanySnapshot | None":
        """O(delta) evolution: scatter the changed rows into a copy of the
        matrix.

        updates: pid -> L2-normalized f32 vector (new or changed people);
        meta_updates: pid -> metadata for every pid in ``updates``;
        removals: pids to evict (absent pids are ignored);
        get_vec: pid -> current f32 vector, for rows that swap-fill holes.

        Returns the evolved snapshot, ``self`` when nothing is relevant, or
        ``None`` when a full rebuild is required (capacity growth, or an int8
        vector that the global scale would clip).
        """
        # Removals by row, descending: each hole is swap-filled with the
        # current last live row, which is then never a pending removal.
        rel_removals = sorted(dict.fromkeys(p for p in removals if p in self.row_of),
                              key=lambda p: -self.row_of[p])
        removed_set = set(rel_removals)
        rel_updates = {p: v for p, v in updates.items() if p not in removed_set}
        new_pids = [p for p in rel_updates if p not in self.row_of]
        if not (rel_removals or rel_updates):
            return self
        cap = int(self.device_matrix.shape[0])
        new_size = self.size - len(rel_removals) + len(new_pids)
        if new_size > cap:
            return None  # capacity growth: rebuild at the doubled capacity
        if self.dtype == "int8" and rel_updates:
            newmax = max(float(np.abs(v).max()) for v in rel_updates.values())
            if newmax > self.int8_scale * 127.0 * (1.0 + 1e-6):
                return None  # the global scale would clip: requantize

        ids = list(self.ids)
        row_of = dict(self.row_of)
        metadata = dict(self.metadata)
        touched: dict = {}  # row -> f32 vector
        size = self.size
        # evictions keep the live prefix contiguous (the top-1 kernels mask
        # by row < size)
        for pid in rel_removals:
            r = row_of.pop(pid)
            metadata.pop(pid, None)
            size -= 1
            if r != size:
                moved = ids[size]
                ids[r] = moved
                row_of[moved] = r
                touched[r] = rel_updates.get(moved)
                if touched[r] is None:
                    touched[r] = get_vec(moved)
            touched.pop(size, None)  # the row past the new prefix is dead
            del ids[size]
        for pid, vec in rel_updates.items():
            if pid in row_of:  # in-place update (or a row just swap-moved)
                touched[row_of[pid]] = vec
            else:  # append
                row_of[pid] = size
                ids.append(pid)
                touched[size] = vec
                size += 1
            metadata[pid] = meta_updates[pid]
        assert size == new_size

        matrix = self.device_matrix
        if touched:
            rows = np.fromiter(touched.keys(), np.int64, len(touched))
            vals = np.stack([np.asarray(v, np.float32) for v in touched.values()])
            if self.dtype == "int8":
                vals = np.clip(np.rint(vals / self.int8_scale), -127, 127).astype(np.int8)
            matrix = _scatter_rows(matrix, rows, vals)
        valid = (self.device_valid if size == self.size
                 else _prefix_mask(cap, size, matrix.device))
        return _CompanySnapshot._evolved(self, ids, row_of, metadata, matrix, valid, size)

    @classmethod
    @metrics.on_device
    def from_device_matrix(cls, device_matrix: torch.Tensor, size: int, dtype: str,
                           int8_scale=None, ids=None, metadata=None, embed_dim: int = 512,
                           block: int = 1024) -> "_CompanySnapshot":
        """Wrap an already-on-device padded [capacity, embed_dim] matrix (first
        ``size`` rows live) as a snapshot, without a host copy: galleries of
        millions of rows are generated on the card in milliseconds.  Ids
        default to ``str(row)``."""
        snap = object.__new__(cls)
        n = int(size)
        snap.ids = list(ids) if ids is not None else [str(i) for i in range(n)]
        snap.row_of = {pid: i for i, pid in enumerate(snap.ids)}
        snap.metadata = metadata or {}
        snap.embed_dim = embed_dim
        snap.block = block
        snap.dtype = dtype
        snap.int8_scale = int8_scale
        snap.device_matrix = device_matrix
        snap.device_valid = _prefix_mask(int(device_matrix.shape[0]), n, device_matrix.device)
        snap.size = n
        return snap

    def _dense_matrix(self) -> torch.Tensor:
        """Float view for the k > 1 path (dequantizes int8)."""
        if self.dtype != "int8":
            return self.device_matrix
        return self.device_matrix.float() * self.int8_scale

    @metrics.on_device
    @torch.inference_mode()
    def match(self, query_embeddings: np.ndarray, k: int = 1):
        """[B, D] normalized queries -> (scores [B, k], ids [B, k] of str|None)."""
        b_real = len(query_embeddings)
        if self.size == 0 or b_real == 0:
            return np.full((b_real, k), -1.0, np.float32), [[None] * k for _ in range(b_real)]
        # Bucketed query batches keep the kernels on a few shapes; padded
        # zero queries change nothing for the real rows.
        q = np.zeros((bucket(b_real), self.embed_dim), np.float32)
        q[:b_real] = query_embeddings
        q32 = torch.from_numpy(q).to(self.device_matrix.device)
        vals, idx = self._device_match(q32, k)
        vals = vals.cpu().numpy()[:b_real]
        idx = idx.cpu().numpy()[:b_real]
        ids = [[self.ids[j] if 0 <= j < self.size and vals[b, i] > -np.inf else None
                for i, j in enumerate(row)] for b, row in enumerate(idx)]
        return vals, ids

    def _device_match(self, q32: torch.Tensor, k: int = 1):
        """Device (vals [B, k], idx [B, k]): K2 (int8) or K1 for k == 1, else
        cosine_topk on the float (dequantized) matrix."""
        if k == 1:
            if self.dtype == "int8":
                v1, i1 = gallery_top1_int8(q32, self.device_matrix, self.int8_scale,
                                           self.size)
            else:
                v1, i1 = gallery_top1(q32.to(self.device_matrix.dtype),
                                      self.device_matrix, self.size)
            return v1[:, None], i1[:, None]
        dense = self._dense_matrix()
        return cosine_topk(q32.to(dense.dtype), dense, self.device_valid, k=k)


class GalleryManager:
    """The store-backed gallery: a host cache of every person's normalized
    embedding and metadata, and one device snapshot per company (``None``
    keys the whole gallery), built at first use and evolved on each sync."""

    def __init__(self, ds: Datastore, cfg: Config | None = None,
                 sync_interval_s: float | None = None, mesh=None,
                 initial_load: bool = True, device=None):
        # the device first: off the card this raises before any load
        self.device = resolve_device(device)
        if mesh is not None:
            raise NotImplementedError(
                "a sharded gallery (mesh) is ROADMAP Queue 1 item 5 (multi-GPU)")
        cfg = cfg or get_config()
        self.ds = ds
        self.cfg = cfg
        self.sync_interval = (sync_interval_s if sync_interval_s is not None
                              else cfg.sync.inference_sync_s)
        self._lock = threading.Lock()
        self.embeddings: Dict[str, np.ndarray] = {}
        self.metadata: Dict[str, dict] = {}
        self._snapshots: Dict[str, _CompanySnapshot] = {}
        self._version = 0
        self._sync_count = 0
        self.last_sync_time = None
        self.is_initial_load = True
        self.running = False
        self._thread = None
        if initial_load:
            self._initial_load()

    # ------------------------------------------------------------- loading
    def _initial_load(self):
        employees = list(self.ds.employee_info.find({
            "status": "active", "blacklisted": False,
            "employeeEmbeddings.buffalo_l.status": "done"}))
        visitors = list(self.ds.visitors.find({
            "visitorEmbeddings.buffalo_l.status": "done"}))
        self._load_updated(employees, visitors)
        self.last_sync_time = get_current_utc()
        self.is_initial_load = False
        logger.info("Initial gallery load: %d embeddings", len(self.embeddings))

    def _load_updated(self, employees, visitors):
        # GridFS reads and unpickling happen outside the lock (seconds for a
        # big delta); only the dict swap holds it, so matching never stalls
        # behind storage I/O
        loaded: dict = {}
        meta: dict = {}
        for employee in employees:
            try:
                pid = str(employee["_id"])
                entry = employee["employeeEmbeddings"]["buffalo_l"]
                blob = self.ds.employee_embeddings.get(
                    ObjectId(str(entry["embeddingId"]))).read()
                loaded[pid] = _normalize(deserialize_embedding(blob))
                meta[pid] = {
                    "name": employee.get("employeeName", "Unknown"),
                    "employeeId": employee.get("employeeId", "Unknown"),
                    "email": employee.get("employeeEmail", ""),
                    "mobile": employee.get("employeeMobile", ""),
                    "type": "employee",
                    "companyId": str(employee.get("companyId")),
                    "lastUpdated": employee.get("lastUpdated"),
                }
            except Exception as e:  # skip unreadable entries, keep serving
                logger.error("employee embedding load failed for %s: %s",
                             employee.get("_id"), e)
        for visitor in visitors:
            try:
                pid = str(visitor["_id"])
                entry = (visitor.get("visitorEmbeddings") or {}).get("buffalo_l") or {}
                if entry.get("status") != "done" or not entry.get("embeddingId"):
                    continue
                blob = self.ds.visitor_embeddings.get(
                    ObjectId(str(entry["embeddingId"]))).read()
                loaded[pid] = _normalize(deserialize_embedding(blob))
                meta[pid] = {
                    "name": visitor.get("visitorName", "Unknown"),
                    "type": "visitor",
                    "companyId": str(visitor.get("companyId")),
                    "lastUpdated": visitor.get("lastUpdated"),
                }
            except Exception as e:
                logger.error("visitor embedding load failed for %s: %s",
                             visitor.get("_id"), e)
        if not loaded:
            return
        with self._lock:
            # a person whose companyId changed leaves the old company's
            # snapshot as well as joining the new one
            moved = {pid for pid in loaded
                     if pid in self.metadata
                     and self.metadata[pid].get("companyId") != meta[pid].get("companyId")}
            self.embeddings.update(loaded)
            self.metadata.update(meta)
            pending = self._begin_delta_locked()
        self._evolve_snapshots(pending, loaded, meta, moved_companies=moved)

    def _remove_inactive(self, audit_existence: bool = True):
        inactive = self.ds.employee_info.find(
            {"$or": [{"status": {"$ne": "active"}}, {"blacklisted": True}]},
            {"_id": 1})
        inactive_ids = {str(d["_id"]) for d in inactive}
        # Hard-deleted people never match the inactive query: check that the
        # cached ids still exist.  Each 24-char id is probed in both forms: a
        # non-hex custom id must not raise InvalidId (which would end the
        # sync loop), and a doc whose _id is stored as a hex string must
        # still be found (an ObjectId never equals a str in the store).
        probes: list = []
        audited: set = set()
        if audit_existence:
            with self._lock:
                for pid in self.embeddings:
                    if len(pid) == 24:
                        audited.add(pid)
                        probes.append(pid)
                        if ObjectId.is_valid(pid):
                            probes.append(ObjectId(pid))
        existing: set = set()
        if probes:
            for coll in (self.ds.employee_info, self.ds.visitors):
                for d in coll.find({"_id": {"$in": probes}}, {"_id": 1}):
                    existing.add(str(d["_id"]))
        with self._lock:
            removed = set()
            for pid in list(self.embeddings):
                if pid in inactive_ids or (pid in audited and pid not in existing):
                    del self.embeddings[pid]
                    self.metadata.pop(pid, None)
                    removed.add(pid)
            pending = self._begin_delta_locked() if removed else None
        if removed:
            self._evolve_snapshots(pending, {}, {}, removals=removed)
            logger.info("Removed %d inactive/deleted embeddings", len(removed))

    def _begin_delta_locked(self) -> list:
        """Start a delta generation (the caller holds ``self._lock``, having
        just changed embeddings / metadata): bump the version so in-flight
        builds of the pre-delta state are not cached, and return the cached
        snapshots to evolve outside the lock."""
        self._version += 1
        return list(self._snapshots.items())

    def _evolve_snapshots(self, pending: list, updates: dict, meta: dict,
                          removals: set | None = None,
                          moved_companies: set | None = None):
        """Evolve every cached snapshot by the delta (O(delta) host -> device
        traffic).  A snapshot that cannot absorb it (capacity growth, int8
        scale drift) is dropped and rebuilt at its next use.

        Runs without ``self._lock``, so the scatters never stall matchers.
        Safe because snapshots are value-immutable, the sync thread is the
        only writer of the host cache, and the install is identity-checked:
        a snapshot a matcher rebuilt meanwhile (from the updated cache, so it
        holds this delta) is kept."""
        removals = removals or set()
        moved_companies = moved_companies or set()

        def get_vec(pid):
            return self.embeddings[pid]

        for key, snap in pending:
            if key == "__all__":
                rel_up, rel_rm = updates, removals
            else:
                rel_up = {p: v for p, v in updates.items()
                          if meta[p].get("companyId") == key}
                # company changes evict from every other company's snapshot
                rel_rm = removals | {p for p in moved_companies
                                     if meta[p].get("companyId") != key}
            rel_meta = {p: meta[p] for p in rel_up}
            new_snap = snap.apply_delta(rel_up, rel_meta, rel_rm, get_vec)
            with self._lock:
                if self._snapshots.get(key) is not snap:
                    continue  # rebuilt meanwhile: already holds the delta
                if new_snap is None:
                    del self._snapshots[key]  # rebuilt at its next use
                    metrics.counter("gallery.snapshot_rebuilds").inc()
                else:
                    if new_snap is not snap:
                        metrics.counter("gallery.delta_rows").inc(len(rel_up) + len(rel_rm))
                    self._snapshots[key] = new_snap

    # ---------------------------------------------------------------- sync
    def start_sync(self):
        if self.running:
            return
        self.running = True
        self._thread = threading.Thread(target=self._sync_loop, daemon=True)
        self._thread.start()

    def stop_sync(self):
        self.running = False
        if self._thread:
            self._thread.join(timeout=5)

    def _sync_loop(self):
        while self.running:
            try:
                self._sync()
                time.sleep(self.sync_interval)
            except Exception as e:
                logger.error("sync loop error: %s", e)
                time.sleep(5)

    def _sync(self):
        if self.last_sync_time is None:
            return
        t0 = time.perf_counter()
        since = self.last_sync_time
        # Stamp the next watermark before querying: a doc whose lastUpdated
        # lands while this sync runs is read again by the next one (reading
        # a doc twice is harmless; skipping one loses a person).
        next_watermark = get_current_utc()
        updated_employees = list(self.ds.employee_info.find({
            "lastUpdated": {"$gte": since}, "status": "active",
            "blacklisted": False,
            "employeeEmbeddings.buffalo_l.status": "done"}))
        updated_visitors = list(self.ds.visitors.find({
            "lastUpdated": {"$gte": since},
            "visitorEmbeddings.buffalo_l.status": "done"}))
        # The hard-delete audit probes every cached id: galleries up to
        # 100,000 ids audit every tick (a hard delete leaves within one sync
        # interval), larger ones every 10th tick; inactive and blacklisted
        # removals run every tick either way.
        self._sync_count += 1
        audit = len(self.embeddings) <= 100_000 or self._sync_count % 10 == 0
        self._remove_inactive(audit_existence=audit)
        if updated_employees or updated_visitors:
            self._load_updated(updated_employees, updated_visitors)
        self.last_sync_time = next_watermark
        metrics.timer("gallery.sync").observe(time.perf_counter() - t0)
        metrics.gauge("gallery.size").set(len(self.embeddings))

    def force_sync(self):
        self._sync()

    # ------------------------------------------------------------ matching
    def _company_person_ids(self, company_id: str) -> set:
        ids = set()
        for doc in self.ds.employee_info.find(
                {"companyId": ObjectId(company_id), "status": "active",
                 "blacklisted": False}, {"_id": 1}):
            ids.add(str(doc["_id"]))
        for doc in self.ds.visitors.find({"companyId": ObjectId(company_id)}, {"_id": 1}):
            ids.add(str(doc["_id"]))
        return ids

    def set_snapshot(self, ids, metadata: dict, matrix, company_id: str | None = None):
        """Install a snapshot built from row-aligned ids, {id: metadata} and an
        [n, 512] matrix (rows L2-normalized here, as a load normalizes them)
        for ``company_id``, as the reference's tests and benchmark build theirs
        directly, for a manager whose store holds no one of that key.  Syncs
        do not see these rows in the host cache."""
        matrix = np.asarray(matrix, np.float32).reshape(len(ids), self.cfg.engine.embed_dim)
        matrix = matrix / np.maximum(np.linalg.norm(matrix, axis=1, keepdims=True), 1e-12)
        snap = _CompanySnapshot(ids, metadata, matrix, self.cfg.engine.embed_dim,
                                self.cfg.engine.gallery_block,
                                dtype=self.cfg.engine.gallery_dtype, device=self.device)
        with self._lock:
            self._snapshots[company_id or "__all__"] = snap
        return snap

    def snapshot(self, company_id: str | None = None) -> _CompanySnapshot:
        """Device view for a company (or the whole gallery), cached per sync
        generation."""
        key = company_id or "__all__"
        with self._lock:
            snap = self._snapshots.get(key)
            if snap is not None:
                return snap
            version = self._version
        # Store reads happen outside the lock; everything touching
        # self.embeddings happens inside one acquisition, so a concurrent
        # removal cannot delete a pid between the id listing and the matrix
        # build.  _version detects an invalidation that raced the read: the
        # stale snapshot is returned but not cached.
        allowed = None if company_id is None else self._company_person_ids(company_id)
        with self._lock:
            ids = [pid for pid in self.embeddings if allowed is None or pid in allowed]
            vecs = [self.embeddings[i] for i in ids]  # refs only; cheap
            meta = {i: self.metadata[i] for i in ids}
        # stacking and uploading the matrix run without the lock, so matching
        # and syncing never stall behind a rebuild
        matrix = (np.stack(vecs) if ids
                  else np.zeros((0, self.cfg.engine.embed_dim), np.float32))
        snap = _CompanySnapshot(ids, meta, matrix, self.cfg.engine.embed_dim,
                                self.cfg.engine.gallery_block,
                                dtype=self.cfg.engine.gallery_dtype, device=self.device)
        with self._lock:
            if self._version == version:
                self._snapshots[key] = snap
        return snap

    def match(self, query_embeddings, company_id: str | None = None, k: int = 1):
        """Match normalized queries; returns (scores, ids, metadata-dict)."""
        snap = self.snapshot(company_id)
        scores, ids = snap.match(query_embeddings, k=k)
        return scores, ids, snap.metadata

    # ---------------------------------------------------- host-side views
    def get_embeddings_for_company(self, company_id: str) -> Tuple[dict, dict]:
        """{pid: vector}, {pid: metadata} of a company's snapshot."""
        snap = self.snapshot(company_id)
        with self._lock:
            emb = {pid: self.embeddings[pid] for pid in snap.ids if pid in self.embeddings}
        return emb, dict(snap.metadata)

    def get_all(self) -> Tuple[dict, dict]:
        with self._lock:
            return dict(self.embeddings), dict(self.metadata)

    def is_empty(self) -> bool:
        """O(1) empty check for per-frame guards (``get_stats`` walks the
        metadata)."""
        with self._lock:
            return not self.embeddings

    def get_stats(self) -> dict:
        with self._lock:
            employees = sum(1 for m in self.metadata.values() if m["type"] == "employee")
            visitors = sum(1 for m in self.metadata.values() if m["type"] == "visitor")
            return {
                "total_embeddings": len(self.embeddings),
                "employees": employees,
                "visitors": visitors,
                "last_sync": (self.last_sync_time.isoformat()
                              if self.last_sync_time else None),
                "initial_load_complete": not self.is_initial_load,
            }
