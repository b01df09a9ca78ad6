"""Campus entry/exit counting: person state machines + unknown clustering.

Behavior-identical re-implementation of the reference's
``CampusPeopleManager`` / ``PersonState`` / ``UnknownPerson``
(reference peopleCount.py:35-692; per-method citations inline):

- per-person INSIDE/OUTSIDE state with entry/exit debounce: a confirmation
  requires a second detection >= 2 s after the first on the same camera
  type, pending detections expire after 5 s (:140-185);
- unknown-person clustering against a running-mean embedding over the last
  10 detections, join threshold cos >= 0.65 (:52-91, :432-500);
- event and state writes are batched: flush every 5 s or at 50 pending via
  bulk_write/insert_many (:526-587);
- per-campus daily analytics rollup every 60 s (:589-626);
- state survives restarts via the people_status collection (:278-315).

Background threads are opt-in (``start_background``) so the state machine is
deterministic under test; ``flush()`` and ``update_analytics()`` expose the
thread bodies directly.

The port's copy of ``facerecognition_infrenceengine_tpu/domain/campus.py``.
"""

from __future__ import annotations

import logging
import threading
import time
from collections import defaultdict, deque
from datetime import datetime
from enum import Enum
from typing import Dict, List, Optional

import numpy as np

from ..api.utils import get_current_utc
from ..core.config import CampusConfig, Config, get_config
from ..store.client import Datastore

logger = logging.getLogger("fre.campus")


class CameraType(Enum):
    ENTRY = "entry"
    EXIT = "exit"


class PersonStatus(Enum):
    INSIDE = "inside"
    OUTSIDE = "outside"


class EventType(Enum):
    ENTRY = "entry"
    EXIT = "exit"
    ANOMALY = "anomaly"


class UnknownPerson:
    """reference peopleCount.py:52-91."""

    def __init__(self, unknown_id: str, campus_id: str, first_timestamp: datetime,
                 first_camera: str, first_embedding: np.ndarray, first_bbox: List[int],
                 history: int = 10):
        self.unknown_id = unknown_id
        self.campus_id = campus_id
        self.first_seen = first_timestamp
        self.last_seen = first_timestamp
        self.detection_count = 1
        self.cameras_seen = {first_camera}
        self.embeddings = deque(maxlen=history)
        self.embeddings.append(np.asarray(first_embedding, np.float32))
        self.avg_embedding = np.asarray(first_embedding, np.float32)
        self.last_bbox = first_bbox

    def update(self, timestamp, camera_id, embedding, bbox):
        self.last_seen = timestamp
        self.detection_count += 1
        self.cameras_seen.add(camera_id)
        self.embeddings.append(np.asarray(embedding, np.float32))
        self.avg_embedding = np.mean(list(self.embeddings), axis=0)
        self.last_bbox = bbox

    def compute_similarity(self, embedding) -> float:
        return float(np.dot(self.avg_embedding, embedding))

    def to_dict(self) -> dict:
        return {
            "unknown_id": self.unknown_id,
            "campus_id": self.campus_id,
            "first_seen": self.first_seen,
            "last_seen": self.last_seen,
            "detection_count": self.detection_count,
            "cameras_seen": list(self.cameras_seen),
            "last_bbox": self.last_bbox,
        }

    def to_persist_doc(self) -> dict:
        """Full cluster state for the unknown_clusters collection — the
        reference keeps clusters memory-only and loses them on restart
        (reference peopleCount.py:231, SURVEY §5.4); persisting the
        embedding window lets an unknown seen before a restart rejoin the
        same cluster after it."""
        doc = self.to_dict()
        doc["embeddings"] = [[float(v) for v in e] for e in self.embeddings]
        return doc

    @classmethod
    def from_doc(cls, doc: dict, history: int = 10) -> "UnknownPerson":
        embs = [np.asarray(e, np.float32) for e in doc.get("embeddings", [])]
        if not embs:
            embs = [np.zeros(512, np.float32)]
        obj = cls(doc["unknown_id"], doc["campus_id"], doc["first_seen"],
                  (doc.get("cameras_seen") or ["?"])[0], embs[0],
                  doc.get("last_bbox") or [0, 0, 0, 0], history=history)
        for e in embs[1:]:
            obj.embeddings.append(e)
        obj.avg_embedding = np.mean(list(obj.embeddings), axis=0)
        obj.last_seen = doc.get("last_seen", obj.first_seen)
        obj.detection_count = doc.get("detection_count", len(embs))
        obj.cameras_seen = set(doc.get("cameras_seen") or [])
        return obj


class _ClusterBank:
    """Stacked cluster-mean matrix per campus: the unknown-cluster match
    as ONE dot product instead of a per-cluster Python scan (the
    reference iterates clusters one `np.dot` at a time,
    peopleCount.py:445-455 — exactly the O(N) pattern this project
    replaces with matmuls).  Rows live in insertion order, so
    "first cluster above threshold" is the lowest matching row index —
    decision-identical to the reference loop.  Row upserts are O(1)
    scatters, the host-scale mirror of engine/gallery.apply_delta."""

    def __init__(self, dim: int, cap: int = 16):
        self.matrix = np.zeros((cap, dim), np.float32)
        self.ids: List[str] = []
        self.index: Dict[str, int] = {}

    def upsert(self, unknown_id: str, mean: np.ndarray):
        i = self.index.get(unknown_id)
        if i is None:
            i = len(self.ids)
            self.ids.append(unknown_id)
            self.index[unknown_id] = i
            if i >= len(self.matrix):
                self.matrix = np.vstack(
                    [self.matrix, np.zeros_like(self.matrix)])
        self.matrix[i] = mean

    def first_match(self, embedding: np.ndarray, threshold: float):
        """(unknown_id, similarity) of the FIRST cluster in insertion
        order with cos >= threshold, else None."""
        n = len(self.ids)
        if not n:
            return None
        sims = self.matrix[:n] @ np.asarray(embedding, np.float32)
        hits = np.flatnonzero(sims >= threshold)
        if not hits.size:
            return None
        i = int(hits[0])
        return self.ids[i], float(sims[i])


class PersonState:
    """reference peopleCount.py:94-201."""

    def __init__(self, person_id: str, metadata: dict, campus_id: str,
                 cfg: CampusConfig | None = None):
        self.cfg = cfg or get_config().campus
        self.person_id = person_id
        self.metadata = metadata
        self.campus_id = campus_id
        self.status = PersonStatus.OUTSIDE
        self.current_entry_time: Optional[datetime] = None
        self.last_exit_time: Optional[datetime] = None
        self.total_entries_today = 0
        self.total_exits_today = 0
        self.last_seen_camera: Optional[str] = None
        self.last_seen_time: Optional[datetime] = None
        self.pending_entry_detection: Optional[datetime] = None
        self.pending_exit_detection: Optional[datetime] = None
        self.pending_entry_camera: Optional[str] = None
        self.pending_exit_camera: Optional[str] = None
        self.pending_entry_similarity = 0.0
        self.pending_exit_similarity = 0.0
        self.detection_count_today = 0
        self.last_detection_logged: Optional[datetime] = None

    def should_log_detection(self, current_time, log_interval: float = 30.0) -> bool:
        if not self.last_detection_logged:
            return True
        return (current_time - self.last_detection_logged).total_seconds() >= log_interval

    def start_entry_detection(self, camera_id, timestamp, similarity):
        self.pending_entry_detection = timestamp
        self.pending_entry_camera = camera_id
        self.pending_entry_similarity = similarity

    def start_exit_detection(self, camera_id, timestamp, similarity):
        self.pending_exit_detection = timestamp
        self.pending_exit_camera = camera_id
        self.pending_exit_similarity = similarity

    def confirm_entry(self, timestamp) -> bool:
        # second detection >= confirm_delay_s after the first (:140-155)
        if self.status == PersonStatus.OUTSIDE and self.pending_entry_detection:
            duration = (timestamp - self.pending_entry_detection).total_seconds()
            if duration >= self.cfg.confirm_delay_s:
                self.status = PersonStatus.INSIDE
                self.current_entry_time = self.pending_entry_detection
                self.total_entries_today += 1
                self.last_seen_camera = self.pending_entry_camera
                self.last_seen_time = timestamp
                self.pending_entry_detection = None
                self.pending_entry_camera = None
                return True
        return False

    def confirm_exit(self, timestamp) -> bool:
        if self.status == PersonStatus.INSIDE and self.pending_exit_detection:
            duration = (timestamp - self.pending_exit_detection).total_seconds()
            if duration >= self.cfg.confirm_delay_s:
                self.status = PersonStatus.OUTSIDE
                self.last_exit_time = self.pending_exit_detection
                self.total_exits_today += 1
                self.last_seen_camera = self.pending_exit_camera
                self.last_seen_time = timestamp
                self.current_entry_time = None
                self.pending_exit_detection = None
                self.pending_exit_camera = None
                return True
        return False

    def clear_stale_detections(self, current_time):
        # pending detections expire after pending_expiry_s (:175-185)
        expiry = self.cfg.pending_expiry_s
        if self.pending_entry_detection:
            if (current_time - self.pending_entry_detection).total_seconds() > expiry:
                self.pending_entry_detection = None
                self.pending_entry_camera = None
        if self.pending_exit_detection:
            if (current_time - self.pending_exit_detection).total_seconds() > expiry:
                self.pending_exit_detection = None
                self.pending_exit_camera = None

    def to_dict(self) -> dict:
        return {
            "person_id": self.person_id,
            "metadata": self.metadata,
            "campus_id": self.campus_id,
            "status": self.status.value,
            "current_entry_time": self.current_entry_time,
            "last_exit_time": self.last_exit_time,
            "total_entries_today": self.total_entries_today,
            "total_exits_today": self.total_exits_today,
            "last_seen_camera": self.last_seen_camera,
            "last_seen_time": self.last_seen_time,
            "detection_count_today": self.detection_count_today,
        }


def _new_campus_stats() -> dict:
    return {
        "current_inside": 0,
        "employees_inside": set(),
        "visitors_inside": set(),
        "total_entries_today": 0,
        "total_exits_today": 0,
        "unknown_detections_today": 0,
        "unique_unknowns": 0,
    }


class CampusPeopleManager:
    def __init__(self, ds: Datastore, cfg: Config | None = None,
                 start_background: bool = True):
        cfg = cfg or get_config()
        self.ds = ds
        self.cfg = cfg.campus
        self.unknown_similarity_threshold = cfg.thresholds.unknown_cluster_join

        self._ensure_indexes()
        self.camera_configs: Dict[str, dict] = {}
        self.state_lock = threading.Lock()
        self.people_states: Dict[str, PersonState] = {}
        self.unknown_people: Dict[str, Dict[str, UnknownPerson]] = defaultdict(dict)
        self._cluster_banks: Dict[str, _ClusterBank] = {}
        self.campus_stats: Dict[str, dict] = defaultdict(_new_campus_stats)

        self.update_queue_lock = threading.Lock()
        self.pending_updates: List[dict] = []
        self.pending_events: List[dict] = []
        self.pending_cluster_updates: List[dict] = []
        self.last_batch_time = time.time()
        self._stats_day = get_current_utc().date()

        self._load_people_state()
        self._load_unknown_clusters()

        self.running = False
        self.batch_thread = None
        self.analytics_thread = None
        if start_background:
            self.start()

    # ----------------------------------------------------------- lifecycle
    def start(self):
        if self.running:
            return
        self.running = True
        self.batch_thread = threading.Thread(target=self._batch_update_loop,
                                             daemon=True)
        self.batch_thread.start()
        self.analytics_thread = threading.Thread(target=self._analytics_loop,
                                                 daemon=True)
        self.analytics_thread.start()

    def stop(self):
        """Flush + join (reference peopleCount.py:679-692)."""
        self.running = False
        self.flush()
        for t in (self.batch_thread, self.analytics_thread):
            if t:
                t.join(timeout=5)

    def _ensure_indexes(self):
        # reference peopleCount.py:264-276
        self.ds.people_status.create_index(
            [("person_id", 1), ("campus_id", 1)], unique=True)
        self.ds.people_status.create_index([("campus_id", 1), ("status", 1)])
        self.ds.campus_events.create_index([("person_id", 1), ("timestamp", -1)])
        self.ds.campus_events.create_index([("campus_id", 1), ("timestamp", -1)])
        self.ds.campus_events.create_index([("event_type", 1), ("timestamp", -1)])
        self.ds.campus_analytics.create_index([("campus_id", 1), ("date", -1)])
        self.ds.unknown_detections.create_index([("campus_id", 1), ("timestamp", -1)])
        self.ds.unknown_clusters.create_index(
            [("campus_id", 1), ("unknown_id", 1)], unique=True)

    def _load_people_state(self):
        # reference peopleCount.py:278-315
        today = get_current_utc().date()
        with self.state_lock:
            chosen: Dict[str, dict] = {}
            for doc in self.ds.people_status.find({}):
                # one in-memory state per person (reference semantics), but
                # the store may hold one doc per (person, campus): keep the
                # most recently seen doc rather than iteration-order-last,
                # so detections resume against the right campus
                pid = doc["person_id"]
                prev = chosen.get(pid)
                if prev is None or ((doc.get("last_seen_time")
                                     or doc.get("current_entry_time")
                                     or datetime.min)
                                    > (prev.get("last_seen_time")
                                       or prev.get("current_entry_time")
                                       or datetime.min)):
                    chosen[pid] = doc
            for person_id, doc in chosen.items():
                campus_id = doc["campus_id"]
                state = PersonState(person_id, doc["metadata"], campus_id, self.cfg)
                state.status = PersonStatus(doc["status"])
                state.current_entry_time = doc.get("current_entry_time")
                state.last_exit_time = doc.get("last_exit_time")
                state.total_entries_today = doc.get("total_entries_today", 0)
                state.total_exits_today = doc.get("total_exits_today", 0)
                state.last_seen_camera = doc.get("last_seen_camera")
                state.last_seen_time = doc.get("last_seen_time")
                # a doc last touched before today carries YESTERDAY's
                # counters — resuming them would inflate today's rollup
                seen = state.last_seen_time or state.current_entry_time
                if seen is not None and seen.date() < today:
                    state.total_entries_today = 0
                    state.total_exits_today = 0
                self.people_states[person_id] = state
                stats = self.campus_stats[campus_id]
                if state.status == PersonStatus.INSIDE:
                    stats["current_inside"] += 1
                    if state.metadata.get("type") == "employee":
                        stats["employees_inside"].add(person_id)
                    else:
                        stats["visitors_inside"].add(person_id)
                stats["total_entries_today"] += state.total_entries_today
                stats["total_exits_today"] += state.total_exits_today

    def _load_unknown_clusters(self):
        """Beyond-reference hardening: the reference's unknown clusters are
        memory-only and lost on restart (peopleCount.py:231).  Reload them
        (running-mean embedding window included) so re-appearing unknowns
        rejoin their cluster instead of inflating unique_unknowns."""
        with self.state_lock:
            for doc in self.ds.unknown_clusters.find({}):
                campus_id = doc["campus_id"]
                unknown = UnknownPerson.from_doc(
                    doc, history=self.cfg.unknown_history)
                self.unknown_people[campus_id][unknown.unknown_id] = unknown
                self._bank(campus_id, unknown.avg_embedding.shape[0]).upsert(
                    unknown.unknown_id, unknown.avg_embedding)
            for campus_id, clusters in self.unknown_people.items():
                self.campus_stats[campus_id]["unique_unknowns"] = len(clusters)

    def _bank(self, campus_id: str, dim: int) -> _ClusterBank:
        bank = self._cluster_banks.get(campus_id)
        if bank is None:
            bank = self._cluster_banks[campus_id] = _ClusterBank(dim)
        return bank

    def _queue_cluster_update(self, unknown: "UnknownPerson"):
        with self.update_queue_lock:
            self.pending_cluster_updates.append({
                "filter": {"campus_id": unknown.campus_id,
                           "unknown_id": unknown.unknown_id},
                "update": {"$set": unknown.to_persist_doc()},
                "upsert": True,
            })

    # ------------------------------------------------------------- cameras
    def register_camera(self, camera_id: str, campus_id: str,
                        camera_type: CameraType, name: str | None = None):
        self.camera_configs[camera_id] = {
            "campus_id": campus_id, "type": camera_type,
            "name": name or camera_id}

    # ---------------------------------------------------------- detections
    def process_detection(self, person_id: str, metadata: dict, camera_id: str,
                          timestamp: datetime, similarity: float):
        # reference peopleCount.py:326-360
        camera_config = self.camera_configs.get(camera_id)
        if not camera_config:
            logger.warning("Unknown camera: %s", camera_id)
            return
        campus_id = camera_config["campus_id"]
        camera_type = camera_config["type"]
        self._maybe_roll_day(timestamp)
        with self.state_lock:
            if person_id not in self.people_states:
                self.people_states[person_id] = PersonState(
                    person_id, metadata, campus_id, self.cfg)
            state = self.people_states[person_id]
            state.detection_count_today += 1
            state.last_seen_camera = camera_id
            state.last_seen_time = timestamp
            if state.should_log_detection(timestamp):
                state.last_detection_logged = timestamp
            if camera_type == CameraType.ENTRY:
                self._handle_entry_detection(state, camera_id, timestamp, similarity)
            elif camera_type == CameraType.EXIT:
                self._handle_exit_detection(state, camera_id, timestamp, similarity)

    def _handle_entry_detection(self, state, camera_id, timestamp, similarity):
        # reference peopleCount.py:362-395
        if state.status == PersonStatus.OUTSIDE:
            if not state.pending_entry_detection:
                state.start_entry_detection(camera_id, timestamp, similarity)
            elif state.confirm_entry(timestamp):
                campus_id = state.campus_id
                stats = self.campus_stats[campus_id]
                stats["current_inside"] += 1
                stats["total_entries_today"] += 1
                if state.metadata.get("type") == "employee":
                    stats["employees_inside"].add(state.person_id)
                else:
                    stats["visitors_inside"].add(state.person_id)
                self._queue_event(state.person_id, state.metadata, campus_id,
                                  camera_id, EventType.ENTRY,
                                  state.current_entry_time, similarity)
                self._queue_state_update(state)
                logger.info("ENTRY: %s entered %s",
                            state.metadata.get("name"), campus_id)

    def _handle_exit_detection(self, state, camera_id, timestamp, similarity):
        # reference peopleCount.py:397-430
        if state.status == PersonStatus.INSIDE:
            if not state.pending_exit_detection:
                state.start_exit_detection(camera_id, timestamp, similarity)
            elif state.confirm_exit(timestamp):
                campus_id = state.campus_id
                stats = self.campus_stats[campus_id]
                stats["current_inside"] -= 1
                stats["total_exits_today"] += 1
                if state.metadata.get("type") == "employee":
                    stats["employees_inside"].discard(state.person_id)
                else:
                    stats["visitors_inside"].discard(state.person_id)
                self._queue_event(state.person_id, state.metadata, campus_id,
                                  camera_id, EventType.EXIT,
                                  state.last_exit_time, similarity)
                self._queue_state_update(state)
                logger.info("EXIT: %s exited %s",
                            state.metadata.get("name"), campus_id)

    def process_unknown_detection(self, camera_id: str, timestamp: datetime,
                                  face_embedding: np.ndarray, bbox: List[int]):
        # reference peopleCount.py:432-500
        camera_config = self.camera_configs.get(camera_id)
        if not camera_config:
            return
        campus_id = camera_config["campus_id"]
        emb = np.asarray(face_embedding, np.float32)
        with self.state_lock:
            # One stacked-means dot product against every cluster at once;
            # lowest matching row = the reference loop's first-above-
            # threshold-in-insertion-order decision (peopleCount.py:445-455),
            # pinned by tests/test_campus_counting.py.
            bank = self._bank(campus_id, emb.shape[0])
            hit = bank.first_match(emb, self.unknown_similarity_threshold)
            matched = (self.unknown_people[campus_id].get(hit[0])
                       if hit else None)
            if matched:
                matched.update(timestamp, camera_id, face_embedding, bbox)
                bank.upsert(matched.unknown_id, matched.avg_embedding)
                self._queue_cluster_update(matched)
                self.campus_stats[campus_id]["unknown_detections_today"] += 1
                event = {
                    "type": "unknown_detection",
                    "unknown_id": matched.unknown_id,
                    "campus_id": campus_id,
                    "camera_id": camera_id,
                    "timestamp": timestamp,
                    "bbox": [int(x) for x in bbox],
                    "detection_count": matched.detection_count,
                }
            else:
                unknown_id = (f"unknown_{campus_id}_"
                              f"{len(self.unknown_people[campus_id]) + 1}")
                self.unknown_people[campus_id][unknown_id] = UnknownPerson(
                    unknown_id, campus_id, timestamp, camera_id,
                    face_embedding, bbox, history=self.cfg.unknown_history)
                bank.upsert(unknown_id, self.unknown_people[campus_id]
                            [unknown_id].avg_embedding)
                self._queue_cluster_update(
                    self.unknown_people[campus_id][unknown_id])
                stats = self.campus_stats[campus_id]
                stats["unknown_detections_today"] += 1
                stats["unique_unknowns"] = len(self.unknown_people[campus_id])
                event = {
                    "type": "unknown_detection",
                    "unknown_id": unknown_id,
                    "campus_id": campus_id,
                    "camera_id": camera_id,
                    "timestamp": timestamp,
                    "bbox": [int(x) for x in bbox],
                    "detection_count": 1,
                    "is_new": True,
                }
        with self.update_queue_lock:
            self.pending_events.append(event)

    # --------------------------------------------------------- write paths
    def _queue_state_update(self, state: PersonState):
        with self.update_queue_lock:
            self.pending_updates.append({
                "filter": {"person_id": state.person_id,
                           "campus_id": state.campus_id},
                "update": {"$set": state.to_dict()},
                "upsert": True,
            })

    def _queue_event(self, person_id, metadata, campus_id, camera_id,
                     event_type: EventType, timestamp, similarity):
        with self.update_queue_lock:
            self.pending_events.append({
                "type": "event",
                "person_id": person_id,
                "metadata": metadata,
                "campus_id": campus_id,
                "camera_id": camera_id,
                "event_type": event_type.value,
                "timestamp": timestamp,
                "similarity": float(similarity),
            })

    def _batch_update_loop(self):
        # reference peopleCount.py:526-545
        while self.running:
            try:
                time.sleep(2)
                now = time.time()
                should_flush = (now - self.last_batch_time) >= self.cfg.batch_interval_s
                with self.update_queue_lock:
                    big = (len(self.pending_updates) >= self.cfg.batch_size
                           or len(self.pending_events) >= self.cfg.batch_size
                           or len(self.pending_cluster_updates)
                           >= self.cfg.batch_size)
                if should_flush or big:
                    self.flush()
                    self.last_batch_time = now
            except Exception as e:
                logger.error("batch update loop error: %s", e)
                time.sleep(5)

    def flush(self):
        """Flush pending writes (reference peopleCount.py:547-587).

        Crash-safe: a transient backend failure (fre:// store bounce,
        socket drop) must not silently drop a batch interval of state —
        whatever phase hadn't succeeded is re-queued for the next cycle.
        State/cluster writes are idempotent $set upserts; event inserts
        become at-least-once (a partial insert_many that raises may
        duplicate an event on retry, which beats losing confirmed
        entries/exits outright)."""
        with self.update_queue_lock:
            updates = self.pending_updates[:]
            events = self.pending_events[:]
            clusters = self.pending_cluster_updates[:]
            self.pending_updates.clear()
            self.pending_events.clear()
            self.pending_cluster_updates.clear()
        try:
            if updates:
                # ds.UpdateOne is the backend's own request type — pymongo
                # rejects the embedded store's class and vice versa
                ops = [self.ds.UpdateOne(u["filter"], u["update"],
                                         upsert=u["upsert"])
                       for u in updates]
                self.ds.people_status.bulk_write(ops, ordered=False)
                updates = []
            if events:
                regular = [dict(e) for e in events if e.get("type") == "event"]
                unknown = [dict(e) for e in events
                           if e.get("type") == "unknown_detection"]
                for e in regular:
                    e.pop("type", None)
                for e in unknown:
                    e.pop("type", None)
                if regular:
                    self.ds.campus_events.insert_many(regular)
                if unknown:
                    self.ds.unknown_detections.insert_many(unknown)
                events = []
            if clusters:
                # last write per cluster wins (docs are full-state $set
                # upserts)
                latest = {(c["filter"]["campus_id"],
                           c["filter"]["unknown_id"]): c for c in clusters}
                ops = [self.ds.UpdateOne(c["filter"], c["update"], upsert=True)
                       for c in latest.values()]
                self.ds.unknown_clusters.bulk_write(ops, ordered=False)
                clusters = []
        except Exception:
            with self.update_queue_lock:
                # re-queue AT THE FRONT so ordering survives new arrivals
                self.pending_updates[:0] = updates
                self.pending_events[:0] = events
                self.pending_cluster_updates[:0] = clusters
            raise

    def _analytics_loop(self):
        while self.running:
            try:
                time.sleep(self.cfg.analytics_interval_s)
                self.update_analytics()
            except Exception as e:
                logger.error("analytics loop error: %s", e)
                time.sleep(self.cfg.analytics_interval_s)

    def _maybe_roll_day(self, now: datetime):
        """Zero the *_today counters at the local-midnight boundary.

        The reference never resets them (peopleCount.py keeps cumulative
        lifetime totals), which makes every daily analytics doc after day
        one report inflated numbers — exactly the rollup this module
        documents.  Caller must NOT hold state_lock (plain Lock, not
        reentrant)."""
        day = now.date()
        # forward-only: a detection carrying yesterday's timestamp (clock
        # skew, replayed frames) must not zero today's counters
        if day <= self._stats_day:
            return
        with self.state_lock:
            if day <= self._stats_day:
                return
            self._stats_day = day
            for stats in self.campus_stats.values():
                stats["total_entries_today"] = 0
                stats["total_exits_today"] = 0
                stats["unknown_detections_today"] = 0
            for state in self.people_states.values():
                state.total_entries_today = 0
                state.total_exits_today = 0
                state.detection_count_today = 0
                self._queue_state_update(state)

    def update_analytics(self):
        """Per-campus daily rollup upsert (reference peopleCount.py:589-626)."""
        now = get_current_utc()
        self._maybe_roll_day(now)
        today = datetime.combine(now.date(), datetime.min.time())
        for campus_id, stats in list(self.campus_stats.items()):
            data = {
                "campus_id": campus_id,
                "date": today,
                "current_inside": stats["current_inside"],
                "employees_inside": len(stats["employees_inside"]),
                "visitors_inside": len(stats["visitors_inside"]),
                "total_entries": stats["total_entries_today"],
                "total_exits": stats["total_exits_today"],
                "unknown_detections": stats["unknown_detections_today"],
                "timestamp": now,
            }
            self.ds.campus_analytics.update_one(
                {"campus_id": campus_id, "date": today},
                {"$set": data}, upsert=True)

    def cleanup_stale_detections(self):
        current_time = get_current_utc()
        with self.state_lock:
            for state in self.people_states.values():
                state.clear_stale_detections(current_time)

    # ------------------------------------------------------------- queries
    def get_campus_status(self, campus_id: str | None = None) -> dict:
        # reference peopleCount.py:636-669.  Read under the lock and without
        # defaultdict-indexing: an arbitrary campus id from a URL must not
        # permanently pollute campus_stats.
        def one(cid, stats):
            return {
                "campus_id": cid,
                "current_inside": stats["current_inside"],
                "employees_inside": len(stats["employees_inside"]),
                "visitors_inside": len(stats["visitors_inside"]),
                "total_entries_today": stats["total_entries_today"],
                "total_exits_today": stats["total_exits_today"],
                "unknown_detections_today": stats["unknown_detections_today"],
                "unique_unknowns_today": len(self.unknown_people.get(cid, {})),
            }

        with self.state_lock:
            if campus_id:
                stats = self.campus_stats.get(campus_id) or _new_campus_stats()
                return one(campus_id, stats)
            return {cid: one(cid, stats)
                    for cid, stats in self.campus_stats.items()}

    def get_person_status(self, person_id: str) -> dict | None:
        with self.state_lock:
            state = self.people_states.get(person_id)
            return state.to_dict() if state else None
