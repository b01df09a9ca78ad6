"""Enrollment/embedding worker — the reference's "training server".

Job state machine identical to the reference (reference trainingServer.py):
poll ``embeddingJobs`` for queued jobs of this model every 2 s
(:491-513, claim by update_many), per job: fetch up to 3 pose images from
GridFS → detect (largest face when several, :234-243) → embedding →
pairwise same-person check (cos >= 0.4, :202-214) → average → company-wide
duplicate check (cos > 0.4, :170-200) → pickle to GridFS (:384-398) →
status transitions queued/started/done/failed/duplicate with heartbeat
(:316-320), <=3 retries (:432-453), 30-min stuck-job requeue (:457-489),
CPU/mem backpressure (:80-97), ThreadPoolExecutor fan-out (:567-580).

Difference from upstream: the duplicate scan is one host numpy matvec over
the company's enrolled embeddings instead of a cosine per person in a
Python loop (SURVEY.md §8).

The port's copy of ``facerecognition_infrenceengine_tpu/domain/enrollment.py``.
``FaceAnalysis`` runs on the card; each executor thread binds to the
detector's card before it runs the detector (``core.device.bind_thread``).
"""

from __future__ import annotations

import itertools
import logging
import os
import socket
import threading
import time
from concurrent.futures import ThreadPoolExecutor, as_completed
from datetime import timedelta
from enum import Enum

import numpy as np

from ..api.utils import get_current_utc
from ..core.serialization import deserialize_embedding, serialize_embedding
from ..core.config import Config, WorkerConfig, get_config
from ..core.device import bind_thread
from ..store.client import Datastore
from ..store.objectid import ObjectId

logger = logging.getLogger("fre.enrollment")


class JobStatus(Enum):
    QUEUED = "queued"
    STARTED = "started"
    DONE = "done"
    FAILED = "failed"
    DUPLICATE = "duplicate"


class ResourceMonitor:
    """CPU/memory backpressure (reference trainingServer.py:73-104)."""

    def __init__(self, cfg: WorkerConfig):
        self.cfg = cfg
        try:
            import psutil

            self._psutil = psutil
        except ImportError:
            self._psutil = None

    def check_resources(self) -> bool:
        if self._psutil is None:
            return True
        try:
            if self._psutil.virtual_memory().percent > self.cfg.mem_backpressure_pct:
                logger.warning("Memory usage too high")
                return False
            if self._psutil.cpu_percent(interval=0.1) > self.cfg.cpu_backpressure_pct:
                logger.warning("CPU usage too high")
                return False
            return True
        except Exception:
            return True


_WORKER_SEQ = itertools.count(1)


class FaceEmbeddingWorker:
    def __init__(self, ds: Datastore, cfg: Config | None = None,
                 detector=None, worker_id: str | None = None):
        cfg = cfg or get_config()
        self.ds = ds
        self.cfg = cfg.worker
        # Unique per worker instance: multiple workers share the job queue by
        # atomic claim (trainingServer.py:491-513); a shared id would let a
        # loser of the claim race "recover" the winner's jobs and
        # double-process them.
        self.worker_id = worker_id or (
            f"{self.cfg.model_name}_{socket.gethostname()}_{os.getpid()}"
            f"_{next(_WORKER_SEQ)}")
        self.resource_monitor = ResourceMonitor(self.cfg)
        self._detector = detector  # FaceAnalysis-compatible; lazy by default
        self.shutdown_event = threading.Event()
        self.executor = ThreadPoolExecutor(max_workers=self.cfg.max_workers)
        self.stats = {"processed": 0, "failed": 0, "duplicates": 0,
                      "started_at": get_current_utc()}
        # from the INJECTED cfg (not the global): a caller constructing a
        # worker with custom thresholds must get those thresholds
        self.similarity_threshold = cfg.thresholds.same_person
        self.duplicate_threshold = cfg.thresholds.duplicate_face

    @property
    def detector(self):
        if self._detector is None:
            from ..models.zoo import FaceAnalysis

            self._detector = FaceAnalysis(name=self.cfg.model_name)
            self._detector.prepare(ctx_id=0)
        return self._detector

    # ---------------------------------------------------------- primitives
    def _process_image(self, image_id, image_fs, position: str):
        """One pose image -> embedding or None (trainingServer.py:216-247)."""
        from .. import native

        try:
            data = image_fs.get(ObjectId(str(image_id))).read()
            image = native.decode_image(data)
            if image is not None:
                # FaceAnalysis.get takes cv2-convention BGR frames (the
                # reference feeds cv2.imdecode output straight in,
                # trainingServer.py:221-227); the native codec yields RGB.
                image = np.ascontiguousarray(image[..., ::-1])
            if image is None:
                logger.warning("Failed to decode image %s", image_id)
                return None
            detector = self.detector
            bind_thread(getattr(detector, "device", None))
            faces = detector.get(image)
            if not faces:
                return None
            if len(faces) > 1:
                areas = [(f.bbox[2] - f.bbox[0]) * (f.bbox[3] - f.bbox[1])
                         for f in faces]
                return faces[int(np.argmax(areas))].normed_embedding
            return faces[0].normed_embedding
        except Exception as e:
            logger.error("Error processing %s image %s: %s", position, image_id, e)
            return None

    def _check_image_similarity(self, embeddings):
        """All poses must be the same person (trainingServer.py:202-214)."""
        if len(embeddings) < 2:
            return True, None
        for i in range(len(embeddings)):
            for j in range(i + 1, len(embeddings)):
                sim = float(np.dot(embeddings[i], embeddings[j]) /
                            (np.linalg.norm(embeddings[i]) *
                             np.linalg.norm(embeddings[j])))
                if sim < self.similarity_threshold:
                    return False, (i, j)
        return True, None

    def _check_duplicate_face(self, new_embedding, company_id, collection,
                              id_field: str, exclude_doc_id=None,
                              model: str = "buffalo_l"):
        """Company-wide duplicate scan as one matmul.

        Same decision rule as the reference (cos > 0.4 against any enrolled
        embedding of the company, trainingServer.py:170-200) but computed as
        a single normalized matmul over a gallery snapshot, not a GridFS
        read per person.  ``exclude_doc_id`` skips the person being enrolled
        — a retried job whose previous attempt already stored its embedding
        must not flag them as a duplicate of themselves."""
        key = f"{id_field}Embeddings"
        fs = (self.ds.employee_embeddings if id_field == "employee"
              else self.ds.visitor_embeddings)
        ids, vectors = [], []
        # status=done filters out failed/duplicate-flagged people whose
        # leftover blobs would otherwise still count as duplicates (the
        # reference scans on $exists alone, propagating stale state).
        for doc in collection.find({
                "companyId": company_id,
                f"{key}.{model}.embeddingId": {"$exists": True},
                f"{key}.{model}.status": "done"}):
            if exclude_doc_id is not None and doc["_id"] == exclude_doc_id:
                continue
            try:
                entry = doc[key][model]
                blob = fs.get(ObjectId(str(entry["embeddingId"]))).read()
                vec = deserialize_embedding(blob)
                n = np.linalg.norm(vec)
                if n > 0:
                    ids.append(doc.get(f"{id_field}Id") or doc["_id"])
                    vectors.append(vec / n)
            except Exception as e:
                logger.warning("Error reading embedding for %s: %s",
                               doc.get("_id"), e)
        if not vectors:
            return False, None
        gallery = np.stack(vectors)  # [N, 512]
        q = np.asarray(new_embedding, np.float32)
        q = q / max(np.linalg.norm(q), 1e-12)
        scores = gallery @ q  # one matvec == the reference's whole loop
        best = int(np.argmax(scores))
        if scores[best] > self.duplicate_threshold:
            return True, ids[best]
        return False, None

    # ------------------------------------------------------------ job body
    def _fail_job(self, job_id, error: str):
        self.ds.embedding_jobs.update_one(
            {"_id": job_id},
            {"$set": {"status": JobStatus.FAILED.value, "error": error,
                      "finishedAt": get_current_utc()}})

    def _process_job(self, job: dict) -> bool:
        """trainingServer.py:249-455 — transitions preserved exactly."""
        job_id = job["_id"]
        jobs = self.ds.embedding_jobs
        try:
            is_visitor = job.get("visitorId") is not None
            doc_id = job.get("visitorId") if is_visitor else job.get("employeeId")
            if not doc_id:
                raise ValueError("No ID found in job")
            doc_id = ObjectId(str(doc_id))
            company_id = ObjectId(str(job["companyId"]))
            collection = self.ds.visitors if is_visitor else self.ds.employee_info
            id_field = "visitor" if is_visitor else "employee"
            image_fs = (self.ds.visitor_images if is_visitor
                        else self.ds.employee_images)
            embedding_fs = (self.ds.visitor_embeddings if is_visitor
                            else self.ds.employee_embeddings)
            key = f"{id_field}Embeddings"
            # write results under the JOB's model key — a worker configured
            # for a different model must not clobber another model's entry
            model = job.get("model", self.cfg.model_name)

            jobs.update_one({"_id": job_id}, {"$set": {
                "status": JobStatus.STARTED.value,
                "startedAt": get_current_utc(),
                "workerId": self.worker_id}})
            collection.update_one(
                {"companyId": company_id, "_id": doc_id},
                {"$set": {f"{key}.{model}.status": JobStatus.STARTED.value,
                          f"{key}.{model}.startedAt": get_current_utc()}})

            doc = collection.find_one({"companyId": company_id, "_id": doc_id})
            if doc is None:
                raise ValueError(f"Document not found for {doc_id}")

            image_dict = doc.get(f"{id_field}Images", {})
            positions = (["left", "right", "center"] if is_visitor
                         else ["center", "left", "right"])  # :305
            face_embeddings = []
            embedded_positions = []  # parallel to face_embeddings: a skipped
                                     # pose must not shift the error labels
            for position in positions:
                image_id = image_dict.get(position)
                if not image_id:
                    continue
                emb = self._process_image(image_id, image_fs, position)
                if emb is not None:
                    face_embeddings.append(np.asarray(emb, np.float32))
                    embedded_positions.append(position)
                jobs.update_one({"_id": job_id},
                                {"$set": {"heartbeat": get_current_utc()}})

            if not face_embeddings:
                raise ValueError("No faces found in any image")

            same, diff = self._check_image_similarity(face_embeddings)
            if not same:
                i, j = diff
                error = (f"Different persons detected in "
                         f"{embedded_positions[i]} and "
                         f"{embedded_positions[j]} images")
                collection.update_one(
                    {"companyId": company_id, "_id": doc_id},
                    {"$set": {f"{key}.{model}.status": JobStatus.FAILED.value,
                              f"{key}.{model}.error": error,
                              f"{key}.{model}.finishedAt": get_current_utc(),
                              "status": "incomplete"}})
                self._fail_job(job_id, error)
                return False

            avg_embedding = np.mean(face_embeddings, axis=0)

            is_dup, dup_id = self._check_duplicate_face(
                avg_embedding, company_id, collection, id_field,
                exclude_doc_id=doc_id, model=model)
            if is_dup:
                collection.update_one(
                    {"companyId": company_id, "_id": doc_id},
                    {"$set": {f"{key}.{model}.status": JobStatus.DUPLICATE.value,
                              f"{key}.{model}.duplicateOf": dup_id,
                              f"{key}.{model}.finishedAt": get_current_utc(),
                              "status": "pending_duplicate_removal"}})
                jobs.update_one({"_id": job_id}, {"$set": {
                    "status": JobStatus.DUPLICATE.value,
                    "finishedAt": get_current_utc()}})
                self.stats["duplicates"] += 1
                return True

            embedding_id = embedding_fs.put(
                serialize_embedding(avg_embedding),
                filename=f"{company_id}_{doc_id}_{model}.pkl",
                metadata={"companyId": company_id, f"{id_field}Id": doc_id,
                          "model": model, "type": "embedding",
                          "timestamp": get_current_utc()})
            emb_entry = {
                "embeddingId": embedding_id,
                "createdAt": get_current_utc(),
                "updatedAt": get_current_utc(),
                "status": JobStatus.DONE.value,
                "finishedAt": get_current_utc(),
                "corrupt": False,
            }
            collection.update_one(
                {"companyId": company_id, "_id": doc_id},
                {"$set": {f"{key}.{model}": emb_entry,
                          # bump lastUpdated so gallery delta-sync picks it up
                          "lastUpdated": get_current_utc()}})
            jobs.update_one({"_id": job_id}, {"$set": {
                "status": JobStatus.DONE.value,
                "finishedAt": get_current_utc()}})
            self.stats["processed"] += 1
            return True

        except Exception as e:
            logger.error("Error processing job %s: %s", job_id, e)
            self.stats["failed"] += 1
            retry_count = job.get("retryCount", 0) + 1
            if retry_count < self.cfg.max_retries:
                jobs.update_one({"_id": job_id}, {"$set": {
                    "status": JobStatus.QUEUED.value,
                    "retryCount": retry_count,
                    "error": str(e),
                    "requeuedAt": get_current_utc()}})
            else:
                self._fail_job(job_id, str(e))
            return False

    # ------------------------------------------------------- queue plumbing
    def _recover_stuck_jobs(self):
        """trainingServer.py:457-489."""
        now = get_current_utc()
        cutoff = now - timedelta(seconds=self.cfg.stuck_job_timeout_s)
        for job in self.ds.embedding_jobs.find({
                "status": JobStatus.STARTED.value,
                "startedAt": {"$lt": cutoff},
                # liveness gate: _process_job heartbeats per image — a job
                # whose claim is old but whose heartbeat is fresh is a slow
                # job STILL RUNNING (big backlog behind the thread pool,
                # slow GridFS), and requeueing it would double-process it
                # on another worker
                "$or": [{"heartbeat": {"$exists": False}},
                        {"heartbeat": {"$lt": cutoff}}]}):
            retry_count = job.get("retryCount", 0) + 1
            if retry_count < self.cfg.max_retries:
                self.ds.embedding_jobs.update_one({"_id": job["_id"]}, {"$set": {
                    "status": JobStatus.QUEUED.value,
                    "retryCount": retry_count,
                    "requeuedAt": now}})
            else:
                self.ds.embedding_jobs.update_one({"_id": job["_id"]}, {"$set": {
                    "status": JobStatus.FAILED.value,
                    "finishedAt": now,
                    "error": "Stuck too long after retries"}})

    def _fetch_jobs(self) -> list:
        """Claim a batch atomically (trainingServer.py:491-513)."""
        jobs = list(self.ds.embedding_jobs.find(
            {"status": JobStatus.QUEUED.value, "model": self.cfg.model_name}
        ).sort("createdAt", 1).limit(self.cfg.batch_size))
        if jobs:
            job_ids = [j["_id"] for j in jobs]
            result = self.ds.embedding_jobs.update_many(
                {"_id": {"$in": job_ids}, "status": JobStatus.QUEUED.value},
                {"$set": {"status": JobStatus.STARTED.value,
                          "startedAt": get_current_utc(),
                          "workerId": self.worker_id}})
            if result.modified_count < len(jobs):
                # another worker raced us; keep only what we actually own
                owned = list(self.ds.embedding_jobs.find(
                    {"_id": {"$in": job_ids}, "workerId": self.worker_id,
                     "status": JobStatus.STARTED.value}))
                return owned
        return jobs

    def process_available_jobs(self) -> int:
        """One poll cycle; returns number of jobs processed (test hook)."""
        jobs = self._fetch_jobs()
        if not jobs:
            return 0
        futures = [self.executor.submit(self._process_job, job) for job in jobs]
        for future in as_completed(futures):
            try:
                future.result()
            except Exception as e:
                logger.error("Job failed: %s", e)
        return len(jobs)

    def run(self):
        """Main loop (trainingServer.py:531-600)."""
        logger.info("Starting face embedding worker %s", self.worker_id)
        last_recovery = time.time()
        last_stats = time.time()
        try:
            while not self.shutdown_event.is_set():
                try:
                    if not self.resource_monitor.check_resources():
                        time.sleep(self.cfg.poll_interval_s * 2)
                        continue
                    if time.time() - last_recovery > self.cfg.stuck_scan_interval_s:
                        self._recover_stuck_jobs()
                        last_recovery = time.time()
                    if time.time() - last_stats > 3600:
                        logger.info("Worker stats: %s", self.stats)
                        last_stats = time.time()
                    if not self.process_available_jobs():
                        time.sleep(self.cfg.poll_interval_s)
                except KeyboardInterrupt:
                    break
                except Exception as e:
                    logger.error("Unexpected error in main loop: %s", e)
                    time.sleep(self.cfg.poll_interval_s)
        finally:
            self.executor.shutdown(wait=True)
            logger.info("Worker shutdown complete: %s", self.stats)

    def stop(self):
        self.shutdown_event.set()
