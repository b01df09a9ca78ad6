"""The enrollment worker and the people counter of both packages on the same
inputs, on the CPU.

det_2.5g + r18 with their seeded synthetic weights on a 128x128 canvas,
float32 on both sides, 144x192 photos and frames (letterbox scale 2/3: the
two-program path).  The reference runs on JAX's CPU backend, the port on
the CPU with its kernels' plain versions.

- Enrollment: the same seeded PNG photos are registered through each
  package's REST API into its own store, and each package's
  ``FaceEmbeddingWorker`` runs the jobs one at a time.  The seeded,
  untrained embedder puts any two of these photos at cosine 0.6-0.85 (and
  two poses of one photo at ~0.99), so the same-person and duplicate
  thresholds are raised to 0.9 and 0.95 in both packages' configs (the
  worker reads them from its config).  Every job ends with
  the same status (done, failed for poses of two persons, duplicate) and the
  same ``duplicateOf``; each stored embedding is within 1e-4 cosine of the
  reference's (f32 summation order, as in tests/test_torch_slice.py).
- Counting: the same frames, at the same clock, go through each package's
  ``CountingProcessor`` over a gallery holding the same documents, with
  the recognition / unknown / cluster-join thresholds raised likewise to
  0.95 / 0.9 / 0.97.  The
  campus counters, every person's state and the unknown clusters (ids,
  detection counts, cameras) are equal, and the clusters' mean embeddings
  within 1e-4 cosine.
"""

import dataclasses
import datetime

import cv2
import numpy as np
import pytest

from facerecognition_infrenceengine_tpu.api import create_app as ref_create_app
from facerecognition_infrenceengine_tpu.core.config import Config as RefConfig
from facerecognition_infrenceengine_tpu.core.config import EngineConfig as RefEngineConfig
from facerecognition_infrenceengine_tpu.core.config import (
    ThresholdConfig as RefThresholdConfig)
from facerecognition_infrenceengine_tpu.domain import campus as ref_campus
from facerecognition_infrenceengine_tpu.domain import counting as ref_counting
from facerecognition_infrenceengine_tpu.domain.enrollment import (
    FaceEmbeddingWorker as RefWorker)
from facerecognition_infrenceengine_tpu.engine.pipeline import FaceEngine as RefFaceEngine
from facerecognition_infrenceengine_tpu.models.zoo import FaceAnalysis as RefFaceAnalysis
from facerecognition_infrenceengine_tpu.store import Datastore as RefDatastore
from facerecognition_infrenceengine_tpu_torch.api import create_app
from facerecognition_infrenceengine_tpu_torch.core.config import (
    Config, EngineConfig, ThresholdConfig)
from facerecognition_infrenceengine_tpu_torch.core.serialization import deserialize_embedding
from facerecognition_infrenceengine_tpu_torch.domain import campus, counting
from facerecognition_infrenceengine_tpu_torch.domain.enrollment import FaceEmbeddingWorker
from facerecognition_infrenceengine_tpu_torch.engine.pipeline import FaceEngine
from facerecognition_infrenceengine_tpu_torch.models.zoo import FaceAnalysis
from facerecognition_infrenceengine_tpu_torch.store import Datastore
from test_torch_gallery import Twin

KW = dict(det_size=(128, 128), max_faces=8, pre_nms_topk=64, dtype="float32")
MODULES = ("detection", "recognition")
COS = 1e-4
ENROLL = dict(same_person=0.9, duplicate_face=0.95)
COUNT = dict(counting_recognition=0.95, definitely_unknown=0.9, unknown_cluster_join=0.97)


@pytest.fixture(scope="module")
def apps():
    ref = RefFaceAnalysis(cfg=RefEngineConfig(**KW), allowed_modules=MODULES,
                          engine=RefFaceEngine(RefEngineConfig(**KW), det_arch="det_2.5g",
                                               rec_arch="r18"))
    ref.det_thresh = 0.5
    port = FaceAnalysis(cfg=EngineConfig(**KW), allowed_modules=MODULES,
                        engine=FaceEngine(EngineConfig(**KW), det_arch="det_2.5g",
                                          rec_arch="r18", device="cpu"))
    port.prepare(det_thresh=0.5)
    return ref, port


def _photos(seed, persons=4, poses=3):
    """Each person: a seeded 144x192 noise image; each pose: it plus +-8 of
    noise.  RGB."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(persons):
        base = rng.integers(0, 256, (144, 192, 3)).astype(np.int16)
        out.append([np.clip(base + rng.integers(-8, 9, base.shape), 0, 255).astype(np.uint8)
                    for _ in range(poses)])
    return out


def _png(rgb):
    ok, buf = cv2.imencode(".png", np.ascontiguousarray(rgb[..., ::-1]))
    assert ok
    return buf.tobytes()


def _cos(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))


def _person(state):
    """A person's state, its gallery metadata reduced to the employee id
    (the two packages' ObjectId classes do not compare equal)."""
    return {**state, "metadata": state["metadata"].get("employeeId")}


def test_enrollment_worker_matches_reference(apps):
    photos = _photos(3)
    # employee id -> (person, pose) of its center / left / right photos
    jobs = {"E0": [(0, 0), (0, 1), (0, 2)], "E1": [(1, 0), (1, 1), (1, 2)],
            "E2": [(2, 0), (2, 1), (2, 2)], "E3": [(3, 0), (3, 1), (3, 2)],
            "E4": [(0, 0), (1, 1), (2, 2)], "E5": [(1, 2), (3, 0), (0, 1)],
            "E0b": [(0, 2), (0, 0), (0, 1)]}
    results = []
    for create, store, worker_cls, cfg, app in (
            (ref_create_app, RefDatastore, RefWorker, RefConfig(
                thresholds=RefThresholdConfig(**ENROLL)), apps[0]),
            (create_app, Datastore, FaceEmbeddingWorker, Config(
                thresholds=ThresholdConfig(**ENROLL)), apps[1])):
        ds = store(cfg)
        client = create(ds, cfg).test_client()
        cid = client.post("/bharatlytics/v1/companies/seed").get_json()["company"]["_id"]
        worker = worker_cls(ds, cfg, detector=app)
        out = {}
        for emp, shots in jobs.items():
            files = {pose: (f"{pose}.png", _png(photos[p][k]), "image/png")
                     for pose, (p, k) in zip(("center", "left", "right"), shots)}
            r = client.post("/bharatlytics/v1/employees/register",
                            data={"employeeId": emp, "employeeName": emp, "companyId": cid},
                            files=files)
            assert r.status_code == 200, r.get_json()
            assert worker.process_available_jobs() == 1
            doc = ds.employee_info.find_one({"employeeId": emp})
            entry = doc["employeeEmbeddings"]["buffalo_l"]
            job = ds.embedding_jobs.find_one({"employeeId": doc["_id"], "model": "buffalo_l"})
            vec = (deserialize_embedding(ds.employee_embeddings.get(entry["embeddingId"]).read())
                   if entry["status"] == "done" else None)
            out[emp] = (job["status"], entry["status"], job.get("error"),
                        entry.get("duplicateOf"), vec)
        results.append(out)
    ref, port = results
    assert {s for s, *_ in ref.values()} == {"done", "failed", "duplicate"}
    for emp in jobs:
        assert port[emp][:4] == ref[emp][:4], emp
        if ref[emp][4] is not None:
            assert _cos(port[emp][4], ref[emp][4]) >= 1 - COS, emp


def test_counting_processor_matches_reference(apps, monkeypatch):
    ref_app, app = apps
    frames = [f[0][..., ::-1].copy() for f in _photos(5, persons=4, poses=1)]
    faces = [ref_app.get(f) for f in frames]
    # the gallery: the largest face of frames 0 and 1, and distractors
    twin = Twin()
    for i in (0, 1):
        areas = [(f.bbox[2] - f.bbox[0]) * (f.bbox[3] - f.bbox[1]) for f in faces[i]]
        twin.enroll(f"E{i}", faces[i][int(np.argmax(areas))].normed_embedding)
    for i, vec in enumerate(np.random.default_rng(6).normal(size=(20, 512))):
        twin.enroll(f"D{i}", vec / np.linalg.norm(vec))
    galleries = twin.managers()
    # (camera, frame) in order, one clock step of 1.5 s each: entries are
    # confirmed by a second sighting >= 2 s later, exits likewise
    sequence = [("in", 0), ("in", 1), ("in", 0), ("in", 2), ("in", 1), ("in", 3),
                ("out", 0), ("out", 3), ("out", 0), ("in", 2)]
    t0 = datetime.datetime.now(datetime.timezone.utc).replace(tzinfo=None)
    states = []
    for mod, camp, cfg, gallery, face_app in (
            (ref_counting, ref_campus, dataclasses.replace(
                twin.ref_cfg, thresholds=RefThresholdConfig(**COUNT)), galleries[0], ref_app),
            (counting, campus, dataclasses.replace(
                twin.cfg, thresholds=ThresholdConfig(**COUNT)), galleries[1], app)):
        ds = gallery.ds
        manager = camp.CampusPeopleManager(ds, cfg, start_background=False)
        manager.register_camera("in", "c1", camp.CameraType.ENTRY)
        manager.register_camera("out", "c1", camp.CameraType.EXIT)
        proc = mod.CountingProcessor(gallery, manager, face_app=face_app, cfg=cfg)
        clock = iter(t0 + datetime.timedelta(seconds=1.5 * i) for i in range(len(sequence)))
        monkeypatch.setattr(mod, "get_current_utc", lambda: next(clock))
        stats = [proc.process_frame(frames[k], cam) for cam, k in sequence]
        unknown = manager.unknown_people["c1"]
        states.append((stats, manager.get_campus_status(),
                       {pid: _person(manager.get_person_status(pid))
                        for pid in manager.people_states},
                       {uid: (u.detection_count, sorted(u.cameras_seen))
                        for uid, u in unknown.items()},
                       {uid: u.avg_embedding for uid, u in unknown.items()}))
    (ref_stats, ref_status, ref_people, ref_unknown, ref_means), port_state = states
    assert port_state[:4] == (ref_stats, ref_status, ref_people, ref_unknown)
    assert sum(s["recognized"] for s in ref_stats) > 0
    assert sum(s["unknown"] for s in ref_stats) > 0
    assert ref_status["c1"]["total_entries_today"] > 0
    for uid, mean in ref_means.items():
        assert _cos(port_state[4][uid], mean) >= 1 - COS, uid
