"""The port's store-backed ``GalleryManager`` against the reference's.

Each case writes identical documents into a reference datastore and a port
datastore the way registration and the enrollment worker write them (the
employee doc, then the embedding blob into GridFS and the
``employeeEmbeddings.buffalo_l`` entry with ``lastUpdated``), drives both
managers through the same syncs, and holds the port to the reference: equal
stats, equal snapshot ids, equal top-1 ids, f32 scores within 1e-6, equal
``_CompanySnapshot.full_builds`` deltas.  int8 snapshots hold the reference's
quantized matrix bit for bit, and their ids and scores equal the reference's
int8 kernel (``match_pallas.gallery_top1_int8`` in the interpreter: what the
reference serves on its chip; off it the reference dequantizes).  The cases
are the gallery cases of tests/test_enrollment_gallery.py.
"""

import dataclasses
import datetime

import jax.numpy as jnp
import numpy as np
import pytest

from facerecognition_infrenceengine_tpu.api.utils import get_current_utc as ref_utc
from facerecognition_infrenceengine_tpu.core.config import Config as RefConfig
from facerecognition_infrenceengine_tpu.core.serialization import (
    serialize_embedding as ref_serialize)
from facerecognition_infrenceengine_tpu.engine import gallery as ref_gallery
from facerecognition_infrenceengine_tpu.models.zoo import fake_embedding
from facerecognition_infrenceengine_tpu.ops import match_pallas
from facerecognition_infrenceengine_tpu.store import Datastore as RefDatastore
from facerecognition_infrenceengine_tpu.store import ObjectId as RefObjectId
from facerecognition_infrenceengine_tpu_torch.core.clock import get_current_utc
from facerecognition_infrenceengine_tpu_torch.core.config import Config
from facerecognition_infrenceengine_tpu_torch.core.serialization import serialize_embedding
from facerecognition_infrenceengine_tpu_torch.engine import gallery
from facerecognition_infrenceengine_tpu_torch.engine.pipeline import bucket
from facerecognition_infrenceengine_tpu_torch.store import Datastore, ObjectId


class Twin:
    """A reference store and a port store holding the same documents."""

    def __init__(self, gallery_dtype="float32", gallery_block=1024):
        self.ref_cfg = RefConfig()
        self.cfg = Config()
        for name in ("ref_cfg", "cfg"):
            c = getattr(self, name)
            setattr(self, name, dataclasses.replace(c, engine=dataclasses.replace(
                c.engine, gallery_dtype=gallery_dtype, gallery_block=gallery_block)))
        self.stores = [(RefDatastore(self.ref_cfg), RefObjectId, ref_serialize, ref_utc),
                       (Datastore(self.cfg), ObjectId, serialize_embedding, get_current_utc)]
        self.cid = str(ObjectId())
        self.pids = {}

    def enroll(self, emp_id, vec, cid=None, visitor=False):
        """Registration (the doc, embedding queued) then the worker's write
        (GridFS blob, the buffalo_l entry, lastUpdated); re-registering an
        employee id replaces its face."""
        cid = cid or self.cid
        pid = self.pids.setdefault(emp_id, str(ObjectId()))
        coll, fs, key = (("visitors", "visitor_embeddings", "visitorEmbeddings") if visitor
                         else ("employee_info", "employee_embeddings", "employeeEmbeddings"))
        for ds, oid, ser, utc in self.stores:
            doc = ({"visitorName": f"V {emp_id}", "visitorId": emp_id} if visitor else
                   {"employeeId": emp_id, "employeeName": f"P {emp_id}",
                    "employeeEmail": f"{emp_id}@x", "employeeMobile": "1",
                    "status": "active", "blacklisted": False})
            doc.update({"companyId": oid(cid), key: {"buffalo_l": {"status": "queued"}},
                        "lastUpdated": utc()})
            getattr(ds, coll).update_one({"_id": oid(pid)}, {"$set": doc}, upsert=True)
            fid = getattr(ds, fs).put(ser(np.asarray(vec, np.float32)),
                                      filename=f"{cid}_{pid}_buffalo_l.pkl")
            entry = {"embeddingId": fid, "createdAt": utc(), "updatedAt": utc(),
                     "status": "done", "finishedAt": utc(), "corrupt": False}
            getattr(ds, coll).update_one({"companyId": oid(cid), "_id": oid(pid)},
                                         {"$set": {f"{key}.buffalo_l": entry,
                                                   "lastUpdated": utc()}})
        return pid

    def archive(self, emp_id):
        """The API's soft delete: status archived, lastUpdated untouched."""
        for ds, oid, _, utc in self.stores:
            ds.employee_info.update_one({"_id": oid(self.pids[emp_id])},
                                        {"$set": {"status": "archived", "deletedAt": utc()}})

    def managers(self, **kw):
        return (ref_gallery.GalleryManager(self.stores[0][0], self.ref_cfg, mesh=None, **kw),
                gallery.GalleryManager(self.stores[1][0], self.cfg, device="cpu", **kw))


def _builds():
    return ref_gallery._CompanySnapshot.full_builds, gallery._CompanySnapshot.full_builds


def _same(ref, mine, probes, company_id=None, k=1):
    """Equal stats and snapshot ids; equal top-1 ids and close f32 scores (int8:
    equal to the reference's int8 kernel).  Returns (ids, metadata)."""
    a, b = ref.get_stats(), mine.get_stats()
    a.pop("last_sync"), b.pop("last_sync")
    assert a == b
    assert mine.snapshot(company_id).ids == ref.snapshot(company_id).ids
    probes = np.asarray(probes, np.float32)
    s_ref, ids_ref, meta_ref = ref.match(probes, company_id=company_id, k=k)
    s, ids, meta = mine.match(probes, company_id=company_id, k=k)
    assert ids == ids_ref
    snap = mine.snapshot(company_id)
    if snap.dtype == "int8" and snap.size:
        ref_snap = ref.snapshot(company_id)
        np.testing.assert_array_equal(snap.device_matrix.numpy(),
                                      np.asarray(ref_snap.device_matrix))
        assert snap.int8_scale == ref_snap.int8_scale
        q = np.zeros((bucket(len(probes)), 512), np.float32)
        q[:len(probes)] = probes
        v, i = match_pallas.gallery_top1_int8(jnp.asarray(q), ref_snap.device_matrix,
                                              ref_snap.int8_scale, ref_snap.size,
                                              interpret=True)
        np.testing.assert_array_equal(s[:, 0], np.asarray(v)[:len(probes)])
        assert [r[0] for r in ids] == [ref_snap.ids[j] if x > -np.inf else None for j, x in
                                       zip(np.asarray(i)[:len(probes)],
                                           np.asarray(v)[:len(probes)])]
    else:
        np.testing.assert_allclose(s, s_ref, rtol=0, atol=1e-6)
    assert {p: m["employeeId"] for p, m in meta.items() if "employeeId" in m} == \
        {p: m["employeeId"] for p, m in meta_ref.items() if "employeeId" in m}
    return ids, meta


def _emp(meta, ids):
    return [meta[r[0]].get("employeeId") if r[0] is not None else None for r in ids]


def test_gallery_sync_and_match():
    t = Twin()
    t.enroll("E1", fake_embedding(42))
    t.enroll("E2", fake_embedding(43))
    t.enroll("V1", fake_embedding(50), visitor=True)
    ref, mine = t.managers()
    assert mine.get_stats()["total_embeddings"] == 3
    assert mine.get_stats()["visitors"] == 1 and not mine.is_empty()
    ids, meta = _same(ref, mine, [fake_embedding(42, 0.05)], t.cid)
    assert _emp(meta, ids) == ["E1"]
    # a delta sync picks up a later enrollment
    t.enroll("E9", fake_embedding(99))
    ref.force_sync(), mine.force_sync()
    assert mine.get_stats()["total_embeddings"] == 4
    ids, meta = _same(ref, mine, [fake_embedding(99), fake_embedding(50, 0.02)], t.cid)
    assert _emp(meta, ids) == ["E9", None] and meta[ids[1][0]]["type"] == "visitor"
    # archiving removes from the gallery at the next sync
    t.archive("E9")
    ref.force_sync(), mine.force_sync()
    assert mine.get_stats()["total_embeddings"] == 3
    _same(ref, mine, [fake_embedding(99)], t.cid)
    _same(ref, mine, [fake_embedding(42), fake_embedding(43)])  # the whole gallery
    emb, meta = mine.get_embeddings_for_company(t.cid)
    ref_emb, ref_meta = ref.get_embeddings_for_company(t.cid)
    assert emb.keys() == ref_emb.keys() and meta.keys() == ref_meta.keys()
    assert mine.get_all()[0].keys() == ref.get_all()[0].keys()


def test_gallery_company_isolation():
    t = Twin()
    t.enroll("E1", fake_embedding(1))
    ref, mine = t.managers()
    ids, _ = _same(ref, mine, [fake_embedding(1)], "0" * 24)
    assert ids[0][0] is None
    other = str(ObjectId())
    t.enroll("E2", fake_embedding(2), cid=other)
    ref.force_sync(), mine.force_sync()
    ids, meta = _same(ref, mine, [fake_embedding(2), fake_embedding(1)], other)
    assert _emp(meta, ids) == ["E2", "E2"]  # company 2 holds only E2


def test_gallery_delta_sync_is_incremental():
    t = Twin()
    for i, seed in enumerate((42, 43, 44)):
        t.enroll(f"E{i}", fake_embedding(seed))
    ref, mine = t.managers()
    snap0 = mine.snapshot(t.cid)
    ref.snapshot(t.cid), ref.snapshot(None), mine.snapshot(None)
    builds = _builds()
    # append one person
    t.enroll("E9", fake_embedding(99))
    ref.force_sync(), mine.force_sync()
    assert _builds() == builds, "append caused a rebuild"
    snap1 = mine.snapshot(t.cid)
    assert snap1 is not snap0 and snap1.size == snap0.size + 1
    assert snap1.device_matrix.shape == snap0.device_matrix.shape
    ids, meta = _same(ref, mine, [fake_embedding(99)], t.cid)
    assert _emp(meta, ids) == ["E9"]
    # the old snapshot is value-immutable
    _, ids_old = snap0.match(fake_embedding(42, 0.05)[None])
    assert snap0.metadata[ids_old[0][0]]["employeeId"] == "E0"
    # removal keeps the live prefix contiguous
    t.archive("E0")
    ref.force_sync(), mine.force_sync()
    assert _builds() == builds, "removal caused a rebuild"
    snap2 = mine.snapshot(t.cid)
    assert snap2.size == snap1.size - 1
    assert sorted(snap2.row_of.values()) == list(range(snap2.size))
    ids, meta = _same(ref, mine, [fake_embedding(43, 0.02), fake_embedding(99, 0.02)], t.cid)
    assert _emp(meta, ids) == ["E1", "E9"]
    for pid, row in snap2.row_of.items():
        _, ids_r = snap2.match(snap2.device_matrix[row].numpy()[None])
        assert ids_r[0][0] == pid
    # update in place: re-register an existing employee with a new face
    t.enroll("E1", fake_embedding(430))
    ref.force_sync(), mine.force_sync()
    assert _builds() == builds, "update caused a rebuild"
    _same(ref, mine, [fake_embedding(430), fake_embedding(43)], t.cid)
    _same(ref, mine, [fake_embedding(430), fake_embedding(99)])


def test_gallery_delta_multi_removal_including_last_row():
    t = Twin()
    for i, seed in enumerate((42, 43, 44, 45, 46)):
        t.enroll(f"E{i}", fake_embedding(seed))
    ref, mine = t.managers()
    assert mine.snapshot(t.cid).size == 5
    ref.snapshot(t.cid)
    builds = _builds()
    for emp in ("E0", "E4"):  # row 0 and the last live row in one delta
        t.archive(emp)
    ref.force_sync(), mine.force_sync()
    assert _builds() == builds, "removal caused a rebuild"
    snap1 = mine.snapshot(t.cid)
    assert snap1.size == 3 and sorted(snap1.row_of.values()) == list(range(3))
    assert {m["employeeId"] for m in snap1.metadata.values()} == {"E1", "E2", "E3"}
    for pid, row in snap1.row_of.items():
        _, ids_r = snap1.match(snap1.device_matrix[row].numpy()[None])
        assert ids_r[0][0] == pid
    ids, meta = _same(ref, mine, [fake_embedding(s) for s in (42, 43, 44, 45, 46)], t.cid)
    assert "E0" not in _emp(meta, ids) and "E4" not in _emp(meta, ids)


def test_gallery_delta_evolution_respects_concurrent_rebuild():
    """A snapshot a matcher rebuilt while a delta was evolving (from the
    updated host cache) is not overwritten by the stale evolution."""
    t = Twin()
    for i, seed in enumerate((42, 43)):
        t.enroll(f"E{i}", fake_embedding(seed))
    for manager in t.managers():
        old_snap = manager.snapshot(None)
        vec = ref_gallery._normalize(fake_embedding(77))
        with manager._lock:
            manager.embeddings["p-race"] = vec
            manager.metadata["p-race"] = {"name": "Race", "type": "employee",
                                          "companyId": t.cid}
            pending = manager._begin_delta_locked()
            del manager._snapshots["__all__"]
        rebuilt = manager.snapshot(None)
        assert "p-race" in rebuilt.row_of
        manager._evolve_snapshots(pending, {"p-race": vec},
                                  {"p-race": manager.metadata["p-race"]})
        assert manager.snapshot(None) is rebuilt, "stale evolution overwrote a rebuild"
        assert pending == [("__all__", old_snap)]


def test_gallery_delta_capacity_growth_rebuilds_once():
    t = Twin(gallery_block=2)
    for i, seed in enumerate((42, 43)):
        t.enroll(f"E{i}", fake_embedding(seed))
    ref, mine = t.managers()
    assert mine.snapshot(t.cid).device_matrix.shape[0] == 2
    ref.snapshot(t.cid)
    b_ref, b_mine = _builds()
    t.enroll("E2", fake_embedding(44))
    ref.force_sync(), mine.force_sync()
    ids, meta = _same(ref, mine, [fake_embedding(44)], t.cid)
    snap1 = mine.snapshot(t.cid)
    assert snap1.device_matrix.shape[0] == 4 and snap1.size == 3
    assert _builds() == (b_ref + 1, b_mine + 1)
    assert _emp(meta, ids) == ["E2"]


def test_gallery_delta_int8_append_no_requant():
    t = Twin(gallery_dtype="int8")
    for i, seed in enumerate((42, 43)):
        t.enroll(f"E{i}", fake_embedding(seed))
    ref, mine = t.managers()
    snap0 = mine.snapshot(t.cid)
    _same(ref, mine, [fake_embedding(42, 0.05), fake_embedding(43, 0.01)], t.cid)
    builds = _builds()
    t.enroll("E9", fake_embedding(99))
    ref.force_sync(), mine.force_sync()
    assert _builds() == builds
    snap1 = mine.snapshot(t.cid)
    assert snap1.dtype == "int8" and snap1.int8_scale == snap0.int8_scale
    ids, meta = _same(ref, mine, [fake_embedding(99), fake_embedding(42, 0.05)], t.cid)
    assert _emp(meta, ids) == ["E9", "E0"]


def test_sync_survives_custom_and_string_ids():
    """A 24-char non-hex id must not end the sync, and a doc whose _id is a
    24-hex string must not be evicted until it is really deleted."""
    t = Twin()
    t.enroll("E1", fake_embedding(42))
    managers = t.managers()
    hexstr_id = str(ObjectId())
    custom_id = "EMP-2026-000000001-XYZAB"
    assert len(custom_id) == 24 and not ObjectId.is_valid(custom_id)
    now = datetime.datetime.now(datetime.timezone.utc).replace(tzinfo=None)
    emb = fake_embedding(7)
    for (ds, oid, _, _), manager in zip(t.stores, managers):
        for pid in (hexstr_id, custom_id):
            ds.employee_info.insert_one({
                "_id": pid, "companyId": oid(t.cid), "employeeId": pid,
                "status": "active", "blacklisted": False, "lastUpdated": now})
            with manager._lock:
                manager.embeddings[pid] = emb
                manager.metadata[pid] = {"name": pid, "type": "employee", "companyId": t.cid}
        manager.last_sync_time = now
        manager._sync()
        assert hexstr_id in manager.embeddings and custom_id in manager.embeddings
        ds.employee_info.delete_one({"_id": hexstr_id})
        manager._sync()
        assert hexstr_id not in manager.embeddings and custom_id in manager.embeddings
    _same(*managers, [fake_embedding(42), fake_embedding(7)])


def test_match_query_batch_is_bucketed():
    t = Twin()
    for emp, seed in (("E1", 42), ("E2", 43), ("E3", 44)):
        t.enroll(emp, fake_embedding(seed))
    ref, mine = t.managers()
    probe3 = np.stack([fake_embedding(s, 0.02) for s in (42, 43, 44)])
    s3, ids3, _ = mine.match(probe3, company_id=t.cid)
    assert s3.shape[0] == 3 and len(ids3) == 3
    _same(ref, mine, probe3, t.cid)
    for i in range(3):
        s1, ids1, _ = mine.match(probe3[i:i + 1], company_id=t.cid)
        assert ids1[0] == ids3[i]
        np.testing.assert_allclose(s1[0], s3[i], atol=1e-5)
    _same(ref, mine, probe3[:1], t.cid, k=2)  # k > 1: cosine_topk on both


def test_sync_thread_runs_a_tick_and_stops():
    t = Twin()
    t.enroll("E1", fake_embedding(42))
    mine = gallery.GalleryManager(t.stores[1][0], t.cfg, sync_interval_s=0.05, device="cpu")
    t.enroll("E2", fake_embedding(43))
    mine.start_sync()
    try:
        import time

        deadline = time.time() + 30
        while mine.get_stats()["total_embeddings"] < 2 and time.time() < deadline:
            time.sleep(0.02)
    finally:
        mine.stop_sync()
    assert mine.get_stats()["total_embeddings"] == 2
    assert not mine._thread.is_alive()


def test_constructor_contract():
    """The device resolves first (off the card it raises before any load); a
    mesh raises, naming the multi-GPU item; initial_load=False loads nothing;
    from_device_matrix wraps a padded matrix as a snapshot."""
    import torch

    ds = Datastore(Config())
    with pytest.raises(NotImplementedError, match="Queue 1 item 5"):
        gallery.GalleryManager(ds, Config(), mesh=object(), device="cpu")
    empty = gallery.GalleryManager(ds, Config(), initial_load=False, device="cpu")
    assert empty.last_sync_time is None and empty.is_empty()
    assert empty.get_stats()["initial_load_complete"] is False
    m = torch.zeros(1024, 512)
    m[:3] = torch.eye(512)[:3]
    snap = gallery._CompanySnapshot.from_device_matrix(m, 3, "float32")
    scores, ids = snap.match(np.eye(512, dtype=np.float32)[[2, 0]])
    assert [r[0] for r in ids] == ["2", "0"] and np.allclose(scores[:, 0], 1.0)
