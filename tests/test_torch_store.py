"""The port's datastore (``store/``) on the reference's store tests.

Every case of tests/test_store.py and tests/test_store_remote.py runs here
against ``facerecognition_infrenceengine_tpu_torch.store`` (the files are
read, re-pointed and executed; they stay as they are).  Two remote cases
drive layers the port has not ported yet (the REST API and enrollment
worker, the campus manager: ROADMAP Queue 1 items 6-7); their port
counterparts, below under the same names, make the same writes over the
wire directly: the enrollment worker's embedding write from a second OS
process, synced and matched by the port's ``GalleryManager``, and the
people-count flush's bulk upserts and event inserts read back by a fresh
``Datastore``.
"""

import subprocess
import sys

import numpy as np

from test_torch_port_cases import exec_port_cases

exec_port_cases("test_store.py", globals())
exec_port_cases("test_store_remote.py", globals())


def test_enrollment_worker_in_second_process(server):
    """A second OS process writes an enrollment result over the wire the way
    the enrollment worker does (the embedding blob into GridFS, the
    ``employeeEmbeddings.buffalo_l`` entry and ``lastUpdated`` on the doc);
    this process sees it and its gallery loads and matches it."""
    from facerecognition_infrenceengine_tpu_torch.core.clock import get_current_utc
    from facerecognition_infrenceengine_tpu_torch.core.config import Config, DBConfig
    from facerecognition_infrenceengine_tpu_torch.core.serialization import (
        deserialize_embedding)
    from facerecognition_infrenceengine_tpu_torch.engine.gallery import GalleryManager
    from facerecognition_infrenceengine_tpu_torch.store import Datastore

    uri = f"fre://127.0.0.1:{server._port}"
    cfg = Config(db=DBConfig(mongodb_uri=uri, database_name="bharatlytics"))
    ds = Datastore(cfg)
    cid = ds.companies.insert_one({"companyName": "WireCo"}).inserted_id
    emp = ds.employee_info.insert_one({
        "companyId": cid, "employeeId": "EW1", "employeeName": "Wire Worker",
        "status": "active", "blacklisted": False,
        "employeeEmbeddings": {"buffalo_l": {"status": "queued"}},
        "lastUpdated": get_current_utc()}).inserted_id
    vec = np.random.default_rng(7).normal(size=512).astype(np.float32)

    code = (
        "import os\n"
        "import numpy as np\n"
        f"os.environ['MONGODB_URI'] = {uri!r}\n"
        "from facerecognition_infrenceengine_tpu_torch.core.clock import get_current_utc\n"
        "from facerecognition_infrenceengine_tpu_torch.core.serialization import "
        "serialize_embedding\n"
        "from facerecognition_infrenceengine_tpu_torch.store import ObjectId, get_datastore\n"
        "ds = get_datastore()\n"
        "vec = np.random.default_rng(7).normal(size=512).astype(np.float32)\n"
        f"cid, emp = ObjectId({str(cid)!r}), ObjectId({str(emp)!r})\n"
        "fid = ds.employee_embeddings.put(serialize_embedding(vec), "
        "filename=f'{cid}_{emp}_buffalo_l.pkl', metadata={'companyId': cid, "
        "'employeeId': emp, 'model': 'buffalo_l', 'type': 'embedding'})\n"
        "entry = {'embeddingId': fid, 'createdAt': get_current_utc(), "
        "'status': 'done', 'finishedAt': get_current_utc(), 'corrupt': False}\n"
        "r = ds.employee_info.update_one({'companyId': cid, '_id': emp}, {'$set': "
        "{'employeeEmbeddings.buffalo_l': entry, 'lastUpdated': get_current_utc()}})\n"
        "print('processed:', r.modified_count)\n"
    )
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert "processed: 1" in r.stdout

    doc = ds.employee_info.find_one({"employeeId": "EW1"})
    entry = doc["employeeEmbeddings"]["buffalo_l"]
    assert entry["status"] == "done"
    stored = deserialize_embedding(ds.employee_embeddings.get(entry["embeddingId"]).read())
    np.testing.assert_array_equal(stored, vec)

    gallery = GalleryManager(ds, cfg, device="cpu")
    assert gallery.get_stats()["total_embeddings"] == 1
    probe = vec + 0.05 * np.random.default_rng(8).normal(size=512).astype(np.float32)
    scores, ids, meta = gallery.match((probe / np.linalg.norm(probe))[None],
                                      company_id=str(cid))
    assert ids[0][0] == str(emp) and meta[ids[0][0]]["employeeId"] == "EW1"
    assert scores[0][0] > 0.9
    ds.db.close()


def test_campus_flush_and_state_resume_over_wire(server):
    """The people-count flush's writes over the wire (an unordered bulk_write
    of ``ds.UpdateOne`` upserts into people_status, insert_many of events),
    and a fresh Datastore (a restarted process) reading the state back."""
    import datetime

    from facerecognition_infrenceengine_tpu_torch.core.config import Config, DBConfig
    from facerecognition_infrenceengine_tpu_torch.store import Datastore

    uri = f"fre://127.0.0.1:{server._port}"
    cfg = Config(db=DBConfig(mongodb_uri=uri))
    ds = Datastore(cfg)
    t0 = datetime.datetime(2026, 8, 18, 9, 0, 0)
    key = {"personId": "p1", "campusId": "campusA"}
    ops = [ds.UpdateOne(key, {"$set": {"status": "inside", "lastSeen": t0,
                                       "name": "Asha", "type": "employee"}}, upsert=True),
           ds.UpdateOne(key, {"$set": {"lastSeen": t0 + datetime.timedelta(seconds=2.5)}},
                        upsert=True)]
    ds.people_status.bulk_write(ops, ordered=False)
    ds.campus_events.insert_many([{"personId": "p1", "campusId": "campusA",
                                   "event_type": "entry", "timestamp": t0}])
    assert ds.campus_events.count_documents({"event_type": "entry"}) == 1
    ds2 = Datastore(cfg)
    state = ds2.people_status.find_one(key)
    assert state["status"] == "inside"
    assert state["lastSeen"] == t0 + datetime.timedelta(seconds=2.5)
    assert ds2.people_status.count_documents({}) == 1
    ds.db.close()
    ds2.db.close()


def test_store_server_runs_as_a_module(tmp_path):
    """``python -m facerecognition_infrenceengine_tpu_torch.store.server``
    serves; a client in this process writes and reads through it."""
    import socket
    import time

    from facerecognition_infrenceengine_tpu_torch.store import RemoteDatabase

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    proc = subprocess.Popen(
        [sys.executable, "-m", "facerecognition_infrenceengine_tpu_torch.store.server",
         "--listen", f"127.0.0.1:{port}", "--uri", f"file://{tmp_path / 'snap'}"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        deadline = time.time() + 60
        while True:
            try:
                db = RemoteDatabase("127.0.0.1", port, name="m")
                break
            except OSError:
                assert proc.poll() is None and time.time() < deadline, proc.stdout.read()
                time.sleep(0.2)
        db["c"].insert_one({"x": 1})
        assert db["c"].count_documents({"x": 1}) == 1
        db.close()
    finally:
        proc.terminate()
        proc.wait(timeout=30)
