"""The port's datastore (``store/``) on the reference's store tests.

Every case of tests/test_store.py and tests/test_store_remote.py runs here
against ``facerecognition_infrenceengine_tpu_torch.store`` (the files are
read, re-pointed and executed; they stay as they are), among them the
remote cases that drive the port's REST API, enrollment worker (in a second
OS process) and campus manager over the wire.  The gallery those cases
build with no device runs on the CPU.
"""

import subprocess
import sys

import pytest

from test_torch_port_cases import cpu_by_default, exec_port_cases

exec_port_cases("test_store.py", globals())
exec_port_cases("test_store_remote.py", globals())


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    cpu_by_default(monkeypatch)


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
