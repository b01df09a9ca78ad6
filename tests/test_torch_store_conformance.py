"""The port's datastore on the reference's MongoDB-conformance cases: every
case of tests/test_store_conformance.py runs here against
``facerecognition_infrenceengine_tpu_torch.store`` (the file is read,
re-pointed and executed; it stays as it is)."""

from test_torch_port_cases import exec_port_cases

exec_port_cases("test_store_conformance.py", globals())
