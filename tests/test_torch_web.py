"""The port's ``web`` package: every case of tests/test_web.py runs here
against ``facerecognition_infrenceengine_tpu_torch.web`` (the file is read,
re-pointed and executed; it stays as it is) -- routing, blueprints, request
parsing, errors, the threaded socket server and the body-size limits."""

from test_torch_port_cases import exec_port_cases

exec_port_cases("test_web.py", globals())


def test_the_cases_run_against_the_port():
    assert App.__module__ == "facerecognition_infrenceengine_tpu_torch.web.framework"  # noqa: F821
