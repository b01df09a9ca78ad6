"""The port's REST API (``api/``), admin UI (``web/ui``) and enrollment
worker on the reference's API tests.

Every case of these reference files runs here against
``facerecognition_infrenceengine_tpu_torch`` (tests/test_torch_port_cases.py
reads, re-points and executes them; they stay as they are):
tests/test_api_employee_company.py, test_api_entity.py, test_api_visitor.py,
test_route_census.py, test_ui.py, test_security_jobs.py,
test_review_regressions.py and test_fault_injection.py.  Where two files
bind the same fixture or helper (``app``, ``client``, ...), the later file's
is renamed, so each case keeps its own.  ``store_cfg`` is the port's
``Config``; galleries built with no device run on the CPU.
"""

import pytest

from test_torch_port_cases import cpu_by_default, exec_port_cases, store_cfg  # noqa: F401

for _name in ("test_api_employee_company.py", "test_api_entity.py", "test_api_visitor.py",
              "test_route_census.py", "test_ui.py", "test_security_jobs.py",
              "test_review_regressions.py", "test_fault_injection.py"):
    exec_port_cases(_name, globals())


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    cpu_by_default(monkeypatch)
