"""The port's domain runtimes (``domain/``: campus counting, the enrollment
worker, visitor passes and QR) and its people-count server on the
reference's tests.

Run here against ``facerecognition_infrenceengine_tpu_torch``
(tests/test_torch_port_cases.py reads, re-points and executes the files;
they stay as they are):
- every case of tests/test_campus_counting.py and tests/test_qr.py;
- the cases of tests/test_enrollment_gallery.py that need neither JAX nor a
  device mesh (the sharded cases build their mesh from ``jax.devices()``:
  tests/test_torch_parallel.py holds hand-written equivalents on a mesh of
  CPU devices; the f32 score-cache case pins a TPU-only bf16 copy the port
  does not keep);
- the cases of tests/test_servers.py that tests/test_torch_serving.py does
  not run, except ``test_recalibrate_int8_route``, which waits for the int8
  embedder (ROADMAP Queue 1 item 4).

``store_cfg`` is the port's ``Config``; galleries and engines built with no
device run on the CPU.  Pillow is optional for the port's ``domain``: the
last test imports it with Pillow hidden.
"""

import os
import subprocess
import sys

import pytest

from test_torch_port_cases import cpu_by_default, exec_port_cases, store_cfg  # noqa: F401

exec_port_cases("test_campus_counting.py", globals())
exec_port_cases("test_qr.py", globals())
exec_port_cases("test_enrollment_gallery.py", globals(), only=(
    "test_enrollment_happy_path", "test_enrollment_different_persons_fails",
    "test_enrollment_duplicate_detection", "test_job_retry_then_terminal_failure",
    "test_stuck_job_recovery", "test_gallery_sync_and_match",
    "test_gallery_company_isolation", "test_two_workers_do_not_double_process",
    "test_bf16_gallery_matches_same_ids", "test_int8_gallery_matches_same_ids",
    "test_gallery_delta_sync_is_incremental",
    "test_gallery_delta_multi_removal_including_last_row",
    "test_gallery_delta_evolution_respects_concurrent_rebuild",
    "test_gallery_delta_capacity_growth_rebuilds_once",
    "test_gallery_delta_int8_append_no_requant",
    "test_stuck_recovery_respects_fresh_heartbeat", "test_worker_uses_injected_thresholds",
    "test_sync_survives_custom_and_string_ids", "test_match_query_batch_is_bucketed"))
exec_port_cases("test_servers.py", globals(), only=(
    "test_recalibrate_int8_route", "test_people_count_api", "test_server_dashboards_serve_and_poll_own_api",
    "test_dashboard_field_contract", "test_control_apis_enable_cors",
    "test_dashboard_inline_scripts_parse_sane", "test_people_count_bad_int_params_are_400"))


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    cpu_by_default(monkeypatch)


def test_domain_and_api_import_without_pillow():
    """With ``PIL`` unimportable, ``domain``, ``domain.cameras`` and ``api``
    import (the card's host need not have Pillow), and the pass and QR
    image functions raise an ImportError naming Pillow."""
    code = (
        "import sys\n"
        "class Block:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name == 'PIL' or name.startswith('PIL.'):\n"
        "            raise ImportError('PIL is hidden')\n"
        "sys.meta_path.insert(0, Block())\n"
        "import facerecognition_infrenceengine_tpu_torch.domain as d\n"
        "import facerecognition_infrenceengine_tpu_torch.domain.cameras\n"
        "import facerecognition_infrenceengine_tpu_torch.api as api\n"
        "api.create_app()\n"
        "for call in (lambda: d.qr_encode('x'), lambda: d.qr_decode(b'x'),\n"
        "             lambda: d.generate_visitor_pass({}, {}, {}, 'v', None, None)):\n"
        "    try:\n"
        "        call()\n"
        "    except ImportError as e:\n"
        "        assert 'Pillow' in str(e), e\n"
        "    else:\n"
        "        raise AssertionError('no ImportError')\n"
        "assert 'PIL' not in sys.modules\n"
        "print('ok')\n")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                       timeout=120, cwd=repo,
                       env={**os.environ, "MONGODB_URI": "memory://", "PYTHONPATH": repo})
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "ok"



@pytest.mark.parametrize("visit_id,now", [
    ("4ced26e91ad23507003db27f", "2026-11-11T11:15:13.609604"),
    ("0e9b5ec62497e3623edac769", "2026-11-26T22:17:03.972546")])
def test_pass_qr_decodes_when_a_data_run_hides_a_finder(visit_id, now):
    """Visitor passes whose QR data modules hold a wider 1:1:3:1:1 run next
    to the top-right finder: clustered with it, the run moved the finder off
    centre and the pass did not decode (one of 480 passes over random ids
    and times; the reference's decoder too, and test_visit_lifecycle_with_qr
    failed now and then for it).  The locator now keeps
    runs of another module size apart and falls back to two finders."""
    import datetime

    from facerecognition_infrenceengine_tpu_torch.domain import passes
    from facerecognition_infrenceengine_tpu_torch.store import ObjectId

    t = datetime.datetime.fromisoformat(now)
    arrival, departure = t - datetime.timedelta(hours=1), t + datetime.timedelta(hours=3)
    data = {"companyId": "x", "hostEmployeeId": "y", "expectedArrival": arrival.isoformat(),
            "expectedDeparture": departure.isoformat(), "purpose": "Audit",
            "accessAreas": ["Lobby", "Lab"]}
    png = passes.generate_visitor_pass(
        {"visitorName": "Vinod Guest", "phone": "9876543210"},
        {"employeeName": "Host Singh", "employeeId": "H1"}, data, ObjectId(visit_id),
        arrival, departure, None)
    assert passes.qr_decode(png) == visit_id
