"""Server entry points plus the self-served ops dashboards they expose at
``GET /``: the port's live recognition server (``inference_server``), the
REST API (``api_server``), the enrollment worker (``training_server``) and
the campus people counter (``people_count``)."""

from __future__ import annotations

import os

_DASHBOARDS = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "dashboards")


def dashboard_page(name: str) -> bytes:
    """Load a single-file dashboard (inline CSS/JS, same-origin polling)."""
    with open(os.path.join(_DASHBOARDS, name), "rb") as f:
        return f.read()
