"""Admin frontend (reference app/static + app/templates, SURVEY.md §2.18).

The reference ships a jQuery/Bootstrap/Cytoscape admin UI loaded from CDNs
(reference app/templates/index.html, companies.html, company-details.html;
app/static/js/{app,entity-definitions,config}.js — ~3,400 LoC).  This
build serves a dependency-free vanilla-JS equivalent with the same
capabilities — companies CRUD + seed, company branding/designations/
infrastructure, entity-definition editor (templates → per-company
definitions → entities), and an SVG hierarchy diagram in place of
Cytoscape — talking to the same ``/bharatlytics/v1`` API the reference
frontend pins in app/static/js/config.js:3.

The port's copy of ``facerecognition_infrenceengine_tpu/web/ui/__init__.py``.
"""

from __future__ import annotations

import os

from ..framework import Blueprint, Response, abort

_HERE = os.path.dirname(os.path.abspath(__file__))

_MIME = {
    ".html": "text/html; charset=utf-8",
    ".js": "application/javascript; charset=utf-8",
    ".css": "text/css; charset=utf-8",
    ".svg": "image/svg+xml",
    ".png": "image/png",
    ".ico": "image/x-icon",
}


def _read(*parts: str) -> bytes:
    path = os.path.normpath(os.path.join(_HERE, *parts))
    # trailing separator: a bare prefix check would admit sibling dirs
    # sharing the "ui" prefix (web/ui-backup/...) via ../ traversal
    if not path.startswith(_HERE + os.sep) or not os.path.isfile(path):
        abort(404, "not found")
    with open(path, "rb") as f:
        return f.read()


def ui_page(name: str) -> Response:
    """Serve an admin-UI template (also used by API routes that render a
    page, e.g. the reference's /employees/page, employee.py:519-521)."""
    body = _read("templates", name)
    return Response(body, 200, mimetype=_MIME[".html"])


def make_ui_bp() -> Blueprint:
    bp = Blueprint("ui")

    page = ui_page

    @bp.route("/", methods=["GET"])
    def index():
        return page("index.html")

    @bp.route("/companies", methods=["GET"])
    def companies():
        return page("companies.html")

    @bp.route("/company-details", methods=["GET"])
    def company_details():
        return page("company-details.html")

    @bp.route("/employees", methods=["GET"])
    def employees():
        return page("employees.html")

    @bp.route("/visitors", methods=["GET"])
    def visitors():
        return page("visitors.html")

    @bp.route("/static/<path:filename>", methods=["GET"])
    def static_file(filename: str):
        ext = os.path.splitext(filename)[1].lower()
        if ext not in _MIME:
            abort(404, "not found")
        return Response(_read("static", filename), 200, mimetype=_MIME[ext],
                        headers={"Cache-Control": "no-cache"})

    return bp
