"""REST application factory.

The reference never registers its blueprints — ``app/__init__.py`` is an
empty file and no app factory exists in the snapshot (SURVEY.md §0); the
URL layout is pinned by the frontend config (reference
app/static/js/config.js:3: prefix ``/bharatlytics/v1``) and the API docs.
``create_app`` supplies the missing factory: employee/visitor/company/
entity blueprints under the prefix, plus a health endpoint.

The port's copy of ``facerecognition_infrenceengine_tpu/api/__init__.py``.
"""

from __future__ import annotations

from ..core.config import Config, get_config
from ..store.client import Datastore, get_datastore
from ..store.indexes import init_db
from ..web import App, jsonify


def create_app(ds: Datastore | None = None, cfg: Config | None = None,
               initialize: bool = True) -> App:
    cfg = cfg or get_config()
    ds = ds or get_datastore(cfg)
    if initialize:
        init_db(ds)

    from ..web.ui import make_ui_bp
    from .company import make_company_bp
    from .employee import make_employee_bp
    from .entity import make_entity_bp
    from .visitor import make_visitor_bp

    app = App("bharatlytics")
    prefix = cfg.api.url_prefix
    app.register_blueprint(make_employee_bp(ds, cfg), url_prefix=f"{prefix}/employees")
    app.register_blueprint(make_visitor_bp(ds, cfg), url_prefix=f"{prefix}/visitors")
    app.register_blueprint(make_company_bp(ds, cfg), url_prefix=f"{prefix}/companies")
    app.register_blueprint(make_entity_bp(ds, cfg), url_prefix=prefix)
    app.register_blueprint(make_ui_bp(), url_prefix="/ui")

    @app.route(f"{prefix}/health", methods=["GET"])
    def health():
        return jsonify({"status": "ok"})

    app.datastore = ds  # type: ignore[attr-defined]
    app.config_tree = cfg  # type: ignore[attr-defined]
    return app
