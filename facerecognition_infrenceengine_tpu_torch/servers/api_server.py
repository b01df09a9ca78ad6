"""REST API + admin UI server.

The reference deploys its Flask blueprints as a standalone web app (the
app factory itself is missing from the snapshot — SURVEY.md §0; the URL
prefix /bharatlytics/v1 is pinned by app/static/js/config.js:3).  This
entry point serves ``create_app``'s full surface: employee / visitor /
company / entity APIs, the health endpoint, and the admin frontend
under /ui.  It runs no model: the port's copy of
``facerecognition_infrenceengine_tpu/servers/api_server.py``.

Run: python -m facerecognition_infrenceengine_tpu_torch.servers.api_server
"""

from __future__ import annotations

import argparse
import signal
import sys

from ..api import create_app
from ..core.config import get_config
from ..core.logging import setup_logging


def main(argv=None):
    parser = argparse.ArgumentParser(description="Bharatlytics REST API server")
    parser.add_argument("--host", default=None)
    parser.add_argument("--port", type=int, default=None)
    args = parser.parse_args(argv)

    logger = setup_logging("fre.api", logfile="api_server.log")
    cfg = get_config()
    app = create_app(cfg=cfg)

    def shutdown(signum, frame):
        logger.info("Shutting down gracefully...")
        sys.exit(0)

    signal.signal(signal.SIGINT, shutdown)
    signal.signal(signal.SIGTERM, shutdown)

    host = args.host or cfg.api.host
    port = args.port or cfg.api.port
    logger.info("REST API + UI on %s:%d (prefix %s)", host, port,
                cfg.api.url_prefix)
    app.run(host, port)


if __name__ == "__main__":
    main()
