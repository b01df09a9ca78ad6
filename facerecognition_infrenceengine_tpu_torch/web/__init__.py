"""The WSGI framework and threaded server of the control APIs."""

from .framework import (  # noqa: F401
    App,
    Blueprint,
    Request,
    Response,
    jsonify,
    request,
    abort,
    HTTPError,
    FileStorage,
)
from .serving import serve  # noqa: F401
