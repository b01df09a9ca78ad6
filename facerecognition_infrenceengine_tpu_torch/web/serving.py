"""Threaded WSGI server for the REST entry points (the port's copy of
``facerecognition_infrenceengine_tpu/web/serving.py``).

The reference serves each process's Flask app with the builtin dev server
(reference infrenceServer.py:754, peopleCount.py:1346).  This uses the
stdlib wsgiref handler on a ThreadingMixIn socket server — one thread per
request, enough for the admin/control plane (the data plane never goes
through HTTP; frames flow through the engine's micro-batcher).
"""

from __future__ import annotations

import socketserver
import threading
from wsgiref.simple_server import WSGIRequestHandler, WSGIServer


class _ThreadingWSGIServer(socketserver.ThreadingMixIn, WSGIServer):
    daemon_threads = True
    allow_reuse_address = True
    # wsgiref's default listen backlog is 5: a burst of concurrent clients
    # (every request is its own connection — no keep-alive) overflows it and
    # the kernel RSTs the excess. Measured by the 16-thread load test.
    request_queue_size = 128


class _QuietHandler(WSGIRequestHandler):
    def log_message(self, fmt, *args):  # route access logs through logging
        import logging

        logging.getLogger("fre.http").debug("%s " + fmt, self.address_string(), *args)


def make_server(app, host: str = "0.0.0.0", port: int = 5000) -> _ThreadingWSGIServer:
    server = _ThreadingWSGIServer((host, port), _QuietHandler)
    server.set_app(app)
    return server


def serve(app, host: str = "0.0.0.0", port: int = 5000, background: bool = False):
    """Serve ``app``; returns the server (with .shutdown()) when background."""
    server = make_server(app, host, port)
    if background:
        t = threading.Thread(target=server.serve_forever, daemon=True)
        t.start()
        return server
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        server.shutdown()
    return server
