"""A small WSGI web framework with a Flask-like surface.

The port's copy of ``facerecognition_infrenceengine_tpu/web/framework.py``
(standard library only, plus the port's ``store.objectid``).

Flask is not available in this environment, and the reference's REST layer
is four Flask blueprints plus two inline Flask apps (reference
app/api/*.py, infrenceServer.py:685-724, peopleCount.py:1044-1211).  This
module provides the subset those handlers need — blueprints with URL
prefixes, path parameters, query/form/multipart/JSON request parsing, a
thread-local ``request`` proxy, ``jsonify`` — as plain WSGI, so the API
package keeps byte-identical JSON contracts without the dependency.

JSON serialization policy (the reference leaves ObjectId serialization to a
missing helper module and would 500 on raw ObjectIds, SURVEY.md §8): this
encoder renders ObjectId as its 24-hex string and datetime as ISO-8601 —
the de-facto wire format of the reference's documented API examples
(API_DOCUMENTATION.md shows string ids throughout).
"""

from __future__ import annotations

import datetime
import io
import json
import re
import threading
import traceback
from email.parser import BytesParser
from email.policy import HTTP
from typing import Any, Callable
from urllib.parse import parse_qs, unquote

from ..store.objectid import ObjectId

# --------------------------------------------------------------------- JSON
class APIJSONEncoder(json.JSONEncoder):
    def default(self, o):
        if isinstance(o, ObjectId):
            return str(o)
        if isinstance(o, (datetime.datetime, datetime.date)):
            return o.isoformat()
        if isinstance(o, bytes):
            return o.decode("utf-8", "replace")
        if hasattr(o, "item"):  # numpy scalars
            return o.item()
        if hasattr(o, "tolist"):  # numpy arrays
            return o.tolist()
        return super().default(o)


def dumps(obj) -> str:
    return json.dumps(obj, cls=APIJSONEncoder)


# ------------------------------------------------------------------ request
class FileStorage:
    """Uploaded file part (werkzeug-like surface)."""

    def __init__(self, filename: str, content_type: str, data: bytes,
                 name: str = ""):
        self.filename = filename
        self.content_type = content_type
        self.name = name
        self.stream = io.BytesIO(data)
        self._data = data

    def read(self, size: int = -1) -> bytes:
        return self.stream.read(size)

    def seek(self, pos: int):
        self.stream.seek(pos)

    def save(self, dst):
        if hasattr(dst, "write"):
            dst.write(self._data)
        else:
            with open(dst, "wb") as f:
                f.write(self._data)

    def __bool__(self):
        return bool(self.filename) or bool(self._data)


class MultiDict(dict):
    """dict that also keeps repeated values (getlist)."""

    def __init__(self, items=()):
        super().__init__()
        self._lists: dict = {}
        for k, v in items:
            self.add(k, v)

    def add(self, key, value):
        self._lists.setdefault(key, []).append(value)
        if key not in self:
            super().__setitem__(key, value)

    def getlist(self, key) -> list:
        return list(self._lists.get(key, []))

    def get(self, key, default=None, type=None):
        val = super().get(key, default)
        if type is not None and val is not None:
            try:
                return type(val)
            except (TypeError, ValueError):
                return default
        return val

    def to_dict(self) -> dict:
        return dict(self)


MAX_BODY_BYTES = 64 * 1024 * 1024
"""Request-body ceiling: the largest legitimate payload is a visitor
registration (3 pose images + ID documents, a few MB each); reading an
arbitrary Content-Length into memory is an OOM vector."""


class Request:
    def __init__(self, environ: dict):
        self.environ = environ
        self.method = environ.get("REQUEST_METHOD", "GET").upper()
        self.path = environ.get("PATH_INFO", "/")
        self.query_string = environ.get("QUERY_STRING", "")
        self.headers = _Headers(environ)
        self.remote_addr = environ.get("REMOTE_ADDR", "")
        self.content_type = environ.get("CONTENT_TYPE", "")
        try:
            length = int(environ.get("CONTENT_LENGTH") or 0)
        except ValueError:
            length = 0
        if length < 0:
            # a negative Content-Length would pass the > MAX check and
            # turn body.read(-1) into an unbounded read-until-EOF,
            # defeating the OOM guard
            length = 0
        if length > MAX_BODY_BYTES:
            raise HTTPError(413, "request body too large")
        body = environ.get("wsgi.input")
        self._body = body.read(length) if (body and length) else b""
        self.args = MultiDict(
            (k, v) for k, vs in parse_qs(self.query_string, keep_blank_values=True).items()
            for v in vs
        )
        self.form = MultiDict()
        self.files = MultiDict()
        self._json: Any = None
        self._json_parsed = False
        ctype = self.content_type.split(";")[0].strip().lower()
        if ctype == "application/x-www-form-urlencoded":
            for k, vs in parse_qs(self._body.decode("utf-8", "replace"),
                                  keep_blank_values=True).items():
                for v in vs:
                    self.form.add(k, v)
        elif ctype == "multipart/form-data":
            self._parse_multipart()

    @property
    def data(self) -> bytes:
        return self._body

    def get_data(self) -> bytes:
        return self._body

    @property
    def json(self):
        return self.get_json()

    def get_json(self, silent: bool = False, force: bool = False):
        if not self._json_parsed:
            self._json_parsed = True
            ctype = self.content_type.split(";")[0].strip().lower()
            if force or ctype in ("application/json", ""):
                try:
                    self._json = json.loads(self._body.decode("utf-8")) if self._body else None
                except (ValueError, UnicodeDecodeError):
                    self._json = None
                    if not silent and not force:
                        raise HTTPError(400, "invalid JSON body")
        return self._json

    @property
    def is_json(self) -> bool:
        return "application/json" in self.content_type

    def _parse_multipart(self):
        header = (f"Content-Type: {self.content_type}\r\n"
                  f"MIME-Version: 1.0\r\n\r\n").encode()
        msg = BytesParser(policy=HTTP).parsebytes(header + self._body)
        if not msg.is_multipart():
            return
        for part in msg.iter_parts():
            disp = part.get("Content-Disposition", "")
            name_m = re.search(r'name="([^"]*)"', disp)
            file_m = re.search(r'filename="([^"]*)"', disp)
            name = name_m.group(1) if name_m else ""
            payload = part.get_payload(decode=True) or b""
            if file_m is not None:
                self.files.add(name, FileStorage(
                    file_m.group(1), part.get_content_type(), payload, name))
            else:
                self.form.add(name, payload.decode("utf-8", "replace"))


class _Headers:
    def __init__(self, environ: dict):
        self._env = environ

    def get(self, name: str, default=None):
        key = "HTTP_" + name.upper().replace("-", "_")
        if key in self._env:
            return self._env[key]
        if name.lower() == "content-type":
            return self._env.get("CONTENT_TYPE", default)
        if name.lower() == "content-length":
            return self._env.get("CONTENT_LENGTH", default)
        return default

    def __getitem__(self, name):
        val = self.get(name)
        if val is None:
            raise KeyError(name)
        return val

    def __contains__(self, name):
        return self.get(name) is not None


# ---------------------------------------------------------- request proxy
_local = threading.local()


class _RequestProxy:
    def _get(self) -> Request:
        req = getattr(_local, "request", None)
        if req is None:
            raise RuntimeError("working outside of request context")
        return req

    def __getattr__(self, item):
        return getattr(self._get(), item)


request = _RequestProxy()


# ----------------------------------------------------------------- response
_STATUS = {
    200: "OK", 201: "Created", 204: "No Content", 301: "Moved Permanently",
    302: "Found", 304: "Not Modified", 400: "Bad Request", 401: "Unauthorized",
    403: "Forbidden", 404: "Not Found", 405: "Method Not Allowed",
    409: "Conflict", 410: "Gone", 413: "Payload Too Large",
    415: "Unsupported Media Type", 422: "Unprocessable Entity",
    429: "Too Many Requests", 500: "Internal Server Error",
    503: "Service Unavailable",
}


class Response:
    def __init__(self, body: bytes | str = b"", status: int = 200,
                 headers: dict | None = None, mimetype: str = "text/html"):
        if isinstance(body, str):
            body = body.encode("utf-8")
        self.data = body
        self.status_code = status
        self.headers = {"Content-Type": mimetype}
        if headers:
            self.headers.update(headers)

    def get_json(self):
        return json.loads(self.data.decode("utf-8"))

    @property
    def status(self) -> str:
        return f"{self.status_code} {_STATUS.get(self.status_code, 'Unknown')}"

    @property
    def text(self) -> str:
        return self.data.decode("utf-8", "replace")


def jsonify(*args, **kwargs) -> Response:
    if args and kwargs:
        raise TypeError("jsonify takes args or kwargs, not both")
    obj = args[0] if len(args) == 1 else (list(args) if args else kwargs)
    return Response(dumps(obj), 200, mimetype="application/json")


class HTTPError(Exception):
    def __init__(self, status: int, message: str | None = None):
        self.status = status
        self.message = message or _STATUS.get(status, "Error")
        super().__init__(self.message)


def abort(status: int, message: str | None = None):
    raise HTTPError(status, message)


# ------------------------------------------------------------------ routing
_CONVERTERS = {
    "string": r"[^/]+",
    "int": r"\d+",
    "float": r"\d+(?:\.\d+)?",
    "path": r".+",
}
_CASTS = {"int": int, "float": float}


def _compile_rule(rule: str):
    pattern = ""
    casts = {}
    pos = 0
    for m in re.finditer(r"<(?:(\w+):)?(\w+)>", rule):
        pattern += re.escape(rule[pos:m.start()])
        conv = m.group(1) or "string"
        name = m.group(2)
        pattern += f"(?P<{name}>{_CONVERTERS[conv]})"
        if conv in _CASTS:
            casts[name] = _CASTS[conv]
        pos = m.end()
    pattern += re.escape(rule[pos:])
    return re.compile(f"^{pattern}$"), casts


class Blueprint:
    def __init__(self, name: str, import_name: str = "", url_prefix: str = ""):
        self.name = name
        self.url_prefix = url_prefix
        self._routes: list = []  # (rule, methods, fn)

    def route(self, rule: str, methods=("GET",), **_):
        def deco(fn):
            self._routes.append((rule, tuple(m.upper() for m in methods), fn))
            return fn
        return deco


class App:
    def __init__(self, name: str = "app"):
        self.name = name
        self._routes: list = []  # (regex, casts, methods, fn, rule)
        self._before: list[Callable] = []
        self._error_handlers: dict[int, Callable] = {}
        self._cors = False

    def enable_cors(self):
        """flask_cors CORS(app) defaults (reference infrenceServer.py:34,
        peopleCount.py:33): Access-Control-Allow-Origin: * on every
        response and automatic OPTIONS preflight handling."""
        self._cors = True
        return self

    # -- registration
    def route(self, rule: str, methods=("GET",), **_):
        def deco(fn):
            self.add_url_rule(rule, fn, methods)
            return fn
        return deco

    def add_url_rule(self, rule: str, fn, methods=("GET",)):
        regex, casts = _compile_rule(rule)
        self._routes.append((regex, casts, tuple(m.upper() for m in methods), fn, rule))

    def register_blueprint(self, bp: Blueprint, url_prefix: str | None = None):
        prefix = url_prefix if url_prefix is not None else bp.url_prefix
        for rule, methods, fn in bp._routes:
            if rule in ("", "/"):
                # blueprint root: accept both /prefix and /prefix/
                self.add_url_rule(prefix or "/", fn, methods)
                if prefix:
                    self.add_url_rule(prefix + "/", fn, methods)
            else:
                self.add_url_rule(prefix.rstrip("/") + rule, fn, methods)

    def before_request(self, fn):
        self._before.append(fn)
        return fn

    def errorhandler(self, status: int):
        def deco(fn):
            self._error_handlers[status] = fn
            return fn
        return deco

    # -- dispatch
    def _dispatch(self, req: Request) -> Response:
        path = unquote(req.path)
        allowed: set = set()
        for regex, casts, methods, fn, _rule in self._routes:
            m = regex.match(path)
            if not m:
                continue
            if req.method not in methods and not (
                req.method == "HEAD" and "GET" in methods
            ):
                allowed.update(methods)
                continue
            kwargs = {k: casts.get(k, str)(v) for k, v in m.groupdict().items()}
            for hook in self._before:
                rv = hook()
                if rv is not None:
                    return self._make_response(rv)
            return self._make_response(fn(**kwargs))
        if allowed:
            raise HTTPError(405)
        raise HTTPError(404)

    @staticmethod
    def _make_response(rv) -> Response:
        status = None
        headers = None
        if isinstance(rv, tuple):
            if len(rv) == 3:
                rv, status, headers = rv
            elif len(rv) == 2:
                rv, status = rv
        if isinstance(rv, Response):
            if status is not None:
                rv.status_code = status
            if headers:
                rv.headers.update(headers)
            return rv
        if isinstance(rv, (dict, list)):
            resp = jsonify(rv)
        elif isinstance(rv, (str, bytes)):
            resp = Response(rv)
        elif rv is None:
            resp = Response(b"", 204)
        else:
            resp = Response(str(rv))
        if status is not None:
            resp.status_code = status
        if headers:
            resp.headers.update(headers)
        return resp

    def _error_response(self, err: HTTPError) -> Response:
        handler = self._error_handlers.get(err.status)
        if handler:
            return self._make_response(handler(err))
        return Response(dumps({"error": err.message}), err.status,
                        mimetype="application/json")

    # -- WSGI
    def __call__(self, environ, start_response):
        method = environ.get("REQUEST_METHOD", "GET").upper()
        try:
            try:
                req = Request(environ)  # raises 413 past MAX_BODY_BYTES
                _local.request = req
                if self._cors and method == "OPTIONS":
                    resp = Response(b"", 200, headers={
                        "Access-Control-Allow-Methods":
                            "GET, POST, PUT, PATCH, DELETE, OPTIONS",
                        "Access-Control-Allow-Headers":
                            req.headers.get("Access-Control-Request-Headers")
                            or "*",
                    })
                else:
                    resp = self._dispatch(req)
            except HTTPError as e:
                resp = self._error_response(e)
            except Exception:
                traceback.print_exc()
                resp = self._error_response(HTTPError(500))
        finally:
            _local.request = None
        headers = dict(resp.headers)
        headers.setdefault("Content-Length", str(len(resp.data)))
        if self._cors:
            headers.setdefault("Access-Control-Allow-Origin", "*")
        start_response(resp.status, list(headers.items()))
        if method == "HEAD":
            return [b""]
        return [resp.data]

    # -- test client
    def test_client(self) -> "TestClient":
        return TestClient(self)

    def run(self, host: str = "0.0.0.0", port: int = 5000, **_):
        from .serving import serve

        serve(self, host, port)


# -------------------------------------------------------------- test client
class TestClient:
    """In-process WSGI client (flask test_client-alike)."""

    def __init__(self, app: App):
        self.app = app

    def open(self, path: str, method: str = "GET", data=None, json_body=None,
             files=None, query_string: str | dict = "", headers=None,
             content_type: str | None = None, remote_addr: str = "127.0.0.1"):
        body = b""
        ctype = content_type or ""
        if json_body is not None:
            body = dumps(json_body).encode()
            ctype = "application/json"
        elif files is not None or (isinstance(data, dict) and files is None and
                                   content_type == "multipart/form-data"):
            body, ctype = _encode_multipart(data or {}, files or {})
        elif isinstance(data, dict):
            from urllib.parse import urlencode

            body = urlencode(data, doseq=True).encode()
            ctype = "application/x-www-form-urlencoded"
        elif isinstance(data, (bytes, str)):
            body = data.encode() if isinstance(data, str) else data
        if isinstance(query_string, dict):
            from urllib.parse import urlencode

            query_string = urlencode(query_string, doseq=True)
        if "?" in path and not query_string:
            path, query_string = path.split("?", 1)
        environ = {
            "REQUEST_METHOD": method.upper(),
            "PATH_INFO": path,
            "QUERY_STRING": query_string,
            "CONTENT_TYPE": ctype,
            "CONTENT_LENGTH": str(len(body)),
            "REMOTE_ADDR": remote_addr,
            "wsgi.input": io.BytesIO(body),
        }
        for k, v in (headers or {}).items():
            environ["HTTP_" + k.upper().replace("-", "_")] = v
        captured = {}

        def start_response(status, hdrs):
            captured["status"] = int(status.split(" ", 1)[0])
            captured["headers"] = dict(hdrs)

        chunks = self.app(environ, start_response)
        resp = Response(b"".join(chunks), captured["status"])
        resp.headers = captured["headers"]
        return resp

    def get(self, path, **kw):
        return self.open(path, "GET", **kw)

    def post(self, path, **kw):
        return self.open(path, "POST", **kw)

    def patch(self, path, **kw):
        return self.open(path, "PATCH", **kw)

    def put(self, path, **kw):
        return self.open(path, "PUT", **kw)

    def delete(self, path, **kw):
        return self.open(path, "DELETE", **kw)


def _encode_multipart(fields: dict, files: dict):
    boundary = "----fre-boundary-7MA4YWxkTrZu0gW"
    out = io.BytesIO()
    for name, value in fields.items():
        values = value if isinstance(value, list) else [value]
        for v in values:
            out.write(f"--{boundary}\r\n".encode())
            out.write(f'Content-Disposition: form-data; name="{name}"\r\n\r\n'.encode())
            out.write(str(v).encode() + b"\r\n")
    for name, item in files.items():
        if isinstance(item, tuple):
            filename, payload = item[0], item[1]
            ftype = item[2] if len(item) > 2 else "application/octet-stream"
        else:
            filename, payload, ftype = name, item, "application/octet-stream"
        if isinstance(payload, io.BytesIO):
            payload = payload.getvalue()
        out.write(f"--{boundary}\r\n".encode())
        out.write(
            f'Content-Disposition: form-data; name="{name}"; '
            f'filename="{filename}"\r\n'.encode())
        out.write(f"Content-Type: {ftype}\r\n\r\n".encode())
        out.write(payload + b"\r\n")
    out.write(f"--{boundary}--\r\n".encode())
    return out.getvalue(), f"multipart/form-data; boundary={boundary}"
