"""Run a reference test file's cases against the port's modules (a helper of
the port's tests), and size torch's CPU pool for the whole suite (its one
test checks that size).

Inside a pytest-xdist worker, importing this module sets torch's intra-op
pool to the worker's share of the cores, ``os.cpu_count() //
PYTEST_XDIST_WORKER_COUNT`` threads (at least one): each worker's torch
otherwise starts a pool as wide as the machine, and the workers' pools
together oversubscribe the cores many times over, which slows the port's
many small forwards several times.  One call at import reaches every
worker: its name makes this module a test file, and every xdist worker
collects every test file before it runs any test, whatever files
``--dist loadfile`` then gives it.  Outside xdist (a file run alone) torch
keeps its own pool.

``exec_port_cases(name, namespace)`` reads ``tests/<name>``, re-points every
``facerecognition_infrenceengine_tpu`` import (and the module paths inside its
subprocess snippets) at ``facerecognition_infrenceengine_tpu_torch``, and
executes it into ``namespace``: each case becomes a test of the calling
module, run against the port, while the reference file stays as it is.

``only=(...)`` takes the named test functions alone: the module is parsed,
and what those cases use -- the fixtures they name, the module-level helpers
they call, the names of its imports they read -- is kept, recursively; the
rest of the file, its imports of modules the port does not have among them,
is dropped before it runs.

``unmark=("slow",)`` drops those ``pytest.mark`` decorators from the cases:
a case the reference marks slow for its compile time can run in the port's
quick tier when the port's form of it is quick.

Several files can go into one module.  A module-level name that a file
binds and an earlier file in the same module bound too (each file's own
``app`` and ``client`` fixtures, say) is renamed throughout the later file
(``app`` -> ``app__<file stem>``, the fixture and every parameter and name
that reads it), so each file's cases keep their own fixtures and helpers.

``cpu_by_default(monkeypatch)`` makes the port's ``resolve_device(None)``
the CPU for one test: reference cases build ``GalleryManager(ds, cfg)`` and
``FaceAnalysis(cfg=...)`` with no device, which on the port means ``cuda``.

``store_cfg`` is the port's twin of the conftest fixture of that name: the
port's ``Config``, over the embedded store and (slow tier) the port's
``fre://`` wire server.  A test module that imports it uses it in place of
the conftest one, whose ``Config`` is the reference's.
"""

import ast
import dataclasses
import os
import re
import sys

import pytest
import torch

# torch's pool before this module sized it, which a run outside xdist keeps
_TORCH_THREADS = torch.get_num_threads()


def _worker_threads():
    """The intra-op threads of one xdist worker, or None outside xdist."""
    if "PYTEST_XDIST_WORKER" not in os.environ:
        return None
    return max(1, os.cpu_count() // int(os.environ["PYTEST_XDIST_WORKER_COUNT"]))


if _worker_threads() is not None:
    torch.set_num_threads(_worker_threads())


def test_torch_pool_is_the_workers_share_of_the_cores():
    want = _worker_threads()
    assert torch.get_num_threads() == (_TORCH_THREADS if want is None else want)


TESTS = os.path.dirname(os.path.abspath(__file__))
_REFERENCE = re.compile(r"\bfacerecognition_infrenceengine_tpu\b(?!_torch)")


def port_source(name: str) -> str:
    with open(os.path.join(TESTS, name)) as f:
        return _REFERENCE.sub("facerecognition_infrenceengine_tpu_torch", f.read())


def _names_used(node) -> set:
    """Every name a node reads, and the parameter names of the functions in
    it (pytest resolves parameters to fixtures by name)."""
    used = set()
    for sub in ast.walk(node):
        if isinstance(sub, ast.Name):
            used.add(sub.id)
        elif isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef)):
            used.update(a.arg for a in sub.args.args + sub.args.kwonlyargs)
    return used


def _bound(node) -> set:
    """The module-level names a statement binds."""
    if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
        return {node.name}
    if isinstance(node, (ast.Assign, ast.AnnAssign)):
        targets = node.targets if isinstance(node, ast.Assign) else [node.target]
        return {n.id for t in targets for n in ast.walk(t) if isinstance(n, ast.Name)}
    return set()


def _select(tree: ast.Module, only) -> ast.Module:
    """The statements of ``tree`` that the test functions ``only`` need."""
    defs = [n for n in tree.body if _bound(n)]
    missing = set(only) - {name for n in defs for name in _bound(n)}
    if missing:
        raise KeyError(f"no such cases: {sorted(missing)}")
    only = set(only)

    def needed(node, used):
        names = _bound(node)
        return names & used and not any(x.startswith("test") and x not in only for x in names)

    keep = [n for n in defs if _bound(n) & (only | {"pytestmark"})]
    used = set().union(*(_names_used(n) for n in keep))
    while True:
        more = [n for n in defs if n not in keep and needed(n, used)]
        if not more:
            break
        keep += more
        used |= set().union(*(_names_used(n) for n in more))
    loose = [n for n in tree.body if not _bound(n) and not isinstance(
        n, (ast.Import, ast.ImportFrom)) and not (isinstance(n, ast.Expr)
                                                  and isinstance(n.value, ast.Constant))]
    used |= set().union(*(_names_used(n) for n in loose))
    body = []
    for node in tree.body:
        if node in keep:
            body.append(node)
        elif isinstance(node, (ast.Import, ast.ImportFrom)):
            aliases = [a for a in node.names
                       if (a.asname or a.name.split(".")[0]) in used]
            if aliases:
                node.names = aliases
                body.append(node)
        elif isinstance(node, ast.Expr) and isinstance(node.value, ast.Constant):
            continue  # the docstring
        elif not _bound(node):
            body.append(node)  # module-level statements (pytestmark, asserts)
    return ast.fix_missing_locations(ast.Module(body=body, type_ignores=[]))


class _Rename(ast.NodeTransformer):
    """Renames the identifiers ``names`` maps, wherever they appear as one."""

    def __init__(self, names: dict):
        self.names = names

    def visit_Name(self, node):
        node.id = self.names.get(node.id, node.id)
        return node

    def visit_arg(self, node):
        node.arg = self.names.get(node.arg, node.arg)
        return node

    def _visit_def(self, node):
        node.name = self.names.get(node.name, node.name)
        return self.generic_visit(node)

    visit_FunctionDef = visit_AsyncFunctionDef = visit_ClassDef = _visit_def


def _is_mark(node, names) -> bool:
    """Whether a decorator is ``pytest.mark.<one of names>`` (called or not)."""
    if isinstance(node, ast.Call):
        node = node.func
    return (isinstance(node, ast.Attribute) and node.attr in names
            and isinstance(node.value, ast.Attribute) and node.value.attr == "mark")


def exec_port_cases(name: str, namespace: dict, only=None, unmark=()) -> None:
    path = os.path.join(TESTS, name)
    tree = ast.parse(port_source(name), path)
    if only is not None:
        tree = _select(tree, only)
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            node.decorator_list = [d for d in node.decorator_list if not _is_mark(d, unmark)]
    bound = set().union(*(_bound(n) for n in tree.body))
    earlier = namespace.setdefault("_port_case_names", set())
    clash = {n: f"{n}__{os.path.splitext(name)[0]}" for n in bound & earlier}
    if clash:
        tree = ast.fix_missing_locations(_Rename(clash).visit(tree))
    earlier |= bound - set(clash)
    exec(compile(tree, path, "exec"), namespace)


@pytest.fixture(params=["embedded", pytest.param("fre", marks=pytest.mark.slow)])
def store_cfg(request):
    from facerecognition_infrenceengine_tpu_torch.core.config import Config
    from facerecognition_infrenceengine_tpu_torch.store.server import StoreServer

    cfg = Config()
    if request.param == "embedded":
        yield cfg
        return
    srv = StoreServer(port=0)
    srv.start()
    try:
        yield dataclasses.replace(cfg, db=dataclasses.replace(
            cfg.db, mongodb_uri=f"fre://127.0.0.1:{srv._port}"))
    finally:
        srv.stop()


def cpu_by_default(monkeypatch) -> None:
    """For one test, every port module's ``resolve_device`` maps ``None`` to
    the CPU (an explicit device is resolved as given)."""
    import importlib

    from facerecognition_infrenceengine_tpu_torch.core import device

    # import every module that binds resolve_device first: one imported
    # while the patch is on would keep the patched function for good
    for mod_name in ("engine.gallery", "engine.pipeline", "models.onnx_exec", "models.zoo",
                     "domain.cameras", "servers.inference_server"):
        importlib.import_module(f"facerecognition_infrenceengine_tpu_torch.{mod_name}")
    real = device.resolve_device

    def resolve(dev=None):
        return real("cpu" if dev is None else dev)

    for mod_name, mod in list(sys.modules.items()):
        if (mod_name.startswith("facerecognition_infrenceengine_tpu_torch.")
                and getattr(mod, "resolve_device", None) is real):
            monkeypatch.setattr(mod, "resolve_device", resolve)
