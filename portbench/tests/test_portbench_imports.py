"""What the benchmark may import: nothing of JAX or the JAX package, and in
the reference nothing of the port either (whole top-level names)."""

import ast
import os
import subprocess
import sys

import pytest

from portbench import spec

HERE = os.path.join(spec.ROOT, "portbench")
JAX_SIDE = {"jax", "jaxlib", "flax", "facerecognition_infrenceengine_tpu"}
PORT = "facerecognition_infrenceengine_tpu_torch"


def _sources(sub: str = "") -> list:
    out = []
    for d, _, files in os.walk(os.path.join(HERE, sub)):
        out += [os.path.join(d, f) for f in files if f.endswith(".py")]
    return sorted(out)


def _top_levels(path: str) -> set:
    """Top-level module names a file imports; relative imports resolve
    inside ``portbench``."""
    names = set()
    for node in ast.walk(ast.parse(open(path).read())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            names.add("portbench" if node.level else node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", _sources(), ids=lambda p: os.path.relpath(p, HERE))
def test_no_jax_side_import(path):
    assert not (_top_levels(path) & JAX_SIDE)


@pytest.mark.parametrize("path", _sources("reference"), ids=lambda p: os.path.relpath(p, HERE))
def test_reference_imports_nothing_of_the_port(path):
    assert PORT not in _top_levels(path)
    assert _top_levels(path) <= {"__future__", "functools", "zlib", "dataclasses", "typing",
                                 "numpy", "torch", "portbench"}


def test_whole_names_tell_the_port_from_the_jax_package(monkeypatch):
    import types

    from portbench import run

    for name in (PORT, PORT + ".ops", "jax.numpy"):
        monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    assert run.forbidden_modules() == ["jax"]
    monkeypatch.setitem(sys.modules, "facerecognition_infrenceengine_tpu.ops",
                        types.ModuleType("x"))
    assert run.forbidden_modules() == ["facerecognition_infrenceengine_tpu", "jax"]


def test_a_run_loads_no_jax_side_module():
    """The harness and the port's serving path, imported in a fresh
    process, leave no JAX-side module in ``sys.modules``."""
    code = ("import sys; sys.path.insert(0, %r); "
            "import portbench.bench, portbench.calibrate; "
            "import facerecognition_infrenceengine_tpu_torch.engine.microbatch, "
            "facerecognition_infrenceengine_tpu_torch.engine.recognizer, "
            "facerecognition_infrenceengine_tpu_torch.models.zoo; "
            "print(sorted({m.split('.')[0] for m in sys.modules} & %r))"
            % (spec.ROOT, JAX_SIDE))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, cwd=spec.ROOT)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
