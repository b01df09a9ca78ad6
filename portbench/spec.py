"""The benchmark's data, found by name: ``BENCHMARK.json`` at the checkout's
root names each cell's configuration, traffic mix and metrics; each is a
file of its own under ``portbench/``:

- ``configs/<config>.json``: the model configuration as it is run;
- ``traffic/<traffic>.json``: the traffic mix (loop, clients, batcher,
  frames, transport, gallery, the correctness sample);
- ``limits/<workload>.json``: each compared number's limit in that cell;
- ``metrics/<metric>.py``: one per-layer metric's reader, a ``read(run)``
  that returns the value or None where it finds nothing to read;
- ``reference/embedders/<arch>.py``: the plain reference of an embedder
  architecture a configuration's ``recognizer`` names, a ``build(rec)``
  that returns the module at the widths ``rec`` states.
"""

from __future__ import annotations

import functools
import importlib.util
import json
import os

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def _json(*parts) -> dict:
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def benchmark(root: str = ROOT) -> dict:
    return _json(root, "BENCHMARK.json")


def cell(name: str, root: str = ROOT) -> dict:
    """The workload ``name`` with its configuration, traffic mix, limits and
    the metrics it reports (end to end, then per layer)."""
    bench = benchmark(root)
    work = {w["name"]: w for w in bench["workloads"]}[name]
    here = os.path.join(root, "portbench")

    def reports(m):
        return name in m.get("workloads", [name])

    return {
        "name": name,
        "chips": work["chips"],
        "config": _json(here, "configs", f"{work['config']}.json"),
        "traffic": _json(here, "traffic", f"{work['traffic']}.json"),
        "limits": _json(here, "limits", f"{name}.json"),
        "end_to_end": [m for m in bench["end_to_end"] if reports(m)],
        "per_layer": [m for m in bench["per_layer"] if reports(m)],
    }


def _load(name: str, path: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(metric: str, root: str = ROOT):
    """The module ``metrics/<metric>.py`` (its name may hold dots)."""
    return _load(f"portbench_metric_{metric}",
                 os.path.join(root, "portbench", "metrics", f"{metric}.py"))


@functools.lru_cache(maxsize=None)
def embedder(arch: str, root: str = ROOT):
    """The module ``reference/embedders/<arch>.py``, loaded once a root.  It
    is loaded as a module of ``portbench.reference.embedders``, so its
    relative imports reach the reference's other files.  ``ValueError``
    where ``arch`` is not a bare name or has no file."""
    path = os.path.join(root, "portbench", "reference", "embedders", f"{arch}.py")
    if not arch.isidentifier() or not os.path.isfile(path):
        raise ValueError(f"no reference embedder for {arch!r}")
    return _load(f"portbench.reference.embedders.{arch}", path)
