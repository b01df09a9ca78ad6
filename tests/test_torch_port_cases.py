"""Run a reference test file's cases against the port's modules (a helper of
the port's tests; it holds no test of its own).

``exec_port_cases(name, namespace)`` reads ``tests/<name>``, re-points every
``facerecognition_infrenceengine_tpu`` import (and the module paths inside its
subprocess snippets) at ``facerecognition_infrenceengine_tpu_torch``, and
executes it into ``namespace``: each case becomes a test of the calling
module, run against the port, while the reference file stays as it is.
"""

import os
import re

TESTS = os.path.dirname(os.path.abspath(__file__))
_REFERENCE = re.compile(r"\bfacerecognition_infrenceengine_tpu\b(?!_torch)")


def port_source(name: str) -> str:
    with open(os.path.join(TESTS, name)) as f:
        return _REFERENCE.sub("facerecognition_infrenceengine_tpu_torch", f.read())


def exec_port_cases(name: str, namespace: dict) -> None:
    exec(compile(port_source(name), os.path.join(TESTS, name), "exec"), namespace)
