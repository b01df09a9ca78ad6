"""Safe (de)serialization of embedding vectors.

The wire/storage format is inherited from the reference: embeddings travel
as *pickled* numpy float32[512] blobs in GridFS (reference
trainingServer.py:384-398 writes them, infrenceServer.py:269-273 reads
them), and /register accepts client-supplied blobs (employee.py:180-213).
Plain ``pickle.loads`` on client bytes is remote code execution; this module
keeps the byte format compatible while restricting unpickling to numpy
array reconstruction only, and validating the result's shape/dtype — so a
crafted pickle raises instead of executing.
"""

from __future__ import annotations

import importlib
import io
import pickle

import numpy as np

# The globals a pickled numpy ndarray legitimately references (numpy moved
# core -> _core in 2.x; accept both spellings for cross-version blobs).
_ALLOWED_GLOBALS = {
    ("numpy.core.multiarray", "_reconstruct"),
    ("numpy._core.multiarray", "_reconstruct"),
    ("numpy.core.multiarray", "scalar"),
    ("numpy._core.multiarray", "scalar"),
    ("numpy", "ndarray"),
    ("numpy", "dtype"),
}


class _NumpyOnlyUnpickler(pickle.Unpickler):
    def find_class(self, module, name):  # noqa: D102
        if (module, name) in _ALLOWED_GLOBALS:
            return getattr(importlib.import_module(module), name)
        raise pickle.UnpicklingError(
            f"embedding blob references forbidden global {module}.{name}")


def serialize_embedding(vector: np.ndarray) -> bytes:
    """numpy float32 vector -> the reference's pickled wire format."""
    return pickle.dumps(np.asarray(vector, dtype=np.float32))


def deserialize_embedding(blob: bytes, *, max_dim: int = 4096) -> np.ndarray:
    """Pickled-bytes -> float32 [D] vector, refusing anything that isn't a
    plain numeric numpy array (restricted unpickler: no arbitrary globals,
    so crafted pickles raise instead of executing).

    Raises ValueError/UnpicklingError on malformed or malicious blobs;
    callers treat that as "no embedding".
    """
    vec = _NumpyOnlyUnpickler(io.BytesIO(blob)).load()
    if not isinstance(vec, np.ndarray):
        raise ValueError(f"embedding blob is {type(vec).__name__}, not ndarray")
    if vec.dtype.kind not in "fiu":
        raise ValueError(f"embedding blob has non-numeric dtype {vec.dtype}")
    vec = np.asarray(vec, np.float32).reshape(-1)
    if not 1 <= vec.size <= max_dim:
        raise ValueError(f"embedding blob has implausible size {vec.size}")
    if not np.all(np.isfinite(vec)):
        raise ValueError("embedding blob contains non-finite values")
    return vec
