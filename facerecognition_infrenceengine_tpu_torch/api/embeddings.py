"""Embedding blob storage helpers.

The reference imports these from a missing top-level ``embeddings`` module
(reference app/api/employee.py:4, visitor.py:19).  Contracts from call
sites: ``store_embedding(content, filename, metadata, model) -> emb_entry``
(employee.py:197), ``get_embedding_file`` serves bytes,
``fetch_embedding_from_doc`` resolves a person doc's entry to the vector.

Embedding wire format: pickled numpy float32[512], exactly what the
reference's workers write and the gallery managers read
(trainingServer.py:384-398, infrenceServer.py:269-273).  Deserialization
goes through core.serialization's restricted unpickler — client-supplied
blobs (/register with embeddingAttached) must not be able to execute code.

The port's copy of ``facerecognition_infrenceengine_tpu/api/embeddings.py``.
"""

from __future__ import annotations

import numpy as np

from ..core.serialization import (deserialize_embedding,  # noqa: F401
                                  serialize_embedding)
from ..store.client import Datastore
from ..store.objectid import ObjectId
from .docmodels import build_embedding_entry
from .utils import get_current_utc


def store_embedding(ds: Datastore, content: bytes, filename: str,
                    metadata: dict, model: str, *, bucket: str = "employee") -> dict:
    """Store raw embedding bytes in GridFS; returns the embedding entry dict
    stored on the person document (employee.py:197-200)."""
    fs = ds.employee_embeddings if bucket == "employee" else ds.visitor_embeddings
    emb_id = fs.put(content, filename=filename, metadata=metadata,
                    model=model, type="embedding")
    entry = build_embedding_entry(emb_id)
    entry["model"] = model
    return entry


def get_embedding_file(ds: Datastore, embedding_id, *, bucket: str = "employee"):
    """GridOut for an embedding id (serves /employees/embeddings/<id>)."""
    fs = ds.employee_embeddings if bucket == "employee" else ds.visitor_embeddings
    return fs.get(ObjectId(str(embedding_id)))


def fetch_embedding_from_doc(ds: Datastore, doc: dict, model: str = "buffalo_l",
                             *, bucket: str = "employee") -> np.ndarray | None:
    """Resolve a person doc's embeddings entry to the numpy vector, or None."""
    key = "employeeEmbeddings" if bucket == "employee" else "visitorEmbeddings"
    entry = (doc.get(key) or {}).get(model) or {}
    emb_id = entry.get("embeddingId")
    if not emb_id:
        return None
    try:
        return deserialize_embedding(get_embedding_file(ds, emb_id, bucket=bucket).read())
    except Exception:
        return None


def store_vector(ds: Datastore, vector: np.ndarray, filename: str,
                 metadata: dict, model: str, *, bucket: str = "employee") -> dict:
    """Convenience: pickle + store a numpy embedding (worker path,
    trainingServer.py:384-398)."""
    entry = store_embedding(ds, serialize_embedding(vector), filename,
                            metadata, model, bucket=bucket)
    entry["status"] = "done"
    entry["finishedAt"] = get_current_utc()
    return entry
