"""Device-resident gallery snapshots and the top-1 match.

The torch form of ``facerecognition_infrenceengine_tpu/engine/gallery.py``'s
matching core: a per-company snapshot holds ids, metadata and a padded
power-of-two-capacity [capacity, 512] matrix whose first ``size`` rows are
live (a prefix mask, never read by the top-1 kernel).  A k == 1 match runs
K1 (``ops/match_kernel.gallery_top1``); k > 1 runs ``cosine_topk``.

A float32 snapshot scores in true f32 on the card: K1 accumulates with FFMA
and keeps no bf16 or TF32 copy.  Snapshots here are built from arrays; the
reference's store-backed delta sync is not ported yet.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.config import Config
from ..core.device import resolve_device
from ..ops.match_kernel import gallery_top1
from ..ops.matching import cosine_topk
from .pipeline import bucket

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _next_capacity(n: int, block: int) -> int:
    cap = block
    while cap < n:
        cap *= 2
    return cap


def _prefix_mask(cap: int, n: int, device) -> torch.Tensor:
    """[cap] bool mask of a contiguous prefix of n live rows."""
    return torch.arange(cap, device=device) < n


class _CompanySnapshot:
    """Per-company device view: ids + padded matrix + prefix-valid mask."""

    def __init__(self, ids, metadata, matrix, embed_dim: int, block: int,
                 dtype: str = "float32", device=None):
        if dtype not in _DTYPES:
            raise NotImplementedError(
                f"gallery dtype {dtype!r}: float32/bfloat16 are ported; the int8 "
                "snapshot and its kernel are ROADMAP Queue 2 K2")
        self.ids = list(ids)
        self.metadata = metadata
        self.embed_dim = embed_dim
        self.dtype = dtype
        n = len(self.ids)
        cap = _next_capacity(max(n, 1), block)
        padded = np.zeros((cap, embed_dim), np.float32)
        if n:
            padded[:n] = matrix
        device = resolve_device(device)
        self.device_matrix = torch.from_numpy(padded).to(device, _DTYPES[dtype])
        self.device_valid = _prefix_mask(cap, n, device)
        self.size = n

    @torch.inference_mode()
    def match(self, query_embeddings: np.ndarray, k: int = 1):
        """[B, D] normalized queries -> (scores [B, k], ids [B, k] of str|None)."""
        b_real = len(query_embeddings)
        if self.size == 0 or b_real == 0:
            return np.full((b_real, k), -1.0, np.float32), [[None] * k for _ in range(b_real)]
        # Bucketed query batches keep the kernels on a few shapes; padded
        # zero queries change nothing for the real rows.
        q = np.zeros((bucket(b_real), self.embed_dim), np.float32)
        q[:b_real] = query_embeddings
        q32 = torch.from_numpy(q).to(self.device_matrix.device)
        vals, idx = self._device_match(q32, k)
        vals = vals.cpu().numpy()[:b_real]
        idx = idx.cpu().numpy()[:b_real]
        ids = [[self.ids[j] if 0 <= j < self.size and vals[b, i] > -np.inf else None
                for i, j in enumerate(row)] for b, row in enumerate(idx)]
        return vals, ids

    def _device_match(self, q32: torch.Tensor, k: int = 1):
        """Device (vals [B, k], idx [B, k]): K1 for k == 1, else cosine_topk."""
        q = q32.to(self.device_matrix.dtype)
        if k == 1:
            v1, i1 = gallery_top1(q, self.device_matrix, self.size)
            return v1[:, None], i1[:, None]
        return cosine_topk(q, self.device_matrix, self.device_valid, k=k)


class GalleryManager:
    """Holds one snapshot per company (``None`` keys the whole gallery)."""

    def __init__(self, cfg: Config | None = None, device=None):
        self.cfg = cfg or Config()
        self.device = resolve_device(device)
        self._snapshots: dict = {}

    def set_snapshot(self, ids, metadata: dict, matrix, company_id: str | None = None):
        """Build and install the snapshot for ``company_id`` from row-aligned
        ids, {id: metadata} and an [n, 512] matrix (rows L2-normalized here,
        as the reference normalizes on load)."""
        matrix = np.asarray(matrix, np.float32).reshape(len(ids), self.cfg.engine.embed_dim)
        matrix = matrix / np.maximum(np.linalg.norm(matrix, axis=1, keepdims=True), 1e-12)
        snap = _CompanySnapshot(ids, metadata, matrix, self.cfg.engine.embed_dim,
                                self.cfg.engine.gallery_block,
                                dtype=self.cfg.engine.gallery_dtype, device=self.device)
        self._snapshots[company_id] = snap
        return snap

    def snapshot(self, company_id: str | None = None) -> _CompanySnapshot:
        snap = self._snapshots.get(company_id)
        if snap is None:
            snap = _CompanySnapshot([], {}, None, self.cfg.engine.embed_dim,
                                    self.cfg.engine.gallery_block,
                                    dtype=self.cfg.engine.gallery_dtype, device=self.device)
        return snap

    def match(self, query_embeddings, company_id: str | None = None, k: int = 1):
        """Match normalized queries; returns (scores, ids, metadata-dict)."""
        snap = self.snapshot(company_id)
        scores, ids = snap.match(query_embeddings, k=k)
        return scores, ids, snap.metadata
