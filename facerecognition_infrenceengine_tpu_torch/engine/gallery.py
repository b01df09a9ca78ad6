"""Device-resident gallery snapshots and the top-1 match.

The torch form of ``facerecognition_infrenceengine_tpu/engine/gallery.py``'s
matching core: a per-company snapshot holds ids, metadata and a padded
power-of-two-capacity [capacity, 512] matrix whose first ``size`` rows are
live (a prefix mask, never read by the top-1 kernels).  A k == 1 match runs
K1 (``ops/match_kernel.gallery_top1``, f32 / bf16) or K2
(``gallery_top1_int8``, an int8 matrix with one global scale); k > 1 runs
``cosine_topk`` on the float (for int8, dequantized) matrix, as the
reference does off its TPU.

A float32 snapshot scores in true f32 on the card: K1 accumulates with FFMA
and keeps no bf16 or TF32 copy.  Snapshots are built from arrays and evolve
by O(delta) row scatters (``apply_delta``); the reference's store-backed
``GalleryManager`` sync that drives them is not ported yet.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.config import Config
from ..core.device import resolve_device
from ..ops.match_kernel import gallery_top1, gallery_top1_int8, quantize_gallery
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


def _scatter_rows(matrix: torch.Tensor, rows: np.ndarray, vals: np.ndarray) -> torch.Tensor:
    """A copy of ``matrix`` with ``rows`` set to ``vals``.  Only the delta's
    rows cross from the host; the copy is made on the device so snapshots
    stay value-immutable (a matcher holding the old one keeps a consistent
    (ids, matrix) pair).  The reference pads the row count to a power-of-two
    bucket to bound its compiled scatter shapes; eager torch needs no bucket."""
    dev = matrix.device
    out = matrix.clone()
    out.index_copy_(0, torch.from_numpy(rows.astype(np.int64)).to(dev),
                    torch.from_numpy(vals).to(dev, matrix.dtype))
    return out


class _CompanySnapshot:
    """Per-company device view: ids + padded matrix + prefix-valid mask.

    Snapshots are value-immutable: ``apply_delta`` returns a new snapshot
    with its own matrix, so matchers holding the old one are unaffected.
    """

    full_builds = 0  # O(delta) sync tests pin this

    def __init__(self, ids, metadata, matrix, embed_dim: int, block: int,
                 dtype: str = "float32", device=None):
        if dtype not in _DTYPES and dtype != "int8":
            raise ValueError(f"gallery dtype {dtype!r}")
        _CompanySnapshot.full_builds += 1
        self.ids = list(ids)
        self.metadata = metadata
        self.embed_dim = embed_dim
        self.block = block
        self.dtype = dtype
        n = len(self.ids)
        cap = _next_capacity(max(n, 1), block)
        padded = np.zeros((cap, embed_dim), np.float32)
        if n:
            padded[:n] = matrix
        device = resolve_device(device)
        self.int8_scale = None
        if dtype == "int8":
            q, self.int8_scale = quantize_gallery(padded, headroom=1.25)
            self.device_matrix = torch.from_numpy(q).to(device)
        else:
            self.device_matrix = torch.from_numpy(padded).to(device, _DTYPES[dtype])
        self.device_valid = _prefix_mask(cap, n, device)
        self.size = n
        self.row_of = {pid: i for i, pid in enumerate(self.ids)}

    @classmethod
    def _evolved(cls, src: "_CompanySnapshot", ids, row_of, metadata, device_matrix,
                 device_valid, size):
        snap = object.__new__(cls)
        snap.ids = ids
        snap.row_of = row_of
        snap.metadata = metadata
        snap.embed_dim = src.embed_dim
        snap.block = src.block
        snap.dtype = src.dtype
        snap.int8_scale = src.int8_scale
        snap.device_matrix = device_matrix
        snap.device_valid = device_valid
        snap.size = size
        return snap

    def apply_delta(self, updates: dict, meta_updates: dict, removals,
                    get_vec) -> "_CompanySnapshot | None":
        """O(delta) evolution: scatter the changed rows into a copy of the
        matrix.

        updates: pid -> L2-normalized f32 vector (new or changed people);
        meta_updates: pid -> metadata for every pid in ``updates``;
        removals: pids to evict (absent pids are ignored);
        get_vec: pid -> current f32 vector, for rows that swap-fill holes.

        Returns the evolved snapshot, ``self`` when nothing is relevant, or
        ``None`` when a full rebuild is required (capacity growth, or an int8
        vector that the global scale would clip).
        """
        # Removals by row, descending: each hole is swap-filled with the
        # current last live row, which is then never a pending removal.
        rel_removals = sorted(dict.fromkeys(p for p in removals if p in self.row_of),
                              key=lambda p: -self.row_of[p])
        removed_set = set(rel_removals)
        rel_updates = {p: v for p, v in updates.items() if p not in removed_set}
        new_pids = [p for p in rel_updates if p not in self.row_of]
        if not (rel_removals or rel_updates):
            return self
        cap = int(self.device_matrix.shape[0])
        new_size = self.size - len(rel_removals) + len(new_pids)
        if new_size > cap:
            return None  # capacity growth: rebuild at the doubled capacity
        if self.dtype == "int8" and rel_updates:
            newmax = max(float(np.abs(v).max()) for v in rel_updates.values())
            if newmax > self.int8_scale * 127.0 * (1.0 + 1e-6):
                return None  # the global scale would clip: requantize

        ids = list(self.ids)
        row_of = dict(self.row_of)
        metadata = dict(self.metadata)
        touched: dict = {}  # row -> f32 vector
        size = self.size
        # evictions keep the live prefix contiguous (the top-1 kernels mask
        # by row < size)
        for pid in rel_removals:
            r = row_of.pop(pid)
            metadata.pop(pid, None)
            size -= 1
            if r != size:
                moved = ids[size]
                ids[r] = moved
                row_of[moved] = r
                touched[r] = rel_updates.get(moved)
                if touched[r] is None:
                    touched[r] = get_vec(moved)
            touched.pop(size, None)  # the row past the new prefix is dead
            del ids[size]
        for pid, vec in rel_updates.items():
            if pid in row_of:  # in-place update (or a row just swap-moved)
                touched[row_of[pid]] = vec
            else:  # append
                row_of[pid] = size
                ids.append(pid)
                touched[size] = vec
                size += 1
            metadata[pid] = meta_updates[pid]
        assert size == new_size

        matrix = self.device_matrix
        if touched:
            rows = np.fromiter(touched.keys(), np.int64, len(touched))
            vals = np.stack([np.asarray(v, np.float32) for v in touched.values()])
            if self.dtype == "int8":
                vals = np.clip(np.rint(vals / self.int8_scale), -127, 127).astype(np.int8)
            matrix = _scatter_rows(matrix, rows, vals)
        valid = (self.device_valid if size == self.size
                 else _prefix_mask(cap, size, matrix.device))
        return _CompanySnapshot._evolved(self, ids, row_of, metadata, matrix, valid, size)

    def _dense_matrix(self) -> torch.Tensor:
        """Float view for the k > 1 path (dequantizes int8)."""
        if self.dtype != "int8":
            return self.device_matrix
        return self.device_matrix.float() * self.int8_scale

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
        """Device (vals [B, k], idx [B, k]): K2 (int8) or K1 for k == 1, else
        cosine_topk on the float (dequantized) matrix."""
        if k == 1:
            if self.dtype == "int8":
                v1, i1 = gallery_top1_int8(q32, self.device_matrix, self.int8_scale,
                                           self.size)
            else:
                v1, i1 = gallery_top1(q32.to(self.device_matrix.dtype),
                                      self.device_matrix, self.size)
            return v1[:, None], i1[:, None]
        dense = self._dense_matrix()
        return cosine_topk(q32.to(dense.dtype), dense, self.device_valid, k=k)


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
