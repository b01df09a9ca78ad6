"""K1: the fused gallery top-1 -- best cosine row per query, f32 or bf16.

Replaces ``facerecognition_infrenceengine_tpu/ops/match_pallas.py::
gallery_top1``.  The CUDA kernel is ``csrc/match.cu``; its header states
the bound on the H100 (gallery bytes at small batch, f32 FLOPs at large
batch) and the design (row chunks across blocks, queries in registers, a
second pass that merges chunks by the lowest-index rule).

``gallery_top1`` launches the kernel for CUDA tensors and runs the plain
version, ``gallery_top1_plain``, for CPU tensors.  ``gallery_top1.launches``
counts kernel launches.
"""

from __future__ import annotations

import torch

from ..kernels import build

DIM = 512
_DTYPES = (torch.float32, torch.bfloat16)


def gallery_top1_plain(queries: torch.Tensor, gallery: torch.Tensor, n_valid: int):
    """Masked ``q @ g.T`` in f32 (exact products of the gallery-dtype
    values), then the max with the lowest index on ties; -inf and index 0
    when no row is valid."""
    q = queries.to(gallery.dtype).float()
    col = torch.arange(gallery.shape[0], device=gallery.device)
    scores = torch.where(col[None, :] < n_valid, q @ gallery.float().T,
                         torch.tensor(float("-inf"), device=gallery.device))
    vals = scores.max(dim=1).values
    # lowest column holding the max (every column when all are -inf -> 0)
    idx = torch.where(scores == vals[:, None], col, gallery.shape[0]).min(dim=1).values
    return vals, idx.to(torch.int32)


def gallery_top1(queries: torch.Tensor, gallery: torch.Tensor, n_valid: int):
    """Top-1 cosine match in one pass over the gallery.

    queries: [B, 512] normalized, cast to the gallery's dtype.
    gallery: [N, 512] float32 or bfloat16, contiguous; rows [n_valid:] are
      padding and are never read.
    Returns (values [B] float32, indices [B] int32).
    """
    if (gallery.dim() != 2 or queries.dim() != 2 or gallery.shape[0] == 0
            or queries.shape[1] != gallery.shape[1]):
        raise ValueError(f"queries {tuple(queries.shape)} / gallery {tuple(gallery.shape)}")
    n_valid = int(n_valid)
    if gallery.device.type == "cpu":
        return gallery_top1_plain(queries, gallery, n_valid)
    if gallery.device.type != "cuda" or queries.device != gallery.device:
        raise ValueError(f"queries on {queries.device}, gallery on {gallery.device}")
    if gallery.dtype not in _DTYPES:
        raise TypeError(f"gallery dtype {gallery.dtype} not in {_DTYPES}")
    if gallery.shape[1] != DIM:
        raise ValueError(f"kernel takes {DIM}-d embeddings, got {gallery.shape[1]}")
    if not gallery.is_contiguous():
        raise ValueError("gallery must be contiguous")
    q = queries.to(gallery.dtype).contiguous()
    if q.data_ptr() % 16:
        q = q.clone()
    b = q.shape[0]
    n_rows = max(0, min(n_valid, gallery.shape[0]))
    lib = build.lib()
    rows_per_block = lib.fre_gallery_top1_rows_per_block()
    chunks = -(-n_rows // rows_per_block)
    if chunks > 65535:
        raise ValueError(f"gallery of {n_rows} rows exceeds the kernel's grid")
    dev = gallery.device
    vals = torch.empty(b, dtype=torch.float32, device=dev)
    idx = torch.empty(b, dtype=torch.int32, device=dev)
    if b == 0:
        return vals, idx
    part_val = torch.empty(max(chunks, 1) * b, dtype=torch.float32, device=dev)
    part_idx = torch.empty(max(chunks, 1) * b, dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.fre_gallery_top1(q.data_ptr(), gallery.data_ptr(),
                               int(gallery.dtype == torch.bfloat16), b, n_rows, chunks,
                               part_val.data_ptr(), part_idx.data_ptr(),
                               vals.data_ptr(), idx.data_ptr(), stream)
    build.check(err, "fre_gallery_top1")
    gallery_top1.launches += 1
    return vals, idx


gallery_top1.launches = 0
