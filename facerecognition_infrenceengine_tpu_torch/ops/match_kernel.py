"""K1 and K2: the fused gallery top-1 -- best cosine row per query, against
an f32 / bf16 gallery (K1) or an int8 gallery with one global scale (K2).

Replaces ``facerecognition_infrenceengine_tpu/ops/match_pallas.py::
gallery_top1``.  The CUDA kernel is ``csrc/match.cu``; its header states
the bound on the H100 (gallery bytes at small batch, f32 FLOPs at large
batch) and the design (a persistent grid that reads the gallery once for
every 32 queries staged in shared memory; f32 on the FP32 cores with
gallery rows in registers, bf16 on the tensor cores; blocks fold their
best rows into one 64-bit key a query, ordered by value then the lowest
index, in the same launch).

The wrappers allocate only their outputs: the kernels' scratch is made
once per (device, stream, batch size) and reused, which is safe because
calls on one stream run in order; the C entries are looked up once.

``gallery_top1`` launches the kernel for CUDA tensors and runs the plain
version, ``gallery_top1_plain``, for CPU tensors.  ``gallery_top1.launches``
counts kernel launches.  K2 (``gallery_top1_int8``, ``csrc/match_int8.cu``)
follows the same rules; its section is at the end of this module.
"""

from __future__ import annotations

import numpy as np
import torch

from ..kernels import build

DIM = 512
_DTYPES = (torch.float32, torch.bfloat16)
_scratch: dict = {}  # (kernel, device, stream, b) -> scratch buffers
_entries: dict = {}  # kernel -> its C entry


def _cached_scratch(key, make):
    bufs = _scratch.get(key)
    if bufs is None:
        bufs = _scratch[key] = make()
    return bufs


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

    queries: [B, 512] normalized, rounded to the gallery's dtype.
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
    if not gallery.is_contiguous() or gallery.data_ptr() % 16:
        raise ValueError("gallery must be contiguous and 16-byte aligned")
    # f32 queries either way: the kernel rounds them to the gallery's dtype
    # as it stages them (the plain version's cast), so no cast runs here
    q = queries.float().contiguous()
    if q.data_ptr() % 16:
        q = q.clone()
    b = q.shape[0]
    n_rows = max(0, min(n_valid, gallery.shape[0]))
    dev = gallery.device
    fn = _entries.get("top1")
    if fn is None:
        fn = _entries["top1"] = build.lib().fre_gallery_top1
    vals = torch.empty(b, dtype=torch.float32, device=dev)
    idx = torch.empty(b, dtype=torch.int32, device=dev)
    if b == 0:
        return vals, idx
    stream = torch._C._cuda_getCurrentRawStream(dev.index)  # cheaper than current_stream()
    # a 64-bit best key a query and a done-counter a 32-query tile, both
    # zero between calls
    keys, done = _cached_scratch(
        ("top1", dev, stream, b),
        lambda: (torch.zeros(b, dtype=torch.int64, device=dev),
                 torch.zeros(-(-b // 32), dtype=torch.int32, device=dev)))
    with build.launch_device(dev):
        err = fn(q.data_ptr(), gallery.data_ptr(), int(gallery.dtype == torch.bfloat16), b,
                 n_rows, keys.data_ptr(), done.data_ptr(), vals.data_ptr(), idx.data_ptr(),
                 stream)
    build.check(err, "fre_gallery_top1")
    gallery_top1.launches += 1
    return vals, idx


gallery_top1.launches = 0


# ---------------------------------------------------------------------------
# K2: the int8 gallery top-1.  Replaces ``facerecognition_infrenceengine_tpu/
# ops/match_pallas.py::gallery_top1_int8``; the CUDA kernel is
# ``csrc/match_int8.cu`` (bound and design in its header).
#
# One global gallery scale (``quantize_gallery``) and one per-batch query
# scale make the raw s8 x s8 -> s32 dot monotonic in the true score for
# every row, so the running (max, argmax) compares s32 exactly; the value is
# float(raw) * (qs * gallery_scale).  |raw| <= 512 * 127**2 < 2**24, so every
# partial sum is an exact f32 integer and the plain version's f32 matmul is
# exact in any order: kernel, plain version and the reference agree bit for
# bit.
# ---------------------------------------------------------------------------

def quantize_gallery(x, headroom: float = 1.0) -> tuple:
    """[N, D] float -> (int8 values [N, D], python float global scale), in
    numpy: a copy of the reference's host-side ``quantize_gallery``.

    ``headroom`` > 1 coarsens the scale so vectors slightly larger than the
    current gallery max can later be appended in place (delta sync) without
    clipping."""
    x = np.asarray(x, np.float32)
    scale = max(float(np.abs(x).max()) * headroom / 127.0, 1e-12)
    q = np.clip(np.rint(x / scale), -127, 127).astype(np.int8)
    return q, scale


_127 = {}  # device -> f32 127.0, made once: no host -> device copy per call


def quantize_queries(queries: torch.Tensor):
    """One scale for the whole (padded) batch: qs = max(max|q|, 1e-12) / 127
    in f32, q_int = clip(round_half_even(q / qs), -127, 127) as int8."""
    q = queries.float()
    c127 = _127.get(q.device)
    if c127 is None:
        c127 = _127[q.device] = torch.tensor(127.0, device=q.device)
    # a tensor divisor: CUDA turns division by a Python scalar into a
    # multiply by its reciprocal, which can move the last bit
    qs = torch.clamp(q.abs().max(), min=1e-12) / c127
    q_int = torch.clamp(torch.round(q / qs), -127, 127).to(torch.int8)
    return q_int, qs


def gallery_top1_int8_plain(queries: torch.Tensor, gallery_q: torch.Tensor,
                            gallery_scale, n_valid: int):
    """Masked s32 dot (as exact f32 integers), max with the lowest index on
    ties, then scaled; -inf and index 0 when no row is valid."""
    q_int, qs = quantize_queries(queries)
    col = torch.arange(gallery_q.shape[0], device=gallery_q.device)
    raw = torch.where(col[None, :] < n_valid, q_int.float() @ gallery_q.float().T,
                      torch.tensor(float("-inf"), device=gallery_q.device))
    best = raw.max(dim=1).values
    idx = torch.where(raw == best[:, None], col, gallery_q.shape[0]).min(dim=1).values
    # a Python scalar multiplies as its f32 value: f32(qs) * f32(gallery_scale)
    return best * (qs * float(gallery_scale)), idx.to(torch.int32)


def gallery_top1_int8(queries: torch.Tensor, gallery_q: torch.Tensor, gallery_scale,
                      n_valid: int):
    """Top-1 match against an int8 gallery with one global scale.

    queries: [B, 512] float normalized, quantized with one scale for the
      batch (inside the kernel; ``quantize_queries`` in the plain version).
    gallery_q: [N, 512] int8, contiguous; rows [n_valid:] are never read.
    gallery_scale: the gallery's global f32 scale.
    Returns (values [B] float32 approximate cosines, indices [B] int32).
    """
    if (gallery_q.dim() != 2 or queries.dim() != 2 or gallery_q.shape[0] == 0
            or queries.shape[1] != gallery_q.shape[1]):
        raise ValueError(f"queries {tuple(queries.shape)} / gallery {tuple(gallery_q.shape)}")
    if gallery_q.dtype != torch.int8:
        raise TypeError(f"gallery dtype {gallery_q.dtype}, want torch.int8")
    n_valid = int(n_valid)
    if gallery_q.device.type == "cpu":
        return gallery_top1_int8_plain(queries, gallery_q, gallery_scale, n_valid)
    if gallery_q.device.type != "cuda" or queries.device != gallery_q.device:
        raise ValueError(f"queries on {queries.device}, gallery on {gallery_q.device}")
    if gallery_q.shape[1] != DIM:
        raise ValueError(f"kernel takes {DIM}-d embeddings, got {gallery_q.shape[1]}")
    if not gallery_q.is_contiguous() or gallery_q.data_ptr() % 16:
        raise ValueError("gallery must be contiguous and 16-byte aligned")
    q = queries.float().contiguous()
    if q.data_ptr() % 16:
        q = q.clone()
    b = q.shape[0]
    n_rows = max(0, min(n_valid, gallery_q.shape[0]))
    dev = gallery_q.device
    fn = _entries.get("top1_int8")
    if fn is None:
        fn = _entries["top1_int8"] = build.lib().fre_gallery_top1_int8
    vals = torch.empty(b, dtype=torch.float32, device=dev)
    idx = torch.empty(b, dtype=torch.int32, device=dev)
    if b == 0:
        return vals, idx
    stream = torch._C._cuda_getCurrentRawStream(dev.index)  # cheaper than current_stream()
    # the batch's max|q| word and a done-counter, a 64-bit best key a query
    # (all zero between calls), and the quantized queries (used for B > 32)
    state, keys, q_int = _cached_scratch(
        ("top1_int8", dev, stream, b),
        lambda: (torch.zeros(2, dtype=torch.int32, device=dev),
                 torch.zeros(b, dtype=torch.int64, device=dev),
                 torch.empty((b, DIM), dtype=torch.int8, device=dev)))
    with build.launch_device(dev):
        err = fn(q.data_ptr(), gallery_q.data_ptr(), float(gallery_scale), b, n_rows,
                 state.data_ptr(), q_int.data_ptr(), keys.data_ptr(), vals.data_ptr(),
                 idx.data_ptr(), stream)
    build.check(err, "fre_gallery_top1_int8")
    gallery_top1_int8.launches += 1
    return vals, idx


gallery_top1_int8.launches = 0
