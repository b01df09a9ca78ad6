"""Distributed gallery top-k over a row-sharded gallery.

The torch form of ``facerecognition_infrenceengine_tpu/parallel/topk.py``:

  queries [B, D] (copied to each shard's device) x gallery shard [N/s, D]
  -> per-shard scores -> per-shard top-k -> the candidates gathered to the
  first shard's device -> the final top-k -> global row indices.

Each shard runs on its own device; the gather is one ``Tensor.to`` a shard.
Ties go to the lowest global index, as ``lax.top_k`` breaks them over the
reference's shard-major candidate list: every top-k here is a stable
descending sort, and the candidates are concatenated in shard order.

``distributed_top1_fused`` runs K1 (f32 / bf16) or K2 (int8) on each shard,
so an int8 gallery stays int8 on every device.  Each function takes the
gallery as :class:`~.sharding.RowShards` (or a whole tensor, split here with
``gallery_sharding(mesh)``); its ``*_plain`` twin runs the same merge with
every shard on the CPU, through the kernels' plain versions.
"""

from __future__ import annotations

import torch

from ..ops.match_kernel import gallery_top1, gallery_top1_int8, quantize_queries
from .sharding import Mesh, RowShards, gallery_sharding

_NEG_INF = float("-inf")


def _shards(gallery, mesh: Mesh | None) -> RowShards:
    if isinstance(gallery, RowShards):
        return gallery
    if mesh is None:
        raise ValueError("a whole gallery tensor needs the mesh to shard it over")
    return gallery_sharding(mesh).put(gallery)


def _stable_topk(scores: torch.Tensor, k: int):
    vals, idx = torch.sort(scores, dim=1, descending=True, stable=True)
    return vals[:, :k], idx[:, :k]


def _merge(shards: RowShards, local):
    """[(vals [B, k_i], local idx [B, k_i])] a shard -> the top-k over
    every shard's candidates on the first shard's device, global int32
    indices."""
    dev = shards.device
    k = max(v.shape[1] for v, _ in local)
    vals = torch.cat([v.to(dev) for v, _ in local], dim=1)
    idx = torch.cat([(i.long() + off).to(dev) for (_, i), off in zip(local, shards.offsets)],
                    dim=1)
    top_v, pos = _stable_topk(vals, k)
    return top_v, torch.gather(idx, 1, pos).to(torch.int32)


def distributed_topk(queries: torch.Tensor, gallery, valid, mesh: Mesh | None = None,
                     k: int = 1):
    """Top-k cosine match of ``queries`` against a row-sharded ``gallery``.

    queries: [B, D] L2-normalized; gallery: [N, D] row shards; valid: [N]
    bool mask of real rows (shards aligned with the gallery's); scores
    accumulate in f32.  Returns (values [B, k] float32, indices [B, k]
    int32), global row ids, on the first shard's device."""
    shards = _shards(gallery, mesh)
    valid = _shards(valid, mesh)
    local = []
    for g, ok in zip(shards.parts, valid.parts):
        s = queries.to(g.device).float() @ g.float().T
        s = torch.where(ok[None, :], s, torch.tensor(_NEG_INF, device=g.device))
        local.append(_stable_topk(s, min(k, g.shape[0])))
    return _merge(shards, local)


def distributed_topk_plain(queries, gallery: RowShards, valid: RowShards, k: int = 1):
    """``distributed_topk`` with every shard on the CPU."""
    return distributed_topk(queries.cpu(), gallery.to("cpu"), valid.to("cpu"), k=k)


def distributed_top1(queries, gallery, valid, mesh: Mesh | None = None):
    vals, idx = distributed_topk(queries, gallery, valid, mesh, k=1)
    return vals[:, 0], idx[:, 0]


def _local_valid(size: int, offset: int, n_local: int) -> int:
    """The live rows of a shard: the global prefix [0, size) clipped to it."""
    return min(max(int(size) - offset, 0), n_local)


def distributed_top1_fused(queries: torch.Tensor, gallery, size: int, mesh: Mesh | None = None,
                           int8_scale=None):
    """Top-1 with the single-pass kernel on each shard and one gather.

    queries: [B, D] f32 normalized; gallery: [N, D] row shards, f32 / bf16
    (K1) or int8 with the global ``int8_scale`` (K2); live rows are the
    global prefix [0, size).  The kernel's scores are merged with the
    lowest global index on ties.  Returns (values [B] f32, indices [B]
    int32) on the first shard's device."""
    shards = _shards(gallery, mesh)
    local = []
    for g, off in zip(shards.parts, shards.offsets):
        nv = _local_valid(size, off, int(g.shape[0]))
        q = queries.to(g.device)
        if int8_scale is None:
            v1, i1 = gallery_top1(q.to(g.dtype), g, nv)
        else:
            v1, i1 = gallery_top1_int8(q, g, int8_scale, nv)
        local.append((v1[:, None], i1[:, None]))
    vals, idx = _merge(shards, local)
    return vals[:, 0], idx[:, 0]


def distributed_top1_fused_plain(queries, gallery: RowShards, size: int, int8_scale=None):
    """``distributed_top1_fused`` with every shard on the CPU (K1's and K2's
    plain versions)."""
    return distributed_top1_fused(queries.cpu(), gallery.to("cpu"), size,
                                  int8_scale=int8_scale)


def _pad_to(n: int, m: int) -> int:
    return n + (-n) % m


def _int8_scores(q_int: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Raw s8 x s8 -> s32 scores [B, n] as f32 (exact: |raw| <= 512 * 127**2
    < 2**24).  On the card ``torch._int_mm``, with M padded to a multiple of
    32 and K, N to multiples of 8 (``ops/int8_conv.py``'s rule: cuBLASLt
    refuses M <= 16 and some M below 64); on the CPU an int32 matmul."""
    if g.device.type != "cuda":
        return (q_int.to(torch.int32) @ g.to(torch.int32).T).float()
    b, d = q_int.shape
    n = g.shape[0]
    bp, dp, np_ = _pad_to(max(b, 32), 32), _pad_to(d, 8), _pad_to(n, 8)
    a = torch.zeros((bp, dp), dtype=torch.int8, device=g.device)
    a[:b, :d] = q_int
    w = g.T if (dp, np_) == (d, n) else torch.nn.functional.pad(g, (0, dp - d, 0, np_ - n)).T
    return torch._int_mm(a, w)[:b, :n].float()


def distributed_topk_int8(queries: torch.Tensor, gallery_q, gallery_scale, size: int,
                          mesh: Mesh | None = None, k: int = 1):
    """Top-k against a row-sharded int8 gallery without dequantizing it.

    The queries are quantized once with the batch's global scale (the
    scheme of K2, so the raw s32 compare is monotonic in the true score);
    each shard computes raw s8 x s8 -> s32 scores, masks the rows past its
    live count and takes its top-k; the merged raw scores are scaled by
    ``qs * gallery_scale``.  Returns (values [B, k] float32, indices
    [B, k] int32) on the first shard's device."""
    shards = _shards(gallery_q, mesh)
    q_int, qs = quantize_queries(queries)
    local = []
    for g, off in zip(shards.parts, shards.offsets):
        n_local = int(g.shape[0])
        raw = _int8_scores(q_int.to(g.device), g)
        col = torch.arange(n_local, device=g.device)
        raw = torch.where(col[None, :] < _local_valid(size, off, n_local), raw,
                          torch.tensor(_NEG_INF, device=g.device))
        local.append(_stable_topk(raw, min(k, n_local)))
    vals, idx = _merge(shards, local)
    return vals * (qs.to(vals.device) * float(gallery_scale)), idx


def distributed_topk_int8_plain(queries, gallery_q: RowShards, gallery_scale, size: int,
                                k: int = 1):
    """``distributed_topk_int8`` with every shard on the CPU."""
    return distributed_topk_int8(queries.cpu(), gallery_q.to("cpu"), gallery_scale, size, k=k)
