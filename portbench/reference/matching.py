# Frozen copy of facerecognition_infrenceengine_tpu_torch/ops/matching.py at commit 5fe48e2 (imports made local); do not edit.
"""Cosine-similarity gallery matching primitives (the k > 1 path)."""

from __future__ import annotations

import torch


def l2_normalize(x: torch.Tensor, dim: int = -1, eps: float = 1e-12) -> torch.Tensor:
    n = torch.linalg.vector_norm(x, dim=dim, keepdim=True)
    return x / torch.clamp(n, min=eps)


def cosine_scores(queries: torch.Tensor, gallery: torch.Tensor) -> torch.Tensor:
    """[B, D] x [N, D] -> [B, N] cosine scores (inputs assumed normalized),
    accumulated in f32."""
    return queries.float() @ gallery.float().T


def cosine_topk(queries: torch.Tensor, gallery: torch.Tensor, valid: torch.Tensor,
                k: int = 1):
    """Top-k matches: queries [B, D], gallery [N, D] (padded rows allowed),
    valid [N] bool.  Scores accumulate in f32; ties go to the lowest index
    (a stable descending sort), as ``lax.top_k`` does.

    Returns (scores [B, k] float32, indices [B, k] int32)."""
    scores = cosine_scores(queries, gallery)
    scores = torch.where(valid[None, :], scores,
                         torch.tensor(float("-inf"), device=scores.device))
    vals, idx = torch.sort(scores, dim=1, descending=True, stable=True)
    return vals[:, :k], idx[:, :k].to(torch.int32)
