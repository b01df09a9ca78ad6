"""5-point similarity-transform face alignment, batched over faces.

Umeyama (1991) least-squares similarity from the detector's 5 landmarks to
the ArcFace template, and the affine inverse, as in
``facerecognition_infrenceengine_tpu/ops/align.py``.
"""

from __future__ import annotations

import numpy as np
import torch

# Canonical ArcFace 112x112 destination landmarks (insightface convention).
ARCFACE_DST = np.array(
    [
        [38.2946, 51.6963],
        [73.5318, 51.5014],
        [56.0252, 71.7366],
        [41.5493, 92.3655],
        [70.7299, 92.2041],
    ],
    dtype=np.float32,
)


def umeyama_similarity(src: torch.Tensor, dst: torch.Tensor) -> torch.Tensor:
    """Least-squares similarity (rotation + scale + translation).

    src [..., K, 2] detected landmarks, dst [K, 2] or [..., K, 2] template
    -> M [..., 2, 3] with ``dst ~ M[:, :2] @ src + M[:, 2]``.

    The reference takes the SVD of the 2x2 covariance and flips the last
    singular direction when det(U)det(V) < 0, so the rotation is always
    proper.  In 2-D that rotation and trace(D S) have a closed form: with
    cov = [[p, q], [r, u]], scale*R = [[p+u, q-r], [r-q, p+u]] / var_src.
    Same function, no iterative SVD on the device; it stays finite on
    degenerate (all-equal, e.g. zero) landmarks, where it gives scale 0.
    """
    src = src.float()
    dst = dst.float().to(src.device)
    k = src.shape[-2]
    mu_s = src.mean(dim=-2)
    mu_d = dst.mean(dim=-2)
    src_c = src - mu_s[..., None, :]
    dst_c = dst - mu_d[..., None, :]
    p = (dst_c[..., 0] * src_c[..., 0]).sum(-1) / k
    q = (dst_c[..., 0] * src_c[..., 1]).sum(-1) / k
    r = (dst_c[..., 1] * src_c[..., 0]).sum(-1) / k
    u = (dst_c[..., 1] * src_c[..., 1]).sum(-1) / k
    var_s = (src_c ** 2).sum(dim=(-2, -1)) / k
    denom = torch.clamp(var_s, min=1e-12)
    a = (p + u) / denom
    b = (r - q) / denom
    sr = torch.stack([torch.stack([a, -b], -1), torch.stack([b, a], -1)], -2)
    t = mu_d - (sr @ mu_s[..., None])[..., 0]
    return torch.cat([sr, t[..., None]], dim=-1)


def _invert_affine(m: torch.Tensor) -> torch.Tensor:
    """Invert [..., 2, 3] affines; a determinant below 1e-12 in magnitude is
    clamped to +-1e-12 so degenerate transforms stay finite."""
    a00, a01, a02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    a10, a11, a12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    det = a00 * a11 - a01 * a10
    tiny = torch.where(det < 0, torch.full_like(det, -1e-12), torch.full_like(det, 1e-12))
    det = torch.where(det.abs() < 1e-12, tiny, det)
    i00, i01 = a11 / det, -a01 / det
    i10, i11 = -a10 / det, a00 / det
    t0 = -(i00 * a02 + i01 * a12)
    t1 = -(i10 * a02 + i11 * a12)
    return torch.stack([torch.stack([i00, i01, t0], -1),
                        torch.stack([i10, i11, t1], -1)], -2)
