"""5-point similarity-transform face alignment, batched over faces.

Umeyama (1991) least-squares similarity from the detector's 5 landmarks to
the ArcFace template, the affine inverse, and the plain bilinear aligner
(``warp_face`` / ``warp_faces``: inverse bilinear sampling, tap indices
clamped to the frame), as in ``facerecognition_infrenceengine_tpu/ops/align.py``.
The serving path aligns through ``ops/warp2pass.py`` (K3); the bilinear
aligner is the exact warp that one is held against, and runs as torch ops
on the input's device.
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


def _sum_k(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last dim, left to right, one elementwise add at a time:
    the same bits on the CPU and on the card (a reduction kernel's order
    differs between devices)."""
    out = x[..., 0]
    for i in range(1, x.shape[-1]):
        out = out + x[..., i]
    return out


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
    Every sum runs in a fixed order of elementwise ops and every division
    is a true one, so the card and the CPU give the same affine bit for bit.
    """
    src, dst = torch.broadcast_tensors(src.float(), dst.float().to(src.device))
    # a 0-dim tensor on the device, not a Python number: CUDA divides by a
    # host scalar as a multiply by its reciprocal, the CPU divides exactly
    k = src.new_full((), float(src.shape[-2]))
    mu_sx, mu_sy, mu_dx, mu_dy = _sum_k(torch.stack(
        [src[..., 0], src[..., 1], dst[..., 0], dst[..., 1]])) / k
    sx, sy = src[..., 0] - mu_sx[..., None], src[..., 1] - mu_sy[..., None]
    dx, dy = dst[..., 0] - mu_dx[..., None], dst[..., 1] - mu_dy[..., None]
    p, q, r, u, var_s = _sum_k(torch.stack(
        [dx * sx, dx * sy, dy * sx, dy * sy, sx * sx + sy * sy])) / k
    denom = torch.clamp(var_s, min=1e-12)
    a = (p + u) / denom
    b = (r - q) / denom
    t0 = mu_dx - (a * mu_sx - b * mu_sy)
    t1 = mu_dy - (b * mu_sx + a * mu_sy)
    return torch.stack([torch.stack([a, -b, t0], -1), torch.stack([b, a, t1], -1)], -2)


def _invert_affine(m: torch.Tensor) -> torch.Tensor:
    """Invert [..., 2, 3] affines; a determinant below 1e-12 in magnitude is
    clamped to +-1e-12 so degenerate transforms stay finite.

    The translation is -(inv @ t) summed as XLA's CPU dot sums a 2-term row:
    the first product rounded, the second fused onto it (an fma, taken in
    float64 here).  A one-ulp difference in the translation moves every
    sample coordinate, which on a noisy frame is a few 1e-3 of intensity."""
    a00, a01, a02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    a10, a11, a12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    det = a00 * a11 - a01 * a10
    tiny = torch.where(det < 0, torch.full_like(det, -1e-12), torch.full_like(det, 1e-12))
    det = torch.where(det.abs() < 1e-12, tiny, det)
    i00, i01 = a11 / det, -a01 / det
    i10, i11 = -a10 / det, a00 / det

    def fma(a, b, c):
        return (a.double() * b.double() + c.double()).to(m.dtype)

    t0 = -fma(i01, a12, i00 * a02)
    t1 = -fma(i11, a12, i10 * a02)
    return torch.stack([torch.stack([i00, i01, t0], -1),
                        torch.stack([i10, i11, t1], -1)], -2)


def _sample_bilinear(image: torch.Tensor, inv: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """Bilinear samples of ``image`` [H, W, C] at ``inv`` [..., 2, 3] applied
    to every output pixel -> [..., out_h, out_w, C] float32.  Tap indices
    are clamped to the frame while the fractions are not, as the
    reference's: past an edge a sample blends the edge pixel and its inner
    neighbour, which near the edge is close to cv2.BORDER_REPLICATE."""
    h, w = image.shape[0], image.shape[1]
    gy, gx = torch.meshgrid(torch.arange(out_h, dtype=torch.float32, device=image.device),
                            torch.arange(out_w, dtype=torch.float32, device=image.device),
                            indexing="ij")
    inv = inv.float().to(image.device)[..., None, None, :, :]
    sx = inv[..., 0, 0] * gx + inv[..., 0, 1] * gy + inv[..., 0, 2]
    sy = inv[..., 1, 0] * gx + inv[..., 1, 1] * gy + inv[..., 1, 2]
    x0, y0 = torch.floor(sx), torch.floor(sy)
    fx, fy = (sx - x0)[..., None], (sy - y0)[..., None]
    # clamp before the int cast: a degenerate affine sends taps far outside
    x0i = x0.clamp(-1, w).to(torch.long).clamp(0, w - 1)
    y0i = y0.clamp(-1, h).to(torch.long).clamp(0, h - 1)
    x1i = (x0i + 1).clamp(max=w - 1)
    y1i = (y0i + 1).clamp(max=h - 1)
    img = image.float()
    top = img[y0i, x0i] * (1 - fx) + img[y0i, x1i] * fx
    bot = img[y1i, x0i] * (1 - fx) + img[y1i, x1i] * fx
    return top * (1 - fy) + bot * fy


def warp_affine_bilinear(image: torch.Tensor, m: torch.Tensor, out_hw: tuple) -> torch.Tensor:
    """Apply the forward affine ``m`` [2, 3] (src -> dst) by inverse bilinear
    sampling: image [H, W, C] -> [out_h, out_w, C] float32, tap indices
    clamped to the frame."""
    return _sample_bilinear(image, _invert_affine(m), *out_hw)


def _template(size: int) -> torch.Tensor:
    return torch.from_numpy(ARCFACE_DST) * (size / 112.0)


def warp_face(image: torch.Tensor, kps: torch.Tensor, size: int = 112) -> torch.Tensor:
    """Align one face: 5 landmarks [5, 2] -> the [size, size, C] ArcFace crop."""
    return warp_affine_bilinear(image, umeyama_similarity(kps, _template(size)), (size, size))


def warp_faces(image: torch.Tensor, kps_batch: torch.Tensor, size: int = 112) -> torch.Tensor:
    """Align many faces of one frame: [F, 5, 2] -> [F, size, size, C], in one
    batched gather."""
    m_inv = _invert_affine(umeyama_similarity(kps_batch, _template(size)))
    return _sample_bilinear(image, m_inv, size, size)
