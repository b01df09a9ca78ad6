"""K3: the face warp -- ROI windows + dst->ROI affines -> aligned crops.

Replaces ``facerecognition_infrenceengine_tpu/ops/warp_pallas.py::
warp_rois_pallas``.  The CUDA kernel is ``csrc/warp.cu``; its header states
the bound on the H100 (bytes) and the design (a per-pixel gather of the
two non-zero hat taps in each pass, no intermediate).

``warp_rois`` launches the kernel for CUDA tensors and runs the plain
version, ``warp_rois_plain``, for CPU tensors.  ``warp_rois.launches``
counts kernel launches, and ``warp_rois.launches_by_size`` the same launches
by crop size (112 for the embedder, 96 and 192 for the attribute heads).
"""

from __future__ import annotations

from collections import Counter

import torch

from ..kernels import build


def _hat_weights(coords: torch.Tensor, n_in: int) -> torch.Tensor:
    """coords [..., K] -> hat (linear interpolation) weights [..., K, n_in],
    coordinates clamped to [0, n_in - 1] (border replicate)."""
    c = torch.clamp(coords, 0.0, n_in - 1.0)
    idx = torch.arange(n_in, dtype=torch.float32, device=coords.device)
    return torch.clamp(1.0 - torch.abs(c[..., None] - idx), min=0.0)


def _warp_chunk(rois: torch.Tensor, mats: torch.Tensor, out_size: int) -> torch.Tensor:
    r = rois.shape[1]
    dev = rois.device
    m00, m01, m02 = (mats[:, 0, k, None, None] for k in range(3))
    m10, m11, m12 = (mats[:, 1, k, None, None] for k in range(3))
    m11 = torch.where(torch.abs(m11) < 1e-6, torch.full_like(m11, 1e-6), m11)
    jj = torch.arange(out_size, dtype=torch.float32, device=dev)
    yy = torch.arange(r, dtype=torch.float32, device=dev)
    ii = torch.arange(out_size, dtype=torch.float32, device=dev)
    # pass 1: tmp[y, j] = sum_x roi[y, x] hat(u(y, j) - x)
    u = ((m00 - m01 * m10 / m11) * jj[None, None, :]
         + (m01 / m11) * yy[None, :, None]
         + (m02 - m01 * m12 / m11))                       # [n, R(y), out(j)]
    tmp = torch.einsum("nyxc,nyjx->nyjc", rois, _hat_weights(u, r))
    # pass 2: out[i, j] = sum_y tmp[y, j] hat(sy(i, j) - y)
    sy = m10 * jj[None, None, :] + m11 * ii[None, :, None] + m12  # [n, out(i), out(j)]
    return torch.einsum("nyjc,nijy->nijc", tmp, _hat_weights(sy, r))


def warp_rois_plain(rois: torch.Tensor, mats: torch.Tensor,
                    out_size: int = 112) -> torch.Tensor:
    """The plain PyTorch version: the reference's ``_warp_one_from_roi`` as
    dense hat-weight contractions, in chunks of 8 faces (the weights are
    ~16 MB a face)."""
    rois = rois.float()
    mats = mats.float()
    m, _, _, c = rois.shape
    if m == 0:
        return rois.new_zeros((0, out_size, out_size, c))
    return torch.cat([_warp_chunk(rois[s:s + 8], mats[s:s + 8], out_size)
                      for s in range(0, m, 8)])


def warp_rois(rois: torch.Tensor, mats: torch.Tensor, out_size: int = 112) -> torch.Tensor:
    """Warp M ROIs with per-face dst->ROI affines.

    rois: [M, R, R, C] float32, contiguous NHWC; mats: [M, 2, 3] float32.
    Returns [M, out_size, out_size, C] float32.
    """
    if rois.dim() != 4 or rois.shape[1] != rois.shape[2]:
        raise ValueError(f"rois must be [M, R, R, C], got {tuple(rois.shape)}")
    m, r, _, c = rois.shape
    if tuple(mats.shape) != (m, 2, 3):
        raise ValueError(f"mats must be [{m}, 2, 3], got {tuple(mats.shape)}")
    if rois.device.type == "cpu":
        return warp_rois_plain(rois, mats, out_size)
    if rois.device.type != "cuda" or mats.device != rois.device:
        raise ValueError(f"rois on {rois.device}, mats on {mats.device}")
    if rois.dtype != torch.float32 or mats.dtype != torch.float32:
        raise TypeError(f"float32 expected, got {rois.dtype} and {mats.dtype}")
    if not (rois.is_contiguous() and mats.is_contiguous()):
        raise ValueError("rois and mats must be contiguous")
    if not 1 <= c <= 4 or m > 65535:
        raise ValueError(f"kernel takes 1-4 channels and <= 65535 faces, got C={c}, M={m}")
    out = torch.empty((m, out_size, out_size, c), dtype=torch.float32, device=rois.device)
    if m == 0:
        return out
    stream = torch.cuda.current_stream(rois.device).cuda_stream
    err = build.lib().fre_warp_rois(rois.data_ptr(), mats.data_ptr(), out.data_ptr(),
                                    m, r, c, out_size, stream)
    build.check(err, "fre_warp_rois")
    warp_rois.launches += 1
    warp_rois.launches_by_size[out_size] += 1
    return out


warp_rois.launches = 0
warp_rois.launches_by_size = Counter()
