"""K3: the face warp -- windows of the pyramid atlas + dst->window affines
-> aligned crops.

Replaces ``facerecognition_infrenceengine_tpu/ops/warp_pallas.py::
warp_rois_pallas``.  The CUDA kernel is ``csrc/warp.cu``; its header states
the bound on the H100 (bytes) and the design (a gather of the two non-zero
hat taps in each pass, 4 adjacent output pixels a thread, the taps read
straight from the uint8 or float32 atlas, raw or s2d4-packed).

``warp_windows`` warps each face's window of an atlas; ``warp_rois`` is the
counterpart of ``warp_rois_pallas``, the case where the atlas is the ROI
stack itself.  Both launch the kernel for CUDA tensors and run the plain
version (``warp_windows_plain``: the windows gathered in torch, then
``warp_rois_plain``) for CPU tensors.  ``warp_rois.launches`` counts the
kernel launches of both, and ``warp_rois.launches_by_size`` the same
launches by crop size (112 for the embedder, 96 and 192 for the attribute
heads).
"""

from __future__ import annotations

from collections import Counter

import torch

from ..kernels import build
from .stem_kernel import depth_to_space4

ROI = 192  # the side of a face's window of the atlas, in raw pixels
VARIANTS = ("direct", "staged")  # the uint8 read (csrc/warp.cu)


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


def gather_windows(atlas: torch.Tensor, windows: torch.Tensor, side: int) -> torch.Tensor:
    """Each face's side x side window of the atlas [B, Ha, Wa, Cs] in its
    layout and dtype -> [M, side, side, Cs].  windows [M, 3] = (frame, row
    origin, column origin) in atlas units, clamped into the atlas as the
    kernel clamps them."""
    b, ha, wa, _ = atlas.shape
    w = windows.long()
    frame = w[:, 0].clamp(0, b - 1)
    y0 = w[:, 1].clamp(0, ha - side)
    x0 = w[:, 2].clamp(0, wa - side)
    ar = torch.arange(side, device=atlas.device)
    return atlas[frame[:, None, None], (y0[:, None] + ar)[:, :, None],
                 (x0[:, None] + ar)[:, None, :]]


def warp_windows_plain(atlas: torch.Tensor, windows: torch.Tensor, mats: torch.Tensor,
                       out_size: int = 112, packed: bool = False) -> torch.Tensor:
    """The plain version of ``warp_windows``: the windows gathered (packed
    ones unpacked to raw layout) as float32 ROIs, then ``warp_rois_plain``."""
    rois = gather_windows(atlas, windows, ROI // 4 if packed else ROI)
    if packed:
        rois = depth_to_space4(rois)
    return warp_rois_plain(rois.float(), mats, out_size)


def _launch(atlas, windows, mats, out_size, packed, side, variant) -> torch.Tensor:
    b, ha, wa, cs = atlas.shape
    c = cs // 16 if packed else cs
    m = mats.shape[0]
    out = torch.empty((m, out_size, out_size, c), dtype=torch.float32, device=atlas.device)
    if m == 0:
        return out
    stream = torch.cuda.current_stream(atlas.device).cuda_stream
    with build.launch_device(atlas.device):
        err = build.lib().fre_warp_windows(
            atlas.data_ptr(), None if windows is None else windows.data_ptr(),
            mats.data_ptr(), out.data_ptr(), m, b, ha, wa, c, side, out_size,
            int(atlas.dtype == torch.uint8), int(packed), VARIANTS.index(variant), stream)
    build.check(err, "fre_warp_windows")
    warp_rois.launches += 1
    warp_rois.launches_by_size[out_size] += 1
    return out


def _check_out_size(out_size: int) -> None:
    if not 1 <= out_size <= 4096:
        raise ValueError(f"out_size {out_size}: the kernel takes 1-4096")


def warp_windows(atlas: torch.Tensor, windows: torch.Tensor, mats: torch.Tensor,
                 out_size: int = 112, packed: bool = False,
                 variant: str = "direct") -> torch.Tensor:
    """Warp each face's ROI x ROI window of a pyramid atlas by its
    dst->window affine, with no ROI tensor in between.

    atlas: [B, Ha, Wa, C] (raw) or [B, Ha, Wa, 16C] (s2d4-packed: raw pixel
    (4Y+p, 4X+q, c) at channel (p*4+q)*C + c), uint8 or float32, contiguous;
    windows: [M, 3] int32 (frame, row origin, column origin) in atlas units
    (packed pixels on a packed atlas), clamped into the atlas; mats:
    [M, 2, 3] float32 dst -> raw window coordinates.  variant: the uint8
    read, "direct" or "staged" (csrc/warp.cu; measured slower).
    Returns [M, out_size, out_size, C] float32.
    """
    if atlas.dim() != 4 or (packed and atlas.shape[3] % 16):
        raise ValueError(f"atlas must be [B, Ha, Wa, {'16C' if packed else 'C'}], got "
                         f"{tuple(atlas.shape)}")
    m = windows.shape[0]
    c = atlas.shape[3] // 16 if packed else atlas.shape[3]
    side = ROI // 4 if packed else ROI
    if tuple(windows.shape) != (m, 3) or tuple(mats.shape) != (m, 2, 3):
        raise ValueError(f"windows must be [M, 3] and mats [M, 2, 3], got "
                         f"{tuple(windows.shape)} and {tuple(mats.shape)}")
    if not 1 <= c <= 4 or side > min(atlas.shape[1], atlas.shape[2]):
        raise ValueError(f"kernel takes 1-4 channels and {side}-pixel windows inside the "
                         f"atlas, got C={c} on {tuple(atlas.shape)}")
    if variant not in VARIANTS:
        raise ValueError(f"variant {variant!r}, not one of {VARIANTS}")
    _check_out_size(out_size)
    if atlas.device.type == "cpu":
        return warp_windows_plain(atlas, windows, mats, out_size, packed)
    if atlas.device.type != "cuda" or windows.device != atlas.device or mats.device != atlas.device:
        raise ValueError(f"atlas on {atlas.device}, windows on {windows.device}, "
                         f"mats on {mats.device}")
    if atlas.dtype not in (torch.uint8, torch.float32) or windows.dtype != torch.int32 \
            or mats.dtype != torch.float32:
        raise TypeError(f"uint8 or float32 atlas, int32 windows and float32 mats expected, got "
                        f"{atlas.dtype}, {windows.dtype} and {mats.dtype}")
    if not (atlas.is_contiguous() and windows.is_contiguous() and mats.is_contiguous()):
        raise ValueError("atlas, windows and mats must be contiguous")
    if variant == "staged" and atlas.data_ptr() % 16:
        raise ValueError("staged: the atlas must start on a 16-byte boundary (cp.async)")
    return _launch(atlas, windows, mats, out_size, packed, ROI, variant)


def warp_rois(rois: torch.Tensor, mats: torch.Tensor, out_size: int = 112) -> torch.Tensor:
    """Warp M ROIs with per-face dst->ROI affines: the kernel on the ROI
    stack as the atlas, window k = (k, 0, 0).

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
    if not 1 <= c <= 4:
        raise ValueError(f"kernel takes 1-4 channels, got C={c}")
    _check_out_size(out_size)
    if m == 0:
        return rois.new_empty((0, out_size, out_size, c))
    return _launch(rois, None, mats, out_size, False, r, "direct")


warp_rois.launches = 0
warp_rois.launches_by_size = Counter()
