"""Affine face warp from a per-frame pyramid atlas: ROI windows, then K3.

The torch form of ``facerecognition_infrenceengine_tpu/ops/warp2pass.py``
(raw-layout path).  Faces larger than the static ROI window sample from an
average-pool pyramid level chosen per face, so every face is one
[ROI, ROI, C] window plus a dst->ROI affine, and the warp itself
(``ops/warp_kernel.warp_rois``, K3) sees one static shape.

The pyramid is kept as one atlas per frame, levels side by side: uint8
input gives a uint8 atlas whose levels are integer sums rounded half up
(level 0 is the input, bit-exact); float input keeps a float32 atlas.
"""

from __future__ import annotations

import torch

from .align import ARCFACE_DST, _invert_affine, umeyama_similarity
from .warp_kernel import warp_rois

ROI = 192  # static ROI window (source pixels) per face, per pyramid level
HALO = 3.0  # source pixels beyond the crop's exact axis-aligned extent


def _edge_pad(p: torch.Tensor, pad_h: int, pad_w: int) -> torch.Tensor:
    """Border-replicate [B, H, W, C] on the bottom/right."""
    if pad_w:
        p = torch.cat([p, p[:, :, -1:].expand(-1, -1, pad_w, -1)], dim=2)
    if pad_h:
        p = torch.cat([p, p[:, -1:].expand(-1, pad_h, -1, -1)], dim=1)
    return p


def _pool2(x: torch.Tensor) -> torch.Tensor:
    """Sum of each 2x2 block (odd trailing rows/columns dropped)."""
    b, h, w, c = x.shape
    x = x[:, : h // 2 * 2, : w // 2 * 2]
    return x.reshape(b, h // 2, 2, w // 2, 2, c).sum(dim=(2, 4))


def build_atlas(frames: torch.Tensor, levels: int = 4):
    """Pyramid as one image per frame, levels side by side.

    Returns (atlas [B, H_a, W_a, C], offsets: list of (x_off, lw, lh)).
    """
    if frames.dtype == torch.uint8:
        pyr = [frames]
        acc = frames.float()
        for lvl in range(1, levels):
            acc = _pool2(acc)  # integer sums < 2**24: exact in f32
            pyr.append(torch.floor(acc / (4 ** lvl) + 0.5).to(torch.uint8))
    else:
        x = frames.float()
        pyr = [x]
        for _ in range(1, levels):
            x = _pool2(x) / 4.0
            pyr.append(x)
    h_a = max(max(p.shape[1] for p in pyr), ROI)
    cols, offsets = [], []
    x_off = 0
    for p in pyr:
        _, lh, lw, _ = p.shape
        # edge-pad small levels up to the ROI window, then zero-fill the
        # never-read rows down to the atlas height
        p = _edge_pad(p, max(ROI - lh, 0), max(ROI - lw, 0))
        p = torch.nn.functional.pad(p, (0, 0, 0, 0, 0, h_a - p.shape[1]))
        cols.append(p)
        offsets.append((x_off, max(lw, ROI), max(lh, ROI)))
        x_off += p.shape[2]
    return torch.cat(cols, dim=2), offsets


def pyramid_level(m_inv: torch.Tensor, out_size: int, levels: int = 4) -> torch.Tensor:
    """Per face, the smallest pyramid level whose scaled span of the crop's
    inverse image (its axis-aligned extent plus the halo) fits the ROI
    window; faces too large for the coarsest level keep it.  m_inv [M, 2, 3]
    dst->frame affines -> [M] int64."""
    m_inv = m_inv.float()
    span = torch.maximum((m_inv[:, 0, 0].abs() + m_inv[:, 0, 1].abs()) * out_size + HALO,
                         (m_inv[:, 1, 0].abs() + m_inv[:, 1, 1].abs()) * out_size + HALO)
    lvl_f = torch.ceil(torch.log2(torch.clamp(span / ROI, min=1.0)))
    return torch.clamp(lvl_f.long(), 0, levels - 1)


def extract_rois_from_affines(frames: torch.Tensor, frame_idx: torch.Tensor,
                              m_inv: torch.Tensor, out_size: int, levels: int = 4):
    """Per-face ROI window + dst->ROI affine, pyramid level pre-selected.

    frames [B, H, W, C]; frame_idx [M]; m_inv [M, 2, 3] dst->frame affines.
    Returns (rois [M, ROI, ROI, C] float32, mats [M, 2, 3] float32).
    """
    atlas, offsets = build_atlas(frames, levels)
    dev = frames.device
    x_offs = torch.tensor([o[0] for o in offsets], dtype=torch.int64, device=dev)
    lws = torch.tensor([o[1] for o in offsets], dtype=torch.int64, device=dev)
    lhs = torch.tensor([o[2] for o in offsets], dtype=torch.int64, device=dev)
    m_inv = m_inv.float()
    m00, m01, m02 = m_inv[:, 0, 0], m_inv[:, 0, 1], m_inv[:, 0, 2]
    m10, m11, m12 = m_inv[:, 1, 0], m_inv[:, 1, 1], m_inv[:, 1, 2]
    lvl = pyramid_level(m_inv, out_size, levels)
    half = out_size / 2
    cx = m00 * half + m01 * half + m02
    cy = m10 * half + m11 * half + m12
    # Level pixel i averages source pixels [s*i, s*i + s): its center is at
    # source coordinate s*i + (s-1)/2.
    s = torch.exp2(lvl.float())
    shift = (s - 1.0) / 2.0
    x0 = torch.clamp(torch.round((cx - shift) / s - ROI / 2).long(), min=0)
    x0 = torch.minimum(x0, lws[lvl] - ROI)
    y0 = torch.clamp(torch.round((cy - shift) / s - ROI / 2).long(), min=0)
    y0 = torch.minimum(y0, lhs[lvl] - ROI)
    ar = torch.arange(ROI, device=dev)
    rows = (y0[:, None] + ar)[:, :, None]
    cols = (x_offs[lvl] + x0)[:, None, None] + ar[None, None, :]
    rois = atlas[frame_idx.long()[:, None, None], rows, cols].float()
    lin = m_inv[:, :, :2] / s[:, None, None]
    trans = (m_inv[:, :, 2] - shift[:, None]) / s[:, None] - torch.stack([x0, y0], 1).float()
    mats = torch.cat([lin, trans[:, :, None]], dim=2)
    return rois.contiguous(), mats.contiguous()


def extract_rois(frames: torch.Tensor, frame_idx: torch.Tensor, kps: torch.Tensor,
                 out_size: int = 112, dst: torch.Tensor | None = None, levels: int = 4):
    """ROI windows + affines from landmarks [M, 5, 2] in frame coordinates."""
    if dst is None:
        dst = torch.from_numpy(ARCFACE_DST) * (out_size / 112.0)
    m_inv = _invert_affine(umeyama_similarity(kps, dst.to(frames.device)))
    return extract_rois_from_affines(frames, frame_idx, m_inv, out_size, levels)


def warp_faces_two_pass(frames: torch.Tensor, frame_idx: torch.Tensor, kps: torch.Tensor,
                        out_size: int = 112, dst: torch.Tensor | None = None,
                        levels: int = 4) -> torch.Tensor:
    """Align M faces from a batch of frames.

    frames [B, H, W, C] uint8 or float (H, W divisible by 2**(levels-1));
    frame_idx [M]; kps [M, 5, 2] landmarks in frame coordinates.
    Returns [M, out_size, out_size, C] float32 crops, through K3 on the card
    and its plain version on the CPU.
    """
    rois, mats = extract_rois(frames, frame_idx, kps, out_size, dst, levels)
    return warp_rois(rois, mats, out_size)
