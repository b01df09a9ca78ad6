# Frozen excerpt of facerecognition_infrenceengine_tpu_torch/ops/warp2pass.py (the
# raw-layout atlas, windows and affines) and ops/warp_kernel.py (the plain
# version of the warp, K3's definition) at commit 5fe48e2; do not edit.  The
# only change: ``warp_windows`` is the plain version.
"""The face warp the port's K3 computes, as plain torch (frozen excerpt)."""

from __future__ import annotations

import functools

import torch

from .align import ARCFACE_DST, _invert_affine, umeyama_similarity

ROI = 192  # the side of a face's window of the atlas, in raw pixels


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


def warp_windows(atlas: torch.Tensor, windows: torch.Tensor, mats: torch.Tensor,
                 out_size: int = 112) -> torch.Tensor:
    """The windows gathered as float32 ROIs, then ``warp_rois_plain``."""
    return warp_rois_plain(gather_windows(atlas, windows, ROI).float(), mats, out_size)


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


def pyramid_level(m_inv: torch.Tensor, out_size: int, levels: int = 4,
                  halo: float = HALO) -> torch.Tensor:
    """Per face, the smallest pyramid level whose scaled span of the crop's
    inverse image (its axis-aligned extent plus the halo) fits the ROI
    window; faces too large for the coarsest level keep it.  m_inv [M, 2, 3]
    dst->frame affines -> [M] int64."""
    m_inv = m_inv.float()
    span = torch.maximum((m_inv[:, 0, 0].abs() + m_inv[:, 0, 1].abs()) * out_size + halo,
                         (m_inv[:, 1, 0].abs() + m_inv[:, 1, 1].abs()) * out_size + halo)
    lvl_f = torch.ceil(torch.log2(torch.clamp(span / ROI, min=1.0)))
    return torch.clamp(lvl_f.long(), 0, levels - 1)


@functools.lru_cache(maxsize=64)
def _level_tables_on(offsets: tuple, device: torch.device):
    return tuple(torch.tensor([o[k] for o in offsets], dtype=torch.int64, device=device)
                 for k in range(3))


def _level_tables(offsets, device):
    """(x_off, lw, lh) of every atlas level as three int64 tensors, kept per
    (offsets, device): a host->device copy of them at every warp call would
    make the host wait for the card."""
    return _level_tables_on(tuple(offsets), torch.device(device))


def _windows(offsets, frame_idx, m_inv, out_size, levels, halo, unit):
    """Per face: the pyramid level, the window origin on a grid of ``unit``
    level pixels (1 raw, 4 packed; round half to even), clamped into the
    level, and the dst->window affine in level-raw pixels.  Returns
    (windows [M, 3] int32 (frame, row origin, column origin) in atlas units,
    mats [M, 2, 3] float32)."""
    x_offs, lws, lhs = _level_tables(offsets, m_inv.device)
    side = ROI // unit
    m_inv = m_inv.float()
    m00, m01, m02 = m_inv[:, 0, 0], m_inv[:, 0, 1], m_inv[:, 0, 2]
    m10, m11, m12 = m_inv[:, 1, 0], m_inv[:, 1, 1], m_inv[:, 1, 2]
    lvl = pyramid_level(m_inv, out_size, levels, halo=halo)
    half = out_size / 2
    cx = m00 * half + m01 * half + m02
    cy = m10 * half + m11 * half + m12
    # Level pixel i averages source pixels [s*i, s*i + s): its center is at
    # source coordinate s*i + (s-1)/2.
    s = torch.exp2(lvl.float())
    shift = (s - 1.0) / 2.0
    # |unit * x0 - ideal origin| <= unit / 2 raw pixels (packed: inside HALO_P)
    x0 = torch.round(((cx - shift) / s - ROI / 2) / float(unit)).long()
    y0 = torch.round(((cy - shift) / s - ROI / 2) / float(unit)).long()
    x0 = torch.minimum(torch.clamp(x0, min=0), lws[lvl] - side)
    y0 = torch.minimum(torch.clamp(y0, min=0), lhs[lvl] - side)
    lin = m_inv[:, :, :2] / s[:, None, None]
    trans = ((m_inv[:, :, 2] - shift[:, None]) / s[:, None]
             - float(unit) * torch.stack([x0, y0], 1).float())
    mats = torch.cat([lin, trans[:, :, None]], dim=2)
    windows = torch.stack([frame_idx.to(m_inv.device).long(), y0, x_offs[lvl] + x0], 1)
    return windows.int().contiguous(), mats.contiguous()


def roi_windows(offsets, frame_idx: torch.Tensor, m_inv: torch.Tensor, out_size: int,
                levels: int = 4):
    """Per-face ROI window of ``build_atlas``'s atlas + dst->ROI affine,
    pyramid level pre-selected.

    offsets: ``build_atlas``'s level offsets; frame_idx [M]; m_inv [M, 2, 3]
    dst->frame affines.  Returns (windows [M, 3] int32: frame, row origin,
    column origin of each face's ROI x ROI window in the atlas; mats
    [M, 2, 3] float32 dst -> window coordinates).
    """
    return _windows(offsets, frame_idx, m_inv, out_size, levels, HALO, 1)


def boxes_to_affines(bboxes: torch.Tensor, out_size: int,
                     scale_factor: float = 1.5) -> torch.Tensor:
    """dst->src affines [M, 2, 3] of square bbox-centred crops (no rotation):
    side max(w, h) * scale_factor around the box centre, insightface's
    ``face_align.transform`` for the attribute heads.  bboxes [M, 4] xyxy."""
    x1, y1, x2, y2 = bboxes.float().unbind(1)
    cx, cy = (x1 + x2) / 2.0, (y1 + y2) / 2.0
    s = torch.maximum(x2 - x1, y2 - y1) * scale_factor / out_size  # source px a crop px
    zeros = torch.zeros_like(s)
    tx = cx - s * (out_size / 2.0)
    ty = cy - s * (out_size / 2.0)
    return torch.stack([torch.stack([s, zeros, tx], 1), torch.stack([zeros, s, ty], 1)], 1)


def warp_boxes_two_pass(frames: torch.Tensor, frame_idx: torch.Tensor, bboxes: torch.Tensor,
                        out_size: int, scale_factor: float = 1.5,
                        levels: int = 4, atlas=None) -> torch.Tensor:
    """Square bbox-centred crops (the attribute heads' inputs) through the
    same pyramid windows and K3: [M, out_size, out_size, C] float32.
    atlas: ``build_atlas(frames, levels)``'s result, when the caller has
    built it already (one atlas for several crop sizes)."""
    m_inv = boxes_to_affines(bboxes, out_size, scale_factor)
    atlas, offsets = build_atlas(frames, levels) if atlas is None else atlas
    windows, mats = roi_windows(offsets, frame_idx, m_inv, out_size, levels)
    return warp_windows(atlas, windows, mats, out_size)


def warp_faces_two_pass(frames: torch.Tensor, frame_idx: torch.Tensor, kps: torch.Tensor,
                        out_size: int = 112, dst: torch.Tensor | None = None,
                        levels: int = 4) -> torch.Tensor:
    """Align M faces from a batch of frames.

    frames [B, H, W, C] uint8 or float (H, W divisible by 2**(levels-1));
    frame_idx [M]; kps [M, 5, 2] landmarks in frame coordinates.
    Returns [M, out_size, out_size, C] float32 crops, through K3 on the card
    (read straight from the atlas) and its plain version on the CPU.
    """
    if dst is None:
        dst = torch.from_numpy(ARCFACE_DST) * (out_size / 112.0)
    m_inv = _invert_affine(umeyama_similarity(kps, dst.to(frames.device)))
    atlas, offsets = build_atlas(frames, levels)
    windows, mats = roi_windows(offsets, frame_idx, m_inv, out_size, levels)
    return warp_windows(atlas, windows, mats, out_size)


# ---------------------------------------------------------------------------
# s2d4-packed frames [B, H/4, W/4, 16C] (channel (p*4 + q)*C + c holds raw
# pixel (4Y+p, 4X+q, c)): the pyramid atlas is built in packed layout, each
# face's window origin lies on the packed grid, and K3 reads the packed
