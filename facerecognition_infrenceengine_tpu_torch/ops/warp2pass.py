"""Affine face warp from a per-frame pyramid atlas: ROI windows, then K3.

The torch form of ``facerecognition_infrenceengine_tpu/ops/warp2pass.py``
(raw-layout path, and the s2d4-packed path of the streaming transports).
Faces larger than the static ROI window sample from an
average-pool pyramid level chosen per face, so every face is one
[ROI, ROI, C] window of the atlas plus a dst->ROI affine
(``roi_windows``), and the warp itself (``ops/warp_kernel.warp_windows``,
K3) reads each window straight from the atlas: no ROI tensor is formed on
the card.  ``extract_rois*`` still cut the ROIs out, for the tests and
for comparison.

The pyramid is kept as one atlas per frame, levels side by side: uint8
input gives a uint8 atlas whose levels are integer sums rounded half up
(level 0 is the input, bit-exact); float input keeps a float32 atlas.
"""

from __future__ import annotations

import functools

import torch

from .align import ARCFACE_DST, _invert_affine, umeyama_similarity
from .stem_kernel import depth_to_space4, space_to_depth4  # both: the s2d4 layout
from .warp_kernel import ROI, gather_windows, warp_windows  # ROI: each face's window side

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


def extract_rois_from_affines(frames: torch.Tensor, frame_idx: torch.Tensor,
                              m_inv: torch.Tensor, out_size: int, levels: int = 4):
    """Per-face ROI window + dst->ROI affine, pyramid level pre-selected.

    frames [B, H, W, C]; frame_idx [M]; m_inv [M, 2, 3] dst->frame affines.
    Returns (rois [M, ROI, ROI, C] float32, mats [M, 2, 3] float32).
    """
    atlas, offsets = build_atlas(frames, levels)
    windows, mats = roi_windows(offsets, frame_idx, m_inv, out_size, levels)
    return gather_windows(atlas, windows, ROI).float().contiguous(), mats


def extract_rois(frames: torch.Tensor, frame_idx: torch.Tensor, kps: torch.Tensor,
                 out_size: int = 112, dst: torch.Tensor | None = None, levels: int = 4):
    """ROI windows + affines from landmarks [M, 5, 2] in frame coordinates."""
    if dst is None:
        dst = torch.from_numpy(ARCFACE_DST) * (out_size / 112.0)
    m_inv = _invert_affine(umeyama_similarity(kps, dst.to(frames.device)))
    return extract_rois_from_affines(frames, frame_idx, m_inv, out_size, levels)


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
# window as it lies.
# ---------------------------------------------------------------------------

HALO_P = 6.0  # bilinear tap (1) + packed ROI-origin rounding (2) + slack


def _edge_pad_packed(p: torch.Tensor, pad_h: int, pad_w: int) -> torch.Tensor:
    """Border-replicate a packed image [B, Hp, Wp, 16C] on the bottom/right
    in raw-pixel terms: every phase of a pad pixel repeats the last raw
    column (phase q = 3 of the last packed column), likewise rows (p = 3)."""
    b, hp, wp, c16 = p.shape
    c = c16 // 16
    if pad_w:
        last = p[:, :, -1:].reshape(b, hp, 1, 4, 4, c)[:, :, :, :, 3:4]
        rep = last.expand(b, hp, 1, 4, 4, c).reshape(b, hp, 1, c16)
        p = torch.cat([p, rep.expand(b, hp, pad_w, c16)], dim=2)
    if pad_h:
        wp2 = p.shape[2]
        last = p[:, -1:].reshape(b, 1, wp2, 4, 4, c)[:, :, :, 3:4]
        rep = last.expand(b, 1, wp2, 4, 4, c).reshape(b, 1, wp2, c16)
        p = torch.cat([p, rep.expand(b, pad_h, wp2, c16)], dim=1)
    return p


def _pool2_packed(x: torch.Tensor) -> torch.Tensor:
    """Sum of each raw 2x2 block, packed in and packed out: output phase
    (p' = 2u + w, q' = 2v + s) of packed pixel (Y', X') sums input pixel
    (2Y' + u, 2X' + v) phases (2w + {0, 1}, 2s + {0, 1})."""
    b, h4, w4, c16 = x.shape
    c = c16 // 16
    x = x[:, : h4 // 2 * 2, : w4 // 2 * 2]
    x = x.reshape(b, h4 // 2, 2, w4 // 2, 2, 2, 2, 2, 2, c)  # Y' u X' v w a s t c
    x = x.sum(dim=(6, 8))                                     # Y' u X' v w s c
    return x.permute(0, 1, 3, 2, 5, 4, 6, 7).reshape(b, h4 // 2, w4 // 2, c16)


def build_atlas_packed(frames_p4: torch.Tensor, levels: int = 4):
    """Pyramid atlas from s2d4-packed frames, every level packed.

    uint8 frames give uint8 levels from int32 sums of the original pixels
    with one round-half-up per level: the bytes of ``build_atlas``'s levels,
    permuted into packed layout.  Float frames keep float32 levels.

    Returns (atlas [B, Ha, Wa, 16C], offsets: list of (x_off, lw, lh) in
    packed units).
    """
    proi = ROI // 4
    pyr = [frames_p4]
    if frames_p4.dtype == torch.uint8:
        acc = frames_p4.to(torch.int32)
        for lvl in range(1, levels):
            acc = _pool2_packed(acc)
            d = 4 ** lvl
            pyr.append(torch.div(acc + d // 2, d, rounding_mode="floor").to(torch.uint8))
    else:
        acc = frames_p4.float()
        for lvl in range(1, levels):
            acc = _pool2_packed(acc)
            pyr.append(acc / (4.0 ** lvl))
    h_a = max(max(p.shape[1] for p in pyr), proi)
    cols, offsets = [], []
    x_off = 0
    for p in pyr:
        _, lh, lw, _ = p.shape
        p = _edge_pad_packed(p, max(proi - lh, 0), max(proi - lw, 0))
        p = torch.nn.functional.pad(p, (0, 0, 0, 0, 0, h_a - p.shape[1]))
        cols.append(p)
        offsets.append((x_off, max(lw, proi), max(lh, proi)))
        x_off += p.shape[2]
    return torch.cat(cols, dim=2), offsets


def roi_windows_packed(offsets, frame_idx: torch.Tensor, m_inv: torch.Tensor,
                       out_size: int, levels: int = 4):
    """``roi_windows`` on ``build_atlas_packed``'s atlas: the affines are in
    raw frame coordinates, the window origins are quantized to the packed
    grid (round half to even) and the per-face affine absorbs the shift.

    Returns (windows [M, 3] int32 in packed units, mats [M, 2, 3] float32
    mapping dst -> level-raw window coordinates).
    """
    return _windows(offsets, frame_idx, m_inv, out_size, levels, HALO_P, 4)


def extract_rois_packed(frames_p4: torch.Tensor, frame_idx: torch.Tensor,
                        m_inv: torch.Tensor, out_size: int, levels: int = 4):
    """``extract_rois_from_affines`` on packed frames, through
    ``roi_windows_packed``.

    Returns (rois [M, ROI/4, ROI/4, 16C] in the frames' dtype, mats [M, 2, 3]
    float32 mapping dst -> level-raw ROI coordinates).
    """
    atlas, offsets = build_atlas_packed(frames_p4, levels)
    windows, mats = roi_windows_packed(offsets, frame_idx, m_inv, out_size, levels)
    return gather_windows(atlas, windows, ROI // 4), mats


def unpack_roi4(roi_p: torch.Tensor) -> torch.Tensor:
    """[..., PR, PR, 16C] packed ROI(s) -> [..., 4PR, 4PR, C] raw layout."""
    *lead, pr, _, c16 = roi_p.shape
    return depth_to_space4(roi_p.reshape(-1, pr, pr, c16)).reshape(*lead, 4 * pr, 4 * pr,
                                                                   c16 // 16)


def warp_faces_two_pass_packed(frames_p4: torch.Tensor, frame_idx: torch.Tensor,
                               kps: torch.Tensor, out_size: int = 112,
                               dst: torch.Tensor | None = None,
                               levels: int = 4) -> torch.Tensor:
    """``warp_faces_two_pass`` on s2d4-packed frames [B, H/4, W/4, 16C]; kps
    stay in raw frame coordinates.  K3 reads each face's packed window
    (48 x 48 packed pixels, the 192 x 192 raw ROI) straight from the packed
    atlas: the reference's ``_warp_one_from_packed_roi`` with no unpacked
    ROI in between.

    Returns [M, out_size, out_size, C] float32 crops.
    """
    if dst is None:
        dst = torch.from_numpy(ARCFACE_DST) * (out_size / 112.0)
    m_inv = _invert_affine(umeyama_similarity(kps, dst.to(frames_p4.device)))
    atlas, offsets = build_atlas_packed(frames_p4, levels)
    windows, mats = roi_windows_packed(offsets, frame_idx, m_inv, out_size, levels)
    return warp_windows(atlas, windows, mats, out_size, packed=True)
