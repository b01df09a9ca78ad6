"""Affine face warp from a per-frame pyramid atlas: ROI windows, then K3.

The torch form of ``facerecognition_infrenceengine_tpu/ops/warp2pass.py``
(raw-layout path, and the s2d4-packed path of the streaming transports).
Faces larger than the static ROI window sample from an
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
from .stem_kernel import depth_to_space4, space_to_depth4  # both: the s2d4 layout
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
                        levels: int = 4) -> torch.Tensor:
    """Square bbox-centred crops (the attribute heads' inputs) through the
    same pyramid ROI and K3: [M, out_size, out_size, C] float32."""
    m_inv = boxes_to_affines(bboxes, out_size, scale_factor)
    rois, mats = extract_rois_from_affines(frames, frame_idx, m_inv, out_size, levels)
    return warp_rois(rois, mats, out_size)


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


# ---------------------------------------------------------------------------
# s2d4-packed frames [B, H/4, W/4, 16C] (channel (p*4 + q)*C + c holds raw
# pixel (4Y+p, 4X+q, c)): the pyramid atlas is built and cut in packed layout,
# and each face's small packed ROI is unpacked to raw layout before K3.
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


def extract_rois_packed(frames_p4: torch.Tensor, frame_idx: torch.Tensor,
                        m_inv: torch.Tensor, out_size: int, levels: int = 4):
    """``extract_rois_from_affines`` on packed frames: the affines are in raw
    frame coordinates, the ROI origins are quantized to the packed grid
    (round half to even) and the per-face affine absorbs the shift.

    Returns (rois [M, ROI/4, ROI/4, 16C] in the frames' dtype, mats [M, 2, 3]
    float32 mapping dst -> level-raw ROI coordinates).
    """
    atlas, offsets = build_atlas_packed(frames_p4, levels)
    dev = frames_p4.device
    proi = ROI // 4
    x_offs = torch.tensor([o[0] for o in offsets], dtype=torch.int64, device=dev)
    lws = torch.tensor([o[1] for o in offsets], dtype=torch.int64, device=dev)
    lhs = torch.tensor([o[2] for o in offsets], dtype=torch.int64, device=dev)
    m_inv = m_inv.float()
    m00, m01, m02 = m_inv[:, 0, 0], m_inv[:, 0, 1], m_inv[:, 0, 2]
    m10, m11, m12 = m_inv[:, 1, 0], m_inv[:, 1, 1], m_inv[:, 1, 2]
    lvl = pyramid_level(m_inv, out_size, levels, halo=HALO_P)
    half = out_size / 2
    cx = m00 * half + m01 * half + m02
    cy = m10 * half + m11 * half + m12
    s = torch.exp2(lvl.float())
    shift = (s - 1.0) / 2.0
    # |4 * x0p - ideal origin| <= 2 raw pixels, inside HALO_P
    x0p = torch.clamp(torch.round(((cx - shift) / s - ROI / 2) / 4.0).long(), min=0)
    x0p = torch.minimum(x0p, lws[lvl] - proi)
    y0p = torch.clamp(torch.round(((cy - shift) / s - ROI / 2) / 4.0).long(), min=0)
    y0p = torch.minimum(y0p, lhs[lvl] - proi)
    ar = torch.arange(proi, device=dev)
    rows = (y0p[:, None] + ar)[:, :, None]
    cols = (x_offs[lvl] + x0p)[:, None, None] + ar[None, None, :]
    rois = atlas[frame_idx.long()[:, None, None], rows, cols]
    lin = m_inv[:, :, :2] / s[:, None, None]
    trans = ((m_inv[:, :, 2] - shift[:, None]) / s[:, None]
             - 4.0 * torch.stack([x0p, y0p], 1).float())
    mats = torch.cat([lin, trans[:, :, None]], dim=2)
    return rois.contiguous(), mats.contiguous()


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
    stay in raw frame coordinates.  Each face's packed ROI (48 x 48 packed
    pixels) is unpacked to the 192 x 192 raw ROI and warped by K3, the
    reference's ``_warp_one_from_packed_roi``.

    Returns [M, out_size, out_size, C] float32 crops.
    """
    if dst is None:
        dst = torch.from_numpy(ARCFACE_DST) * (out_size / 112.0)
    m_inv = _invert_affine(umeyama_similarity(kps, dst.to(frames_p4.device)))
    rois, mats = extract_rois_packed(frames_p4, frame_idx, m_inv, out_size, levels)
    return warp_rois(unpack_roi4(rois).float().contiguous(), mats, out_size)
