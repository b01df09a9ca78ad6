"""Host-side frame packing for the packed / yuv420 streaming transports.

The port's numpy copy of what the streaming path needs from the
reference's ``facerecognition_infrenceengine_tpu/native/__init__.py``
(whose C++ ``imagecodec.cc`` this module does not build or load):

- ``pack_s2d4``: [H, W, 3] u8 -> [H/4, W/4, 48] s2d4 (channel (p*4+q)*3+c
  holds pixel (4Y+p, 4X+q, c)), the fused stem's input layout;
- ``pack_yuv420_s2d4``: [H, W, 3] RGB u8 -> [H/4, W/4, 24] 4:2:0 YUV in
  s2d4 layout (ch 0-15 Y of phase p*4+q, ch 16-19 U and 20-23 V of chroma
  block p2*2+q2), BT.601 full range, bit-identical to the C++
  ``fre_pack_yuv420_s2d4`` (same f32 operations in the same order);
- ``letterbox_yuv420_s2d4`` at letterbox scale 1.0 (no resize).
"""

from __future__ import annotations

import numpy as np


def _check_img(img: np.ndarray) -> np.ndarray:
    img = np.ascontiguousarray(img)
    if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"expected HxWx3 uint8 RGB, got {img.dtype} {img.shape}")
    h, w = img.shape[:2]
    if h % 4 or w % 4:
        raise ValueError(f"H, W must be multiples of 4, got {h}x{w}")
    return img


def pack_s2d4(img: np.ndarray) -> np.ndarray:
    """[H, W, 3] u8 canvas -> [H/4, W/4, 48] s2d4-packed."""
    img = _check_img(img)
    h, w = img.shape[:2]
    return np.ascontiguousarray(
        img.reshape(h // 4, 4, w // 4, 4, 3).transpose(0, 2, 1, 3, 4)
    ).reshape(h // 4, w // 4, 48)


def pack_yuv420_s2d4(img: np.ndarray) -> np.ndarray:
    """[H, W, 3] RGB u8 -> [H/4, W/4, 24] packed 4:2:0 YUV (s2d4 layout),
    1.5 B/px: half the host -> device bytes of RGB."""
    img = _check_img(img)
    h, w = img.shape[:2]
    f = img.astype(np.float32)
    y = f[..., 0] * np.float32(0.299) + f[..., 1] * np.float32(0.587) \
        + f[..., 2] * np.float32(0.114)
    yp = np.floor(y + np.float32(0.5)).astype(np.uint8)
    # 2x2 chroma block means: sums of four u8 values are exact in f32 in any
    # order, and * 0.25 is exact (explicit sums: ~6x faster than .mean)
    q = f.reshape(h // 2, 2, w // 2, 2, 3)
    blk = ((q[:, 0, :, 0] + q[:, 0, :, 1]) + (q[:, 1, :, 0] + q[:, 1, :, 1])) * np.float32(0.25)
    u = (np.float32(-0.168736) * blk[..., 0] - np.float32(0.331264) * blk[..., 1]
         + np.float32(0.5) * blk[..., 2] + np.float32(128.0))
    v = (np.float32(0.5) * blk[..., 0] - np.float32(0.418688) * blk[..., 1]
         - np.float32(0.081312) * blk[..., 2] + np.float32(128.0))
    u8 = np.floor(np.clip(u, 0, 255) + np.float32(0.5)).astype(np.uint8)
    v8 = np.floor(np.clip(v, 0, 255) + np.float32(0.5)).astype(np.uint8)
    out = np.empty((h // 4, w // 4, 24), np.uint8)
    out[..., :16] = yp.reshape(h // 4, 4, w // 4, 4).transpose(0, 2, 1, 3).reshape(
        h // 4, w // 4, 16)
    out[..., 16:20] = u8.reshape(h // 4, 2, w // 4, 2).transpose(0, 2, 1, 3).reshape(
        h // 4, w // 4, 4)
    out[..., 20:24] = v8.reshape(h // 4, 2, w // 4, 2).transpose(0, 2, 1, 3).reshape(
        h // 4, w // 4, 4)
    return out


def letterbox_yuv420_s2d4(img: np.ndarray, oh: int, ow: int):
    """Letterbox an RGB frame onto a zero (oh, ow) canvas, top-left, and
    pack it as yuv420 s2d4 [oh/4, ow/4, 24] -> (packed, scale).

    Only scale 1.0 (the frame fits unscaled on its limiting side) is
    ported; the resizing letterbox is ROADMAP Queue 1 item 7."""
    img = np.asarray(img)
    if oh % 4 or ow % 4:
        raise ValueError(f"canvas must be a multiple of 4, got {oh}x{ow}")
    h, w = img.shape[:2]
    scale = min(oh / h, ow / w)
    if scale != 1.0:
        raise NotImplementedError(
            f"a {h}x{w} frame needs a resize onto the {oh}x{ow} canvas (scale "
            f"{scale:.4f}); the resizing letterbox is ROADMAP Queue 1 item 7")
    canvas = np.zeros((oh, ow, 3), np.uint8)
    canvas[:h, :w] = img
    return pack_yuv420_s2d4(canvas), scale
