# Frozen copy of facerecognition_infrenceengine_tpu_torch/native/plain.py at commit 5fe48e2; do not edit.
"""The plain numpy versions of the host codec (``csrc/imagecodec.cc``).

Each function repeats the C++ float32 arithmetic step by step, so its bytes
equal the compiled library's (built with ``-ffp-contract=off``: every
multiply and add rounds on its own, as numpy's do).  The tests and
``chip_smoke.py`` hold the library against them; no entry point calls
them.

- ``resize_bilinear_plain``: OpenCV's pixel-centre alignment,
  ``src = (x + 0.5f) * (w / ow) - 0.5f`` clamped at 0, the left tap clamped
  to ``w - 2`` (so the last output pixels of an upscale extrapolate: weights
  beyond 1), ``top * (1 - wy) + bot * wy`` and ``uint8(v + 0.5f)`` -- a
  truncation to int32 whose low byte is kept, as x86's ``cvttss2si`` does
  for the values the extrapolation takes outside 0..255;
- ``letterbox_plain``: scale, ``nh``, ``nw`` in float32, the frame resized
  into the top-left of a zero canvas;
- ``pack_s2d4_plain``: [H, W, 3] u8 -> [H/4, W/4, 48] s2d4 (channel
  (p*4+q)*3+c holds pixel (4Y+p, 4X+q, c)), the fused stem's input layout;
- ``pack_yuv420_s2d4_plain``: [H, W, 3] RGB u8 -> [H/4, W/4, 24] 4:2:0 YUV
  in s2d4 layout (ch 0-15 Y of phase p*4+q, ch 16-19 U and 20-23 V of
  chroma block p2*2+q2), BT.601 full range;
- ``letterbox_yuv420_s2d4_plain``: the letterbox, then the yuv420 pack.
"""

from __future__ import annotations

import numpy as np

_F32 = np.float32


def _check_img(img: np.ndarray, multiple: int = 1) -> np.ndarray:
    img = np.ascontiguousarray(img)
    if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"expected HxWx3 uint8 RGB, got {img.dtype} {img.shape}")
    h, w = img.shape[:2]
    if h % multiple or w % multiple:
        raise ValueError(f"H, W must be multiples of {multiple}, got {h}x{w}")
    return img


def _taps(n_in: int, n_out: int):
    """(left tap, right tap, weight of the right tap) per output index, in
    the C++ float32 arithmetic."""
    s = _F32(n_in) / _F32(n_out)
    f = (np.arange(n_out, dtype=_F32) + _F32(0.5)) * s - _F32(0.5)
    f = np.maximum(f, _F32(0))
    i0 = f.astype(np.int32)
    i0 = np.where(i0 > n_in - 2, max(n_in - 2, 0), i0)
    wgt = f - i0.astype(_F32)
    if n_in == 1:
        i0 = np.zeros_like(i0)
        wgt = np.zeros_like(wgt)
    return i0, (i0 if n_in == 1 else i0 + 1), wgt


def resize_bilinear_plain(img: np.ndarray, oh: int, ow: int) -> np.ndarray:
    """``fre_resize_bilinear``: [h, w, 3] u8 -> [oh, ow, 3] u8."""
    img = _check_img(img)
    h, w = img.shape[:2]
    y0, y1, wy = _taps(h, oh)
    x0, x1, wx = _taps(w, ow)
    a = img.astype(_F32)
    wx = wx[None, :, None]
    wy = wy[:, None, None]
    r0, r1 = a[y0], a[y1]
    top = r0[:, x0] * (_F32(1) - wx) + r0[:, x1] * wx
    bot = r1[:, x0] * (_F32(1) - wx) + r1[:, x1] * wx
    v = top * (_F32(1) - wy) + bot * wy
    return (v + _F32(0.5)).astype(np.int32).astype(np.uint8)


def letterbox_geometry(h: int, w: int, oh: int, ow: int):
    """``fre_letterbox``'s (scale, nh, nw), computed in float32 as the C++
    does; scale is a float32 (1/3 is 0.33333334)."""
    sh, sw = _F32(oh) / _F32(h), _F32(ow) / _F32(w)
    scale = sh if sh < sw else sw
    nh = min(int(_F32(h) * scale + _F32(0.5)), oh)
    nw = min(int(_F32(w) * scale + _F32(0.5)), ow)
    return scale, nh, nw


def letterbox_plain(img: np.ndarray, oh: int, ow: int):
    """``fre_letterbox``: the frame resized into the top-left of a zero
    (oh, ow) canvas -> (canvas, scale as a Python float of the f32)."""
    img = _check_img(img)
    scale, nh, nw = letterbox_geometry(img.shape[0], img.shape[1], oh, ow)
    canvas = np.zeros((oh, ow, 3), np.uint8)
    canvas[:nh, :nw] = resize_bilinear_plain(img, nh, nw)
    return canvas, float(scale)


def pack_s2d4_plain(img: np.ndarray) -> np.ndarray:
    """[H, W, 3] u8 canvas -> [H/4, W/4, 48] s2d4-packed."""
    img = _check_img(img, 4)
    h, w = img.shape[:2]
    return np.ascontiguousarray(
        img.reshape(h // 4, 4, w // 4, 4, 3).transpose(0, 2, 1, 3, 4)
    ).reshape(h // 4, w // 4, 48)


def pack_yuv420_s2d4_plain(img: np.ndarray) -> np.ndarray:
    """[H, W, 3] RGB u8 -> [H/4, W/4, 24] packed 4:2:0 YUV (s2d4 layout),
    1.5 B/px: half the host -> device bytes of RGB."""
    img = _check_img(img, 4)
    h, w = img.shape[:2]
    f = img.astype(_F32)
    y = f[..., 0] * _F32(0.299) + f[..., 1] * _F32(0.587) + f[..., 2] * _F32(0.114)
    yp = np.floor(y + _F32(0.5)).astype(np.uint8)
    # 2x2 chroma block means: sums of four u8 values are exact in f32 in any
    # order, and * 0.25 is exact (explicit sums: ~6x faster than .mean)
    q = f.reshape(h // 2, 2, w // 2, 2, 3)
    blk = ((q[:, 0, :, 0] + q[:, 0, :, 1]) + (q[:, 1, :, 0] + q[:, 1, :, 1])) * _F32(0.25)
    u = (_F32(-0.168736) * blk[..., 0] - _F32(0.331264) * blk[..., 1]
         + _F32(0.5) * blk[..., 2] + _F32(128.0))
    v = (_F32(0.5) * blk[..., 0] - _F32(0.418688) * blk[..., 1]
         - _F32(0.081312) * blk[..., 2] + _F32(128.0))
    u8 = np.floor(np.clip(u, 0, 255) + _F32(0.5)).astype(np.uint8)
    v8 = np.floor(np.clip(v, 0, 255) + _F32(0.5)).astype(np.uint8)
    out = np.empty((h // 4, w // 4, 24), np.uint8)
    out[..., :16] = yp.reshape(h // 4, 4, w // 4, 4).transpose(0, 2, 1, 3).reshape(
        h // 4, w // 4, 16)
    out[..., 16:20] = u8.reshape(h // 4, 2, w // 4, 2).transpose(0, 2, 1, 3).reshape(
        h // 4, w // 4, 4)
    out[..., 20:24] = v8.reshape(h // 4, 2, w // 4, 2).transpose(0, 2, 1, 3).reshape(
        h // 4, w // 4, 4)
    return out


def letterbox_yuv420_s2d4_plain(img: np.ndarray, oh: int, ow: int):
    """``fre_letterbox_yuv420_s2d4``: letterbox onto a zero (oh, ow) canvas,
    then the yuv420 s2d4 pack -> (packed [oh/4, ow/4, 24], scale)."""
    if oh % 4 or ow % 4:
        raise ValueError(f"canvas must be a multiple of 4, got {oh}x{ow}")
    canvas, scale = letterbox_plain(img, oh, ow)
    return pack_yuv420_s2d4_plain(canvas), scale
