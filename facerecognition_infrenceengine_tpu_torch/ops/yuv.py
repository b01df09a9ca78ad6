"""Device-side inverse of the host's packed-YUV420 transport encoding.

The torch form of ``facerecognition_infrenceengine_tpu/ops/yuv.py``.  The
host packs each frame as 4:2:0 YUV in the s2d4 layout (``native.
pack_yuv420_s2d4``, 1.5 B/px, half of RGB's 3); on the device one constant
[24, 48] mix per packed pixel turns it back into packed RGB: output phase
(p, q) channel c combines the Y channel p*4+q with the U/V channels of its
2x2 chroma block (16/20 + (p//2)*2 + q//2).  BT.601 full range, the inverse
of the host's coefficients; rgb = clip(floor(yuv24 @ K + bias + 0.5)).
"""

from __future__ import annotations

import functools

import numpy as np
import torch


@functools.lru_cache(maxsize=1)
def _mix_constants() -> tuple:
    """(K [24, 48], bias [48]) float32 numpy."""
    k = np.zeros((24, 48), np.float32)
    b = np.zeros((48,), np.float32)
    cu = (0.0, -0.344136, 1.772)     # U coefficient per RGB channel
    cv = (1.402, -0.714136, 0.0)     # V coefficient per RGB channel
    for p in range(4):
        for q in range(4):
            uvch = (p // 2) * 2 + (q // 2)
            for c in range(3):
                o = (p * 4 + q) * 3 + c
                k[p * 4 + q, o] = 1.0
                k[16 + uvch, o] = cu[c]
                k[20 + uvch, o] = cv[c]
                b[o] = -(cu[c] + cv[c]) * 128.0
    return k, b


@functools.lru_cache(maxsize=8)
def _mix_on(device: torch.device) -> tuple:
    """The mix constants on ``device``, uploaded once: a host->device copy
    at every call would wait for the device's queue to drain."""
    k, b = _mix_constants()
    return torch.from_numpy(k).to(device), torch.from_numpy(b).to(device)


def yuv420p4_to_rgbp4(x24: torch.Tensor) -> torch.Tensor:
    """[..., 24] packed-YUV420 u8 -> [..., 48] packed-RGB s2d4 u8, on the
    tensor's device: an f32 matmul with the constant mix (true f32 on the
    card: ``core.device.resolve_device`` turns TF32 off), + bias, then
    floor(+0.5) and a clip to 0..255."""
    k, b = _mix_on(x24.device)
    rgb = x24.float() @ k + b
    return torch.clamp(torch.floor(rgb + 0.5), 0.0, 255.0).to(torch.uint8)


def yuv420p4_to_rgb_host(pack: np.ndarray) -> np.ndarray:
    """[rows, w4, 24] packed-YUV420 u8 -> [rows*4, w4*4, 3] u8 RGB, on the
    host (numpy), with the same constants: for batches that cannot take the
    yuv device path (packs mixed with raw frames)."""
    k, b = _mix_constants()
    rows, w4 = pack.shape[:2]
    rgb48 = pack.astype(np.float32) @ k + b
    rgb48 = np.clip(np.floor(rgb48 + 0.5), 0.0, 255.0).astype(np.uint8)
    # undo s2d4: channel (p*4+q)*3+c -> pixel (r*4+p, x*4+q, c)
    return (rgb48.reshape(rows, w4, 4, 4, 3).transpose(0, 2, 1, 3, 4)
            .reshape(rows * 4, w4 * 4, 3))


def rgb_to_yuv420p4_reference(img: np.ndarray) -> np.ndarray:
    """[H, W, 3] u8 RGB -> [H/4, W/4, 24] packed-YUV420 u8: the plain numpy
    form of the host packer (``native.pack_yuv420_s2d4``), BT.601 full
    range, chroma the mean of each 2x2 block."""
    h, w = img.shape[:2]
    f = img.astype(np.float32)
    y = f[..., 0] * 0.299 + f[..., 1] * 0.587 + f[..., 2] * 0.114
    yp = np.floor(y + 0.5).astype(np.uint8)
    blk = f.reshape(h // 2, 2, w // 2, 2, 3).mean(axis=(1, 3))
    u = (-0.168736 * blk[..., 0] - 0.331264 * blk[..., 1]
         + 0.5 * blk[..., 2] + 128.0)
    v = (0.5 * blk[..., 0] - 0.418688 * blk[..., 1]
         - 0.081312 * blk[..., 2] + 128.0)
    u8 = np.floor(np.clip(u, 0, 255) + 0.5).astype(np.uint8)
    v8 = np.floor(np.clip(v, 0, 255) + 0.5).astype(np.uint8)
    out = np.empty((h // 4, w // 4, 24), np.uint8)
    out[..., :16] = yp.reshape(h // 4, 4, w // 4, 4).transpose(
        0, 2, 1, 3).reshape(h // 4, w // 4, 16)
    out[..., 16:20] = u8.reshape(h // 4, 2, w // 4, 2).transpose(
        0, 2, 1, 3).reshape(h // 4, w // 4, 4)
    out[..., 20:24] = v8.reshape(h // 4, 2, w // 4, 2).transpose(
        0, 2, 1, 3).reshape(h // 4, w // 4, 4)
    return out
