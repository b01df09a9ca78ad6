"""Space-to-depth ("packed") evaluation of the SCRFD deep stem as plain convs.

The torch form of ``facerecognition_infrenceengine_tpu/models/packed_stem.py``:
the opt-in ``EngineConfig.packed_stem`` (raw frames) and
``packed_stem_impl="xla"`` (s2d4-packed frames) stems.  They evaluate the
same stem weights with every activation keeping 2x2 spatial blocks in the
channel dim ([B, 320, 320, 28] -> [B, 160, 160, 112] at 640x640); the packed
kernels are exact linear re-indexings of the 3x3 kernels with the inference
BatchNorm folded in, computed once at engine build.  The convs are
``F.conv2d`` (cuDNN on the card); the fused hand-written stem is K4
(``ops/stem_kernel.py``).  The reference measured both forms slower in situ
than its compiler's own stem on a TPU; the port's times on the H100 are in
PERF.md.

Kernel re-indexing (rows; columns alike): packed output row I holds
original rows 2I+oi (oi in {0,1}); packed input row P holds original rows
2P+pi.  A packed 3x3 conv at stride s reads P = s*I + kh - 1, so the
original tap is dy = 2*kh + pi - s*oi - 1, and the packed kernel entry
[kh, kw, (pi, pj, ci), (oi, oj, co)] equals W[dy, dx, ci, co] when
0 <= dy, dx <= 2, else 0.  Out-of-range taps map to zeroed entries or to
zero-padded packed rows, so zero padding matches.

stem1 runs straight on the unpacked [B, H, W, 3] input as one 5x5 stride-4
conv padded (1, 0) (``pack_stem1_direct``), or on s2d4 frames as a 2x2
stride-1 conv padded (1, 0) (``ops/stem_kernel.pack_stem1_4to2``); stem2
and stem3 are packed 3x3 convs; the 3x3/2 max-pool runs separably on the
packed tensor and emits the ordinary [B, H/4, W/4, 2*stem_width] stem output
that ``SCRFD.forward(stem_out=)`` takes.  Kernels are HWIO, as the
reference's; the asymmetric (1, 0) padding is an explicit ``F.pad``.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.stem_kernel import pack_stem1_4to2, precompute_fused_stem


def space_to_depth(x: torch.Tensor) -> torch.Tensor:
    """[B, H, W, C] -> [B, H/2, W/2, 4C], channel = (h2*2 + w2)*C + c."""
    b, h, w, c = x.shape
    x = x.reshape(b, h // 2, 2, w // 2, 2, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, h // 2, w // 2, 4 * c)


def _select_tensor(stride: int) -> np.ndarray:
    """S[k, p, o, d] = 1 iff packed tap k with input phase p contributes
    original tap d to output phase o (one spatial axis)."""
    s = np.zeros((3, 2, 2, 3), np.float32)
    for k in range(3):
        for p in range(2):
            for o in range(2):
                d = 2 * k + p - stride * o - 1
                if 0 <= d <= 2:
                    s[k, p, o, d] = 1.0
    return s


def pack_kernel(w: torch.Tensor, stride: int) -> torch.Tensor:
    """[3, 3, Ci, Co] (HWIO) conv kernel -> packed [3, 3, 4Ci, 4Co]
    equivalent.  Each packed entry is one original weight or zero, so the
    einsum against the 0/1 selection tensors is exact."""
    ci, co = w.shape[2], w.shape[3]
    s = torch.from_numpy(_select_tensor(stride)).to(w.device, w.dtype)
    wp = torch.einsum("apod,bqre,decf->abpqcorf", s, s, w)
    return wp.reshape(3, 3, 4 * ci, 4 * co)


def pack_stem1_direct(w: torch.Tensor) -> torch.Tensor:
    """stem1 [3, 3, Ci, Co] (stride 2, HWIO) -> direct packed [5, 5, Ci, 4Co]:
    packed output pixel I, phase oi holds original stride-2 output row
    2I+oi, which reads original rows 4I + 2*oi + dy - 1 (dy in 0..2): a
    5-row window from 4I-1, so one 5x5 stride-4 conv padded (1, 0) with tap
    u = 2*oi + dy."""
    ci, co = w.shape[2], w.shape[3]
    w_np = w.detach().float().cpu().numpy()
    wd = np.zeros((5, 5, ci, 2, 2, co), np.float32)
    for oi in range(2):
        for oj in range(2):
            for dy in range(3):
                for dx in range(3):
                    wd[2 * oi + dy, 2 * oj + dx, :, oi, oj, :] = w_np[dy, dx]
    return torch.from_numpy(wd.reshape(5, 5, ci, 4 * co)).to(w.device, w.dtype)


def _conv_nhwc(x: torch.Tensor, w: torch.Tensor, stride: int, pad) -> torch.Tensor:
    """NHWC conv with an HWIO kernel; ``pad`` is (top/left, bottom/right)."""
    xin = x.permute(0, 3, 1, 2)
    if pad != (0, 0):
        xin = F.pad(xin, (pad[0], pad[1], pad[0], pad[1]))
    return F.conv2d(xin, w.permute(3, 2, 0, 1), stride=stride).permute(0, 2, 3, 1)


def _packed_maxpool_3x3s2(x_packed: torch.Tensor, c: int) -> torch.Tensor:
    """3x3/2 max-pool (pad 1) over the original grid, input packed.

    Separable: the original row window {2t-1, 2t, 2t+1} is phase 1 of packed
    row t-1 and phases 0, 1 of packed row t; then the same on columns.
    x_packed [B, H2, W2, 4C] holds the original [B, 2H2, 2W2, C]; returns
    [B, H2, W2, C]."""
    b, h2, w2, _ = x_packed.shape
    neg = float("-inf")
    ph = x_packed.reshape(b, h2, w2, 2, 2 * c)  # [.., pi, (pj c)]
    ph1_up = torch.cat([x_packed.new_full((b, 1, w2, 2 * c), neg), ph[:, :-1, :, 1]], dim=1)
    rows = torch.maximum(torch.maximum(ph[:, :, :, 0], ph[:, :, :, 1]), ph1_up)
    pw = rows.reshape(b, h2, w2, 2, c)
    pw1_left = torch.cat([x_packed.new_full((b, h2, 1, c), neg), pw[:, :, :-1, 1]], dim=2)
    return torch.maximum(torch.maximum(pw[:, :, :, 0], pw[:, :, :, 1]), pw1_left)


def _precompute(detector, stem1_pack, dtype) -> dict:
    """The reference's fold (inv = scale / sqrt(var + eps), w * inv,
    beta - mean * inv, float32 in numpy: ``precompute_fused_stem``), then
    stem1 packed by ``stem1_pack``, stem2 / stem3 by ``pack_kernel``, and the
    bias tiled 4x to the packed channel layout."""
    folded = precompute_fused_stem(detector, torch.float32)
    ws = [stem1_pack(folded["w1"]), pack_kernel(folded["w2"], 1), pack_kernel(folded["w3"], 1)]
    bs = [folded[f"b{i}"].repeat(4) for i in (1, 2, 3)]
    return {"w": [w.to(dtype) for w in ws], "b": [b.to(dtype) for b in bs]}


@torch.no_grad()
def precompute_packed_stem(detector, dtype=torch.float32) -> dict:
    """BN-folded packed stem kernels from a float32 SCRFD module, once, at
    engine build: {"w": [wp1 [5, 5, 3, 4sw], wp2, wp3 [3, 3, 4Ci, 4Co]],
    "b": [b1, b2, b3]} in ``dtype``."""
    return _precompute(detector, pack_stem1_direct, dtype)


@torch.no_grad()
def precompute_packed_stem_s2d4(detector, dtype=torch.float32) -> dict:
    """The kernels of :func:`packed_stem_forward_s2d4`: the same fold, stem1
    packed 4x4-in / 2x2-out ([2, 2, 48, 4sw], ``pack_stem1_4to2``)."""
    return _precompute(detector, pack_stem1_4to2, dtype)


def _stem23_and_pool(x: torch.Tensor, packed: dict, stem_width: int, dtype) -> torch.Tensor:
    x = torch.relu(x + packed["b"][0].to(dtype))
    for i in (1, 2):
        x = _conv_nhwc(x, packed["w"][i].to(dtype), 1, (1, 1))
        x = torch.relu(x + packed["b"][i].to(dtype))
    return _packed_maxpool_3x3s2(x, 2 * stem_width)


def packed_stem_forward(x: torch.Tensor, packed: dict, stem_width: int,
                        dtype=torch.float32) -> torch.Tensor:
    """The detector's stem (stem1/2/3 + max-pool) evaluated packed.

    x [B, H, W, 3] preprocessed (H, W multiples of 4); ``packed`` from
    :func:`precompute_packed_stem`.  Returns [B, H/4, W/4, 2*stem_width] in
    ``dtype``, the unpacked stem's output up to float summation order."""
    x = _conv_nhwc(x.to(dtype), packed["w"][0].to(dtype), 4, (1, 0))
    return _stem23_and_pool(x, packed, stem_width, dtype)


def packed_stem_forward_s2d4(x48: torch.Tensor, packed: dict, stem_width: int,
                             dtype=torch.float32) -> torch.Tensor:
    """The stem from s2d4-packed uint8 frames [B, H/4, W/4, 48] (channel
    (p*4 + q)*3 + c, ``ops/stem_kernel.space_to_depth4``), as three plain
    convs: stem1 is the 3x3 stride-2 conv seen through the 4x4-packed input
    and a 2x2-packed output, a 2x2 stride-1 conv whose (1, 0) zero pad is
    stem1's own pad 1; stem2 / stem3 and the max-pool as in
    :func:`packed_stem_forward`.  ``packed`` from
    :func:`precompute_packed_stem_s2d4`.  Returns
    [B, H/4, W/4, 2*stem_width] in ``dtype``."""
    x = (x48.to(dtype) - 127.5) * (1.0 / 128.0)
    x = _conv_nhwc(x, packed["w"][0].to(dtype), 1, (1, 0))
    return _stem23_and_pool(x, packed, stem_width, dtype)
