"""Space-to-depth re-indexing of 3x3 conv kernels (the packed SCRFD stem).

The torch copy of ``_select_tensor`` and ``pack_kernel`` from
``facerecognition_infrenceengine_tpu/models/packed_stem.py``.  The port's
fused stem (K4, ``ops/stem_kernel.py``) evaluates the stem as a direct
convolution and does not use packed kernels; the tests re-pack the port's
BN-folded 3x3 weights with these functions and hold them to the reference's
packed weights exactly.

A packed conv keeps 2x2 spatial blocks in the channel dim.  Packed output
row I holds original rows 2I+oi; packed input row P holds original rows
2P+pi.  A packed 3x3 conv at stride s reads P = s*I + kh - 1, so the
original tap is dy = 2*kh + pi - s*oi - 1, and the packed kernel entry
[kh, kw, (pi, pj, ci), (oi, oj, co)] equals W[dy, dx, ci, co] when
0 <= dy, dx <= 2, else 0.
"""

from __future__ import annotations

import numpy as np
import torch


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
