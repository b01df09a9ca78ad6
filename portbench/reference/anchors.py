# Frozen copy of facerecognition_infrenceengine_tpu_torch/ops/anchors.py at commit 5fe48e2 (imports made local); do not edit.
"""Anchor centers for the SCRFD head (public SCRFD decode convention).

Per stride ``s`` a (H/s, W/s) grid of centers at ``(x*s, y*s)``, each
repeated ``num_anchors`` times, row-major over (y, x): the row order of
the flattened head outputs.
"""

from __future__ import annotations

import numpy as np
import torch


def anchor_centers(height: int, width: int, stride: int, num_anchors: int = 2) -> np.ndarray:
    """[H/s * W/s * num_anchors, 2] float32 (x, y) centers in input pixels."""
    hs, ws = height // stride, width // stride
    xs, ys = np.meshgrid(np.arange(ws), np.arange(hs))
    centers = np.stack([xs, ys], axis=-1).astype(np.float32) * stride
    centers = centers.reshape(-1, 2)
    if num_anchors > 1:
        centers = np.repeat(centers, num_anchors, axis=0)
    return centers


def all_anchor_centers(height: int, width: int, strides=(8, 16, 32),
                       num_anchors: int = 2, device=None) -> torch.Tensor:
    """Concatenated centers across strides, as a tensor on ``device``."""
    parts = [anchor_centers(height, width, s, num_anchors) for s in strides]
    return torch.from_numpy(np.concatenate(parts, axis=0)).to(device)
