# Frozen copy of facerecognition_infrenceengine_tpu_torch/ops/boxes.py at commit 5fe48e2 (imports made local); do not edit.
"""Box/keypoint decode and IoU, batched over leading dimensions.

Regression targets are distances from the anchor center in stride units;
callers multiply by the stride first (the SCRFD convention).
"""

from __future__ import annotations

import torch


def distance2bbox(centers: torch.Tensor, distances: torch.Tensor) -> torch.Tensor:
    """Centers [N, 2] + distances [..., N, 4] (l, t, r, b) -> boxes [..., N, 4] xyxy."""
    x1 = centers[..., 0] - distances[..., 0]
    y1 = centers[..., 1] - distances[..., 1]
    x2 = centers[..., 0] + distances[..., 2]
    y2 = centers[..., 1] + distances[..., 3]
    return torch.stack([x1, y1, x2, y2], dim=-1)


def distance2kps(centers: torch.Tensor, distances: torch.Tensor) -> torch.Tensor:
    """Centers [N, 2] + offsets [..., N, 2K] -> keypoints [..., N, K, 2]."""
    k = distances.shape[-1] // 2
    d = distances.reshape(*distances.shape[:-1], k, 2)
    return d + centers[..., None, :]


def box_area(boxes: torch.Tensor, offset: float = 0.0) -> torch.Tensor:
    w = torch.clamp(boxes[..., 2] - boxes[..., 0] + offset, min=0.0)
    h = torch.clamp(boxes[..., 3] - boxes[..., 1] + offset, min=0.0)
    return w * h


def pairwise_iou(a: torch.Tensor, b: torch.Tensor, offset: float = 0.0) -> torch.Tensor:
    """IoU [..., N, M] for xyxy boxes a [..., N, 4], b [..., M, 4].

    ``offset=1.0`` is insightface's integer-pixel convention
    ((x2-x1+1)*(y2-y1+1)), which detection NMS uses for decision parity.
    """
    lt = torch.maximum(a[..., :, None, :2], b[..., None, :, :2])
    rb = torch.minimum(a[..., :, None, 2:], b[..., None, :, 2:])
    wh = torch.clamp(rb - lt + offset, min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    union = box_area(a, offset)[..., :, None] + box_area(b, offset)[..., None, :] - inter
    return inter / torch.clamp(union, min=1e-9)
