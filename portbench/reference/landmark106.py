# Frozen copy of facerecognition_infrenceengine_tpu_torch/models/landmark106.py at commit 5fe48e2 (imports made local); do not edit.
"""106-point 2D landmark head (the buffalo_l ``2d106det`` role).

The torch form of ``facerecognition_infrenceengine_tpu/models/landmark106.py``:
five ConvBNPReLU stages (24/48/96/144/192 channels, stride 2 each) over the
192x192 bbox-centred crop, a spatial mean and Dense(212) -> [B, 106, 2]
landmarks in crop coordinates normalized to [-1, 1] (insightface's
convention).  Inputs are NHWC in [-1, 1] (``genderage.preprocess``).
"""

from __future__ import annotations

import torch
from torch import nn

from .layers import ConvBNPReLU

INPUT_SIZE = 192
WIDTHS = (24, 48, 96, 144, 192)


class Landmark106(nn.Module):
    def __init__(self):
        super().__init__()
        in_ch = 3
        for k, width in enumerate(WIDTHS):
            setattr(self, f"ConvBNPReLU_{k}", ConvBNPReLU(in_ch, width, 3, 2))
            in_ch = width
        self.Dense_0 = nn.Linear(in_ch, 212)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x [B, 192, 192, 3] -> [B, 106, 2] float32."""
        x = x.permute(0, 3, 1, 2).to(self.Dense_0.weight.dtype)
        for k in range(len(WIDTHS)):
            x = getattr(self, f"ConvBNPReLU_{k}")(x)
        return self.Dense_0(x.mean(dim=(2, 3))).float().reshape(x.shape[0], 106, 2)
