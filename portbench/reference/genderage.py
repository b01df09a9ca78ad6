# Frozen copy of facerecognition_infrenceengine_tpu_torch/models/genderage.py at commit 5fe48e2 (imports made local); do not edit.
"""Gender/age attribute head (the buffalo_l ``genderage`` role).

The torch form of ``facerecognition_infrenceengine_tpu/models/genderage.py``:
four ConvBNPReLU stages (32/64/128/256 channels, stride 2 each) over the
96x96 bbox-centred crop, a spatial mean and Dense(3) -> [B, 3] = (gender
logits x2, age / 100).  Inputs are NHWC in [-1, 1] (``preprocess``); the
module runs NCHW inside.
"""

from __future__ import annotations

import torch
from torch import nn

from .layers import ConvBNPReLU

INPUT_SIZE = 96
WIDTHS = (32, 64, 128, 256)


def preprocess(images: torch.Tensor) -> torch.Tensor:
    return (images.float() - 127.5) / 128.0


class GenderAge(nn.Module):
    def __init__(self):
        super().__init__()
        in_ch = 3
        for k, width in enumerate(WIDTHS):
            setattr(self, f"ConvBNPReLU_{k}", ConvBNPReLU(in_ch, width, 3, 2))
            in_ch = width
        self.Dense_0 = nn.Linear(in_ch, 3)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x [B, 96, 96, 3] -> [B, 3] float32."""
        x = x.permute(0, 3, 1, 2).to(self.Dense_0.weight.dtype)
        for k in range(len(WIDTHS)):
            x = getattr(self, f"ConvBNPReLU_{k}")(x)
        return self.Dense_0(x.mean(dim=(2, 3))).float()
