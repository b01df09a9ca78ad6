"""Shared torch building blocks, named after the reference's flax modules.

Submodule names (``Conv_0``, ``BatchNorm_0``, ``PReLU_0``) are the flax
auto-names, so ``models/weights.py`` maps state-dict keys to flax paths by
name.  Padding is explicit and symmetric (``kernel // 2``), as in
``facerecognition_infrenceengine_tpu/models/layers.py``.
"""

from __future__ import annotations

import torch
from torch import nn

BN_EPS = 1e-5


class ConvBN(nn.Module):
    """Conv (bias-free) -> BatchNorm (-> ReLU)."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int = 3,
                 stride: int = 1, relu: bool = False):
        super().__init__()
        self.Conv_0 = nn.Conv2d(in_ch, out_ch, kernel, stride, kernel // 2,
                                bias=False)
        self.BatchNorm_0 = nn.BatchNorm2d(out_ch, eps=BN_EPS)
        self.relu = relu

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.BatchNorm_0(self.Conv_0(x))
        return torch.relu(x) if self.relu else x
