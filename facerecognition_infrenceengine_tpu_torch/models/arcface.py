"""ArcFace IResNet embedder (the buffalo_l ``w600k_r50`` equivalent).

The torch form of ``facerecognition_infrenceengine_tpu/models/arcface.py``:
BN-first basic blocks with per-channel PReLU, stride 2 at each stage entry
(112 -> 56 -> 28 -> 14 -> 7) with a 1x1 conv + BN shortcut, and a
BN -> flatten -> Dense(512) -> BN feature head.  Public inputs are NHWC;
the module runs NCHW inside.  The Dense flattens NCHW (channel-major), so
``models/weights.py`` permutes the flax kernel's NHWC rows.

Preprocessing (insightface): RGB, (x - 127.5) / 127.5.  Embeddings are not
normalized here; callers L2-normalize.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from .layers import BN_EPS


class IBasicBlock(nn.Module):
    def __init__(self, in_ch: int, planes: int, stride: int = 1):
        super().__init__()
        self.BatchNorm_0 = nn.BatchNorm2d(in_ch, eps=BN_EPS)
        self.Conv_0 = nn.Conv2d(in_ch, planes, 3, 1, 1, bias=False)
        self.BatchNorm_1 = nn.BatchNorm2d(planes, eps=BN_EPS)
        self.PReLU_0 = nn.PReLU(planes)
        self.Conv_1 = nn.Conv2d(planes, planes, 3, stride, 1, bias=False)
        self.BatchNorm_2 = nn.BatchNorm2d(planes, eps=BN_EPS)
        self.shortcut = stride != 1 or in_ch != planes
        if self.shortcut:
            self.Conv_2 = nn.Conv2d(in_ch, planes, 1, stride, 0, bias=False)
            self.BatchNorm_3 = nn.BatchNorm2d(planes, eps=BN_EPS)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = self.BatchNorm_0(x)
        out = self.Conv_0(out)
        out = self.BatchNorm_1(out)
        out = self.PReLU_0(out)
        out = self.Conv_1(out)
        out = self.BatchNorm_2(out)
        sc = self.BatchNorm_3(self.Conv_2(x)) if self.shortcut else x
        return out + sc


class IResNet(nn.Module):
    """iresnet{18,50} family; default is iresnet50 (w600k_r50)."""

    def __init__(self, depths: Sequence[int] = (3, 4, 14, 3),
                 widths: Sequence[int] = (64, 128, 256, 512),
                 embed_dim: int = 512, input_size: int = 112):
        super().__init__()
        self.Conv_0 = nn.Conv2d(3, widths[0], 3, 1, 1, bias=False)
        self.BatchNorm_0 = nn.BatchNorm2d(widths[0], eps=BN_EPS)
        self.PReLU_0 = nn.PReLU(widths[0])
        blocks, in_ch = [], widths[0]
        for depth, width in zip(depths, widths):
            blocks.append(IBasicBlock(in_ch, width, 2))
            blocks += [IBasicBlock(width, width, 1) for _ in range(depth - 1)]
            in_ch = width
        self.num_blocks = len(blocks)
        for i, block in enumerate(blocks):
            self.add_module(f"IBasicBlock_{i}", block)
        self.BatchNorm_1 = nn.BatchNorm2d(widths[-1], eps=BN_EPS)
        side = input_size // 16
        self.Dense_0 = nn.Linear(widths[-1] * side * side, embed_dim)
        self.Dense_0.flatten_chw = (widths[-1], side, side)
        self.BatchNorm_2 = nn.BatchNorm1d(embed_dim, eps=BN_EPS)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: [B, 112, 112, 3] NHWC scaled to [-1, 1] -> [B, 512] float32."""
        x = x.permute(0, 3, 1, 2).to(self.Conv_0.weight.dtype)
        x = self.PReLU_0(self.BatchNorm_0(self.Conv_0(x)))
        for i in range(self.num_blocks):
            x = getattr(self, f"IBasicBlock_{i}")(x)
        x = self.BatchNorm_1(x)
        x = self.Dense_0(torch.flatten(x, 1))
        return self.BatchNorm_2(x).float()


def iresnet50() -> IResNet:
    return IResNet(depths=(3, 4, 14, 3))


def iresnet18() -> IResNet:
    return IResNet(depths=(2, 2, 2, 2))


def preprocess(images: torch.Tensor) -> torch.Tensor:
    """uint8/float RGB [B, 112, 112, 3] -> insightface convention [-1, 1]."""
    return (images.float() - 127.5) / 127.5
