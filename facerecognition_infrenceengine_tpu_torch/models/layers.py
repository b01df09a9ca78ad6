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


def cast_keep_bn_f32(module: nn.Module, device, dtype: torch.dtype,
                     memory_format=torch.contiguous_format) -> nn.Module:
    """``module.to(device, dtype, memory_format)`` except that every
    BatchNorm keeps its weight, bias and running statistics in float32.

    The reference's ``nn.BatchNorm(dtype=bf16)`` holds f32 parameters and
    statistics, computes in f32 and rounds once to the engine dtype;
    ``F.batch_norm`` with a bf16 input and f32 parameters does the same in
    one pass.  Casting the BN buffers to bf16 first would round the
    statistics before they are used.  Returns ``module``."""
    module.to(device, memory_format=memory_format)
    for sub in module.modules():
        if isinstance(sub, nn.modules.batchnorm._BatchNorm):
            continue
        for p in sub.parameters(recurse=False):
            if p.is_floating_point():
                p.data = p.data.to(dtype)
        for name, b in sub.named_buffers(recurse=False):
            if b.is_floating_point():
                setattr(sub, name, b.to(dtype))
    return module


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


class ConvBNPReLU(nn.Module):
    """ConvBN -> per-channel PReLU (the reference's ``ConvBNPReLU``; the
    slope is flax's ``PReLU_0/alpha``)."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int = 3, stride: int = 1):
        super().__init__()
        self.ConvBN_0 = ConvBN(in_ch, out_ch, kernel, stride)
        self.PReLU_0 = nn.PReLU(out_ch)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.PReLU_0(self.ConvBN_0(x))
