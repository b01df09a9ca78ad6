"""MobileFaceNet embedder (the ``mobile_facenet_v1`` pack).

The torch form of ``facerecognition_infrenceengine_tpu/models/
mobilefacenet.py``: depthwise-separable inverted-residual bottlenecks with
PReLU, a global depthwise conv instead of pooling, and a 512-d linear
embedding (Chen et al., "MobileFaceNets", arXiv:1804.07573), at the paper's
full width.  Submodules carry the flax names (``ConvBlock_k``,
``Bottleneck_n/ConvBlock_{0,1,2}``, ``Dense_0``, ``BatchNorm_0``), so
``models/weights.py`` maps the reference's tree onto them; a depthwise flax
kernel [kH, kW, 1, C] (``feature_group_count`` C) is torch's [C, 1, kH, kW].

Public inputs are NHWC scaled to [-1, 1] (the engine calls
``arcface.preprocess``); the module runs NCHW inside.  Callers L2-normalize
the output.  ``dtype`` is the compute dtype over float32 parameters, as in
``models/arcface.IResNet``.  ``layer_execution_order`` lists the layers in
trace order for the ONNX converter (insightface's ``w600k_mbf.onnx``).
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from .layers import BN_EPS, Conv2d, Linear, PReLU, compute_dtype


class ConvBlock(nn.Module):
    """Conv -> BN -> PReLU (optionally depthwise, optionally linear)."""

    def __init__(self, in_ch: int, features: int, kernel: int = 3, stride: int = 1,
                 groups: int = 1, linear: bool = False):
        super().__init__()
        pad = (kernel - 1) // 2
        self.Conv_0 = Conv2d(in_ch, features, kernel, stride, pad, groups=groups, bias=False)
        self.BatchNorm_0 = nn.BatchNorm2d(features, eps=BN_EPS)
        self.linear = linear  # no activation (the paper's "linear" blocks)
        if not linear:
            self.PReLU_0 = PReLU(features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.BatchNorm_0(self.Conv_0(x))
        return x if self.linear else self.PReLU_0(x)


class Bottleneck(nn.Module):
    """Inverted residual: expand 1x1 -> depthwise 3x3 -> project 1x1."""

    def __init__(self, in_ch: int, features: int, expansion: int, stride: int = 1):
        super().__init__()
        inner = in_ch * expansion
        self.ConvBlock_0 = ConvBlock(in_ch, inner, kernel=1)
        self.ConvBlock_1 = ConvBlock(inner, inner, kernel=3, stride=stride, groups=inner)
        self.ConvBlock_2 = ConvBlock(inner, features, kernel=1, linear=True)
        self.residual = stride == 1 and in_ch == features

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = self.ConvBlock_2(self.ConvBlock_1(self.ConvBlock_0(x)))
        return out + x if self.residual else out


class MobileFaceNet(nn.Module):
    """112x112x3 -> embed_dim embedding (the paper's table 1 layout)."""

    # (expansion, features, repeats, stride) per stage
    STAGES = ((2, 64, 5, 2), (4, 128, 1, 2), (2, 128, 6, 1), (4, 128, 1, 2), (2, 128, 2, 1))

    def __init__(self, embed_dim: int = 512, stages: Sequence = STAGES, input_size: int = 112,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.ConvBlock_0 = ConvBlock(3, 64, kernel=3, stride=2)  # 56
        self.ConvBlock_1 = ConvBlock(64, 64, kernel=3, groups=64)
        blocks, in_ch = [], 64
        for expansion, features, repeats, stride in stages:
            blocks.append(Bottleneck(in_ch, features, expansion, stride))
            blocks += [Bottleneck(features, features, expansion, 1) for _ in range(repeats - 1)]
            in_ch = features
        self.num_blocks = len(blocks)
        for i, block in enumerate(blocks):
            self.add_module(f"Bottleneck_{i}", block)
        self.ConvBlock_2 = ConvBlock(in_ch, 512, kernel=1)
        # global depthwise conv (7x7 at 112 input, padded by 3 as the
        # reference's) instead of avg-pool; its centre tap is taken
        side = input_size
        for _, _, _, stride in ((None, None, None, 2),) + tuple(stages):
            side = (side - 1) // stride + 1
        self.gd = side
        self.ConvBlock_3 = ConvBlock(512, 512, kernel=side, groups=512, linear=True)
        self.Dense_0 = Linear(512, embed_dim, bias=False)
        self.BatchNorm_0 = nn.BatchNorm1d(embed_dim, eps=BN_EPS)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: [B, 112, 112, 3] NHWC scaled to [-1, 1] -> [B, 512] float32."""
        x = x.permute(0, 3, 1, 2).to(compute_dtype(self, self.ConvBlock_0.Conv_0))
        x = self.ConvBlock_1(self.ConvBlock_0(x))
        for i in range(self.num_blocks):
            x = getattr(self, f"Bottleneck_{i}")(x)
        x = self.ConvBlock_3(self.ConvBlock_2(x))
        gd = x.shape[2]
        x = x[:, :, gd // 2, gd // 2] if gd > 1 else x[:, :, 0, 0]
        return self.BatchNorm_0(self.Dense_0(x)).float()


def mobilefacenet(dtype: torch.dtype = torch.float32) -> MobileFaceNet:
    return MobileFaceNet(dtype=dtype)


def layer_execution_order(stages: Sequence = MobileFaceNet.STAGES) -> list:
    """[(kind, flax path)] in trace order for the ONNX converter: each
    ConvBlock traces Conv -> BN (-> PReLU), a bottleneck its three
    ConvBlocks in turn, the tail Dense_0 then BatchNorm_0."""
    def convblock(path: str, linear: bool = False) -> list:
        out = [("conv", f"{path}/Conv_0"), ("bn", f"{path}/BatchNorm_0")]
        return out if linear else out + [("prelu", f"{path}/PReLU_0")]

    order = convblock("params/ConvBlock_0") + convblock("params/ConvBlock_1")
    n = 0
    for _expansion, _features, repeats, _stride in stages:
        for _ in range(repeats):
            base = f"params/Bottleneck_{n}"
            order += convblock(f"{base}/ConvBlock_0") + convblock(f"{base}/ConvBlock_1")
            order += convblock(f"{base}/ConvBlock_2", linear=True)
            n += 1
    order += convblock("params/ConvBlock_2") + convblock("params/ConvBlock_3", linear=True)
    return order + [("dense", "params/Dense_0"), ("bn", "params/BatchNorm_0")]


def preprocess(images: torch.Tensor) -> torch.Tensor:
    """uint8/float RGB [B, 112, 112, 3] -> [-1, 1]."""
    return (images.float() - 127.5) / 127.5
