"""ArcFace IResNet embedder (the buffalo_l ``w600k_r50`` equivalent).

The torch form of ``facerecognition_infrenceengine_tpu/models/arcface.py``:
BN-first basic blocks with per-channel PReLU, stride 2 at each stage entry
(112 -> 56 -> 28 -> 14 -> 7) with a 1x1 conv + BN shortcut, and a
BN -> flatten -> Dense(512) -> BN feature head.  Public inputs are NHWC;
the module runs NCHW inside.  The Dense flattens NCHW (channel-major), so
``models/weights.py`` permutes the flax kernel's NHWC rows.

``dtype`` is the compute dtype, as the reference's flax ``dtype``: the
parameters and BatchNorm statistics stay float32, the input is cast to
``dtype``, convs, the Dense and PReLU read their parameters cast to it, and
each BatchNorm normalises in float32 and rounds its output to it.  The
serving engine instead casts a float32-built module with
``layers.cast_keep_bn_f32``; the forward then computes in the cast dtype.

``serve_forward`` is the serving engine's forward of the same module: the
same weights and the same values, with every BatchNorm, PReLU and residual
add written in place by ``ops/epilogue_kernel.py``.  Training, ONNX export
and the int8 twin keep ``IResNet.forward``, whose out-of-place graph they
need.

Preprocessing (insightface): RGB, (x - 127.5) / 127.5.  Embeddings are not
normalized here; callers L2-normalize.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from ..ops.epilogue_kernel import epilogue
from .layers import BN_EPS, Conv2d, Linear, PReLU, compute_dtype


class IBasicBlock(nn.Module):
    def __init__(self, in_ch: int, planes: int, stride: int = 1):
        super().__init__()
        self.BatchNorm_0 = nn.BatchNorm2d(in_ch, eps=BN_EPS)
        self.Conv_0 = Conv2d(in_ch, planes, 3, 1, 1, bias=False)
        self.BatchNorm_1 = nn.BatchNorm2d(planes, eps=BN_EPS)
        self.PReLU_0 = PReLU(planes)
        self.Conv_1 = Conv2d(planes, planes, 3, stride, 1, bias=False)
        self.BatchNorm_2 = nn.BatchNorm2d(planes, eps=BN_EPS)
        self.shortcut = stride != 1 or in_ch != planes
        if self.shortcut:
            self.Conv_2 = Conv2d(in_ch, planes, 1, stride, 0, bias=False)
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
                 embed_dim: int = 512, input_size: int = 112,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.Conv_0 = Conv2d(3, widths[0], 3, 1, 1, bias=False)
        self.BatchNorm_0 = nn.BatchNorm2d(widths[0], eps=BN_EPS)
        self.PReLU_0 = PReLU(widths[0])
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
        self.Dense_0 = Linear(widths[-1] * side * side, embed_dim)
        self.Dense_0.flatten_chw = (widths[-1], side, side)
        self.BatchNorm_2 = nn.BatchNorm1d(embed_dim, eps=BN_EPS)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: [B, 112, 112, 3] NHWC scaled to [-1, 1] -> [B, 512] float32
        (the last BatchNorm's output in the compute dtype, then float32, as
        the reference's ``astype(jnp.float32)``)."""
        x = x.permute(0, 3, 1, 2).to(compute_dtype(self, self.Conv_0))
        x = self.PReLU_0(self.BatchNorm_0(self.Conv_0(x)))
        for i in range(self.num_blocks):
            x = getattr(self, f"IBasicBlock_{i}")(x)
        x = self.BatchNorm_1(x)
        x = self.Dense_0(torch.flatten(x, 1))
        return self.BatchNorm_2(x).float()


@torch.inference_mode()
def serve_forward(model: IResNet, x: torch.Tensor) -> torch.Tensor:
    """``model(x)``, value for value, with the per-channel epilogues run in
    place (``ops/epilogue_kernel.epilogue``): the convs allocate the only
    activations.  A stage-entry block applies its BatchNorm_0 to its input
    in place once the shortcut conv has read it, so at 112x112 two full
    activations are live (and the shortcut's stride-2 output), not three;
    an identity block keeps its input for the residual and writes its
    BatchNorm_0 into a new tensor.  Eval statistics; the module's own
    parameters and buffers."""
    if model.training:
        raise ValueError("serve_forward runs a module in eval mode")
    x = x.permute(0, 3, 1, 2).to(compute_dtype(model, model.Conv_0))
    x = epilogue(model.Conv_0(x), model.BatchNorm_0, prelu=model.PReLU_0.weight)
    for i in range(model.num_blocks):
        block = getattr(model, f"IBasicBlock_{i}")
        if block.shortcut:
            sc = block.Conv_2(x)
            c = block.Conv_0(epilogue(x, block.BatchNorm_0))
        else:
            sc = x
            c = block.Conv_0(epilogue(x, block.BatchNorm_0, out=torch.empty_like(x)))
        del x
        o = block.Conv_1(epilogue(c, block.BatchNorm_1, prelu=block.PReLU_0.weight))
        del c
        x = epilogue(o, block.BatchNorm_2, res=sc,
                     res_bn=block.BatchNorm_3 if block.shortcut else None)
        del o, sc
    x = model.BatchNorm_1(x)
    x = model.Dense_0(torch.flatten(x, 1))
    return model.BatchNorm_2(x).float()


def layer_execution_order(depths: Sequence[int] = (3, 4, 14, 3)) -> list:
    """[(kind, flax path)] in torch/ONNX trace order, for the ONNX converter.

    The stem's conv, BN and PReLU; a block's BatchNorm_0, Conv_0,
    BatchNorm_1, PReLU_0, Conv_1, BatchNorm_2, then (at a stage's stride-2
    entry) the shortcut's Conv_2 and BatchNorm_3; the tail's BatchNorm_1,
    Dense_0 and BatchNorm_2.  ``dense_flatten`` marks the Dense after the
    NCHW flatten, whose rows the converter permutes to the flax NHWC order.
    """
    order = [("conv", "params/Conv_0"), ("bn", "params/BatchNorm_0"),
             ("prelu", "params/PReLU_0")]
    i = 0
    for depth in depths:
        for j in range(depth):
            base = f"params/IBasicBlock_{i}"
            order += [("bn", f"{base}/BatchNorm_0"), ("conv", f"{base}/Conv_0"),
                      ("bn", f"{base}/BatchNorm_1"), ("prelu", f"{base}/PReLU_0"),
                      ("conv", f"{base}/Conv_1"), ("bn", f"{base}/BatchNorm_2")]
            if j == 0:  # stage entry: stride 2, the conv + BN shortcut
                order += [("conv", f"{base}/Conv_2"), ("bn", f"{base}/BatchNorm_3")]
            i += 1
    order += [("bn", "params/BatchNorm_1"), ("dense_flatten", "params/Dense_0"),
              ("bn", "params/BatchNorm_2")]
    return order


def iresnet50(dtype: torch.dtype = torch.float32) -> IResNet:
    return IResNet(depths=(3, 4, 14, 3), dtype=dtype)


def iresnet18(dtype: torch.dtype = torch.float32) -> IResNet:
    return IResNet(depths=(2, 2, 2, 2), dtype=dtype)


def preprocess(images: torch.Tensor) -> torch.Tensor:
    """uint8/float RGB [B, 112, 112, 3] -> insightface convention [-1, 1]."""
    return (images.float() - 127.5) / 127.5
