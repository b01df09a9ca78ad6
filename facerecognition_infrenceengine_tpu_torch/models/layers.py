"""Shared torch building blocks, named after the reference's flax modules.

Submodule names (``Conv_0``, ``BatchNorm_0``, ``PReLU_0``) are the flax
auto-names, so ``models/weights.py`` maps state-dict keys to flax paths by
name.  Padding is explicit and symmetric (``kernel // 2``), as in
``facerecognition_infrenceengine_tpu/models/layers.py``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

BN_EPS = 1e-5


def compute_dtype(model: nn.Module, first: nn.Module) -> torch.dtype:
    """The dtype ``model``'s forward computes in: ``model.dtype`` over
    float32 parameters (flax's ``dtype`` over its float32 ``param_dtype``),
    else the dtype the parameters were cast to (``cast_keep_bn_f32``, as the
    serving engine casts its modules).  ``first`` is the module whose weight
    tells which; the weight is read from ``_parameters`` so that torch.fx
    sees a dtype, not a traced value."""
    w = first._parameters["weight"].dtype
    return model.dtype if w == torch.float32 else w


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` that reads its parameters in its input's dtype: float32
    parameters under a bf16 forward are cast at use, inside autograd, so
    their gradient stays float32 (flax's ``promote_dtype``).  With the
    input in the parameters' dtype it is ``nn.Conv2d``."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self._conv_forward(x, self.weight.to(x.dtype),
                                  None if self.bias is None else self.bias.to(x.dtype))


class Linear(nn.Linear):
    """``nn.Linear`` that reads its parameters in its input's dtype (see
    ``Conv2d``)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, self.weight.to(x.dtype),
                        None if self.bias is None else self.bias.to(x.dtype))


class PReLU(nn.PReLU):
    """``nn.PReLU`` that reads its slope in its input's dtype (the
    reference's ``a.astype(x.dtype)``)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.prelu(x, self.weight.to(x.dtype))


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
