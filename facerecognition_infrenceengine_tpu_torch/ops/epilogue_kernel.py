"""The embedder's per-channel epilogues as one pass: y = BN_a(x), then
optionally + BN_b(r) or + r, then optionally PReLU, written into ``x``
itself (or into ``out``).

Serves ``models/arcface.serve_forward``, IResNet's inference forward, whose
BatchNorms, PReLUs and residual adds then allocate no activation of their
own.  The CUDA kernel is ``csrc/epilogue.cu``; its header states the
bound on the H100 (bytes: each element read and written once) and the
design.

``epilogue`` launches the kernel for CUDA tensors and runs the plain
version, ``epilogue_plain``, for CPU tensors.  ``epilogue.launches`` counts
kernel launches.  The plain version is ATen's own sequence, as the module
forward runs it: ``F.batch_norm`` with the eval statistics, the residual
add, ``F.prelu`` with the slope in the activation dtype, computed out of
place and copied into ``out``.  The kernel rounds where that sequence
rounds (the BatchNorm output, the sum, the PReLU product), so on the card
the two agree bit for bit.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..kernels import build

_BF16 = {torch.float32: 0, torch.bfloat16: 1}
_VEC = {torch.float32: 4, torch.bfloat16: 8}  # channels in 16 bytes
_THREADS = 256  # the kernel's block: a row's vectors must divide it
_entries: dict = {}


def _bn(x: torch.Tensor, bn: nn.BatchNorm2d) -> torch.Tensor:
    return F.batch_norm(x, bn.running_mean, bn.running_var, bn.weight, bn.bias, False, 0.0,
                        bn.eps)


def epilogue_plain(x: torch.Tensor, bn: nn.BatchNorm2d, prelu: torch.Tensor | None = None,
                   res: torch.Tensor | None = None, res_bn: nn.BatchNorm2d | None = None,
                   out: torch.Tensor | None = None) -> torch.Tensor:
    """``bn(x)`` [+ ``res_bn(res)`` or + ``res``] [-> PReLU(``prelu``)],
    out of place in ATen's ops, then copied into ``out`` (default ``x``)."""
    y = _bn(x, bn)
    if res is not None:
        y = y + (res if res_bn is None else _bn(res, res_bn))
    if prelu is not None:
        y = F.prelu(y, prelu.to(y.dtype))
    return (x if out is None else out).copy_(y)


def _bn_args(bn: nn.BatchNorm2d | None, c: int, device) -> list:
    """A BatchNorm's weight, bias, mean and variance pointers and eps (all
    None / 0 for no BatchNorm); the tensors f32, contiguous, [c], on
    ``device``."""
    if bn is None:
        return [None] * 4 + [0.0]
    args = []
    for t in (bn.weight, bn.bias, bn.running_mean, bn.running_var):
        if (t is None or t.dtype != torch.float32 or t.device != device or t.numel() != c
                or not t.is_contiguous()):
            raise ValueError(f"BatchNorm weight, bias and statistics must be float32 [{c}] "
                             f"on {device}")
        args.append(t.data_ptr())
    return args + [float(bn.eps)]


def _rows(t: torch.Tensor, shape, dtype, what: str) -> None:
    if (t.shape != shape or t.dtype != dtype or t.data_ptr() % 16
            or not t.is_contiguous(memory_format=torch.channels_last)):
        raise ValueError(f"{what}: {tuple(t.shape)} {t.dtype} must be {tuple(shape)} {dtype}, "
                         f"channels-last and 16-byte aligned")


def epilogue(x: torch.Tensor, bn: nn.BatchNorm2d, prelu: torch.Tensor | None = None,
             res: torch.Tensor | None = None, res_bn: nn.BatchNorm2d | None = None,
             out: torch.Tensor | None = None) -> torch.Tensor:
    """y = ``bn(x)`` in eval statistics, then + ``res_bn(res)`` (or +
    ``res`` without ``res_bn``), then PReLU with slopes ``prelu`` [C];
    written into ``out`` (default: ``x``, in place) and returned.

    x, res, out: [B, C, H, W] float32 or bfloat16; on the card channels-last
    and 16-byte aligned, with C a multiple of 16 bytes and C's 16-byte
    vectors dividing 256.  The BatchNorms' parameters and statistics are
    float32.
    """
    o = x if out is None else out
    if x.device.type == "cpu":
        return epilogue_plain(x, bn, prelu, res, res_bn, o)
    if x.device.type != "cuda" or x.dim() != 4 or x.dtype not in _BF16:
        raise ValueError(f"x {tuple(x.shape)} {x.dtype} on {x.device}")
    c = x.shape[1]
    vec = _VEC[x.dtype]
    if c % vec or _THREADS % (c // vec):
        raise ValueError(f"C = {c}: a multiple of {vec} whose {vec}-channel vectors divide "
                         f"{_THREADS}")
    _rows(x, x.shape, x.dtype, "x")
    if o is not x:
        _rows(o, x.shape, x.dtype, "out")
    if res is not None:
        _rows(res, x.shape, x.dtype, "res")
    elif res_bn is not None:
        raise ValueError("res_bn without res")
    alpha = None
    if prelu is not None:
        alpha = prelu.to(x.dtype)
        if alpha.numel() != c or alpha.device != x.device or not alpha.is_contiguous():
            raise ValueError(f"prelu: {tuple(prelu.shape)} slopes for C = {c} on {x.device}")
    if x.numel() == 0:
        return o
    fn = _entries.get("epilogue")
    if fn is None:
        fn = _entries["epilogue"] = build.lib().fre_epilogue
    rows = x.numel() // c
    stream = torch._C._cuda_getCurrentRawStream(x.device.index)
    with build.launch_device(x.device):
        err = fn(x.data_ptr(), o.data_ptr(), None if res is None else res.data_ptr(),
                 None if alpha is None else alpha.data_ptr(), _BF16[x.dtype], rows, c,
                 *_bn_args(bn, c, x.device), *_bn_args(res_bn, c, x.device), stream)
    build.check(err, "fre_epilogue")
    epilogue.launches += 1
    return o


epilogue.launches = 0
