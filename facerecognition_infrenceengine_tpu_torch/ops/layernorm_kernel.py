"""The ViT's residual add and the LayerNorm after it as one pass: ``x += a``
written into ``x``, then ``LayerNorm(x)`` written into ``a``'s buffer (or
into ``out``); without a residual, ``LayerNorm(x)`` alone.

Serves ``models/vit.serve_forward``, the ViT's inference forward, whose
residual stream is then updated in place and whose LayerNorms allocate no
activation of their own.  The CUDA kernel is ``csrc/layernorm.cu``; its
header states the bound on the H100 (bytes: x and a read, x and n written)
and the design.

``residual_layernorm`` launches the kernel for CUDA tensors and runs the
plain version, ``residual_layernorm_plain``, for CPU tensors; on any other
device it checks its arguments and raises.  ``residual_layernorm.launches``
counts kernel launches, with a residual and without.  The plain version is ATen's own
sequence: ``x.add_(a)``, then ``F.layer_norm`` with the module's
parameters, copied into the target.  The kernel rounds the sum as ATen's
add does, so the stream agrees bit for bit; it takes the LayerNorm's
statistics in two passes, not in ATen's Welford order, so its LayerNorm
is within a rounding of ATen's (one bf16 ulp on the card).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..kernels import build

_BF16 = {torch.float32: 0, torch.bfloat16: 1}
_LANE_WIDTH = 128  # a warp's 4-element vectors: a row is a whole number of them
_MAX_VEC = 8  # the kernel's widest row: 8 of them
_entries: dict = {}


def residual_layernorm_plain(x: torch.Tensor, a: torch.Tensor | None, norm: nn.LayerNorm,
                             out: torch.Tensor | None = None) -> torch.Tensor:
    """``x.add_(a)`` (``a`` None: x unchanged), then ``norm(x)`` out of place
    in ATen's ops, copied into ``out`` (default ``a``; a new tensor when
    both are None)."""
    if a is not None:
        x.add_(a)
    y = F.layer_norm(x, norm.normalized_shape, norm.weight, norm.bias, norm.eps)
    target = a if out is None else out
    return y if target is None else target.copy_(y)


def _check(x: torch.Tensor, a: torch.Tensor | None, norm: nn.LayerNorm,
           out: torch.Tensor) -> None:
    if x.dtype not in _BF16:
        raise ValueError(f"x {tuple(x.shape)} {x.dtype}: float32 or bfloat16 rows")
    width = x.shape[-1]
    if width % _LANE_WIDTH or width // _LANE_WIDTH > _MAX_VEC:
        raise ValueError(f"width {width}: a multiple of {_LANE_WIDTH} elements, at most "
                         f"{_MAX_VEC * _LANE_WIDTH}")
    for name, t in (("x", x), ("a", a), ("out", out)):
        if t is None:
            continue
        if (t.shape != x.shape or t.dtype != x.dtype or t.device != x.device
                or not t.is_contiguous() or t.data_ptr() % (4 * t.element_size())):
            raise ValueError(f"{name}: {tuple(t.shape)} {t.dtype} on {t.device} must be "
                             f"{tuple(x.shape)} {x.dtype} on {x.device}, contiguous and "
                             f"aligned to 4 elements")
    if tuple(norm.normalized_shape) != (width,):
        raise ValueError(f"LayerNorm over {tuple(norm.normalized_shape)}, rows of {width}")
    for name in ("weight", "bias"):
        t = getattr(norm, name)
        if (t is None or t.dtype != x.dtype or t.device != x.device or t.numel() != width
                or not t.is_contiguous()):
            raise ValueError(f"LayerNorm {name}: {width} values of {x.dtype} on {x.device}")


def residual_layernorm(x: torch.Tensor, a: torch.Tensor | None, norm: nn.LayerNorm,
                       out: torch.Tensor | None = None) -> torch.Tensor:
    """``x += a`` in place (``a`` None: no residual, x only read), then
    ``norm(x)`` written into ``out`` (default: ``a``'s buffer; a new tensor
    without a residual) and returned.

    x, a, out: [..., width] float32 or bfloat16; on the card contiguous,
    aligned to 4 elements, width a multiple of 128 up to 1,024, and the
    LayerNorm's weight and bias in x's dtype.
    """
    if x.device.type == "cpu":
        return residual_layernorm_plain(x, a, norm, out)
    if out is None:
        out = torch.empty_like(x) if a is None else a
    _check(x, a, norm, out)
    if x.device.type != "cuda":
        raise ValueError(f"x on {x.device}: the kernel runs on a CUDA tensor")
    if x.numel() == 0:
        return out
    fn = _entries.get("residual_layernorm")
    if fn is None:
        fn = _entries["residual_layernorm"] = build.lib().fre_residual_layernorm
    width = x.shape[-1]
    stream = torch._C._cuda_getCurrentRawStream(x.device.index)
    with build.launch_device(x.device):
        err = fn(x.data_ptr(), None if a is None else a.data_ptr(), out.data_ptr(),
                 norm.weight.data_ptr(), norm.bias.data_ptr(), float(norm.eps), _BF16[x.dtype],
                 x.numel() // width, width, stream)
    build.check(err, "fre_residual_layernorm")
    residual_layernorm.launches += 1
    return out


residual_layernorm.launches = 0
