"""s8 x s8 -> s32 convolutions for the int8 PTQ scale modes (models/quant.py).

The reference lets XLA compute these (``lax.conv_general_dilated(x8, w8,
preferred_element_type=int32)``); no Pallas kernel of the reference is
behind them.  Here one convolution is an NHWC im2col of the int8 input and
one ``torch._int_mm`` (cuBLASLt's int8 GEMM on the card) against the
[K, Cout] int8 weights: ``F.unfold`` and ``F.conv2d`` have no int8 kernel.

* ``quantize_act(x, sa)``: ``clip(round(x / sa), -127, 127)`` to int8, the
  reference's expression (f32 division, round half to even).
* ``int8_conv2d_nhwc(x8, w8, stride, pad)``: the convolution.  K (kh*kw*Cin)
  and Cout are padded with zero columns to multiples of 8, and M (output
  pixels) to a multiple of 32, as ``_int_mm`` on the card requires (torch
  2.11: M > 16, K and N multiples of 8; cuBLASLt refused M = 17, 24, 40 and
  56 at K = N = 32, ran M = 32); zero columns and rows add nothing, so the
  int32 result is exact.  The batch is split so that no chunk's im2col and
  int32 output exceed ``IM2COL_BUDGET`` bytes.
* ``int8_conv2d_exact(x8, w8, stride, pad)``: the same convolution in
  float64 (one matmul a kernel tap, no im2col), as int32: exact, since
  |sum| <= 9 * 512 * 127**2 < 2**53 (float32 is not: the sums pass 2**24).
  The tests and the chip smoke hold the GEMM form to it; no serving path
  calls it.

On a CUDA tensor ``int8_conv2d_nhwc`` runs ``torch._int_mm`` on the card or
raises; on a CPU tensor it runs ``torch._int_mm``'s CPU kernel.
``int8_conv2d_nhwc.calls`` counts its ``_int_mm`` calls.  While a
torch.profiler trace runs, the passes are ranges of their own
(``int8.quantize``, ``int8.im2col``, ``int8.int_mm``, ``int8.dequantize``),
so a trace splits their device time; with no trace they cost one check.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

IM2COL_BUDGET = 256 * 2**20  # bytes of im2col + int32 output a chunk
_ROWS = 32  # M a multiple of 32 (see above)
_WIDE = ((8, torch.int64), (4, torch.int32), (2, torch.int16))


def _span(name: str):
    """A profiler range while a trace runs, else nothing."""
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return contextlib.nullcontext()


def quantize_act(x: torch.Tensor, sa: float) -> torch.Tensor:
    """float32 activations -> int8 at per-tensor scale ``sa``."""
    with _span("int8.quantize"):
        return torch.clamp(torch.round(x / sa), -127, 127).to(torch.int8)


def _pad_to(n: int, m: int) -> int:
    return n + (-n) % m


def gemm_weight(w8: torch.Tensor) -> torch.Tensor:
    """[kh, kw, Cin, Cout] int8 (HWIO) -> [Kp, Np] int8, rows (kh, kw, cin)
    as the im2col's columns, zero-padded to multiples of 8, column-major
    (``_int_mm`` on the card runs 3.5-5.7x faster with the right operand
    column-major).  A view, no copy, when ``w8``'s Cout dim is outermost in
    memory (``models/quant`` stores it so) and nothing is padded."""
    kh, kw, ci, co = w8.shape
    k = kh * kw * ci
    wm = w8.reshape(k, co)
    kp, np_ = _pad_to(k, 8), _pad_to(co, 8)
    if (kp, np_) != (k, co):
        wm = F.pad(wm, (0, np_ - co, 0, kp - k))
    if wm.stride() != (1, kp):
        wm = wm.t().contiguous().t()
    return wm


def _word(ci: int):
    """The widest integer type whose bytes split the channels evenly: the
    im2col copy moves that many channels an element."""
    for n, dtype in _WIDE:
        if ci % n == 0:
            return n, dtype
    return 1, torch.int8


def int8_conv2d_nhwc(x8: torch.Tensor, w8: torch.Tensor, stride: int, pad: int,
                     scale: torch.Tensor | None = None) -> torch.Tensor:
    """x8 [B, H, W, Cin] int8, w8 [kh, kw, Cin, Cout] int8 (HWIO), symmetric
    zero padding ``pad`` -> [B, Ho, Wo, Cout] int32, exact.  With ``scale``
    ([Cout] float32) each chunk is dequantized as it is computed and the
    result is float32 ``y32 * scale``."""
    if x8.dtype != torch.int8 or w8.dtype != torch.int8:
        raise TypeError(f"int8 operands, got {x8.dtype} and {w8.dtype}")
    if x8.device.type not in ("cuda", "cpu") or w8.device != x8.device:
        raise ValueError(f"operands on {x8.device} and {w8.device}")
    b, h, w, ci = x8.shape
    kh, kw, wci, co = w8.shape
    if wci != ci:
        raise ValueError(f"input has {ci} channels, the kernel {wci}")
    ho = (h + 2 * pad - kh) // stride + 1
    wo = (w + 2 * pad - kw) // stride + 1
    k = kh * kw * ci
    wm = gemm_weight(w8)
    kp, np_ = wm.shape
    xp = (F.pad(x8, (0, 0, pad, pad, pad, pad)) if pad else x8).contiguous()
    g, word = _word(ci)
    # [B, Ho, Wo, C/g, kh, kw] view of the shifted windows, g channels a word
    win = xp.view(word).unfold(1, kh, stride).unfold(2, kw, stride)
    out = torch.empty((b, ho, wo, co), dtype=torch.int32 if scale is None else torch.float32,
                      device=x8.device)
    per_image = ho * wo * (kp + 4 * np_)
    step = max(1, min(b, IM2COL_BUDGET // max(per_image, 1)))
    for s in range(0, b, step):
        n = min(step, b - s)
        rows = n * ho * wo
        mp = _pad_to(rows, _ROWS)
        with _span("int8.im2col"):
            cols = torch.empty((mp, kp), dtype=torch.int8, device=x8.device)
            if kp != k:
                cols[:, k:].zero_()
            if mp != rows:
                cols[rows:].zero_()
            # one strided copy: window (kh, kw) order, then channels
            cols.view(word)[:rows, :k // g].view(n, ho, wo, kh, kw, ci // g).copy_(
                win[s:s + n].permute(0, 1, 2, 4, 5, 3))
        with _span("int8.int_mm"):
            y = torch._int_mm(cols, wm)[:rows, :co].view(n, ho, wo, co)
        int8_conv2d_nhwc.calls += 1
        with _span("int8.dequantize"):
            if scale is None:
                out[s:s + n] = y
            else:
                torch.mul(y, scale, out=out[s:s + n])
    return out


int8_conv2d_nhwc.calls = 0


def int8_conv2d_exact(x8: torch.Tensor, w8: torch.Tensor, stride: int, pad: int) -> torch.Tensor:
    """The check: the same convolution in float64 -> int32 NHWC, as a sum
    over the kernel's taps of one float64 matmul each (every partial sum is
    an integer below 2**53, so the result is exact whatever the order)."""
    b, h, w, ci = x8.shape
    kh, kw, _, co = w8.shape
    ho = (h + 2 * pad - kh) // stride + 1
    wo = (w + 2 * pad - kw) // stride + 1
    xp = F.pad(x8.to(torch.float64), (0, 0, pad, pad, pad, pad))
    wd = w8.to(torch.float64)
    y = torch.zeros((b, ho, wo, co), dtype=torch.float64, device=x8.device)
    for dy in range(kh):
        for dx in range(kw):
            tap = xp[:, dy:dy + stride * (ho - 1) + 1:stride, dx:dx + stride * (wo - 1) + 1:stride]
            y += tap @ wd[dy, dx]
    return y.to(torch.int32)
