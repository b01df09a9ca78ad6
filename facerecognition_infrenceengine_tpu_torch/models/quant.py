"""Post-training int8 quantization of the IResNet embedder and the SCRFD
backbone: the opt-in scale modes ``EngineConfig.embed_int8`` / ``det_int8``.

The torch form of ``facerecognition_infrenceengine_tpu/models/quant.py``,
function for function, reading the port's modules (``models/arcface.IResNet``,
``models/scrfd.SCRFD``; OIHW conv weights) where the reference reads flax
trees.  Quant-point names are the reference's strings
(``IBasicBlock_{b}/Conv_0``, ``layer{i}_b{j}/conv1``, ``stem1``...), so a
scales dict of either package drives the other.

Scheme (symmetric PTQ):
  - conv weights: per-output-channel int8, sw = max(max|w|, 1e-8) / 127 over
    (kh, kw, cin), from the float32 weights (folded in numpy, so ``w8`` and
    ``sw`` are the reference's bit for bit);
  - conv inputs: per-tensor int8 at scales calibrated by a float forward
    over a calibration batch, max(abs-max, 1e-6) * margin / 127 a point;
  - convs s8 x s8 -> s32 (``ops/int8_conv.int8_conv2d_nhwc``), dequantized
    as y32 * (sa * sw)[c];
  - activations float32 between layers, NHWC; BatchNorm, PReLU, ReLU, the
    residual, the embedder's stem conv, Dense and feature BN in float; float
    convs cast their operands to the engine dtype and accumulate in float32.

The forwards are functional twins of the modules: ``apply_float`` /
``scrfd_backbone_forward`` with no weights given are pinned against
``IResNet.forward`` / ``ResNetV1e.forward`` by tests/test_torch_quant.py.
The embedder twin reads float32 parameters (the reference adds the f32
Dense bias and PReLU slopes); the detector twin reads the engine's module
(BatchNorm kept float32, conv weights rounded to the dtype as the
reference rounds them).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.int8_conv import int8_conv2d_nhwc, quantize_act
from .layers import BN_EPS
from .scrfd import block_has_downsample

DEPTHS = (3, 4, 14, 3)  # iresnet50 (arcface.iresnet50)


def _bn(x: torch.Tensor, bn) -> torch.Tensor:
    """Inference BatchNorm over the last dim, in float32 (the reference's
    ``x * inv + (bias - mean * inv)``)."""
    inv = bn.weight.float() / torch.sqrt(bn.running_var.float() + BN_EPS)
    return x * inv + (bn.bias.float() - bn.running_mean.float() * inv)


def _prelu(x: torch.Tensor, prelu) -> torch.Tensor:
    return torch.where(x > 0, x, x * prelu.weight.float())


def _float_conv(x: torch.Tensor, weight: torch.Tensor, stride: int, pad: int,
                dtype: torch.dtype) -> torch.Tensor:
    """NHWC float32 -> NHWC float32: the operands rounded to ``dtype``, the
    products summed in float32 (the reference's preferred_element_type=f32)."""
    xin = x.to(dtype).float().permute(0, 3, 1, 2)
    w = weight.to(dtype).float()
    return F.conv2d(xin, w, stride=stride, padding=pad).permute(0, 2, 3, 1)


def _quantize_conv(weight: torch.Tensor):
    """OIHW float weights -> (w8 [kh, kw, cin, cout] int8, sw [cout] float32)
    on the weights' device, computed in numpy (f32 division, round half to
    even) as the reference computes them.  w8 is an HWIO view of Cout-major
    storage: ``ops/int8_conv.gemm_weight`` then reads it as the column-major
    GEMM operand with no copy."""
    w = weight.detach().float().cpu().numpy().transpose(2, 3, 1, 0)  # HWIO
    sw = np.maximum(np.max(np.abs(w), axis=(0, 1, 2)), np.float32(1e-8)) / np.float32(127.0)
    w8 = np.clip(np.round(w / sw), -127, 127).astype(np.int8)
    dev = weight.device
    w8 = torch.from_numpy(np.ascontiguousarray(w8.transpose(3, 0, 1, 2))).to(dev)
    return w8.permute(1, 2, 3, 0), torch.from_numpy(sw.astype(np.float32)).to(dev)


def _int8_conv(xin: torch.Tensor, w8: torch.Tensor, sw: torch.Tensor, sa: float,
               stride: int, pad: int) -> torch.Tensor:
    """Quantize, s8 x s8 -> s32 conv, dequantize: NHWC float32 in and out."""
    return int8_conv2d_nhwc(quantize_act(xin, sa), w8, stride, pad, scale=sa * sw)


def _collect_point(collect, xin, collect_reduce, collect_scales):
    if collect_reduce == "clipfrac":
        s = collect_scales[len(collect)]
        collect.append(torch.mean((torch.abs(xin) > 127.0 * s).float()))
    else:
        collect.append(torch.max(torch.abs(xin)))


def quantize_weights(model, min_block: int = 0) -> dict:
    """Per-output-channel int8 conv kernels + scales for every block conv:
    {"<block>/<conv>": (w8 [3, 3, ci, co] or [1, 1, ci, co], sw [co])}.  The
    stem conv and Dense are not quantized; ``min_block`` keeps earlier
    blocks in float."""
    out = {}
    for b in range(min_block, sum(model.depths)):
        blk = getattr(model, f"IBasicBlock_{b}")
        for conv in ("Conv_0", "Conv_1", "Conv_2"):
            if hasattr(blk, conv):
                out[f"IBasicBlock_{b}/{conv}"] = _quantize_conv(getattr(blk, conv).weight)
    return out


def _forward(model, x, qw=None, act_scales=None, dtype=torch.bfloat16, collect=None,
             collect_reduce="absmax", collect_scales=None):
    """Shared forward of the embedder, x [B, 112, 112, 3] preprocessed NHWC.
    With qw + act_scales: int8 convs at the points qw holds (the rest
    float).  With ``collect`` (a list): the float forward, appending a
    scalar tensor a quant point in calibration order -- the abs-max, or
    with ``collect_reduce="clipfrac"`` and per-point ``collect_scales`` the
    share of values that would clip at that scale."""
    f = torch.float32
    x = x.to(f)

    def qconv(name, xin, stride):
        if collect is not None:
            _collect_point(collect, xin, collect_reduce, collect_scales)
        blk, conv = name.split("/")
        weight = getattr(getattr(model, blk), conv).weight
        pad = 1 if weight.shape[2] == 3 else 0
        if qw is None or name not in qw:
            return _float_conv(xin, weight, stride, pad, dtype)
        w8, sw = qw[name]
        return _int8_conv(xin, w8, sw, act_scales[name], stride, pad)

    # stem: conv + bn + prelu, float (3-channel input)
    x = _float_conv(x, model.Conv_0.weight, 1, 1, dtype)
    x = _prelu(_bn(x, model.BatchNorm_0), model.PReLU_0)

    starts = set(np.cumsum((0,) + model.depths)[:-1].tolist())
    for b in range(sum(model.depths)):
        name = f"IBasicBlock_{b}"
        blk = getattr(model, name)
        stride = 2 if b in starts else 1
        out = _bn(x, blk.BatchNorm_0)
        out = qconv(f"{name}/Conv_0", out, 1)
        out = _prelu(_bn(out, blk.BatchNorm_1), blk.PReLU_0)
        out = qconv(f"{name}/Conv_1", out, stride)
        out = _bn(out, blk.BatchNorm_2)
        if hasattr(blk, "Conv_2"):
            sc = _bn(qconv(f"{name}/Conv_2", x, stride), blk.BatchNorm_3)
        else:
            sc = x
        x = out + sc

    x = _bn(x, model.BatchNorm_1)
    x = x.permute(0, 3, 1, 2).reshape(x.shape[0], -1)  # the Dense's CHW row order
    dense = model.Dense_0
    x = F.linear(x.to(dtype), dense.weight.to(dtype)).to(f) + dense.bias.float()
    return _bn(x, model.BatchNorm_2).to(torch.float32)


def calibration_order(depths: Sequence[int] = DEPTHS) -> list:
    """Quant-point names in the order ``_forward`` visits them (every
    stage-start block, block 0 included, has the Conv_2 shortcut)."""
    names, starts = [], set(np.cumsum((0,) + tuple(depths))[:-1].tolist())
    for b in range(sum(depths)):
        names.append(f"IBasicBlock_{b}/Conv_0")
        names.append(f"IBasicBlock_{b}/Conv_1")
        if b in starts:
            names.append(f"IBasicBlock_{b}/Conv_2")
    return names


def _scales(names, maxes, margin: float) -> dict:
    assert len(names) == len(maxes), (len(names), len(maxes))
    return {n: float(max(m, 1e-6)) * (margin / 127.0) for n, m in zip(names, maxes)}


@torch.no_grad()
def calibrate(model, calib_x, dtype=torch.bfloat16, margin: float = 1.0) -> dict:
    """The float forward over a calibration batch -> {quant point: python
    float activation scale} (abs-max / 127 * margin).  One host read at the
    end."""
    maxes = []
    _forward(model, calib_x, dtype=dtype, collect=maxes)
    return _scales(calibration_order(model.depths), torch.stack(maxes).cpu().numpy(), margin)


@torch.no_grad()
def apply_int8(model, qw, act_scales, x, dtype=torch.bfloat16) -> torch.Tensor:
    """int8 embedder forward: un-normalized [B, 512] float32 embeddings, the
    contract of ``IResNet.forward`` (callers L2-normalize)."""
    return _forward(model, x, qw=qw, act_scales=act_scales, dtype=dtype)


@torch.no_grad()
def clip_fractions(model, act_scales, x, dtype=torch.bfloat16) -> dict:
    """Per quant point, the share of activations that would clip at the
    given scales (|a| > 127 * scale), from one float forward: {point:
    python float in [0, 1]}.  A healthy calibration keeps every entry near
    0; persistent clipping means recalibrate (FaceEngine.recalibrate_int8)."""
    names = calibration_order(model.depths)
    fracs = []
    _forward(model, x, dtype=dtype, collect=fracs, collect_reduce="clipfrac",
             collect_scales=[act_scales[n] for n in names])
    return {n: float(v) for n, v in zip(names, torch.stack(fracs).cpu().numpy())}


@torch.no_grad()
def apply_float(model, x, dtype=torch.bfloat16) -> torch.Tensor:
    """The same functional forward without quantization (the twin the tests
    pin against ``IResNet.forward``)."""
    return _forward(model, x, dtype=dtype)


# ---------------------------------------------------------------------------
# SCRFD backbone (models/scrfd.ResNetV1e) int8 twin, the same scheme; the
# neck and head stay float.

def _scrfd_names(cfg) -> list:
    """(quant-point name, stride, kernel) in execution order, mirroring
    ResNetV1e.forward."""
    names = [("stem1", 2, 3), ("stem2", 1, 3), ("stem3", 1, 3)]
    for i, blocks in enumerate(cfg.stage_blocks):
        for j in range(blocks):
            stride = 2 if (i > 0 and j == 0) else 1
            blk = f"layer{i + 1}_b{j}"
            names.append((f"{blk}/conv1", stride, 3))
            names.append((f"{blk}/conv2", 1, 3))
            if block_has_downsample(cfg, i, j):
                names.append((f"{blk}/downsample", 1, 1))
    return names


def _convbn_module(backbone, name: str):
    mod = backbone
    for part in name.split("/"):
        mod = getattr(mod, part)
    return mod


def quantize_scrfd_weights(model, cfg) -> dict:
    """Per-output-channel int8 kernels for every backbone conv of an SCRFD
    module (read before any cast to bf16)."""
    return {name: _quantize_conv(_convbn_module(model.backbone, name).Conv_0.weight)
            for name, _, _ in _scrfd_names(cfg)}


@torch.no_grad()
def scrfd_backbone_forward(model, x, cfg, qw=None, act_scales=None, dtype=torch.bfloat16,
                           collect=None) -> list:
    """Functional twin of ResNetV1e.forward (float, or int8 with qw +
    act_scales) on x [B, H, W, 3] preprocessed NHWC.  Returns the [C3, C4,
    C5] NHWC features the PAFPN consumes, in ``dtype``."""
    backbone = model.backbone
    f = torch.float32

    def convbn(name, xin, stride, ksize, act):
        if collect is not None:
            collect.append(torch.max(torch.abs(xin)))
        layer = _convbn_module(backbone, name)
        pad = ksize // 2
        if qw is None:
            y = _float_conv(xin, layer.Conv_0.weight, stride, pad, dtype)
        else:
            w8, sw = qw[name]
            y = _int8_conv(xin, w8, sw, act_scales[name], stride, pad)
        y = _bn(y, layer.BatchNorm_0)
        return torch.relu(y) if act else y

    x = x.to(f)
    x = convbn("stem1", x, 2, 3, True)
    x = convbn("stem2", x, 1, 3, True)
    x = convbn("stem3", x, 1, 3, True)
    x = F.max_pool2d(x.permute(0, 3, 1, 2), 3, 2, 1).permute(0, 2, 3, 1)

    feats = []
    for i, blocks in enumerate(cfg.stage_blocks):
        for j in range(blocks):
            stride = 2 if (i > 0 and j == 0) else 1
            blk = f"layer{i + 1}_b{j}"
            out = convbn(f"{blk}/conv1", x, stride, 3, True)
            out = convbn(f"{blk}/conv2", out, 1, 3, False)
            if block_has_downsample(cfg, i, j):
                sc = x
                if stride != 1:
                    sc = F.avg_pool2d(sc.permute(0, 3, 1, 2), stride, stride).permute(0, 2, 3, 1)
                sc = convbn(f"{blk}/downsample", sc, 1, 1, False)
            else:
                sc = x
            x = torch.relu(out + sc)
        if i >= 1:
            feats.append(x.to(dtype))
    return feats


@torch.no_grad()
def calibrate_scrfd(model, calib_x, cfg, dtype=torch.bfloat16, margin: float = 1.0) -> dict:
    """Activation scales for the backbone's quant points (one float pass,
    one host read)."""
    maxes = []
    scrfd_backbone_forward(model, calib_x, cfg, dtype=dtype, collect=maxes)
    return _scales([n for n, _, _ in _scrfd_names(cfg)], torch.stack(maxes).cpu().numpy(),
                   margin)
