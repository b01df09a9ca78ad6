# Frozen copy of facerecognition_infrenceengine_tpu_torch/models/scrfd.py at commit 5fe48e2 (imports made local); do not edit.
"""SCRFD face detector: the ``det_10g`` graph of the buffalo_l pack, in torch.

The torch form of ``facerecognition_infrenceengine_tpu/models/scrfd.py``:

* ResNetV1e backbone: deep stem of three 3x3 convs (first stride 2) and a
  3x3/2 max-pool padded by 1, then BasicBlock stages with ResNet-D
  ("avg_down": 2x2/2 average pool, no padding, then 1x1 conv) shortcuts.
* PAFPN neck with bias-carrying convs and nearest-2x upsampling.
* A head shared across strides: conv+BN+ReLU stack, then cls/bbox/kps
  3x3 convs and a learnable per-level bbox scale.

Inputs are NHWC; the module runs NCHW inside.  The head outputs are
permuted back to NHWC before they are flattened, so rows come out ordered
(stride, y, x, anchor) exactly as the flax head's, which ``ops/anchors``
decodes.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from .layers import ConvBN

STRIDES = (8, 16, 32)
NUM_ANCHORS = 2


@dataclass(frozen=True)
class SCRFDConfig:
    stem_width: int = 28  # first/second deep-stem conv width; third is 2x
    stage_blocks: Sequence[int] = (3, 4, 2, 3)
    stage_planes: Sequence[int] = (56, 88, 88, 224)
    neck_width: int = 56
    head_width: int = 64
    head_depth: int = 4


CONFIGS = {
    "det_10g": SCRFDConfig(),
    "det_2.5g": SCRFDConfig(stem_width=12, stage_blocks=(2, 3, 2, 2),
                            stage_planes=(24, 48, 48, 96), neck_width=32,
                            head_width=32, head_depth=2),
    "det_500m": SCRFDConfig(stem_width=8, stage_blocks=(1, 2, 2, 1),
                            stage_planes=(16, 32, 48, 64), neck_width=24,
                            head_width=24, head_depth=2),
}


def block_has_downsample(cfg: SCRFDConfig, stage: int, block: int) -> bool:
    """Whether backbone block (stage, block) carries a downsample shortcut."""
    if block != 0:
        return False
    stride = 1 if stage == 0 else 2
    in_ch = 2 * cfg.stem_width if stage == 0 else cfg.stage_planes[stage - 1]
    return stride != 1 or in_ch != cfg.stage_planes[stage]


class BasicBlockV1e(nn.Module):
    """conv3x3(stride)-BN-ReLU -> conv3x3-BN, shortcut identity or
    avgpool(stride) + conv1x1 + BN, then add + ReLU."""

    def __init__(self, in_ch: int, planes: int, stride: int = 1):
        super().__init__()
        self.conv1 = ConvBN(in_ch, planes, 3, stride, relu=True)
        self.conv2 = ConvBN(planes, planes, 3, 1)
        self.stride = stride
        self.has_downsample = stride != 1 or in_ch != planes
        if self.has_downsample:
            self.downsample = ConvBN(in_ch, planes, 1, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = self.conv2(self.conv1(x))
        if self.has_downsample:
            if self.stride != 1:
                x = F.avg_pool2d(x, self.stride, self.stride)
            x = self.downsample(x)
        return torch.relu(out + x)


class ResNetV1e(nn.Module):
    def __init__(self, cfg: SCRFDConfig):
        super().__init__()
        self.stem1 = ConvBN(3, cfg.stem_width, 3, 2, relu=True)
        self.stem2 = ConvBN(cfg.stem_width, cfg.stem_width, 3, 1, relu=True)
        self.stem3 = ConvBN(cfg.stem_width, 2 * cfg.stem_width, 3, 1, relu=True)
        self.stages = []
        in_ch = 2 * cfg.stem_width
        for i, (blocks, planes) in enumerate(zip(cfg.stage_blocks, cfg.stage_planes)):
            names = []
            for j in range(blocks):
                stride = 2 if (i > 0 and j == 0) else 1
                self.add_module(f"layer{i + 1}_b{j}", BasicBlockV1e(in_ch, planes, stride))
                names.append(f"layer{i + 1}_b{j}")
                in_ch = planes
            self.stages.append(names)

    def forward(self, x: torch.Tensor, stem_out: torch.Tensor | None = None) -> list:
        """x [B, 3, H, W]; ``stem_out`` [B, 2*stem_width, H/4, W/4], when
        given, is the stem's output (K4, ops/stem_kernel.py) and stage 1
        starts from it: stem1-3 and the max-pool are skipped."""
        if stem_out is not None:
            x = stem_out
        else:
            x = self.stem3(self.stem2(self.stem1(x)))
            x = F.max_pool2d(x, 3, 2, 1)
        feats = []
        for i, names in enumerate(self.stages):
            for name in names:
                x = getattr(self, name)(x)
            if i >= 1:  # start_level=1: C3 (s8), C4 (s16), C5 (s32)
                feats.append(x)
        return feats


class PAFPN(nn.Module):
    def __init__(self, in_chs: Sequence[int], width: int):
        super().__init__()
        n = len(in_chs)
        self.n = n
        for i, c in enumerate(in_chs):
            self.add_module(f"lateral{i}", nn.Conv2d(c, width, 1))
            self.add_module(f"fpn{i}", nn.Conv2d(width, width, 3, 1, 1))
        for i in range(n - 1):
            self.add_module(f"down{i}", nn.Conv2d(width, width, 3, 2, 1))
            self.add_module(f"pafpn{i}", nn.Conv2d(width, width, 3, 1, 1))

    def forward(self, feats: list) -> list:
        n = self.n
        laterals = [getattr(self, f"lateral{i}")(f) for i, f in enumerate(feats)]
        for i in range(n - 1, 0, -1):
            laterals[i - 1] = laterals[i - 1] + F.interpolate(
                laterals[i], scale_factor=2, mode="nearest")
        inter = [getattr(self, f"fpn{i}")(lat) for i, lat in enumerate(laterals)]
        for i in range(n - 1):
            inter[i + 1] = inter[i + 1] + getattr(self, f"down{i}")(inter[i])
        return [inter[0]] + [getattr(self, f"pafpn{i}")(inter[i + 1])
                             for i in range(n - 1)]


class SCRFDHead(nn.Module):
    def __init__(self, in_ch: int, width: int, depth: int):
        super().__init__()
        self.depth = depth
        for i in range(depth):
            self.add_module(f"stack{i}", ConvBN(in_ch if i == 0 else width,
                                                width, 3, 1, relu=True))
        self.cls = nn.Conv2d(width, NUM_ANCHORS * 1, 3, 1, 1)
        self.reg = nn.Conv2d(width, NUM_ANCHORS * 4, 3, 1, 1)
        self.kps = nn.Conv2d(width, NUM_ANCHORS * 10, 3, 1, 1)

    def forward(self, x: torch.Tensor):
        for i in range(self.depth):
            x = getattr(self, f"stack{i}")(x)
        return self.cls(x), self.reg(x), self.kps(x)


class SCRFD(nn.Module):
    def __init__(self, cfg: SCRFDConfig = SCRFDConfig()):
        super().__init__()
        self.cfg = cfg
        self.backbone = ResNetV1e(cfg)
        self.neck = PAFPN(cfg.stage_planes[1:], cfg.neck_width)
        self.head = SCRFDHead(cfg.neck_width, cfg.head_width, cfg.head_depth)
        for lvl in range(len(STRIDES)):
            self.register_parameter(f"bbox_scale_{lvl}", nn.Parameter(torch.ones(1)))

    def forward(self, x: torch.Tensor | None, stem_out: torch.Tensor | None = None,
                feats_in: list | None = None):
        """x: [B, H, W, 3] NHWC, preprocessed.  ``stem_out``: the stem's
        [B, H/4, W/4, 2*stem_width] NHWC output (K4, the packed stems); the
        backbone then starts at stage 1 and ``x`` is not read (it may be
        None).  ``feats_in``: the whole backbone's [C3, C4, C5] NHWC output
        (the int8 backbone, models/quant.scrfd_backbone_forward); the float
        backbone is not run and ``x`` and ``stem_out`` are not read.

        Returns (scores [B, A, 1] logits, bbox [B, A, 4] stride units,
        kps [B, A, 10] stride units) in float32, rows ordered
        (stride asc, y, x, anchor)."""
        dtype = self.bbox_scale_0.dtype
        # NHWC permuted to NCHW is already a channels_last view: no copy
        if feats_in is not None:
            feats = self.neck([f.permute(0, 3, 1, 2).to(dtype) for f in feats_in])
        elif stem_out is not None:
            feats = self.neck(self.backbone(None, stem_out.permute(0, 3, 1, 2).to(dtype)))
        else:
            feats = self.neck(self.backbone(x.permute(0, 3, 1, 2).to(dtype)))
        scores, bboxes, kpss = [], [], []
        for lvl, f in enumerate(feats):
            cls, bbox, kps = self.head(f)
            bbox = bbox * getattr(self, f"bbox_scale_{lvl}")
            b = f.shape[0]
            scores.append(cls.permute(0, 2, 3, 1).reshape(b, -1, 1))
            bboxes.append(bbox.permute(0, 2, 3, 1).reshape(b, -1, 4))
            kpss.append(kps.permute(0, 2, 3, 1).reshape(b, -1, 10))
        return (torch.cat(scores, 1).float(), torch.cat(bboxes, 1).float(),
                torch.cat(kpss, 1).float())


def layer_execution_order(cfg: SCRFDConfig) -> list:
    """[(kind, flax path)] in torch/ONNX trace order, for the ONNX converter
    (``models/convert_onnx.py``).

    Kinds: ``convbn`` (a Conv node then a BatchNormalization node, leaves
    under <path>/Conv_0 and <path>/BatchNorm_0), ``conv`` (a bias-carrying
    Conv, leaves under <path>), ``scale`` (a 1-element Mul constant, the
    leaf at <path>).  The shared head is traced once per level in ONNX; the
    repeats reuse the same initializers, which the converter skips by name.
    """
    order = [("convbn", "params/backbone/stem1"),
             ("convbn", "params/backbone/stem2"),
             ("convbn", "params/backbone/stem3")]
    for i, blocks in enumerate(cfg.stage_blocks):
        for j in range(blocks):
            base = f"params/backbone/layer{i + 1}_b{j}"
            order.append(("convbn", f"{base}/conv1"))
            order.append(("convbn", f"{base}/conv2"))
            if block_has_downsample(cfg, i, j):
                order.append(("convbn", f"{base}/downsample"))
    for name, count in (("lateral", 3), ("fpn", 3), ("down", 2), ("pafpn", 2)):
        order += [("conv", f"params/neck/{name}{i}") for i in range(count)]
    order += [("convbn", f"params/head/stack{i}") for i in range(cfg.head_depth)]
    order += [("conv", "params/head/cls"), ("conv", "params/head/reg")]
    # one Mul (Scale) constant a level, met in level order as the head re-traces
    order += [("scale", f"params/bbox_scale_{lvl}") for lvl in range(len(STRIDES))]
    order.append(("conv", "params/head/kps"))
    return order


def num_anchors_total(height: int, width: int) -> int:
    return sum((height // s) * (width // s) * NUM_ANCHORS for s in STRIDES)


def preprocess(images: torch.Tensor) -> torch.Tensor:
    """uint8/float RGB -> detector input convention."""
    return (images.float() - 127.5) / 128.0
