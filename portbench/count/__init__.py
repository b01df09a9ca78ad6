"""Operations and bytes of the served work, counted from the configuration's
shapes and the cell's sizes, never from the port's code: a roofline then
reads the same work whatever implements it.

Peaks are NVIDIA's data-sheet figures for one H100 SXM (dense, at its
700 W limit).  A model's operations are the multiply-adds x 2 of every
matmul its forward runs: convolutions, dense layers and batched matmuls
(``mm``, ``addmm``, ``bmm``, ``baddbmm``, ``scaled_dot_product_attention``),
as ``torch.utils.flop_counter.FlopCounterMode`` counts them over one forward
of the reference's module of the configuration's widths, built and run on
the meta device (no weights, no compute).  Normalisations, activations and
adds are not counted.
"""

from __future__ import annotations

import math

import torch
from torch.utils.flop_counter import FlopCounterMode

from ..reference import arcface
from ..reference.pipeline import detector_factory, embedder_factory, head_factory

HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12, "int8": 1979e12}
ROI = 192  # the side of the atlas window the face warp reads, raw pixels


def bound(bytes_moved: float, flops: float, dtype: str) -> tuple:
    """The least time in seconds the card could take, and what bounds it."""
    t_bytes = bytes_moved / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype]
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def model_flops(make, input_nhwc: tuple) -> float:
    """Multiply-adds x 2 of one forward of ``make()`` on one input."""
    with torch.device("meta"):
        model = make().eval()
        with torch.no_grad(), FlopCounterMode(display=False) as counter:
            model(torch.zeros((1,) + tuple(input_nhwc)))
    return float(counter.get_total_flops())


def frame_flops(config: dict) -> dict:
    """Operations a frame asks of each model, at the widths the configuration
    file states: the detector on the canvas, the embedder (and the attribute
    heads, at their input sides) on each of its ``max_faces`` faces (with
    the port's synthetic packs every slot holds a face)."""
    h, w = config["canvas"]
    faces = config["max_faces"]
    side = config["embed_size"]
    out = {"detector": model_flops(detector_factory(config["detector"]), (h, w, 3)),
           "embedder": faces * model_flops(embedder_factory(config["recognizer"]),
                                           (side, side, 3))}
    if config.get("attribute_heads"):
        out["heads"] = faces * sum(model_flops(head_factory(name, head),
                                               (head["input"], head["input"], 3))
                                   for name, head in config["attribute_heads"].items())
    return out


def epilogue_passes(rec: dict, side: int) -> list:
    """[((C, H, W), tensors)] of each per-channel epilogue pass IResNet's
    serving forward (the port's ``arcface.serve_forward``) makes over one
    face, from the BatchNorm output shapes of the reference module at the
    widths ``rec`` states, on a ``side`` x ``side`` crop.  A pass reads and
    writes one activation (2 tensors): the stem's BatchNorm + PReLU, each
    block's BatchNorm_0, and its BatchNorm_1 + PReLU; a block's BatchNorm_2
    also reads the residual (3 tensors), its shortcut's BatchNorm_3 folded
    into the same pass.  The last BatchNorm is not an epilogue pass.  Empty
    for an embedder that is not an IResNet."""
    with torch.device("meta"):
        model = embedder_factory(rec)().eval()
    if not isinstance(model, arcface.IResNet):
        return []
    shapes = {}
    hooks = [m.register_forward_hook(
        lambda _m, _i, out, name=name: shapes.__setitem__(name, tuple(out.shape[1:])))
        for name, m in model.named_modules() if isinstance(m, torch.nn.BatchNorm2d)]
    with torch.no_grad():
        model(torch.zeros((1, side, side, 3), device="meta"))
    for h in hooks:
        h.remove()
    passes = [(shapes["BatchNorm_0"], 2)]
    for i in range(model.num_blocks):
        block = f"IBasicBlock_{i}."
        passes += [(shapes[block + "BatchNorm_0"], 2), (shapes[block + "BatchNorm_1"], 2),
                   (shapes[block + "BatchNorm_2"], 3)]
    return passes


def epilogue_pass_bytes(faces: int, chw: tuple, tensors: int, dtype: str) -> float:
    """One epilogue pass over ``faces`` activations of shape ``chw`` in
    ``dtype``: each of its ``tensors`` read or written once."""
    return float(faces * math.prod(chw) * tensors * getattr(torch, dtype).itemsize)


def epilogue_bytes(config: dict, faces: int) -> float:
    """The bytes the embedder's epilogue passes must move over ``faces``
    faces in the configuration's dtype (0 for an embedder that is not an
    IResNet)."""
    return float(sum(epilogue_pass_bytes(faces, chw, tensors, config["dtype"])
                     for chw, tensors in epilogue_passes(config["recognizer"],
                                                         config["embed_size"])))


def warp_bytes(faces: int, crop_sides) -> float:
    """K3 on ``faces`` faces at each crop side: the float32 crops written
    plus one read of each face's u8 ROI x ROI x 3 window (an upper count:
    the kernel reads only the taps its crop needs)."""
    return float(sum(faces * (side * side * 3 * 4 + ROI * ROI * 3) for side in crop_sides))


def match_f32_bytes(rows: int, queries: int, dim: int = 512) -> float:
    """K1: the valid gallery rows once, in float32, plus the queries."""
    return float(rows * dim * 4 + queries * dim * 4)


def match_int8_bytes(rows: int, queries: int, dim: int = 512) -> float:
    """K2: the valid int8 rows once, the queries as int8 and the two f32
    scales."""
    return float(rows * dim + queries * dim + 8)


def stem_work(frames: int, canvas: tuple, stem_width: int) -> tuple:
    """K4 on ``frames`` packed canvases: (operations, bytes).  The stem is
    three 3x3 convs (3 -> w stride 2, w -> w, w -> 2w) and a 3x3/2 max-pool;
    it reads the s2d4-packed RGB u8 frame and writes the [H/4, W/4, 2w]
    bf16 output."""
    h, w = canvas
    h2, w2 = math.ceil(h / 2), math.ceil(w / 2)
    macs = h2 * w2 * stem_width * 27 + h2 * w2 * stem_width * 9 * stem_width \
        + h2 * w2 * 2 * stem_width * 9 * stem_width
    out_bytes = (h // 4) * (w // 4) * 2 * stem_width * 2
    return frames * 2.0 * macs, frames * float(h * w * 3 + out_bytes)
