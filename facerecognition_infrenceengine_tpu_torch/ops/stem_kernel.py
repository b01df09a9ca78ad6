"""K4: the fused SCRFD deep stem -- three BN-folded 3x3 convs + ReLU and the
3x3/2 max-pool in one kernel, from s2d4-packed uint8 frames.

Replaces ``facerecognition_infrenceengine_tpu/ops/stem_pallas.py::
fused_stem``.  The CUDA kernel is ``csrc/stem.cu``; its header states the
bound on the H100 (operations) and the design: per 8x8 tile of pooled
outputs in shared memory, an implicit GEMM on the tensor cores in bf16
and a direct convolution on the FP32 cores in f32, not the reference's
phase-packed form.

Layouts are the reference's: ``space_to_depth4`` packs [B, H, W, C] into
[B, H/4, W/4, 16C] with channel (p*4 + q)*C + c holding raw pixel
(4Y+p, 4X+q, c).  ``prepare_input`` / ``pad_packed_u8`` build the
reference's padded x4 input ([B, H/4+8, >=W/4+1, 128]) and ``fused_stem``
takes it with the reference's signature; the kernel itself reads the
unpadded [B, H/4, W/4, 48] frames (``fused_stem_s2d4``), since the padding
is a TPU tiling artifact that would triple the bytes read.

``precompute_fused_stem`` folds BN into the 3x3 weights (f32, eps 1e-5,
the reference's order) and casts them to the engine dtype; they stay in
HWIO, the layout the f32 kernel and the plain version read.  In bf16 it
also returns ``pack_stem_fragments``' copy of them, zero-padded and in the
order the tensor-core kernel's MMA fragments read.  ``fused_stem_s2d4``
launches the kernel for CUDA tensors and runs the plain version,
``fused_stem_plain``, for CPU tensors.  ``fused_stem.launches`` counts
kernel launches.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..kernels import build

_PAD_TOP = 4  # halo(3) + conv1 pad(1) rows of the reference's x4 layout
_PAD_BOT = 4
BN_EPS = 1e-5


def space_to_depth4(x: torch.Tensor) -> torch.Tensor:
    """[B, H, W, C] -> [B, H/4, W/4, 16C], channel = (p*4 + q)*C + c."""
    b, h, w, c = x.shape
    x = x.reshape(b, h // 4, 4, w // 4, 4, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, h // 4, w // 4, 16 * c)


def depth_to_space4(x4: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`space_to_depth4`: [B, H/4, W/4, 16C] -> [B, H, W, C]."""
    b, h4, w4, c16 = x4.shape
    c = c16 // 16
    x = x4.reshape(b, h4, w4, 4, 4, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, h4 * 4, w4 * 4, c)


def pack_stem1_4to2(w: torch.Tensor) -> torch.Tensor:
    """stem1 [3, 3, C, Co] (stride 2, HWIO) -> [2, 2, 16C, 4Co]: conv1 seen
    through a 4x4-packed input and a 2x2-packed output, as the reference's
    kernel evaluates it.  W4[kh, kw, (pi*4+pj)*C + c, (oi*2+oj)*Co + co] =
    W[dy, dx, c, co] with dy = 4*kh + pi - 2*oi - 3 when 0 <= dy <= 2."""
    c, co = w.shape[2], w.shape[3]
    w_np = w.detach().float().cpu().numpy()
    w4 = np.zeros((2, 2, 4, 4, c, 2, 2, co), np.float32)
    for kh in range(2):
        for kw in range(2):
            for pi in range(4):
                for pj in range(4):
                    for oi in range(2):
                        for oj in range(2):
                            dy = 4 * kh + pi - 2 * oi - 3
                            dx = 4 * kw + pj - 2 * oj - 3
                            if 0 <= dy <= 2 and 0 <= dx <= 2:
                                w4[kh, kw, pi, pj, :, oi, oj, :] = w_np[dy, dx]
    return torch.from_numpy(w4.reshape(2, 2, 16 * c, 4 * co)).to(w.device, w.dtype)


@torch.no_grad()
def precompute_fused_stem(detector, dtype=torch.bfloat16) -> dict:
    """BN-folded stem weights for the kernel, from a float32 SCRFD module.

    Returns {"w1": [3, 3, 3, sw], "w2": [3, 3, sw, sw], "w3": [3, 3, sw,
    2sw]} in ``dtype`` (HWIO) and {"b1", "b2", "b3"} float32, on the
    module's device; in bf16 (stem width <= 32) also {"f1", "f2", "f3"}, the
    same weights in the tensor-core kernel's fragment order
    (:func:`pack_stem_fragments`).  The fold is the reference's, in f32:
    inv = scale / sqrt(var + eps), bias = beta - mean * inv, w = w * inv.
    It runs in numpy, whose f32 sqrt is correctly rounded as XLA's is (torch's
    vectorized CPU sqrt can differ in the last bit)."""
    backbone = detector.backbone
    out = {}
    for i, name in enumerate(("stem1", "stem2", "stem3")):
        layer = getattr(backbone, name)
        if layer.Conv_0.weight.dtype != torch.float32:
            raise TypeError("fold the stem from the float32 module, before any cast")
        bn = {k: v.detach().cpu().numpy() for k, v in layer.BatchNorm_0.state_dict().items()}
        w = layer.Conv_0.weight.detach().cpu().numpy().transpose(2, 3, 1, 0)  # OIHW -> HWIO
        inv = bn["weight"] / np.sqrt(bn["running_var"] + np.float32(BN_EPS))
        bias = bn["bias"] - bn["running_mean"] * inv
        dev = layer.Conv_0.weight.device
        out[f"w{i + 1}"] = torch.from_numpy(np.ascontiguousarray(w * inv)).to(dev, dtype)
        out[f"b{i + 1}"] = torch.from_numpy(bias.astype(np.float32)).to(dev)
    sw = backbone.stem1.Conv_0.out_channels
    if dtype == torch.bfloat16 and sw <= 32:
        out.update(pack_stem_fragments(out, sw))
    return out


def stem_channel_pad(stem_width: int) -> int:
    """CP, the channels a conv2/conv3 input pixel holds in the bf16 kernel:
    the stem width padded to 16 or 32 (one or two MMA k-steps a tap)."""
    if stem_width <= 0 or stem_width % 4 or stem_width > 32:
        raise ValueError(f"the bf16 kernel takes a stem width that is a multiple of 4 "
                         f"and at most 32, got {stem_width}")
    return 16 if stem_width <= 16 else 32


def _b_fragments(bmat: torch.Tensor) -> torch.Tensor:
    """[k-steps, 16, N] B matrices -> [k-steps, N/8, 32, 4]: lane l of
    mma.m16n8k16's B fragment for n-tile t holds B[k][8t + l/4] for
    k = 2(l%4), 2(l%4)+1, 2(l%4)+8, 2(l%4)+9."""
    ks, _, n = bmat.shape
    lane = torch.arange(32)[:, None]
    e = torch.arange(4)[None, :]
    k = 2 * (lane % 4) + e % 2 + 8 * (e // 2)
    col = (lane // 4).expand(32, 4)
    return bmat.reshape(ks, 16, n // 8, 8).permute(0, 2, 1, 3)[:, :, k, col]


@torch.no_grad()
def pack_stem_fragments(weights: dict, stem_width: int) -> dict:
    """The HWIO bf16 weights of :func:`precompute_fused_stem` in the order
    the tensor-core kernel reads them, zero-padded (``csrc/stem.cu``):

    - f1 [3, CP/8, 32, 4]: conv1, one k-step per kernel row ky, k = 4j + c
      for raw column 2ox + j (j < 4; j = 3 is zero) and channel c (c = 3 is
      zero); N = CP output channels (those past sw zero);
    - f2 [9*CP/16, CP/8, 32, 4]: conv2, k-step tap*(CP/16) + h, k the input
      channel 16h + k (zero past sw), N = CP;
    - f3 [9*CP/16, 2sw/8, 32, 4]: conv3, the same K, N = 2sw.
    """
    sw = int(stem_width)
    cp = stem_channel_pad(sw)
    w1, w2, w3 = (weights[f"w{i}"].float() for i in (1, 2, 3))
    dev = w1.device
    b1 = torch.zeros(3, 4, 4, cp, device=dev)  # [ky, j, c, n]
    b1[:, :3, :3, :sw] = w1
    b2 = torch.zeros(3, 3, cp, cp, device=dev)
    b2[:, :, :sw, :sw] = w2
    b3 = torch.zeros(3, 3, cp, 2 * sw, device=dev)
    b3[:, :, :sw, :] = w3
    out = {}
    for key, bmat in (("f1", b1.reshape(3, 16, cp)), ("f2", b2.reshape(9 * cp // 16, 16, cp)),
                      ("f3", b3.reshape(9 * cp // 16, 16, 2 * sw))):
        out[key] = _b_fragments(bmat.cpu()).to(dev, torch.bfloat16).contiguous()
    return out


def pad_packed_u8(x48: torch.Tensor) -> torch.Tensor:
    """[B, H4, W4, 48] u8 s2d4 frames -> the reference's padded u8 x4
    [B, H4+8, W4+1+right, 128] (cols to a multiple of 32, channels to 128)."""
    w4 = x48.shape[2]
    right = (-(w4 + 1)) % 32
    return F.pad(x48, (0, 128 - x48.shape[3], 1, right, _PAD_TOP, _PAD_BOT))


def prepare_input(frames_u8: torch.Tensor, dtype=torch.bfloat16) -> torch.Tensor:
    """[B, H, W, 3] u8 frames -> the reference's padded x4 stem input.

    ``dtype=torch.uint8`` keeps the bytes (the kernel preprocesses them);
    a float dtype preprocesses here, (x - 127.5) / 128, and pads with zero
    (cols to a multiple of 8)."""
    x = space_to_depth4(frames_u8)
    if dtype == torch.uint8:
        return pad_packed_u8(x)
    x = (x.to(dtype) - torch.tensor(127.5, dtype=dtype)) * torch.tensor(1.0 / 128.0, dtype=dtype)
    w4 = x.shape[2]
    right = (-(w4 + 1)) % 8
    return F.pad(x, (0, 128 - x.shape[3], 1, right, _PAD_TOP, _PAD_BOT))


def fused_stem_plain(x48: torch.Tensor, weights: dict, stem_width: int) -> torch.Tensor:
    """The plain PyTorch version: [B, H4, W4, 48] s2d4 frames (u8, or float
    already preprocessed) -> [B, H4, W4, 2*stem_width] in the weights'
    dtype.  f32 convolutions of the dtype-rounded operands, + bias, ReLU
    and a cast to the dtype after each conv; -inf-padded max-pool."""
    dtype = weights["w1"].dtype
    x = depth_to_space4(x48)
    if x.dtype == torch.uint8:
        x = (x.float() - 127.5) * (1.0 / 128.0)
    h = x.to(dtype).permute(0, 3, 1, 2).float()
    for i in (1, 2, 3):
        w = weights[f"w{i}"].float().permute(3, 2, 0, 1)  # HWIO -> OIHW
        h = F.conv2d(h, w, stride=2 if i == 1 else 1, padding=1)
        h = torch.relu(h + weights[f"b{i}"].view(1, -1, 1, 1)).to(dtype).float()
    assert h.shape[1] == 2 * stem_width
    h = F.max_pool2d(h, 3, 2, 1)
    return h.to(dtype).permute(0, 2, 3, 1).contiguous()


def fused_stem_s2d4(x48: torch.Tensor, weights: dict, stem_width: int) -> torch.Tensor:
    """K4 on unpadded s2d4 frames [B, H4, W4, 48] -> [B, H4, W4, 2*stem_width]
    NHWC in the weights' dtype (float32 or bfloat16)."""
    if x48.dim() != 4 or x48.shape[3] != 48:
        raise ValueError(f"x48 must be [B, H4, W4, 48], got {tuple(x48.shape)}")
    if x48.device.type == "cpu":
        return fused_stem_plain(x48, weights, stem_width)
    if x48.device.type != "cuda":
        raise ValueError(f"frames on {x48.device}")
    if x48.dtype != torch.uint8:
        raise TypeError(f"the kernel takes uint8 frames, got {x48.dtype}")
    dtype = weights["w1"].dtype
    if dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"weights dtype {dtype}")
    sw = int(stem_width)
    shapes = {"w1": (3, 3, 3, sw), "w2": (3, 3, sw, sw), "w3": (3, 3, sw, 2 * sw),
              "b1": (sw,), "b2": (sw,), "b3": (2 * sw,)}
    for key, shape in shapes.items():
        t = weights[key]
        want = torch.float32 if key[0] == "b" else dtype
        if (tuple(t.shape) != shape or t.dtype != want or t.device != x48.device
                or not t.is_contiguous() or t.data_ptr() % 16):
            raise ValueError(f"stem weight {key}: {tuple(t.shape)} {t.dtype} {t.device}, "
                             f"want {shape} {want} contiguous on {x48.device}")
    if sw % 4:
        raise ValueError(f"the kernel takes a stem width that is a multiple of 4, got {sw}")
    x48 = x48.contiguous()
    if x48.data_ptr() % 16:
        x48 = x48.clone()
    b, h4, w4, _ = x48.shape
    out = torch.empty((b, h4, w4, 2 * sw), dtype=dtype, device=x48.device)
    if out.numel() == 0:
        return out
    stream = torch.cuda.current_stream(x48.device).cuda_stream
    if dtype == torch.bfloat16:
        frags = weights if "f1" in weights else pack_stem_fragments(weights, sw)
        cp = stem_channel_pad(sw)
        for key, shape in (("f1", (3, cp // 8, 32, 4)), ("f2", (9 * cp // 16, cp // 8, 32, 4)),
                           ("f3", (9 * cp // 16, sw // 4, 32, 4))):
            t = frags[key]
            if (tuple(t.shape) != shape or t.dtype != dtype or t.device != x48.device
                    or not t.is_contiguous() or t.data_ptr() % 16):
                raise ValueError(f"stem fragments {key}: {tuple(t.shape)} {t.dtype}, want "
                                 f"{shape} bf16 contiguous on {x48.device}")
        with build.launch_device(x48.device):
            err = build.lib().fre_fused_stem_bf16(
                x48.data_ptr(), frags["f1"].data_ptr(), weights["b1"].data_ptr(),
                frags["f2"].data_ptr(), weights["b2"].data_ptr(), frags["f3"].data_ptr(),
                weights["b3"].data_ptr(), out.data_ptr(), b, h4, w4, sw, stream)
        build.check(err, "fre_fused_stem_bf16")
    else:
        with build.launch_device(x48.device):
            err = build.lib().fre_fused_stem(
                x48.data_ptr(), weights["w1"].data_ptr(), weights["b1"].data_ptr(),
                weights["w2"].data_ptr(), weights["b2"].data_ptr(), weights["w3"].data_ptr(),
                weights["b3"].data_ptr(), out.data_ptr(), b, h4, w4, sw, stream)
        build.check(err, "fre_fused_stem")
    fused_stem.launches += 1
    return out


def fused_stem(x4: torch.Tensor, weights: dict, w4: int, stem_width: int = 28) -> torch.Tensor:
    """The reference's signature: x4 is the padded [B, H4+8, >=W4+1, 128]
    output of :func:`prepare_input` / :func:`pad_packed_u8`; ``w4`` is the
    frame's W/4.  The real region is sliced out and run through K4 (uint8
    x4) or, for a float x4 on the CPU, through the plain version.

    Returns [B, H4, W4, 2*stem_width] NHWC in the weights' dtype."""
    h4 = x4.shape[1] - _PAD_TOP - _PAD_BOT
    x48 = x4[:, _PAD_TOP:_PAD_TOP + h4, 1:1 + w4, :48]
    if x4.dtype != torch.uint8:
        if x4.device.type != "cpu":
            raise TypeError("the kernel takes uint8 x4; a float x4 runs only the "
                            "plain version, on the CPU")
        return fused_stem_plain(x48, weights, stem_width)
    return fused_stem_s2d4(x48.contiguous(), weights, stem_width)


fused_stem.launches = 0
