"""The fused recognition pipeline: frames -> [B, max_faces] detections ->
aligned crops -> L2-normalized embeddings.

The torch form of ``facerecognition_infrenceengine_tpu/engine/pipeline.py``:
SCRFD forward -> sigmoid -> decode -> masked top-k -> greedy NMS into
``max_faces`` fixed slots, then Umeyama -> pyramid atlas -> K3 warp (each
face's ROI window read straight from the atlas) -> IResNet -> L2 normalize,
with every shape static per batch size.
``detect_align_embed_flat`` packs the outputs into one [B, F, 528] tensor
(boxes 4 | score 1 | kps 10 | valid 1 | emb 512).

Two input contracts: raw RGB canvases [B, H, W, 3], and the streaming wire
formats -- s2d4-packed RGB [B, H/4, W/4, 48] (``detect_align_embed_packed``)
and packed yuv420 content rows [B, rows, W/4, 24]
(``detect_align_embed_yuv420(_flat)``), which one constant mix
(``ops/yuv.py``) turns into packed RGB.  ``EngineConfig.packed_stem_impl``
picks the packed programs' stem: "unpack" undoes the s2d4 layout and runs
the raw program; "pallas" runs K4, the fused stem kernel
(``ops/stem_kernel.py``), on the packed frames, the backbone from its
output, and warps from a packed pyramid atlas.  ``stem_kernel="on"`` runs
K4 on the raw path too.

Convolutions and the embedder's dense layer run through PyTorch (cuDNN /
cuBLAS on the card), as the reference left them to XLA; the stem (K4), the
face warp (K3) and the gallery top-1 (K1 / K2) are hand-written kernels.  On
the card the f32 path stays true f32: ``core.device.resolve_device``
switches TF32 off for cuDNN and cuBLAS.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np
import torch

from .. import native
from ..core.config import EngineConfig
from ..core.device import resolve_device
from ..models import arcface, genderage, landmark106, scrfd
from ..models.layers import cast_keep_bn_f32
from ..models.weights import flatten_tree, load_or_init, load_tree, weights_dir
from ..ops.align import ARCFACE_DST
from ..ops.anchors import all_anchor_centers
from ..ops.boxes import distance2bbox, distance2kps
from ..ops.matching import l2_normalize
from ..ops.nms import nms_padded
from ..ops.stem_kernel import depth_to_space4, fused_stem_s2d4, precompute_fused_stem
from ..ops.stem_kernel import space_to_depth4
from ..ops.warp2pass import boxes_to_affines, build_atlas, warp_boxes_two_pass
from ..ops.warp2pass import warp_faces_two_pass, warp_faces_two_pass_packed
from ..ops.yuv import yuv420p4_to_rgbp4

# YUV black (Y = 0, U = V = 128) for canvas rows a yuv420 pack does not
# carry: zero chroma would decode green
_YUV_BLACK = (0,) * 16 + (128,) * 8


def _stride_rows(height: int, width: int) -> np.ndarray:
    """Per-anchor-row stride multiplier, in all_anchor_centers order."""
    parts = []
    for s in scrfd.STRIDES:
        n = (height // s) * (width // s) * scrfd.NUM_ANCHORS
        parts.append(np.full(n, float(s), np.float32))
    return np.concatenate(parts)


def bucket(n: int, buckets=(1, 2, 4, 8, 16, 32, 64, 128, 256)) -> int:
    """Round up to the nearest standard batch shape."""
    for b in buckets:
        if n <= b:
            return b
    return ((n + buckets[-1] - 1) // buckets[-1]) * buckets[-1]


@dataclass
class DetectionBatch:
    """Host-side view of the detect program's fixed-shape outputs."""

    boxes: np.ndarray  # [B, F, 4] canvas coords, xyxy
    scores: np.ndarray  # [B, F]
    kps: np.ndarray  # [B, F, 5, 2] canvas coords
    valid: np.ndarray  # [B, F] bool


def _from_variables(name: str, model, variables, seed: int):
    """A flax variable tree (nested dicts of arrays: ``params``,
    ``batch_stats`` and any derived collections, which are ignored) loaded
    into ``model``; with none, ``load_or_init``."""
    if variables is None:
        return load_or_init(name, model, seed)
    flat = flatten_tree({k: v for k, v in variables.items() if k in ("params", "batch_stats")})
    return load_tree(model, flat)


class FaceEngine:
    """Owns the detector and embedder and runs the pipeline on one device.

    Weights come from ``det_variables`` / ``rec_variables`` (the reference
    engine's flax variable trees, converted by ``models/weights.from_flax``;
    its derived collections -- ``stem_pallas``, ``packed_stem``,
    ``packed_stem_s2d4``, ``int8`` -- are ignored and K4's fold is recomputed
    from ``params`` + ``batch_stats``), else from
    ``<FRE_WEIGHTS_DIR>/scrfd_<det_arch>.npz`` and ``arcface_<rec_arch>.npz``
    when present, else the reference's synthetic weights for ``seed``
    (detector) and ``seed + 1`` (embedder).  The attribute heads load at the
    first ``attributes`` call.
    """

    def __init__(self, cfg: EngineConfig | None = None, det_variables=None, rec_variables=None,
                 det_arch: str = "det_10g", rec_arch: str = "r50", seed: int = 0, device=None):
        self.cfg = cfg or EngineConfig()
        self.device = resolve_device(device)
        self.dtype = torch.bfloat16 if self.cfg.dtype == "bfloat16" else torch.float32
        if rec_arch not in ("r50", "r18"):
            raise NotImplementedError(
                f"rec_arch {rec_arch!r}: only r50/r18 are ported "
                "(MobileFaceNet is ROADMAP Queue 1 item 4)")
        h, w = self.cfg.det_size
        detector = _from_variables(f"scrfd_{det_arch}", scrfd.SCRFD(scrfd.CONFIGS[det_arch]),
                                   det_variables, seed)
        embedder = _from_variables(f"arcface_{rec_arch}", arcface.iresnet50()
                                   if rec_arch == "r50" else arcface.iresnet18(),
                                   rec_variables, seed + 1)
        # K4's BN-folded stem weights, folded from the float32 module before
        # the cast (the reference folds from its float32 variables)
        self.stem_width = detector.cfg.stem_width
        self.stem_weights = {k: v.to(self.device) for k, v in
                             precompute_fused_stem(detector, self.dtype).items()}
        # "auto" turns the raw-path stem kernel on only on a TPU in the
        # reference: off here
        self._stem_kernel_raw = self.cfg.stem_kernel == "on"
        # BatchNorm stays float32 in a bf16 engine, as the reference's
        fmt = torch.channels_last if self.device.type == "cuda" else torch.contiguous_format
        self.detector = cast_keep_bn_f32(detector, self.device, self.dtype, fmt)
        self.embedder = cast_keep_bn_f32(embedder, self.device, self.dtype, fmt)
        self._centers = all_anchor_centers(h, w, device=self.device)
        self._strides = torch.from_numpy(_stride_rows(h, w)).to(self.device)
        self._dst = torch.from_numpy(ARCFACE_DST * (self.cfg.embed_size / 112.0)).to(self.device)
        self._attr_models = None  # (genderage, landmark106), at first use

    # -------------------------------------------------------------- programs
    def _detect_impl(self, frames_u8: torch.Tensor, det_threshold: float):
        h, w = int(frames_u8.shape[1]), int(frames_u8.shape[2])
        if (self._stem_kernel_raw and frames_u8.dtype == torch.uint8
                and h % 4 == 0 and w % 4 == 0 and ((h // 4) % 16 == 0 or h // 4 <= 64)):
            # K4 from raw frames: pack on the device, then the fused stem
            stem_out = fused_stem_s2d4(space_to_depth4(frames_u8).contiguous(),
                                       self.stem_weights, self.stem_width)
            logits, bbox, kps = self.detector(None, stem_out=stem_out)
        else:
            logits, bbox, kps = self.detector(scrfd.preprocess(frames_u8))
        return self._decode_nms(logits, bbox, kps, det_threshold)

    def _detect_packed_impl(self, frames_p4: torch.Tensor, det_threshold: float):
        """Detect from s2d4-packed u8 frames [B, H/4, W/4, 48]: "unpack" runs
        the raw program on the unpacked frames; "pallas" runs K4 on the
        packed frames and the backbone from its output."""
        if self.cfg.packed_stem_impl == "unpack":
            return self._detect_impl(depth_to_space4(frames_p4), det_threshold)
        stem_out = fused_stem_s2d4(frames_p4, self.stem_weights, self.stem_width)
        logits, bbox, kps = self.detector(None, stem_out=stem_out)
        return self._decode_nms(logits, bbox, kps, det_threshold)

    def _decode_nms(self, logits, bbox, kps, det_threshold: float):
        """sigmoid -> decode -> masked top-k -> greedy NMS at fixed
        [B, max_faces] capacity."""
        cfg = self.cfg
        scores = torch.sigmoid(logits[..., 0])  # [B, A]
        boxes = distance2bbox(self._centers, bbox * self._strides[None, :, None])
        points = distance2kps(self._centers, kps * self._strides[None, :, None])
        scores = torch.where(scores >= det_threshold, scores,
                             torch.tensor(float("-inf"), device=scores.device))
        # top-k with the lowest index first on ties (lax.top_k's order); the
        # -inf candidates never become valid slots.
        top_s, top_i = torch.sort(scores, dim=1, descending=True, stable=True)
        top_s, top_i = top_s[:, :cfg.pre_nms_topk], top_i[:, :cfg.pre_nms_topk]
        cand = torch.gather(boxes, 1, top_i[..., None].expand(-1, -1, 4))
        ob, osc, oidx, valid = nms_padded(cand, top_s, max_out=cfg.max_faces,
                                          iou_thresh=cfg.nms_iou)
        keep = torch.gather(top_i, 1, oidx.long())
        okps = torch.gather(points, 1, keep[..., None, None].expand(-1, -1, 5, 2))
        okps = torch.where(valid[..., None, None], okps, torch.zeros_like(okps))
        return ob, osc, okps, valid

    def _embed_impl(self, frames_u8, frame_idx, kps):
        crops = warp_faces_two_pass(frames_u8, frame_idx, kps, self.cfg.embed_size,
                                    dst=self._dst)
        return l2_normalize(self.embedder(arcface.preprocess(crops)))

    def _embed_crops_impl(self, crops):
        return l2_normalize(self.embedder(arcface.preprocess(crops)))

    def _fused_impl(self, frames_u8, det_threshold: float):
        """detect -> align -> embed at fixed [B, max_faces]."""
        boxes, scores, kps, valid = self._detect_impl(frames_u8, det_threshold)
        b, f = valid.shape
        frame_idx = torch.arange(b, device=self.device).repeat_interleave(f)
        emb = self._embed_impl(frames_u8, frame_idx, kps.reshape(b * f, 5, 2))
        return boxes, scores, kps, valid, emb.reshape(b, f, -1)

    def _fused_packed_impl(self, frames_p4, det_threshold: float):
        """Packed detect -> align -> embed.  "unpack" is the raw program on
        the unpacked frames (outputs identical to ``detect_align_embed`` on
        the same pixels); "pallas" warps from the packed pyramid atlas."""
        if self.cfg.packed_stem_impl == "unpack":
            return self._fused_impl(depth_to_space4(frames_p4), det_threshold)
        boxes, scores, kps, valid = self._detect_packed_impl(frames_p4, det_threshold)
        b, f = valid.shape
        frame_idx = torch.arange(b, device=self.device).repeat_interleave(f)
        crops = warp_faces_two_pass_packed(frames_p4, frame_idx, kps.reshape(b * f, 5, 2),
                                           self.cfg.embed_size, dst=self._dst)
        emb = l2_normalize(self.embedder(arcface.preprocess(crops)))
        return boxes, scores, kps, valid, emb.reshape(b, f, -1)

    def _fused_yuv_impl(self, frames_y24, det_threshold: float):
        """The yuv420 transport: re-pad the content rows to the canvas with
        YUV black, mix to packed RGB, then the packed program."""
        dh = self.cfg.det_size[0] // 4
        b, rows, w4, _ = frames_y24.shape
        if rows < dh:
            black = torch.tensor(_YUV_BLACK, dtype=torch.uint8, device=frames_y24.device)
            frames_y24 = torch.cat([frames_y24, black.expand(b, dh - rows, w4, 24)], dim=1)
        return self._fused_packed_impl(yuv420p4_to_rgbp4(frames_y24), det_threshold)

    def _ensure_attr_models(self):
        """buffalo_l's genderage and 2d106det heads, loaded at first use so the
        recognition path never pays for them: the synthetic heads
        (``load_or_init`` seeds 7 and 8, as the reference's) in the engine's
        dtype, BatchNorm kept f32.  Converted ONNX heads in the weights dir
        (the reference's exact-graph executor) are not ported: they raise
        rather than be replaced by the synthetic heads."""
        if self._attr_models is None:
            onnx = [os.path.join(weights_dir(), f) for f in ("attr_genderage.onnx",
                                                            "attr_2d106det.onnx")]
            if all(os.path.exists(p) for p in onnx):
                raise NotImplementedError(
                    f"{onnx}: the exact-graph attribute executor (models/onnx_exec.py + "
                    "onnxlite.py) is ROADMAP Queue 1 item 3")
            fmt = torch.channels_last if self.device.type == "cuda" else torch.contiguous_format
            self._attr_models = tuple(
                cast_keep_bn_f32(load_or_init(name, model, seed), self.device, self.dtype, fmt)
                for name, model, seed in (("genderage", genderage.GenderAge(), 7),
                                          ("landmark_2d_106", landmark106.Landmark106(), 8)))
        return self._attr_models

    def _attributes_impl(self, frames_u8, frame_idx, bboxes):
        """Gender, age and 106 landmarks of M boxes (frame coordinates): the
        square window of side max(w, h) * 1.5 around each box, resampled by
        K3 to each head's input size; gender = argmax(out[:2]), age =
        round(out[2] * 100), landmarks (out + 1) * size / 2 mapped back
        through the crop's affine."""
        ga_model, lm_model = self._ensure_attr_models()
        ga_size, lm_size = genderage.INPUT_SIZE, landmark106.INPUT_SIZE
        atlas = build_atlas(frames_u8)  # one pyramid for both crop sizes
        ga_out = ga_model(genderage.preprocess(warp_boxes_two_pass(
            frames_u8, frame_idx, bboxes, ga_size, scale_factor=1.5, atlas=atlas)))
        lm = lm_model(genderage.preprocess(warp_boxes_two_pass(
            frames_u8, frame_idx, bboxes, lm_size, scale_factor=1.5, atlas=atlas)))
        gender = torch.argmax(ga_out[:, :2], dim=1)
        age = torch.round(ga_out[:, 2] * 100.0)
        lm_px = (lm + 1.0) * (lm_size / 2.0)
        m_inv = boxes_to_affines(bboxes, lm_size, 1.5)
        lm_src = torch.einsum("mij,mkj->mki", m_inv[:, :, :2], lm_px) + m_inv[:, None, :, 2]
        return gender.to(torch.int32), age.float(), lm_src

    @staticmethod
    def _flatten_fused_outputs(outs) -> torch.Tensor:
        """Pack the five fused outputs into one [B, F, 528] float32 tensor
        (boxes 4 | score 1 | kps 10 | valid 1 | emb 512): one transfer."""
        boxes, scores, kps, valid, emb = outs
        b, f = valid.shape
        return torch.cat([boxes.float(), scores[..., None].float(),
                          kps.reshape(b, f, 10).float(), valid[..., None].float(),
                          emb.float()], dim=-1)

    def _fused_flat_impl(self, frames_u8, det_threshold: float):
        return self._flatten_fused_outputs(self._fused_impl(frames_u8, det_threshold))

    def _fused_yuv_flat_impl(self, frames_y24, det_threshold: float):
        return self._flatten_fused_outputs(self._fused_yuv_impl(frames_y24, det_threshold))

    # ------------------------------------------------------------- host API
    def _to_device(self, array) -> torch.Tensor:
        """A host array, or a tensor already uploaded, on the engine's device."""
        if isinstance(array, torch.Tensor):
            return array.to(self.device)
        return torch.as_tensor(np.asarray(array)).to(self.device)

    @torch.inference_mode()
    def detect(self, frames_u8, det_threshold: float = 0.3) -> DetectionBatch:
        """frames_u8: [B, H, W, 3] RGB uint8 at the det canvas size."""
        outs = self._detect_impl(self._to_device(frames_u8), det_threshold)
        return DetectionBatch(*(o.cpu().numpy() for o in outs))

    @torch.inference_mode()
    def embed_faces(self, frames_u8, frame_idx, kps) -> np.ndarray:
        """Embed M faces of a batch of frames.

        frames_u8 [B, H, W, 3] RGB uint8; frame_idx [M]; kps [M, 5, 2].
        Returns [M, 512] float32 L2-normalized embeddings.
        """
        m = len(frame_idx)
        if m == 0:
            return np.zeros((0, self.cfg.embed_dim), np.float32)
        mb = bucket(m)
        pad_idx = np.zeros(mb, np.int64)
        pad_idx[:m] = frame_idx
        pad_kps = np.tile(ARCFACE_DST[None], (mb, 1, 1))
        pad_kps[:m] = kps
        emb = self._embed_impl(self._to_device(frames_u8), self._to_device(pad_idx),
                               self._to_device(pad_kps))
        return emb.cpu().numpy()[:m]

    @torch.inference_mode()
    def attributes(self, frames_u8, frame_idx, bboxes):
        """Gender [M] int32, age [M] float32 and landmark_2d_106 [M, 106, 2]
        of M boxes; frames_u8 [B, H, W, 3] RGB uint8 (host or device), boxes
        in its coordinates.  M is padded to ``bucket(M)`` with [0, 0, 32, 32]
        boxes of frame 0, as the reference pads it."""
        m = len(frame_idx)
        if m == 0:
            return (np.zeros(0, np.int32), np.zeros(0, np.float32),
                    np.zeros((0, 106, 2), np.float32))
        mb = bucket(m)
        pad_idx = np.zeros(mb, np.int64)
        pad_idx[:m] = frame_idx
        pad_boxes = np.tile(np.array([0, 0, 32, 32], np.float32)[None], (mb, 1))
        pad_boxes[:m] = bboxes
        outs = self._attributes_impl(self._to_device(frames_u8), self._to_device(pad_idx),
                                     self._to_device(pad_boxes))
        return tuple(o.cpu().numpy()[:m] for o in outs)

    @torch.inference_mode()
    def embed_crops(self, crops_u8) -> np.ndarray:
        """Embed pre-aligned 112x112 crops [M, 112, 112, 3]."""
        m = len(crops_u8)
        if m == 0:
            return np.zeros((0, self.cfg.embed_dim), np.float32)
        pad = np.zeros((bucket(m),) + tuple(crops_u8.shape[1:]), crops_u8.dtype)
        pad[:m] = crops_u8
        return self._embed_crops_impl(self._to_device(pad)).cpu().numpy()[:m]

    @torch.inference_mode()
    def detect_align_embed(self, frames_u8, det_threshold: float = 0.3):
        """Fused fixed-capacity variant: device tensors (boxes, scores, kps,
        valid, emb)."""
        return self._fused_impl(self._to_device(frames_u8), det_threshold)

    @torch.inference_mode()
    def detect_align_embed_flat(self, frames_u8, det_threshold: float = 0.3) -> torch.Tensor:
        """Serving variant: one [B, F, 528] device tensor."""
        return self._fused_flat_impl(self._to_device(frames_u8), det_threshold)

    def _has_packed_stem(self) -> bool:
        """Whether the packed-input programs can run: "unpack" needs nothing
        extra, "pallas" the fused-stem weights."""
        return self.cfg.packed_stem_impl == "unpack" or bool(self.stem_weights)

    @staticmethod
    def pack_frames(frames_u8) -> np.ndarray:
        """Host-side s2d4 pack: [B, H, W, 3] u8 -> [B, H/4, W/4, 48]."""
        return np.stack([native.pack_s2d4(frame) for frame in np.asarray(frames_u8)])

    @torch.inference_mode()
    def detect_align_embed_packed(self, frames_p4_u8, det_threshold: float = 0.3):
        """Fused program on s2d4-packed u8 frames [B, H/4, W/4, 48]: device
        tensors (boxes, scores, kps, valid, emb)."""
        return self._fused_packed_impl(self._to_device(frames_p4_u8), det_threshold)

    @torch.inference_mode()
    def detect_align_embed_yuv420(self, frames_y24_u8, det_threshold: float = 0.3):
        """Fused program on packed-yuv420 frames [B, rows <= H/4, W/4, 24]
        (the streaming wire format, 1.5 B/px): same outputs as
        ``detect_align_embed`` up to the 4:2:0 chroma subsampling."""
        return self._fused_yuv_impl(self._to_device(frames_y24_u8), det_threshold)

    @torch.inference_mode()
    def detect_align_embed_yuv420_flat(self, frames_y24_u8,
                                       det_threshold: float = 0.3) -> torch.Tensor:
        """Serving variant of ``detect_align_embed_yuv420``: one [B, F, 528]
        device tensor."""
        return self._fused_yuv_flat_impl(self._to_device(frames_y24_u8), det_threshold)
