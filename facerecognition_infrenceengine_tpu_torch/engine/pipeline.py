"""The fused recognition pipeline: frames -> [B, max_faces] detections ->
aligned crops -> L2-normalized embeddings.

The torch form of ``facerecognition_infrenceengine_tpu/engine/pipeline.py``
on the raw-RGB path: SCRFD forward -> sigmoid -> decode -> masked top-k ->
greedy NMS into ``max_faces`` fixed slots, then Umeyama -> pyramid atlas ->
ROI -> K3 warp -> IResNet -> L2 normalize, with every shape static per
batch size.  ``detect_align_embed_flat`` packs the outputs into one
[B, F, 528] tensor (boxes 4 | score 1 | kps 10 | valid 1 | emb 512).

Convolutions and the embedder's dense layer run through PyTorch (cuDNN /
cuBLAS on the card), as the reference left them to XLA; the face warp runs
the hand-written kernel K3.  On the card the f32 path stays true f32:
``core.device.resolve_device`` switches TF32 off for cuDNN and cuBLAS.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..core.config import EngineConfig
from ..core.device import resolve_device
from ..models import arcface, scrfd
from ..models.weights import load_or_init
from ..ops.align import ARCFACE_DST
from ..ops.anchors import all_anchor_centers
from ..ops.boxes import distance2bbox, distance2kps
from ..ops.matching import l2_normalize
from ..ops.nms import nms_padded
from ..ops.warp2pass import warp_faces_two_pass


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


class FaceEngine:
    """Owns the detector and embedder and runs the pipeline on one device.

    Weights come from ``<FRE_WEIGHTS_DIR>/scrfd_<det_arch>.npz`` and
    ``arcface_<rec_arch>.npz`` when present, else the reference's synthetic
    weights for ``seed`` (detector) and ``seed + 1`` (embedder).
    """

    def __init__(self, cfg: EngineConfig | None = None, det_arch: str = "det_10g",
                 rec_arch: str = "r50", seed: int = 0, device=None):
        self.cfg = cfg or EngineConfig()
        self.device = resolve_device(device)
        self.dtype = torch.bfloat16 if self.cfg.dtype == "bfloat16" else torch.float32
        if rec_arch not in ("r50", "r18"):
            raise NotImplementedError(
                f"rec_arch {rec_arch!r}: only r50/r18 are ported "
                "(MobileFaceNet is ROADMAP Queue 1 item 11)")
        h, w = self.cfg.det_size
        detector = load_or_init(f"scrfd_{det_arch}", scrfd.SCRFD(scrfd.CONFIGS[det_arch]), seed)
        embedder = load_or_init(f"arcface_{rec_arch}", arcface.iresnet50() if rec_arch == "r50"
                                else arcface.iresnet18(), seed + 1)
        fmt = torch.channels_last if self.device.type == "cuda" else torch.contiguous_format
        self.detector = detector.to(self.device, self.dtype, memory_format=fmt)
        self.embedder = embedder.to(self.device, self.dtype, memory_format=fmt)
        self._centers = all_anchor_centers(h, w, device=self.device)
        self._strides = torch.from_numpy(_stride_rows(h, w)).to(self.device)
        self._dst = torch.from_numpy(ARCFACE_DST * (self.cfg.embed_size / 112.0)).to(self.device)

    # -------------------------------------------------------------- programs
    def _detect_impl(self, frames_u8: torch.Tensor, det_threshold: float):
        logits, bbox, kps = self.detector(scrfd.preprocess(frames_u8))
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

    # ------------------------------------------------------------- host API
    def _to_device(self, array) -> torch.Tensor:
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
