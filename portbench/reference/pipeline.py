"""The plain reference: what the served path has to produce, in float32.

Built only from this directory: the frozen copies of the port's plain model
definitions and ops beside this file, in float32 with TF32 off, no kernel,
no batching, no cache.  It takes the same weights the benchmark hands the
port (flat flax trees of numpy arrays) and the same BGR camera frames, and
works out again everything the port's set-up or its clients derive from
them: the canvas (a 640x480 frame lies at the top-left of the zero canvas,
scale 1), the yuv420 packs and their decode, the attribute heads' synthetic
leaves (seeds 7 and 8), the int8 gallery and the per-frame query scale.

``fp8=True`` is the benchmark's control: the same reference with every conv
and dense input and weight rounded to float8 e4m3 (one scale a tensor), the
precision below the configuration's bfloat16.

``detect_probe`` and ``attributes_probe`` are the yardsticks of the
models' own conditioning: the float32 detector (heads) with the conv and
dense weights rounded to the configuration's bfloat16.  A random-weight
detector moves its outputs under rounding by an amount that varies
twentyfold from seed to seed (and the heads' landmarks with the boxes they
crop), so the served outputs are measured in units of what this rounding
alone moves them.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import spec
from . import arcface, codec, genderage, landmark106, scrfd, warp, yuv
from .align import ARCFACE_DST
from .anchors import all_anchor_centers
from .boxes import distance2bbox, distance2kps
from .matching import l2_normalize
from .nms import nms_padded
from .weights import load_tree, synthetic_tree

FP8_MAX = 448.0  # float8 e4m3's largest finite value


def fp8_round(t: torch.Tensor) -> torch.Tensor:
    """``t`` through float8 e4m3 and back, with one scale for the tensor."""
    scale = torch.clamp(t.detach().abs().max().float(), min=1e-12) / FP8_MAX
    return ((t.float() / scale).to(torch.float8_e4m3fn).float() * scale).to(t.dtype)


def bf16_round(t: torch.Tensor) -> torch.Tensor:
    """``t`` through bfloat16 and back."""
    return t.bfloat16().to(t.dtype)


def _rounded(model: torch.nn.Module, fn) -> None:
    """Round every conv and dense weight once, and every input at each call,
    by ``fn``."""
    for mod in model.modules():
        if isinstance(mod, (torch.nn.Conv2d, torch.nn.Linear)):
            mod.weight.data = fn(mod.weight.data)
            mod.register_forward_pre_hook(lambda _m, args: (fn(args[0]),) + args[1:])


def _bf16_weights(flat: dict) -> dict:
    """The conv and dense kernels rounded to bfloat16 (biases, BatchNorm and
    scales as they are)."""
    return {k: (torch.from_numpy(np.ascontiguousarray(v)).bfloat16().float().numpy()
                if k.endswith("/kernel") else v) for k, v in flat.items()}


def _module(make, flat: dict, device) -> torch.nn.Module:
    """``make()`` built without allocating, then loaded from ``flat`` on
    ``device`` in float32."""
    with torch.device("meta"):
        model = make()
    model = model.to_empty(device="cpu")
    load_tree(model, flat)
    return model.to(device).eval()


def embedder_factory(rec: dict):
    """The embedder at the widths the configuration's ``recognizer``
    states; ``build`` raises ``ValueError`` where the file states a width
    that its module fixes.  The port loads the weights drawn for this
    module, so a stated width that is not the port's fails the run.  The
    module is ``reference/embedders/<arch>.py``'s (found by
    ``spec.embedder``; ``ValueError`` where there is none)."""
    mod = spec.embedder(rec["arch"])
    return lambda: mod.build(rec)


HEADS = {"genderage": (genderage, genderage.GenderAge, 7),
         "landmark_2d_106": (landmark106, landmark106.Landmark106, 8)}


def head_factory(name: str, head: dict):
    """An attribute head as the configuration states it (its input side and
    stage widths), checked against the frozen module, which fixes them."""
    module, make, _ = HEADS[name]
    if (head["input"], tuple(head["widths"])) != (module.INPUT_SIZE, tuple(module.WIDTHS)):
        raise ValueError(f"{name}: the file states input {head['input']} and widths "
                         f"{head['widths']}, the head is {module.INPUT_SIZE} and {module.WIDTHS}")
    return make


def detector_factory(det: dict):
    cfg = scrfd.SCRFDConfig(stem_width=det["stem_width"], stage_blocks=tuple(det["stage_blocks"]),
                            stage_planes=tuple(det["stage_planes"]), neck_width=det["neck_width"],
                            head_width=det["head_width"], head_depth=det["head_depth"])
    return lambda: scrfd.SCRFD(cfg)


def canvas_of(frame_bgr: np.ndarray, canvas_hw, transport: str) -> np.ndarray:
    """The detector canvas the port serves a BGR frame on (RGB, the frame at
    the top-left of a zero canvas at scale 1).  The yuv420 transport first
    packs the frame's content rows as the host codec does and decodes them
    as the device mix does: the 4:2:0 chroma loss included."""
    dh, dw = canvas_hw
    h, w = frame_bgr.shape[:2]
    if min(dh / h, dw / w) != 1.0:
        raise ValueError("the reference serves frames at letterbox scale 1 only")
    rgb = np.ascontiguousarray(frame_bgr[..., ::-1])
    canvas = np.zeros((dh, dw, 3), np.uint8)
    if transport == "yuv420":
        rows = min(-(-h // 4) * 4, dh)
        if (h, w) == (rows, dw):  # the letterbox onto (rows, dw) is the identity
            pack = codec.pack_yuv420_s2d4_plain(rgb)
        else:
            pack = codec.letterbox_yuv420_s2d4_plain(rgb, rows, dw)[0]
        decoded = yuv.yuv420p4_to_rgb_host(pack)
        canvas[:decoded.shape[0]] = decoded
    else:
        canvas[:h, :w] = rgb
    return canvas


class Reference:
    """The served path in plain float32 (or, with ``fp8``, the control;
    with ``bf16``, the witness of what rounding to bfloat16 moves)."""

    def __init__(self, config: dict, det_flat: dict, rec_flat: dict, device, fp8: bool = False,
                 bf16: bool = False):
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.device = torch.device(device)
        self.cfg = config
        h, w = config["canvas"]
        self.detector = _module(detector_factory(config["detector"]), det_flat, self.device)
        self._det_flat = det_flat
        self._probe = self._probe_heads = None
        self.embedder = None if rec_flat is None else _module(
            embedder_factory(config["recognizer"]), rec_flat, self.device)
        self.heads = self._heads() if config.get("attribute_heads") else None
        for on, fn in ((fp8, fp8_round), (bf16, bf16_round)):
            if on:
                for m in (self.detector, self.embedder) + (self.heads or ()):
                    if m is not None:
                        _rounded(m, fn)
        self._centers = all_anchor_centers(h, w, device=self.device)
        strides = [np.full((h // s) * (w // s) * scrfd.NUM_ANCHORS, float(s), np.float32)
                   for s in scrfd.STRIDES]
        self._strides = torch.from_numpy(np.concatenate(strides)).to(self.device)
        self._dst = torch.from_numpy(ARCFACE_DST * (config["embed_size"] / 112.0)).to(self.device)

    def _heads(self, round_bf16: bool = False) -> tuple:
        """genderage and 2d106det with the port's synthetic leaves (seeds 7
        and 8), worked out again here."""
        heads = []
        for name in ("genderage", "landmark_2d_106"):
            make = head_factory(name, self.cfg["attribute_heads"][name])
            with torch.device("meta"):
                leaves = synthetic_tree(make(), HEADS[name][2])
            heads.append(_module(make, _bf16_weights(leaves) if round_bf16 else leaves,
                                 self.device))
        return tuple(heads)

    def attributes_probe(self, canvases: np.ndarray, frame_idx: np.ndarray,
                         boxes: np.ndarray) -> tuple:
        """``attributes`` by the heads with bf16-rounded weights."""
        if self._probe_heads is None:
            self._probe_heads = self._heads(round_bf16=True)
        own, self.heads = self.heads, self._probe_heads
        try:
            return self.attributes(canvases, frame_idx, boxes)
        finally:
            self.heads = own

    def detect_probe(self, canvases: np.ndarray) -> dict:
        """``detect`` by the detector with bf16-rounded weights."""
        if self._probe is None:
            self._probe = Reference(dict(self.cfg, attribute_heads=None),
                                    _bf16_weights(self._det_flat), None, self.device)
        return self._probe.detect(canvases)

    @torch.inference_mode()
    def detect(self, canvases: np.ndarray) -> dict:
        """Canvases [B, H, W, 3] RGB u8 -> the fixed slots (boxes, scores,
        kps, valid), the pre-NMS candidates (top-k boxes, scores, kps and
        their anchors' centers) and every anchor's box, kps and score, all
        numpy: sigmoid, decode, a stable descending top-k and greedy NMS as
        the port's engine does them."""
        cfg = self.cfg
        x = scrfd.preprocess(torch.from_numpy(canvases).to(self.device))
        logits, bbox, kps = self.detector(x)
        scores = torch.sigmoid(logits[..., 0])
        boxes = distance2bbox(self._centers, bbox * self._strides[None, :, None])
        points = distance2kps(self._centers, kps * self._strides[None, :, None])
        scores = scores.masked_fill(~(scores >= cfg["det_thresh"]), float("-inf"))
        top_s, top_i = torch.sort(scores, dim=1, descending=True, stable=True)
        top_s, top_i = top_s[:, :cfg["pre_nms_topk"]], top_i[:, :cfg["pre_nms_topk"]]
        cand = torch.gather(boxes, 1, top_i[..., None].expand(-1, -1, 4))
        cand_centers = self._centers[top_i]
        cand_kps = torch.gather(points, 1, top_i[..., None, None].expand(-1, -1, 5, 2))
        ob, osc, oidx, valid = nms_padded(cand, top_s, max_out=cfg["max_faces"],
                                          iou_thresh=cfg["nms_iou"])
        keep = torch.gather(top_i, 1, oidx.long())
        okps = torch.gather(points, 1, keep[..., None, None].expand(-1, -1, 5, 2))
        okps = torch.where(valid[..., None, None], okps, torch.zeros_like(okps))
        out = dict(boxes=ob, scores=osc, kps=okps, valid=valid, cand_boxes=cand,
                   cand_scores=top_s, cand_kps=cand_kps, cand_centers=cand_centers,
                   all_boxes=boxes, all_kps=points, all_scores=torch.sigmoid(logits[..., 0]))
        return {k: v.cpu().numpy() for k, v in out.items()}

    @torch.inference_mode()
    def embed(self, canvases: np.ndarray, frame_idx: np.ndarray, kps: np.ndarray) -> np.ndarray:
        """Unit embeddings [M, D] of the faces at landmarks ``kps`` [M, 5, 2]
        (canvas coordinates) of ``canvases[frame_idx]``."""
        frames = torch.from_numpy(canvases).to(self.device)
        crops = warp.warp_faces_two_pass(frames, torch.from_numpy(frame_idx).to(self.device),
                                         torch.from_numpy(kps).float().to(self.device),
                                         self.cfg["embed_size"], dst=self._dst)
        return l2_normalize(self.embedder(arcface.preprocess(crops))).cpu().numpy()

    @torch.inference_mode()
    def attributes(self, canvases: np.ndarray, frame_idx: np.ndarray,
                   boxes: np.ndarray) -> tuple:
        """The heads on ``boxes`` [M, 4]: (gender logits [M, 2], age as the
        head gives it x 100 [M], landmarks [M, 106, 2] in canvas pixels)."""
        ga, lm_model = self.heads
        frames = torch.from_numpy(canvases).to(self.device)
        idx = torch.from_numpy(frame_idx).to(self.device)
        bx = torch.from_numpy(boxes).float().to(self.device)
        atlas = warp.build_atlas(frames)
        sides = self.cfg["attribute_heads"]
        ga_size, lm_size = sides["genderage"]["input"], sides["landmark_2d_106"]["input"]
        ga_out = ga(genderage.preprocess(warp.warp_boxes_two_pass(
            frames, idx, bx, ga_size, scale_factor=1.5, atlas=atlas)))
        lm = lm_model(genderage.preprocess(warp.warp_boxes_two_pass(
            frames, idx, bx, lm_size, scale_factor=1.5, atlas=atlas)))
        lm_px = (lm + 1.0) * (lm_size / 2.0)
        m_inv = warp.boxes_to_affines(bx, lm_size, 1.5)
        lm_src = torch.einsum("mij,mkj->mki", m_inv[:, :, :2], lm_px) + m_inv[:, None, :, 2]
        return (ga_out[:, :2].cpu().numpy(), (ga_out[:, 2] * 100.0).cpu().numpy(),
                lm_src.cpu().numpy())


def quantize_gallery(x: np.ndarray, headroom: float) -> tuple:
    """[N, D] float -> (int8 rows, the global scale): one scale for the
    whole gallery, round half to even, clipped to +-127."""
    x = np.asarray(x, np.float32)
    scale = max(float(np.abs(x).max()) * headroom / 127.0, 1e-12)
    return np.clip(np.rint(x / scale), -127, 127).astype(np.int8), scale


def int8_queries(queries: np.ndarray) -> tuple:
    """One frame's queries quantized as one batch: (int8 rows, the float32
    scale max|q| / 127)."""
    q = np.asarray(queries, np.float32)
    qs = np.float32(max(float(np.abs(q).max()), 1e-12)) / np.float32(127.0)
    return np.clip(np.rint(q / qs), -127, 127).astype(np.int8), qs
