"""The fused recognition pipeline: frames -> [B, max_faces] detections ->
aligned crops -> L2-normalized embeddings.

The torch form of ``facerecognition_infrenceengine_tpu/engine/pipeline.py``:
SCRFD forward -> sigmoid -> decode -> masked top-k -> greedy NMS into
``max_faces`` fixed slots, then Umeyama -> pyramid atlas -> K3 warp (each
face's ROI window read straight from the atlas) -> IResNet, MobileFaceNet
or ViT-L (``rec_arch``) -> L2 normalize, with every shape static per batch
size.  Each model's input is made once, in the dtype its forward casts to,
from K3's float32 crops, which go before the model runs (``model_input``).
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
output, and warps from a packed pyramid atlas; "xla" does the same with the
packed stem as three plain convs (``models/packed_stem.py``).
``stem_kernel="on"`` runs K4 on the raw path too, and ``packed_stem`` the
packed plain-conv stem.

The opt-in int8 scale modes (``models/quant.py``): ``embed_int8`` runs the
IResNet embedder with int8 PTQ weights and calibrated activation scales
(``recalibrate_int8``), s8 x s8 -> s32 convs through ``torch._int_mm``
(``ops/int8_conv.py``); ``det_int8`` the SCRFD backbone likewise, calibrated
at build, with the neck and head float.  As in the reference, the packed
"xla" / "pallas" programs keep the float backbone under ``det_int8``.

``make_sharded_fused(mesh, variant)`` splits a frame batch over a mesh's
``data`` axis: one copy of the engine on the first device of each data
row, each shard's program on its device, the outputs left on their shards
(``parallel/sharding.RowShards``).

``attributes`` runs buffalo_l's genderage and 2d106det heads on K3 crops:
the exact ONNX graphs when converted ones sit in the weights dir
(``models/onnx_exec.py``), else the synthetic heads.

Spans (``core/metrics``): each public entry is an ``engine.<module>`` span
(``detect``, ``embed``, ``attributes``, ``fused``) and, at the first call of
an entry at an input shape in the process, an ``engine.first_call`` timer
inside it: cuDNN's plans, the kernels' first launches.  Each embedder call
is an ``engine.embedder`` span (its ``arch`` and ``crops``) inside them,
each host-to-device copy an ``engine.upload`` span (its ``bytes``), each
blocking download an ``engine.wait`` span (the wait for the card and the
copy), and the constructor the ``engine.init`` timer.

Convolutions and the embedder's dense layer run through PyTorch (cuDNN /
cuBLAS on the card), as the reference left them to XLA; the stem (K4), the
face warp (K3) and the gallery top-1 (K1 / K2) are hand-written kernels.  On
the card the f32 path stays true f32: ``core.device.resolve_device``
switches TF32 off for cuDNN and cuBLAS.
"""

from __future__ import annotations

import copy
import functools
import os
import threading
from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch

from .. import native
from ..core import metrics
from ..core.config import EngineConfig, get_config
from ..core.device import resolve_device
from ..models import arcface, genderage, landmark106, mobilefacenet, onnxlite, quant, scrfd, vit
from ..models.layers import cast_keep_bn_f32, compute_dtype
from ..models.onnx_exec import OnnxRunner
from ..models.packed_stem import packed_stem_forward, packed_stem_forward_s2d4
from ..models.packed_stem import precompute_packed_stem, precompute_packed_stem_s2d4
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
from ..parallel.sharding import RowShards, batch_sharding, replicated

# YUV black (Y = 0, U = V = 128) for canvas rows a yuv420 pack does not
# carry: zero chroma would decode green
_YUV_BLACK = (0,) * 16 + (128,) * 8


def yuv_black(shape: tuple, device) -> torch.Tensor:
    """A [*shape, 24] uint8 block of YUV black, filled on ``device`` (no
    host->device copy, which would wait for the device's queue)."""
    black = torch.full(tuple(shape) + (24,), 128, dtype=torch.uint8, device=device)
    black[..., :16] = 0
    return black


@dataclass(frozen=True)
class _Embedder:
    """A ``rec_arch``'s embedder: calling it builds the float32 module;
    ``serve(module, x)`` embeds ``arcface.preprocess``'d crops, unnormalized;
    ``int8``, what ``embed_int8`` does: "quantize" its convs, "ignore", "refuse";
    ``input_dtype(module)``, the dtype its forward casts its input to."""

    build: Callable[[], torch.nn.Module]
    serve: Callable[[torch.nn.Module, torch.Tensor], torch.Tensor]
    int8: str
    input_dtype: Callable[[torch.nn.Module], torch.dtype]

    def __call__(self) -> torch.nn.Module:
        return self.build()


def _iresnet_dtype(m):
    return compute_dtype(m, m.Conv_0)


_EMBEDDERS = {"r50": _Embedder(arcface.iresnet50, arcface.serve_forward, "quantize",
                               _iresnet_dtype),
              "r18": _Embedder(arcface.iresnet18, arcface.serve_forward, "quantize",
                               _iresnet_dtype),
              "mobilefacenet": _Embedder(mobilefacenet.mobilefacenet, torch.nn.Module.__call__,
                                         "ignore",
                                         lambda m: compute_dtype(m, m.ConvBlock_0.Conv_0)),
              "vit_l": _Embedder(vit.vit_l, vit.serve_forward, "refuse",
                                 lambda m: m.patch_embed.proj.weight.dtype)}


def model_input(crops: torch.Tensor, scale: float, dtype: torch.dtype,
                own: bool = False) -> torch.Tensor:
    """A model's input from crops [M, S, S, C]: ``(crops - 127.5) / scale``
    in ``dtype``, bit for bit ``preprocess(crops).to(dtype)`` (the same
    kernels and scalars; ``arcface.preprocess``'s scale is 127.5,
    ``genderage.preprocess``'s 128.0).  ``own``: the crops are float32 and
    the program's own (K3's output), so they are normalised in place;
    otherwise a float32 copy is, and the caller's tensor is never written.
    Out of float32 the normalised tensor is dropped on return, its bytes
    counted by ``engine.crops_released``: the caller frees K3's crops
    before the model runs by holding no other name for them."""
    x = crops if own else crops.to(torch.float32, copy=True)
    x.sub_(127.5).div_(scale)
    if dtype == torch.float32:
        return x
    metrics.counter("engine.crops_released").inc(x.numel() * x.element_size())
    return x.to(dtype)


def _stride_rows(height: int, width: int) -> np.ndarray:
    """Per-anchor-row stride multiplier, in all_anchor_centers order."""
    parts = []
    for s in scrfd.STRIDES:
        n = (height // s) * (width // s) * scrfd.NUM_ANCHORS
        parts.append(np.full(n, float(s), np.float32))
    return np.concatenate(parts)


def upload(array, device) -> torch.Tensor:
    """A host array (or a tensor on another device) on ``device`` (a
    resolved one, index and all): one copy, an ``engine.upload`` span
    carrying its ``bytes``."""
    t = array if isinstance(array, torch.Tensor) else torch.as_tensor(np.asarray(array))
    if t.device == torch.device(device):
        return t
    with metrics.span("engine.upload", bytes=t.numel() * t.element_size()):
        return t.to(device)


def download(*tensors) -> tuple:
    """Device tensors -> numpy arrays, as one ``engine.wait`` span: the
    first copy waits for the card's queue."""
    with metrics.span("engine.wait"):
        return tuple(t.cpu().numpy() for t in tensors)


_first_calls: set = set()
_first_calls_lock = threading.Lock()


def _frames_shape(frames, *_) -> tuple:
    return tuple(frames.shape)


def _faces_shape(frames, frame_idx, *_) -> tuple:
    """A per-face entry's programs run at the frames' shape and the
    bucketed face count."""
    return tuple(frames.shape), bucket(len(frame_idx)) if len(frame_idx) else 0


def _crops_shape(crops) -> tuple:
    return (bucket(len(crops)) if len(crops) else 0,) + tuple(crops.shape[1:])


def _entry(module: str, shape=_frames_shape):
    """A public entry's spans: ``engine.<module>`` around the call and, when
    the process has not yet called the entry at this input (``shape`` of
    its positional arguments, the shapes its programs run at, and the first
    one's dtype), the ``engine.first_call`` timer inside it."""
    name = f"engine.{module}"

    def wrap(fn):
        @functools.wraps(fn)
        def call(self, *args, **kwargs):
            key = (fn.__name__, str(self.device), self.dtype, shape(*args),
                   str(getattr(args[0], "dtype", "")))
            with _first_calls_lock:
                new = key not in _first_calls
                _first_calls.add(key)
            with metrics.span(name):
                if not new:
                    return fn(self, *args, **kwargs)
                with metrics.timer("engine.first_call", entry=fn.__name__):
                    return fn(self, *args, **kwargs)
        return call
    return wrap


def _timed(name: str):
    """Each call of the wrapped function runs inside ``metrics.timer(name)``."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            with metrics.timer(name):
                return fn(*args, **kwargs)
        return call
    return wrap


def bucket(n: int, buckets=(1, 2, 4, 8, 16, 32, 64, 128, 256)) -> int:
    """Round up to the nearest standard batch shape."""
    for b in buckets:
        if n <= b:
            return b
    return ((n + buckets[-1] - 1) // buckets[-1]) * buckets[-1]


def _calibration_crops(n: int, size: int, seed: int = 1234) -> np.ndarray:
    """Deterministic structured calibration images for PTQ, the reference's
    bit for bit.

    Aligned face crops are dominated by smooth shading (skin), a bright oval
    on a darker background, localized dark features (eyes, brows, mouth) and
    mild texture.  These synthetic crops span that structure -- per-image
    illumination gradients, an elliptical bright region, feature blobs and
    low-amplitude noise -- so abs-max activation scales land closer to
    real-face ranges than uniform noise would.  With real weights, calibrate
    from real aligned crops through ``FaceEngine.recalibrate_int8``.
    """
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32) / (size - 1)
    crops = np.empty((n, size, size, 3), np.uint8)
    for i in range(n):
        gx, gy = rng.uniform(-60, 60, 2)
        base = rng.uniform(70, 170)
        img = base + gx * (xx - 0.5) + gy * (yy - 0.5)
        # face oval (centre-bright ellipse)
        cx, cy = rng.uniform(0.4, 0.6, 2)
        d = ((xx - cx) / 0.32) ** 2 + ((yy - cy) / 0.45) ** 2
        img = img + rng.uniform(20, 70) * np.exp(-d)
        img = np.repeat(img[:, :, None], 3, axis=2)
        img *= np.array([1.0, rng.uniform(0.75, 0.95),
                         rng.uniform(0.6, 0.9)], np.float32)  # skin-ish tint
        # dark feature blobs (eyes, brows, mouth analogues)
        for _ in range(rng.integers(3, 6)):
            bx, by = rng.uniform(0.2, 0.8, 2)
            bw = rng.uniform(0.04, 0.12)
            blob = np.exp(-(((xx - bx) / bw) ** 2 + ((yy - by) / (bw * 0.6)) ** 2))
            img -= rng.uniform(30, 90) * blob[:, :, None]
        img += rng.normal(0, 6, img.shape)  # sensor-noise texture
        crops[i] = np.clip(img, 0, 255).astype(np.uint8)
    return crops


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
    ``packed_stem_s2d4``, ``int8`` -- are ignored and recomputed from
    ``params`` + ``batch_stats``), else from
    ``<FRE_WEIGHTS_DIR>/scrfd_<det_arch>.npz`` and ``arcface_<rec_arch>.npz``
    when present, else the reference's synthetic weights for ``seed``
    (detector) and ``seed + 1`` (embedder).  The attribute heads load at the
    first ``attributes`` call.

    ``self.det_variables`` / ``self.rec_variables`` hold the derived
    collections under the reference's names (``stem_pallas``, and as
    configured ``packed_stem``, ``packed_stem_s2d4``, ``int8``: the int8
    weights {point: (w8, sw)}), all folded from the float32 modules before
    the cast to the engine dtype.
    """

    @metrics.on_device
    @_timed("engine.init")
    def __init__(self, cfg: EngineConfig | None = None, det_variables=None, rec_variables=None,
                 det_arch: str = "det_10g", rec_arch: str = "r50", seed: int = 0, device=None):
        self.cfg = cfg or get_config().engine
        self.device = resolve_device(device)
        self.dtype = torch.bfloat16 if self.cfg.dtype == "bfloat16" else torch.float32
        rec = _EMBEDDERS.get(rec_arch)
        if rec is None:
            raise ValueError(f"rec_arch {rec_arch!r}: one of {sorted(_EMBEDDERS)}")
        if self.cfg.embed_int8 and rec.int8 == "refuse":
            raise ValueError("embed_int8: the int8 embedder is IResNet's; there is no int8 ViT")
        self.rec_arch = rec_arch
        self._serve_embedder = rec.serve
        self._embedder_dtype = rec.input_dtype
        h, w = self.cfg.det_size
        detector = _from_variables(f"scrfd_{det_arch}", scrfd.SCRFD(scrfd.CONFIGS[det_arch]),
                                   det_variables, seed)
        embedder = _from_variables(f"arcface_{rec_arch}", rec(), rec_variables, seed + 1)
        # K4's BN-folded stem weights, folded from the float32 module before
        # the cast (the reference folds from its float32 variables)
        self.stem_width = detector.cfg.stem_width
        self.stem_weights = {k: v.to(self.device) for k, v in
                             precompute_fused_stem(detector, self.dtype).items()}
        self.det_variables = {"stem_pallas": self.stem_weights}
        self.rec_variables = {}
        # the packed plain-conv stems, only when selected
        for key, on, fold in (("packed_stem", self.cfg.packed_stem, precompute_packed_stem),
                              ("packed_stem_s2d4", self.cfg.packed_stem_impl == "xla",
                               precompute_packed_stem_s2d4)):
            if on:
                packed = fold(detector, self.dtype)
                self.det_variables[key] = {k: [t.to(self.device) for t in v]
                                           for k, v in packed.items()}
        # int8 PTQ weights {point: (w8, sw)}, quantized from the float32 weights
        self._embed_scales = None
        self._int8_calibration = None
        self._det_scales = None
        if self.cfg.embed_int8 and rec.int8 == "quantize":
            self.rec_variables["int8"] = self._on_device(quant.quantize_weights(embedder))
        if self.cfg.det_int8:
            self.det_variables["int8"] = self._on_device(
                quant.quantize_scrfd_weights(detector, detector.cfg))
        # "auto" turns the raw-path stem kernel on only on a TPU in the
        # reference: off here
        self._stem_kernel_raw = self.cfg.stem_kernel == "on"
        # BatchNorm stays float32 in a bf16 engine, as the reference's.  The
        # int8 embedder's twin reads float32 parameters (the reference adds
        # its float32 Dense bias and PReLU slopes), so that module stays
        # float32: the engine never runs it as a float embedder.
        fmt = torch.channels_last if self.device.type == "cuda" else torch.contiguous_format
        self.detector = cast_keep_bn_f32(detector, self.device, self.dtype, fmt)
        self.embedder = cast_keep_bn_f32(embedder, self.device, (
            torch.float32 if "int8" in self.rec_variables else self.dtype), fmt)
        self._centers = all_anchor_centers(h, w, device=self.device)
        self._strides = torch.from_numpy(_stride_rows(h, w)).to(self.device)
        self._dst = torch.from_numpy(ARCFACE_DST * (self.cfg.embed_size / 112.0)).to(self.device)
        self._attr_models = None  # (genderage, landmark106), at first use
        self._attr_runners = None  # the exact ONNX graphs, when converted
        self._attr_sizes = (genderage.INPUT_SIZE, landmark106.INPUT_SIZE)
        if "int8" in self.rec_variables:
            self.recalibrate_int8()
        if "int8" in self.det_variables:
            # the detector's scales, once, on structured crops at the canvas
            calib = _calibration_crops(4, max(h, w), seed=4321)[:, :h, :w]
            with torch.inference_mode():
                self._det_scales = quant.calibrate_scrfd(
                    self.detector, scrfd.preprocess(self._to_device(calib)), self.detector.cfg,
                    dtype=self.dtype)

    def _on_device(self, qw: dict) -> dict:
        return {k: tuple(t.to(self.device) for t in v) for k, v in qw.items()}

    # -------------------------------------------------------------- programs
    def _detect_impl(self, frames_u8: torch.Tensor, det_threshold: float):
        """Raw frames: the int8 backbone under ``det_int8`` (it replaces
        the whole float backbone, stem included), else the stem as
        configured -- K4 (``stem_kernel="on"``), the packed plain convs
        (``packed_stem``, H and W multiples of 4), or the detector's own."""
        h, w = int(frames_u8.shape[1]), int(frames_u8.shape[2])
        x, stem_out, feats_in = None, None, None
        if "int8" in self.det_variables:
            x = scrfd.preprocess(frames_u8)
            feats_in = quant.scrfd_backbone_forward(
                self.detector, x, self.detector.cfg, qw=self.det_variables["int8"],
                act_scales=self._det_scales, dtype=self.dtype)
        elif (self._stem_kernel_raw and frames_u8.dtype == torch.uint8
                and h % 4 == 0 and w % 4 == 0 and ((h // 4) % 16 == 0 or h // 4 <= 64)):
            # K4 from raw frames: pack on the device, then the fused stem
            stem_out = fused_stem_s2d4(space_to_depth4(frames_u8).contiguous(),
                                       self.stem_weights, self.stem_width)
        elif "packed_stem" in self.det_variables and h % 4 == 0 and w % 4 == 0:
            stem_out = packed_stem_forward(scrfd.preprocess(frames_u8),
                                           self.det_variables["packed_stem"], self.stem_width,
                                           self.dtype)
        else:
            x = scrfd.preprocess(frames_u8)
        logits, bbox, kps = self.detector(x, stem_out=stem_out, feats_in=feats_in)
        return self._decode_nms(logits, bbox, kps, det_threshold)

    def _detect_packed_impl(self, frames_p4: torch.Tensor, det_threshold: float):
        """Detect from s2d4-packed u8 frames [B, H/4, W/4, 48]: "unpack" runs
        the raw program on the unpacked frames; "pallas" runs K4 on the
        packed frames, "xla" the packed plain-conv stem, and the float
        backbone from its output (under ``det_int8`` too, as the
        reference's packed programs do)."""
        if self.cfg.packed_stem_impl == "unpack":
            return self._detect_impl(depth_to_space4(frames_p4), det_threshold)
        if self.cfg.packed_stem_impl == "xla":
            stem_out = packed_stem_forward_s2d4(frames_p4, self.det_variables["packed_stem_s2d4"],
                                                self.stem_width, self.dtype)
        else:
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
        scores = scores.masked_fill(~(scores >= det_threshold), float("-inf"))
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

    def _apply_embedder(self, x: torch.Tensor) -> torch.Tensor:
        """Every embedding program's embedder, as an ``engine.embedder``
        span (``arch``, ``crops``): the int8 twin when the engine holds int8
        weights (the scales dict read once: a recalibration replaces it
        whole), else the ``rec_arch``'s serving forward (``_EMBEDDERS``)."""
        with metrics.span("engine.embedder", arch=self.rec_arch, crops=int(x.shape[0])):
            if "int8" in self.rec_variables:
                return quant.apply_int8(self.embedder, self.rec_variables["int8"],
                                        self._embed_scales, x, dtype=self.dtype)
            return self._serve_embedder(self.embedder, x)

    def _embedder_input(self, crops: torch.Tensor, own: bool = False) -> torch.Tensor:
        """``model_input`` for the embedder: in the engine's dtype for the
        int8 twin (``quant._forward`` rounds its input to it), else in the
        dtype the ``rec_arch``'s forward casts to."""
        dtype = self.dtype if "int8" in self.rec_variables else self._embedder_dtype(self.embedder)
        return model_input(crops, 127.5, dtype, own)

    def _embed_impl(self, frames_u8, frame_idx, kps):
        # K3's crops are named nowhere: they go once the input is made
        x = self._embedder_input(warp_faces_two_pass(frames_u8, frame_idx, kps,
                                                     self.cfg.embed_size, dst=self._dst), own=True)
        return l2_normalize(self._apply_embedder(x))

    def _embed_crops_impl(self, crops):
        """A caller's crops, left as they are."""
        return l2_normalize(self._apply_embedder(self._embedder_input(crops)))

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
        the same pixels); "pallas" and "xla" warp from the packed pyramid
        atlas."""
        if self.cfg.packed_stem_impl == "unpack":
            return self._fused_impl(depth_to_space4(frames_p4), det_threshold)
        boxes, scores, kps, valid = self._detect_packed_impl(frames_p4, det_threshold)
        b, f = valid.shape
        frame_idx = torch.arange(b, device=self.device).repeat_interleave(f)
        x = self._embedder_input(warp_faces_two_pass_packed(
            frames_p4, frame_idx, kps.reshape(b * f, 5, 2), self.cfg.embed_size, dst=self._dst),
            own=True)
        emb = l2_normalize(self._apply_embedder(x))
        return boxes, scores, kps, valid, emb.reshape(b, f, -1)

    def _fused_yuv_impl(self, frames_y24, det_threshold: float):
        """The yuv420 transport: re-pad the content rows to the canvas with
        YUV black, mix to packed RGB, then the packed program."""
        dh = self.cfg.det_size[0] // 4
        b, rows, w4, _ = frames_y24.shape
        if rows < dh:
            frames_y24 = torch.cat([frames_y24, yuv_black((b, dh - rows, w4), frames_y24.device)],
                                   dim=1)
        return self._fused_packed_impl(yuv420p4_to_rgbp4(frames_y24), det_threshold)

    def _ensure_attr_models(self):
        """buffalo_l's genderage and 2d106det heads, loaded at first use so the
        recognition path never pays for them.  Two sources, in preference
        order, as the reference's:

        1. the exact graphs: converted ``attr_genderage.onnx`` and
           ``attr_2d106det.onnx`` in the weights dir, run by
           ``models/onnx_exec.OnnxRunner`` in float32 whatever the engine's
           dtype, with the crop sizes read from the graphs' input shapes;
        2. the synthetic heads (``load_or_init`` seeds 7 and 8, as the
           reference's) in the engine's dtype, BatchNorm kept f32.
        """
        if self._attr_models is None:
            paths = [os.path.join(weights_dir(), f) for f in ("attr_genderage.onnx",
                                                              "attr_2d106det.onnx")]
            if all(os.path.exists(p) for p in paths):
                runners = tuple(OnnxRunner(onnxlite.load(p), device=self.device) for p in paths)

                def in_size(r, default):
                    shp = r.input_shapes[r.input_names[0]]
                    return int(shp[-1]) if len(shp) == 4 and shp[-1] > 0 else default

                self._attr_runners = runners
                self._attr_sizes = (in_size(runners[0], genderage.INPUT_SIZE),
                                    in_size(runners[1], landmark106.INPUT_SIZE))
                self._attr_models = runners
                return self._attr_models
            fmt = torch.channels_last if self.device.type == "cuda" else torch.contiguous_format
            self._attr_models = tuple(
                cast_keep_bn_f32(load_or_init(name, model, seed), self.device, self.dtype, fmt)
                for name, model, seed in (("genderage", genderage.GenderAge(), 7),
                                          ("landmark_2d_106", landmark106.Landmark106(), 8)))
        return self._attr_models

    def _attributes_impl(self, frames_u8, frame_idx, bboxes):
        """Gender, age and 106 landmarks of M boxes (frame coordinates): the
        square window of side max(w, h) * 1.5 around each box, resampled by
        K3 to each head's input size from one pyramid atlas; gender =
        argmax(out[:2]), age = round(out[2] * 100), landmarks (out + 1) *
        size / 2 mapped back through the crop's affine.  The exact graphs
        take NCHW float32 crops, mean 0 / std 1 (insightface's blob settings
        for these two heads), and their first output.  The synthetic heads
        each get their input made in their dtype from K3's crops, which go
        before the head runs (``model_input``); the genderage input goes
        before the landmark head runs."""
        ga_model, lm_model = self._ensure_attr_models()
        ga_size, lm_size = self._attr_sizes
        atlas = build_atlas(frames_u8)  # one pyramid for both crop sizes
        ga_crops = warp_boxes_two_pass(frames_u8, frame_idx, bboxes, ga_size,
                                       scale_factor=1.5, atlas=atlas)
        lm_crops = warp_boxes_two_pass(frames_u8, frame_idx, bboxes, lm_size,
                                       scale_factor=1.5, atlas=atlas)
        del atlas
        if self._attr_runners is not None:
            ga_out = ga_model(ga_crops.permute(0, 3, 1, 2).float())[0]
            lm = lm_model(lm_crops.permute(0, 3, 1, 2).float())[0]
            lm = lm.reshape(lm.shape[0], -1, 2)
        else:
            x = model_input(ga_crops, 128.0, ga_model.Dense_0.weight.dtype, own=True)
            del ga_crops
            ga_out = ga_model(x)
            x = model_input(lm_crops, 128.0, lm_model.Dense_0.weight.dtype, own=True)
            del lm_crops
            lm = lm_model(x)
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
    @metrics.on_device
    def _to_device(self, array) -> torch.Tensor:
        """A host array, or a tensor already uploaded, on the engine's device."""
        return upload(array, self.device)

    @metrics.on_device
    @_entry("detect")
    @torch.inference_mode()
    def detect(self, frames_u8, det_threshold: float = 0.3) -> DetectionBatch:
        """frames_u8: [B, H, W, 3] RGB uint8 at the det canvas size."""
        outs = self._detect_impl(self._to_device(frames_u8), det_threshold)
        return DetectionBatch(*download(*outs))

    @metrics.on_device
    @_entry("embed", _faces_shape)
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
        return download(emb)[0][:m]

    @metrics.on_device
    @_entry("attributes", _faces_shape)
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
        return tuple(o[:m] for o in download(*outs))

    @metrics.on_device
    @_entry("embed", _crops_shape)
    @torch.inference_mode()
    def embed_crops(self, crops_u8) -> np.ndarray:
        """Embed pre-aligned 112x112 crops [M, 112, 112, 3]."""
        m = len(crops_u8)
        if m == 0:
            return np.zeros((0, self.cfg.embed_dim), np.float32)
        pad = np.zeros((bucket(m),) + tuple(crops_u8.shape[1:]), crops_u8.dtype)
        pad[:m] = crops_u8
        return download(self._embed_crops_impl(self._to_device(pad)))[0][:m]

    @metrics.on_device
    @_entry("fused")
    @torch.inference_mode()
    def detect_align_embed(self, frames_u8, det_threshold: float = 0.3):
        """Fused fixed-capacity variant: device tensors (boxes, scores, kps,
        valid, emb)."""
        return self._fused_impl(self._to_device(frames_u8), det_threshold)

    @metrics.on_device
    @_entry("fused")
    @torch.inference_mode()
    def detect_align_embed_flat(self, frames_u8, det_threshold: float = 0.3) -> torch.Tensor:
        """Serving variant: one [B, F, 528] device tensor."""
        return self._fused_flat_impl(self._to_device(frames_u8), det_threshold)

    @metrics.on_device
    @torch.inference_mode()
    def recalibrate_int8(self, crops_u8=None):
        """(Re)calibrate the int8 embedder's activation scales.

        crops_u8: [N, embed_size, embed_size, 3] uint8 aligned face crops --
        with real weights, real production crops; None uses the
        deterministic structured default (``_calibration_crops``).  The new
        scales replace the old dict in one assignment, so a dispatch in
        flight embeds with the old scales or the new ones, never a mix;
        ``models/quant.clip_fractions`` measures drift on live data."""
        if "int8" not in self.rec_variables:
            raise ValueError("engine was not built with embed_int8")
        if crops_u8 is None:
            crops_u8 = _calibration_crops(8, self.cfg.embed_size)
            label = "synthetic-structured"
        else:
            label = f"user({len(crops_u8)} crops)"
        x = arcface.preprocess(self._to_device(np.asarray(crops_u8, np.uint8)))
        self._embed_scales = quant.calibrate(self.embedder, x, dtype=self.dtype)
        self._int8_calibration = label

    def _has_packed_stem(self) -> bool:
        """Whether the packed-input programs can run: the selected
        ``packed_stem_impl``'s weights are present ("unpack" runs the raw
        program and needs nothing extra)."""
        if self.cfg.packed_stem_impl == "unpack":
            return True
        if self.cfg.packed_stem_impl == "xla":
            return "packed_stem_s2d4" in self.det_variables
        return "stem_pallas" in self.det_variables

    @staticmethod
    def pack_frames(frames_u8) -> np.ndarray:
        """Host-side s2d4 pack: [B, H, W, 3] u8 -> [B, H/4, W/4, 48]."""
        return np.stack([native.pack_s2d4(frame) for frame in np.asarray(frames_u8)])

    @metrics.on_device
    @_entry("fused")
    @torch.inference_mode()
    def detect_align_embed_packed(self, frames_p4_u8, det_threshold: float = 0.3):
        """Fused program on s2d4-packed u8 frames [B, H/4, W/4, 48]: device
        tensors (boxes, scores, kps, valid, emb)."""
        return self._fused_packed_impl(self._to_device(frames_p4_u8), det_threshold)

    @metrics.on_device
    @_entry("fused")
    @torch.inference_mode()
    def detect_align_embed_yuv420(self, frames_y24_u8, det_threshold: float = 0.3):
        """Fused program on packed-yuv420 frames [B, rows <= H/4, W/4, 24]
        (the streaming wire format, 1.5 B/px): same outputs as
        ``detect_align_embed`` up to the 4:2:0 chroma subsampling."""
        return self._fused_yuv_impl(self._to_device(frames_y24_u8), det_threshold)

    @metrics.on_device
    @_entry("fused")
    @torch.inference_mode()
    def detect_align_embed_yuv420_flat(self, frames_y24_u8,
                                       det_threshold: float = 0.3) -> torch.Tensor:
        """Serving variant of ``detect_align_embed_yuv420``: one [B, F, 528]
        device tensor."""
        return self._fused_yuv_flat_impl(self._to_device(frames_y24_u8), det_threshold)

    @metrics.on_device
    def _on(self, device) -> "FaceEngine":
        """A copy of the engine whose modules and tensors live on ``device``
        (the configuration shared; the attribute heads load there at their
        first use).  A tensor two attributes share is copied once."""
        moved: dict = {}

        def move(v):
            if id(v) in moved:
                return moved[id(v)]
            if isinstance(v, torch.Tensor):
                out = v.to(device)
            elif isinstance(v, torch.nn.Module):
                out = copy.deepcopy(v).to(device)
            elif isinstance(v, dict):
                out = {k: move(x) for k, x in v.items()}
            elif isinstance(v, (list, tuple)):
                out = type(v)(move(x) for x in v)
            else:
                out = v
            moved[id(v)] = out
            return out

        twin = copy.copy(self)
        for name, value in vars(self).items():
            setattr(twin, name, move(value))
        twin.device = device
        twin._attr_models = twin._attr_runners = None
        return twin

    @metrics.on_device
    def make_sharded_fused(self, mesh, variant: str = "raw"):
        """Data-parallel fused program over a mesh's ``data`` axis.

        The engine is copied once to the first device of each data row (no
        copy where that is the engine's own device); the frame batch splits
        over ``data`` and each shard runs the single-device program on its
        device.  Detection is independent a frame, so no shard waits for
        another; devices along ``gallery`` would compute the same thing and
        run nothing here (the gallery axis is the match's,
        ``parallel/topk.py``).

        ``variant`` selects the serving contract:
          "raw"      -- fn(frames_u8 [B, H, W, 3]) -> 5 outputs
          "flat"     -- fn(frames_u8 [B, H, W, 3]) -> one [B, F, 528]
          "yuv_flat" -- fn(frames_y24 [B, rows<=H/4, W/4, 24]) -> [B, F, 528]
        Each output is a ``RowShards`` whose ``parts[i]`` is data shard i's
        rows on its device: nothing is gathered to one device.  B must be
        divisible by the data-axis size.
        """
        impl = {"raw": "_fused_impl", "flat": "_fused_flat_impl",
                "yuv_flat": "_fused_yuv_flat_impl"}[variant]
        copies = {d: self if d == self.device else self._on(d)
                  for d in replicated(mesh).devices}
        engines = [copies[d] for d in batch_sharding(mesh).devices]

        @metrics.on_device
        @torch.inference_mode()
        def run(frames, det_threshold: float = 0.3):
            b, n = int(frames.shape[0]), len(engines)
            if b % n:
                raise ValueError(f"batch of {b} frames does not split over {n} data shards")
            step = b // n
            outs = [getattr(eng, impl)(eng._to_device(frames[i * step:(i + 1) * step]),
                                       det_threshold)
                    for i, eng in enumerate(engines)]
            if variant != "raw":
                return RowShards(outs)
            return tuple(RowShards(parts) for parts in zip(*outs))

        return run
