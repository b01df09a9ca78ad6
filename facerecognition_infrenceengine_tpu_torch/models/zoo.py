"""FaceAnalysis-compatible facade over the port's engine.

The torch form of ``facerecognition_infrenceengine_tpu/models/zoo.py``:
``FaceAnalysis("buffalo_l").prepare(...)`` then ``get(frame)`` /
``get_batch(frames)`` return ``Face`` objects with ``bbox``, ``det_score``,
``kps``, ``normed_embedding`` and, with the genderage and landmark_2d_106
modules (on by default, as in buffalo_l), ``gender``, ``age`` and
``landmark_2d_106``.  The pack name selects the recognizer
(``PACK_RECOGNIZERS``): ``"buffalo_l"`` IResNet-50, ``"mobile_facenet_v1"``
MobileFaceNet, ``"vit_l"`` arcface_torch's ViT-L; any other name IResNet-50.

Frames of any size are letterboxed onto the detector canvas by the host
codec (``native.letterbox``).  ``get_batch_async`` picks a batch's program
once (``_route``).  When every frame of a batch fits the canvas unscaled
(the 640x480 camera on a 640x640 canvas) one fused detect -> align -> embed
call runs and its packed [B, F, 528] result is the one download.  Otherwise
(720p and 1080p cameras) the batch takes two programs: detect on the
canvases, boxes and landmarks divided by each frame's float32 letterbox
scale, then ``embed_faces`` from the native frames padded to a common size.
The attribute heads crop from the same frames as the embedder.

With ``EngineConfig.stream_transport="yuv420"`` each frame is encoded on
the host (``encode_frame``: 4:2:0 YUV in s2d4 layout, content rows only,
1.5 B/px) and the batch runs ``detect_align_embed_yuv420_flat`` -- when
recognition is on, the attribute heads are off and every frame fits
unscaled, as the reference decides; a batch mixing packs with raw frames
decodes the packs on the host and takes the raw-RGB path.  With
``EngineConfig.upload_on_submit`` ``encode_frame`` also uploads the pack
from the calling (capture) thread, and a batch of such device packs is
stacked on the device.

Spans (``core/metrics``): the host's preparation of a batch (BGR -> RGB,
letterbox, stacking, the native-frame pad, the yuv420 encode) is
``facade.prep``; building the ``Face`` objects and per-frame lists and
attaching embeddings and attributes is ``facade.faces``; the packed
output's download is an ``engine.wait``.

``FakeFaceAnalysis`` is the deterministic test double: it decodes a face
descriptor hidden in the pixels (``encode_fake_face``).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field

import numpy as np
import torch

from .. import native
from ..core import metrics
from ..core.config import EngineConfig, get_config
from ..core.device import resolve_device
from ..engine.pipeline import _YUV_BLACK, FaceEngine, bucket, download, upload, yuv_black
from ..ops.align import ARCFACE_DST
from ..ops.yuv import yuv420p4_to_rgb_host

ATTRIBUTE_MODULES = ("genderage", "landmark_2d_106")


@dataclass
class Face:
    bbox: np.ndarray  # [4] xyxy, original frame coords
    det_score: float
    kps: np.ndarray  # [5, 2]
    normed_embedding: np.ndarray = field(default=None)  # [512] unit norm
    gender: int | None = None
    age: int | None = None
    landmark_2d_106: np.ndarray | None = None


def letterbox(frame: np.ndarray, canvas_hw: tuple) -> tuple:
    """Resize-with-aspect onto the top-left of a zero canvas (the insightface
    detector convention) by the host codec -> (canvas uint8, scale), with
    coords_canvas = coords_frame * scale and scale the codec's float32."""
    return native.letterbox(np.ascontiguousarray(frame), *canvas_hw)


# pack name -> the FaceEngine recognizer (``rec_arch``) it serves
PACK_RECOGNIZERS = {"buffalo_l": "r50", "mobile_facenet_v1": "mobilefacenet", "vit_l": "vit_l"}


class FaceAnalysis:
    """insightface-style facade; runs on ``device`` (default ``cuda``)."""

    def __init__(self, name: str = "buffalo_l", cfg: EngineConfig | None = None,
                 engine=None, allowed_modules=None, device=None):
        self.name = name
        self.cfg = cfg or get_config().engine
        self.device = device
        self._engine = engine
        self.det_thresh = 0.3
        # buffalo_l runs every model of the pack on each face; pass e.g.
        # ("detection", "recognition") to trim the per-frame work
        self.allowed_modules = tuple(allowed_modules) if allowed_modules else (
            "detection", "recognition") + ATTRIBUTE_MODULES

    def prepare(self, ctx_id: int = 0, det_size: tuple | None = None,
                det_thresh: float = 0.3):
        if det_size is not None and tuple(det_size) != tuple(self.cfg.det_size):
            self.cfg = dataclasses.replace(self.cfg, det_size=tuple(det_size))
            self._engine = None
        self.det_thresh = det_thresh
        self._ensure_engine()

    def _ensure_engine(self):
        if self._engine is None:
            rec_arch = PACK_RECOGNIZERS.get(self.name, "r50")
            self._engine = FaceEngine(self.cfg, rec_arch=rec_arch, device=self.device)
        # the engine's resolved device, which the serving threads bind to
        self.device = self._engine.device
        return self._engine

    @property
    def _want_attrs(self) -> bool:
        return any(m in self.allowed_modules for m in ATTRIBUTE_MODULES)

    def get(self, frame: np.ndarray, max_num: int = 0) -> list:
        """BGR uint8 frame -> list of Face."""
        return self.get_batch([frame], max_num=max_num)[0]

    @staticmethod
    @metrics.on_device
    def _faces_from_fused_flat(flat, n: int, max_num: int) -> list:
        """Decode the packed [B, F, 528] output (boxes | score | kps | valid |
        emb) of the first ``n`` frames."""
        flat = download(flat)[0] if hasattr(flat, "cpu") else np.asarray(flat)
        with metrics.span("facade.faces"):
            b, f, _ = flat.shape
            boxes, det_scores = flat[..., :4], flat[..., 4]
            kps, valid = flat[..., 5:15].reshape(b, f, 5, 2), flat[..., 15] > 0.5
            emb = flat[..., 16:]
            per_frame = []
            for i in range(n):
                faces = [Face(bbox=boxes[i, j], det_score=float(det_scores[i, j]),
                              kps=kps[i, j], normed_embedding=emb[i, j])
                         for j in range(f) if valid[i, j]]
                per_frame.append(faces[:max_num] if max_num else faces)
            return per_frame

    def _attach_attributes(self, engine, frames, per_frame: list) -> None:
        with metrics.span("facade.faces"):
            flat_faces = [face for faces in per_frame for face in faces]
            if not flat_faces:
                return
            idx = np.asarray([b for b, faces in enumerate(per_frame) for _ in faces], np.int32)
            boxes = np.stack([f.bbox for f in flat_faces]).astype(np.float32)
        gender, age, lm = engine.attributes(frames, idx, boxes)
        with metrics.span("facade.faces"):
            for i, face in enumerate(flat_faces):
                if "genderage" in self.allowed_modules:
                    face.gender = int(gender[i])
                    face.age = int(age[i])
                if "landmark_2d_106" in self.allowed_modules:
                    face.landmark_2d_106 = lm[i]

    # ------------------------------------------------------ yuv420 transport
    @staticmethod
    def _is_pack(frame) -> bool:
        return getattr(frame, "ndim", 0) == 3 and frame.shape[-1] == 24

    def _fits(self, frame) -> bool:
        """Whether a frame (a pack: the content rows it decodes to) fits the
        canvas at letterbox scale 1.0."""
        k = 4 if self._is_pack(frame) else 1
        return min(d / (k * s) for d, s in zip(self.cfg.det_size, frame.shape[:2])) == 1.0

    def _yuv_eligible(self, engine, frames) -> bool:
        """The half-byte transport: configured, recognition on and the
        attribute heads off (they crop raw frames), and every frame a pack
        already or fitting the canvas at letterbox scale 1.0."""
        return (self.cfg.stream_transport == "yuv420" and "recognition" in self.allowed_modules
                and not self._want_attrs and engine._has_packed_stem()
                and all(self._is_pack(f) or self._fits(f) for f in frames))

    @metrics.on_device
    def encode_frame(self, frame_bgr: np.ndarray) -> np.ndarray:
        """One BGR camera frame -> its yuv420 s2d4 content rows
        [ceil(h/4), W/4, 24]: the first rows of ``native.letterbox_yuv420_
        s2d4``'s canvas, which hold the frame (the letterbox puts it at the
        top-left; later rows are padding the device re-creates), letterboxed
        onto a canvas of those rows only.  Returns the frame unchanged for
        the rgb transport or a frame that needs a resize.

        With ``upload_on_submit`` the pack is uploaded here, on the calling
        (capture) thread, and returned as a tensor on the engine's device
        (``cuda`` unless the app or its engine names another)."""
        dh, dw = self.cfg.det_size
        h = frame_bgr.shape[0]
        if self.cfg.stream_transport != "yuv420" or not self._fits(frame_bgr):
            return frame_bgr
        rgb = np.ascontiguousarray(frame_bgr[..., ::-1])
        pack = native.letterbox_yuv420_s2d4(rgb, min(-(-h // 4) * 4, dh), dw)[0]
        if self.cfg.upload_on_submit:
            # the engine's device (once built, ``self.device`` is it) without
            # building it here: N capture threads call this at once
            return upload(pack, resolve_device(self.device))
        return pack

    @staticmethod
    def _stack_yuv(packs, dw: int):
        """Stack content-row packs into one [bucket(n), rows, dw/4, 24] batch;
        the unfilled area is YUV black.  Device packs (``upload_on_submit``)
        of one shape are stacked on their device, padded there with YUV
        black; packs of mixed shapes are brought to the host and stacked
        there."""
        tensors = [p for p in packs if isinstance(p, torch.Tensor)]
        if tensors:
            dev = tensors[0].device
            if len({tuple(p.shape) for p in packs}) == 1:
                stacked = torch.stack([p.to(dev) if isinstance(p, torch.Tensor)
                                       else upload(p, dev) for p in packs])
                pad = bucket(len(packs)) - len(packs)
                if pad:
                    stacked = torch.cat([stacked, yuv_black((pad,) + tuple(stacked.shape[1:3]),
                                                            dev)])
                return stacked
            packs = [p.cpu().numpy() if isinstance(p, torch.Tensor) else p for p in packs]
        rows = max(p.shape[0] for p in packs)
        stacked = np.empty((bucket(len(packs)), rows, dw // 4, 24), np.uint8)
        stacked[...] = np.asarray(_YUV_BLACK, np.uint8)
        for i, p in enumerate(packs):
            stacked[i, :p.shape[0]] = p
        return stacked

    def _rgb(self, frame) -> np.ndarray:
        """A BGR frame as an RGB view; a pack decoded to RGB content rows on
        the host (its 4:2:0 chroma loss was paid at encode)."""
        if self._is_pack(frame):
            return yuv420p4_to_rgb_host(torch.as_tensor(frame).cpu().numpy())
        return frame[..., ::-1]

    # ------------------------------------------------------------ batches
    def _route(self, engine, frames) -> str:
        """A batch's program: "yuv" (``_yuv_eligible``); "fused" (one call
        on canvases that are the native frames) when recognition is on and
        every frame fits at scale 1.0; else "two_program"."""
        if self._yuv_eligible(engine, frames):
            return "yuv"
        if "recognition" in self.allowed_modules and all(self._fits(f) for f in frames):
            return "fused"
        return "two_program"

    @metrics.on_device
    def get_batch_async(self, frames: list, max_num: int = 0):
        """Dispatch a batch on the route ``_route`` picks -> ``resolve()``
        returning per-frame lists of Face.  On the yuv route, and the fused
        one with the attribute heads off, the packed [B, F, 528] result
        stays on the card until ``resolve`` downloads it, so the caller can
        prepare the next batch meanwhile; the others run synchronously."""
        if not frames:
            return lambda: []
        engine = self._ensure_engine()
        n = len(frames)
        route = self._route(engine, frames)
        if route == "yuv":
            with metrics.span("facade.prep"):
                packs = [f if self._is_pack(f) else self.encode_frame(f) for f in frames]
                stacked = self._stack_yuv(packs, self.cfg.det_size[1])
            flat = engine.detect_align_embed_yuv420_flat(stacked, det_threshold=self.det_thresh)
            return lambda: self._faces_from_fused_flat(flat, n, max_num)
        with metrics.span("facade.prep"):
            rgb = [self._rgb(f) for f in frames]
            stacked = np.zeros((bucket(n),) + tuple(self.cfg.det_size) + (3,), np.uint8)
            scales = [1.0] * n
            for i, f in enumerate(rgb):
                stacked[i], scales[i] = letterbox(f, self.cfg.det_size)
        if route == "two_program":
            per_frame = self._two_programs(engine, rgb, stacked, scales, max_num)
            return lambda: per_frame
        # with the heads, one upload here, which they crop from too
        canvases = engine._to_device(stacked) if self._want_attrs else stacked
        flat = engine.detect_align_embed_flat(canvases, det_threshold=self.det_thresh)
        if not self._want_attrs:
            return lambda: self._faces_from_fused_flat(flat, n, max_num)
        per_frame = self._faces_from_fused_flat(flat, n, max_num)
        self._attach_attributes(engine, canvases, per_frame)
        return lambda: per_frame

    @metrics.on_device
    def get_batch(self, frames: list, max_num: int = 0) -> list:
        """``get_batch_async`` resolved: per-frame lists of Face."""
        return self.get_batch_async(frames, max_num)()

    def _two_programs(self, engine, rgb: list, stacked, scales: list, max_num: int) -> list:
        """Detect on the canvases, coordinates divided by each frame's
        letterbox scale, then embed and crop the heads from the native RGB
        frames padded to a common size."""
        det = engine.detect(stacked, det_threshold=self.det_thresh)
        with metrics.span("facade.faces"):
            per_frame, all_idx, all_kps = [], [], []
            for b, scale in enumerate(scales):
                # float32 coordinates over the codec's float32 scale, as the
                # reference maps them back
                faces = [Face(bbox=det.boxes[b, f] / scale, det_score=float(det.scores[b, f]),
                              kps=det.kps[b, f] / scale)
                         for f in range(det.valid.shape[1]) if det.valid[b, f]]
                faces = faces[:max_num] if max_num else faces
                per_frame.append(faces)
                all_idx += [b] * len(faces)
                all_kps += [face.kps for face in faces]
        if not all_idx:
            return per_frame
        with metrics.span("facade.prep"):
            # the native RGB frames, padded to a common size (a multiple of
            # 8: the pyramid's three 2x2 pools) and a bucketed count
            max_h = max(f.shape[0] for f in rgb)
            max_w = max(f.shape[1] for f in rgb)
            batch = np.zeros((bucket(len(rgb)), max_h + (-max_h) % 8,
                              max_w + (-max_w) % 8, 3), np.uint8)
            for i, f in enumerate(rgb):
                batch[i, :f.shape[0], :f.shape[1]] = f
        batch = engine._to_device(batch)  # one upload for embedder and heads
        if "recognition" in self.allowed_modules:
            emb = engine.embed_faces(batch, np.asarray(all_idx, np.int32),
                                     np.stack(all_kps).astype(np.float32))
            with metrics.span("facade.faces"):
                for face, e in zip((f for faces in per_frame for f in faces), emb):
                    face.normed_embedding = e
        if self._want_attrs:
            self._attach_attributes(engine, batch, per_frame)
        return per_frame


# --------------------------------------------------------------- test fake
MARKER = np.array([17, 103, 229], np.uint8)


def encode_fake_face(person_seed: int, pose_jitter: float = 0.0,
                     bbox=(100, 100, 200, 220), size=(480, 640),
                     score: float = 0.9) -> np.ndarray:
    """A BGR image carrying one fake face descriptor in its pixels.

    ``person_seed`` determines the identity embedding; ``pose_jitter``
    rotates it per image (0.0: identical across poses)."""
    if not 0 <= person_seed < (1 << 24):
        # the descriptor carries the seed in 3 unsigned bytes: a larger or
        # negative seed would decode to another identity
        raise ValueError(f"person_seed must be in [0, 2^24), got {person_seed}")
    img = np.random.default_rng(person_seed * 7919 + int(pose_jitter * 1e4)) \
        .integers(0, 255, (*size, 3)).astype(np.uint8)
    img[0, 0] = MARKER
    img[0, 1] = np.frombuffer(np.int32(person_seed).tobytes()[:3], np.uint8)
    img[0, 2] = np.clip([pose_jitter * 100, score * 255, 1], 0, 255).astype(np.uint8)
    x1, y1, x2, y2 = bbox
    img[0, 3] = [x1 // 4, y1 // 4, x2 // 4]
    img[0, 4] = [y2 // 4, 0, 0]
    return img


def fake_embedding(person_seed: int, pose_jitter: float = 0.0) -> np.ndarray:
    """Deterministic unit embedding; jitter rotates it away from the base."""
    rng = np.random.default_rng(int(person_seed))
    base = rng.normal(size=512).astype(np.float32)
    base /= np.linalg.norm(base)
    if pose_jitter:
        noise_rng = np.random.default_rng(int(person_seed) * 31 + 7)
        noise = noise_rng.normal(size=512).astype(np.float32)
        noise -= noise @ base * base
        noise /= np.linalg.norm(noise)
        vec = np.cos(pose_jitter) * base + np.sin(pose_jitter) * noise
        return vec / np.linalg.norm(vec)
    return base


class FakeFaceAnalysis:
    """Deterministic detector/embedder reading descriptors from pixels."""

    def __init__(self, *_, **__):
        pass

    def prepare(self, *_, **__):
        pass

    def get(self, frame: np.ndarray, max_num: int = 0) -> list:
        if frame.shape[0] < 1 or frame.shape[1] < 5:
            return []
        if not np.array_equal(frame[0, 0], MARKER):
            return []
        seed = int.from_bytes(bytes(frame[0, 1].tolist()) + b"\x00", "little")
        jitter = float(frame[0, 2, 0]) / 100.0
        score = float(frame[0, 2, 1]) / 255.0
        x1, y1, x2 = (int(v) * 4 for v in frame[0, 3])
        y2 = int(frame[0, 4, 0]) * 4
        kps = ARCFACE_DST * (x2 - x1) / 112.0 + np.array([x1, y1], np.float32)
        return [Face(bbox=np.array([x1, y1, x2, y2], np.float32), det_score=score,
                     kps=kps.astype(np.float32), normed_embedding=fake_embedding(seed, jitter))]

    def get_batch(self, frames: list, max_num: int = 0) -> list:
        return [self.get(f, max_num) for f in frames]
