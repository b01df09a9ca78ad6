"""The configuration subset the serving paths read.

A copy of the fields of the reference's ``EngineConfig`` and
``ThresholdConfig`` (``facerecognition_infrenceengine_tpu/core/config.py``)
that detect -> align -> embed -> match uses, with the same defaults: the
raw-RGB path and the packed / yuv420 streaming path.
"""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass
class ThresholdConfig:
    """Match thresholds (reference infrenceServer.py:406-407)."""

    detection: float = 0.3
    recognition: float = 0.4


@dataclass
class EngineConfig:
    """Pipeline shapes and dtypes."""

    # Detector input canvas (static shape of every detect program).
    det_size: tuple = (640, 640)
    # Detections kept per frame after NMS (fixed slot count).
    max_faces: int = 32
    # Candidates kept by the pre-NMS top-k over anchor scores.
    pre_nms_topk: int = 512
    nms_iou: float = 0.4
    # Embedder crop size (ArcFace convention).
    embed_size: int = 112
    # Compute dtype of the detector and embedder: "bfloat16" | "float32".
    dtype: str = "bfloat16"
    # Gallery capacity grows by doubling from this block.
    gallery_block: int = 1024
    embed_dim: int = 512
    # Gallery matrix dtype on the device: "float32" | "bfloat16" | "int8".
    # float32 scores in true f32 (no TF32), the parity default.  int8 is
    # one global scale (ops/match_kernel.quantize_gallery) matched by K2:
    # near-tie top-1 decisions can flip, so it is opt-in for scale.
    gallery_dtype: str = "float32"
    # K4, the fused SCRFD stem (ops/stem_kernel.py), on the raw-RGB detect:
    # "on" | "off" | "auto" ("auto" is on only on a TPU in the reference,
    # so off here).
    stem_kernel: str = "off"
    # Stem of the packed-input programs (detect_align_embed_packed /
    # _yuv420): "unpack" undoes the s2d4 layout and runs the raw program;
    # "pallas" runs K4 on the packed frames and warps from a packed atlas.
    # "xla" (the packed stem as plain convs) is not ported.
    packed_stem_impl: str = "unpack"
    # Host -> device frame transport of FaceAnalysis.get_batch: "rgb"
    # (3 B/px canvases) or "yuv420" (4:2:0 YUV in s2d4 layout, 1.5 B/px,
    # content rows only; ops/yuv.py undoes it on the device).
    stream_transport: str = "rgb"

    def __post_init__(self):
        if self.packed_stem_impl == "xla":
            raise NotImplementedError(
                'packed_stem_impl="xla" (the packed stem as plain convs) is '
                "ROADMAP Queue 1 item 8; use \"unpack\" or \"pallas\"")
        if self.packed_stem_impl not in ("unpack", "pallas"):
            raise ValueError(f"packed_stem_impl {self.packed_stem_impl!r}")
        if self.stem_kernel not in ("on", "off", "auto"):
            raise ValueError(f"stem_kernel {self.stem_kernel!r}")
        if self.stream_transport not in ("rgb", "yuv420"):
            raise ValueError(f"stream_transport {self.stream_transport!r}")


@dataclass
class Config:
    thresholds: ThresholdConfig = field(default_factory=ThresholdConfig)
    engine: EngineConfig = field(default_factory=EngineConfig)
