"""The configuration subset the serving path reads.

A copy of the fields of the reference's ``EngineConfig`` and
``ThresholdConfig`` (``facerecognition_infrenceengine_tpu/core/config.py``)
that detect -> align -> embed -> match uses, with the same defaults.
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
    # Gallery matrix dtype on the device: "float32" | "bfloat16".
    # float32 scores in true f32 (no TF32), the parity default.
    gallery_dtype: str = "float32"


@dataclass
class Config:
    thresholds: ThresholdConfig = field(default_factory=ThresholdConfig)
    engine: EngineConfig = field(default_factory=EngineConfig)
