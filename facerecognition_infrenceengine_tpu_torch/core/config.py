"""Typed configuration tree.

The port's copy of ``facerecognition_infrenceengine_tpu/core/config.py``:
one dataclass tree (datastore, REST, thresholds, engine, gallery sync,
enrollment worker, campus), overridable from the environment, with the
reference's defaults.  ``EngineConfig`` holds the fields the ported
serving paths read.

The upstream service hardcodes a production MongoDB credential as the URI
default (app/config/config.py:8); this tree defaults to the embedded store
(``memory://``) instead.
"""

from __future__ import annotations

import dataclasses
import os
from dataclasses import dataclass, field
from typing import Any


def _env(name: str, default: Any, cast=None):
    raw = os.environ.get(name)
    if raw is None:
        return default
    if cast is bool:
        return raw.strip().lower() in ("1", "true", "yes", "on")
    if cast is None:
        cast = type(default) if default is not None else str
    try:
        return cast(raw)
    except (TypeError, ValueError):
        return default


@dataclass
class DBConfig:
    """Datastore endpoints (reference app/config/config.py:5-14)."""

    # "memory://" selects the embedded store; "file:///dir" persists it;
    # "fre://host:port" shares one embedded store across processes via
    # store.server; a mongodb:// URI selects pymongo when installed.
    # Never default to a remote credentialed URI.
    mongodb_uri: str = field(default_factory=lambda: _env("MONGODB_URI", "memory://"))
    database_name: str = field(default_factory=lambda: _env("DATABASE_NAME", "bharatlytics"))
    # Optional on-disk persistence dir for the embedded store ("" = RAM only).
    persist_dir: str = field(default_factory=lambda: _env("FRE_PERSIST_DIR", ""))


@dataclass
class APIConfig:
    """REST serving knobs (reference app/config/config.py:15-24, employee.py:51-52)."""

    host: str = field(default_factory=lambda: _env("HOST", "0.0.0.0"))
    port: int = field(default_factory=lambda: _env("PORT", 5000, int))
    debug: bool = field(default_factory=lambda: _env("DEBUG", False, bool))
    url_prefix: str = "/bharatlytics/v1"
    allowed_extensions: tuple = ("png", "jpg", "jpeg")
    # Reference queues one embedding job per model in ALLOWED_MODELS
    # (app/api/employee.py:163-178, app/config/config.py:24).
    allowed_models: tuple = ("buffalo_l", "mobile_facenet_v1")
    rate_limit_requests: int = 100  # employee.py:51
    rate_limit_window_s: float = 60.0  # employee.py:52


@dataclass
class ThresholdConfig:
    """All match/cluster thresholds (reference citations inline)."""

    detection: float = 0.3  # infrenceServer.py:406
    recognition: float = 0.4  # infrenceServer.py:407
    counting_recognition: float = 0.45  # peopleCount.py:829
    definitely_unknown: float = 0.35  # peopleCount.py:830
    unknown_cluster_join: float = 0.65  # peopleCount.py:232
    same_person: float = 0.4  # trainingServer.py:70
    duplicate_face: float = 0.4  # trainingServer.py:71


@dataclass
class EngineConfig:
    """Pipeline shapes and dtypes, micro-batching, streaming and the opt-in
    scale modes: the reference's fields, with its defaults."""

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
    # Micro-batching: max frames per dispatch and max wait to fill a batch.
    microbatch_max: int = 8
    microbatch_window_ms: float = 4.0
    # Frame-queue depth per camera before dropping (infrenceServer.py:629).
    frame_queue_depth: int = 2
    # Batches in flight beyond the one being dispatched (engine/microbatch.py):
    # 1 = double-buffering (batch k+1 is prepared and uploaded while batch k
    # runs and resolves); 2 adds a pipeline stage, at the cost of one more
    # batch cycle of latency.
    inflight_batches: int = 1
    # Upload each yuv420 frame to the device from its capture thread (inside
    # MicroBatcher.submit's prepare hook) instead of as one stacked batch on
    # the dispatch thread; the batch is then stacked on the device.
    # Admission control applies: a frame is uploaded only if its camera's
    # slot has room.
    upload_on_submit: bool = False
    # Adaptive streaming.  With stream_profile="auto" the MicroBatcher
    # measures each frame's submit->resolve latency and retunes
    # frame_queue_depth / inflight_batches every adapt_interval_s: it
    # tightens one knob when the window's p50 overshoots target_p50_ms, and
    # when p50 sits well under target while frames are dropped it loosens
    # one knob as a trial, kept only if resolved frames/s rose.  Drop-on-full
    # admission (reference infrenceServer.py:594-598) holds at every depth.
    stream_profile: str = "static"  # "static" | "auto"
    target_p50_ms: float = 300.0
    adapt_interval_s: float = 2.0
    # Gallery capacity grows by doubling from this block.
    gallery_block: int = 1024
    embed_dim: int = 512
    # Gallery matrix dtype on the device: "float32" | "bfloat16" | "int8".
    # float32 scores in true f32 (no TF32), the parity default.  int8 is
    # one global scale (ops/match_kernel.quantize_gallery) matched by K2:
    # near-tie top-1 decisions can flip, so it is opt-in for scale.
    gallery_dtype: str = "float32"
    # Evaluate the SCRFD stem in space-to-depth packed layout as plain convs
    # (models/packed_stem.py) on the raw-RGB detect.  A pure re-indexing of
    # the same weights (tests/test_torch_packed_stem.py); opt-in, as in the
    # reference, which measured it slower than its own stem lowering.
    packed_stem: bool = False
    # K4, the fused SCRFD stem (ops/stem_kernel.py), on the raw-RGB detect:
    # "on" | "off" | "auto" ("auto" is on only on a TPU in the reference,
    # so off here).
    stem_kernel: str = "off"
    # Stem of the packed-input programs (detect_align_embed_packed /
    # _yuv420): "unpack" undoes the s2d4 layout and runs the raw program;
    # "pallas" runs K4 on the packed frames and warps from a packed atlas;
    # "xla" runs the packed stem as three plain convs
    # (models/packed_stem.packed_stem_forward_s2d4) and warps from a packed
    # atlas.
    packed_stem_impl: str = "unpack"  # "unpack" | "xla" | "pallas"
    # Host -> device frame transport of FaceAnalysis.get_batch: "rgb"
    # (3 B/px canvases) or "yuv420" (4:2:0 YUV in s2d4 layout, 1.5 B/px,
    # content rows only; ops/yuv.py undoes it on the device).
    stream_transport: str = "rgb"
    # int8 post-training-quantized IResNet embedder (models/quant.py):
    # per-output-channel int8 weights, per-tensor activation scales
    # calibrated at build (FaceEngine.recalibrate_int8), s8 x s8 -> s32
    # convs (ops/int8_conv.py).  An opt-in scale mode, not the parity path;
    # r50 and r18 only (MobileFaceNet ignores it).
    embed_int8: bool = False
    # int8 PTQ SCRFD backbone (models/quant.scrfd_backbone_forward), the
    # same scheme; the neck and head stay float.  Opt-in, as in the
    # reference, which measured it slower than its float backbone.
    det_int8: bool = False

    def __post_init__(self):
        if self.packed_stem_impl not in ("unpack", "xla", "pallas"):
            raise ValueError(f"packed_stem_impl {self.packed_stem_impl!r}")
        if self.stem_kernel not in ("on", "off", "auto"):
            raise ValueError(f"stem_kernel {self.stem_kernel!r}")
        if self.stream_transport not in ("rgb", "yuv420"):
            raise ValueError(f"stream_transport {self.stream_transport!r}")


@dataclass
class SyncConfig:
    """Gallery sync cadences (infrenceServer.py:55, peopleCount.py:710)."""

    inference_sync_s: float = 30.0
    counting_sync_s: float = 60.0


@dataclass
class WorkerConfig:
    """Enrollment worker tunables (reference trainingServer.py:58-71)."""

    poll_interval_s: float = 2.0  # :65
    batch_size: int = 5  # :64
    max_workers: int = 3  # :66
    max_retries: int = 3  # :62
    heartbeat_s: float = 10.0  # :63
    stuck_job_timeout_s: float = 1800.0  # :69 (30 min)
    stuck_scan_interval_s: float = 300.0  # trainingServer.py:548
    cpu_backpressure_pct: float = 90.0  # :80-97
    mem_backpressure_pct: float = 85.0
    model_name: str = "buffalo_l"


@dataclass
class CampusConfig:
    """Entry/exit state machine knobs (reference peopleCount.py)."""

    confirm_delay_s: float = 2.0  # :144,161 second detection >=2s later
    pending_expiry_s: float = 5.0  # :178-185
    batch_size: int = 50  # :249
    batch_interval_s: float = 5.0  # :251
    analytics_interval_s: float = 60.0  # :589-626
    unknown_history: int = 10  # deque(maxlen=10) :68
    frame_skip: int = 2  # :938
    max_camera_errors: int = 10  # :944-945


@dataclass
class Config:
    db: DBConfig = field(default_factory=DBConfig)
    api: APIConfig = field(default_factory=APIConfig)
    thresholds: ThresholdConfig = field(default_factory=ThresholdConfig)
    engine: EngineConfig = field(default_factory=EngineConfig)
    sync: SyncConfig = field(default_factory=SyncConfig)
    worker: WorkerConfig = field(default_factory=WorkerConfig)
    campus: CampusConfig = field(default_factory=CampusConfig)

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)


_default: Config | None = None


def get_config() -> Config:
    global _default
    if _default is None:
        _default = Config()
    return _default


def set_config(cfg: Config) -> None:
    global _default
    _default = cfg
