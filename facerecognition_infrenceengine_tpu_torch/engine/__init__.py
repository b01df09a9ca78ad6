from .pipeline import FaceEngine, DetectionBatch, bucket  # noqa: F401
