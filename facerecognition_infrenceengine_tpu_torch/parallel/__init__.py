"""The device mesh and the distributed gallery top-k (one process drives
every device; see ``sharding.py``)."""

from .sharding import (  # noqa: F401
    AXIS_DATA,
    AXIS_GALLERY,
    build_mesh,
    gallery_sharding,
    replicated,
    batch_sharding,
)
from .topk import distributed_top1, distributed_topk  # noqa: F401
