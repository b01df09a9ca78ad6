from .anchors import anchor_centers  # noqa: F401
from .boxes import distance2bbox, distance2kps, pairwise_iou  # noqa: F401
from .nms import nms_padded  # noqa: F401
from .align import umeyama_similarity, warp_face, ARCFACE_DST  # noqa: F401
from .matching import l2_normalize, cosine_scores, cosine_topk  # noqa: F401
