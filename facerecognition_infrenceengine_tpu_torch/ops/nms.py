"""Static-shape greedy NMS, batched over images.

The padded formulation of ``facerecognition_infrenceengine_tpu/ops/nms.py``:
invalid candidates carry -inf scores, ``max_out`` pick-max-then-suppress
steps run over a precomputed IoU matrix, and the result is ``max_out``
fixed slots plus a validity mask.  Decisions equal classic greedy NMS.
"""

from __future__ import annotations

import torch

from .boxes import pairwise_iou


def nms_padded(boxes: torch.Tensor, scores: torch.Tensor, *, max_out: int = 32,
               iou_thresh: float = 0.4, iou_offset: float = 1.0):
    """Greedy NMS over K padded candidates per image.

    Args:
      boxes:  [..., K, 4] xyxy.
      scores: [..., K], -inf for padding.
      max_out: number of output slots.
      iou_thresh: suppression threshold.
      iou_offset: 1.0 = insightface's integer-pixel IoU.

    Returns (boxes [..., max_out, 4], scores [..., max_out], keep_idx
    [..., max_out] int32 into the input order, valid [..., max_out] bool).
    Picks are the first maximum on ties (``argmax``), as in the reference.
    """
    lead = scores.shape[:-1]
    k = scores.shape[-1]
    boxes2 = boxes.reshape(-1, k, 4)
    live = scores.reshape(-1, k).clone()
    n = live.shape[0]
    iou = pairwise_iou(boxes2, boxes2, offset=iou_offset)  # [N, K, K]
    rows = torch.arange(n, device=scores.device)
    cols = torch.arange(k, device=scores.device)
    picks, pick_scores = [], []
    # Once a step finds nothing live, every later step finds nothing too,
    # so slot ``step`` is the step's pick.
    for _ in range(max_out):
        i = torch.argmax(live, dim=1)
        s = live[rows, i]
        ok = s > float("-inf")
        suppress = (iou[rows, i] > iou_thresh) | (cols[None, :] == i[:, None])
        live = live.masked_fill(ok[:, None] & suppress, float("-inf"))
        picks.append(torch.where(ok, i, torch.full_like(i, -1)))
        pick_scores.append(s.masked_fill(~ok, float("-inf")))
    picks = torch.stack(picks, dim=1)
    pick_scores = torch.stack(pick_scores, dim=1)
    valid = pick_scores > float("-inf")
    safe = torch.clamp(picks, min=0)
    out_boxes = torch.where(valid[..., None],
                            torch.gather(boxes2, 1, safe[..., None].expand(-1, -1, 4)),
                            torch.zeros((), dtype=boxes.dtype, device=boxes.device))
    out_scores = torch.where(valid, pick_scores, torch.zeros_like(pick_scores))
    return (out_boxes.reshape(*lead, max_out, 4), out_scores.reshape(*lead, max_out),
            safe.to(torch.int32).reshape(*lead, max_out), valid.reshape(*lead, max_out))
