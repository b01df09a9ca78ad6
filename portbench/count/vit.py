"""The vision transformer's attention and LayerNorm work, counted from the
shapes of the reference module at the configuration's widths (built and run
on the meta device: no weights, no compute), and the crops a traced span
embedded, from the port's ``engine.embedder`` spans.

Attention, a crop: each block's QK^T and AV, 2 x 2 x tokens^2 x head_dim
operations a head; bytes, q, k and v read and the output written once,
4 x tokens x width elements.  LayerNorm, a crop: each LayerNorm's input
read and its output written once.  Both in the configuration's dtype; an
embedder with neither gives 0.
"""

from __future__ import annotations

import torch

from .. import spans
from ..reference import vit
from ..reference.pipeline import embedder_factory


def _shapes(rec: dict, side: int, kind) -> list:
    """The input shapes [tokens, width] of every ``kind`` submodule of the
    reference module, over one crop of ``side`` x ``side``."""
    with torch.device("meta"):
        model = embedder_factory(rec)().eval()
    seen: list = []
    hooks = [m.register_forward_pre_hook(lambda m, args: seen.append((m, tuple(args[0].shape[1:]))))
             for m in model.modules() if isinstance(m, kind)]
    with torch.no_grad():
        model(torch.zeros((1, side, side, 3), device="meta"))
    for h in hooks:
        h.remove()
    return seen


def attention_work(rec: dict, side: int, dtype: str) -> tuple:
    """(operations, bytes) of every attention of one crop's forward."""
    flops = moved = 0.0
    for m, (tokens, width) in _shapes(rec, side, vit.Attention):
        flops += 2.0 * 2 * tokens * tokens * m.head_dim * m.heads
        moved += 4.0 * tokens * width * getattr(torch, dtype).itemsize
    return flops, moved


def layernorm_bytes(rec: dict, side: int, dtype: str) -> float:
    """Bytes every LayerNorm of one crop's forward reads and writes."""
    return float(sum(2 * tokens * width * getattr(torch, dtype).itemsize
                     for _, (tokens, width) in _shapes(rec, side, torch.nn.LayerNorm)))


def traced_crops(run) -> int:
    """The crops embedded inside the traced interval: the ``crops`` of the
    port's ``engine.embedder`` spans there (0 where it records none).  Each
    embedder call runs inside the port's device gate, whose holder the
    trace's start and stop wait for, so its device work lies wholly inside
    the trace or wholly outside it.  A batch whose dispatch span began
    before the start (and waited at the gate) embeds inside the trace, so
    the spans are taken whether a traced batch holds them or not."""
    p = spans.traced(run)
    return sum(s.attrs.get("crops", 0) for s in (p.spans if p else ())
               if s.name == "engine.embedder" and spans.in_interval(p, s.start_ns)
               and spans.in_interval(p, s.end_ns))
