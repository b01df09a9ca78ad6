"""The ViT's attention (``F.scaled_dot_product_attention`` pinned to
FlashAttention-2 on the card, ``engine/pipeline.py``): the least time of
the attention embedded inside the traced span over the kernel's device time
in it.  Operations: each block's QK^T and AV, 2 x 2 x 144^2 x 96 x 8 a
block and crop; bytes: q, k and v read and the output written, 884,736 B a
block and crop in bf16 (``count.vit.attention_work``, from the reference
module's shapes), over the crops of the ``engine.embedder`` spans in the
traced interval (``count.vit.traced_crops``).  Nothing to read without the
kernel in the trace, without those spans, or for an embedder with no
attention.  No end-to-end metric of the cell reads device time: ``MOVES``
names the cell's one besides ``setup_s``."""

from portbench import count
from portbench.count import vit

LAYER = "kernels"
UNIT = "%"
MOVES = "memory_peak_gib"
KERNEL = "flash_fwd"


def read(run):
    if run.trace is None:
        return None
    us = run.trace.kernel_us(KERNEL)
    crops = vit.traced_crops(run)
    cfg = run.config
    flops, moved = vit.attention_work(cfg["recognizer"], cfg["embed_size"], cfg["dtype"])
    if not us or not crops or not flops:
        return None
    t, _ = count.bound(crops * moved, crops * flops, cfg["dtype"])
    return 100.0 * t / (us / 1e6)
