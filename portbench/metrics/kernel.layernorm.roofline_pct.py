"""ATen's layer-norm kernel (``vectorized_layer_norm_kernel``) in the ViT:
the least time of the LayerNorms embedded inside the traced span over the
kernel's device time in it.  Bytes: each of the 49 LayerNorms (two a block
and the last) reads and writes 144 x 768 bf16 a crop
(``count.vit.layernorm_bytes``, from the reference module's shapes), over
the crops of the ``engine.embedder`` spans in the traced interval
(``count.vit.traced_crops``).  Nothing to read without the kernel in the
trace, without those spans, or for an embedder with no LayerNorm.  No
end-to-end metric of the cell reads device time: ``MOVES`` names the
cell's one besides ``setup_s``."""

from portbench import count
from portbench.count import vit

LAYER = "kernels"
UNIT = "%"
MOVES = "memory_peak_gib"
KERNEL = "layer_norm_kernel"


def read(run):
    if run.trace is None:
        return None
    us = run.trace.kernel_us(KERNEL)
    crops = vit.traced_crops(run)
    cfg = run.config
    moved = vit.layernorm_bytes(cfg["recognizer"], cfg["embed_size"], cfg["dtype"])
    if not us or not crops or not moved:
        return None
    t, _ = count.bound(crops * moved, 0.0, cfg["dtype"])
    return 100.0 * t / (us / 1e6)
