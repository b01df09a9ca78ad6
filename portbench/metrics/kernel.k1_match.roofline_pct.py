"""K1, the float32 gallery top-1 (``ops/match_kernel.py`` + ``csrc/match.cu``):
the least time of the decisions made inside the traced span over K1's
device time in them.  Bytes: the valid gallery rows x 512 x 4 plus the
queries, a call."""

from portbench import count

LAYER = "kernels"
UNIT = "%"
MOVES = "memory_peak_gib"
KERNEL = "top1_f32_kernel"


def read(run):
    if run.trace is None:
        return None
    us = run.trace.kernel_us(KERNEL)
    if not us or not run.traced_matches:
        return None
    moved = sum(count.match_f32_bytes(run.gallery_rows, n) for n in run.traced_matches)
    t, _ = count.bound(moved, 0.0, "float32")
    return 100.0 * t / (us / 1e6)
