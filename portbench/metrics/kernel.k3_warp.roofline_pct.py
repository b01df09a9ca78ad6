"""K3, the face warp (``ops/warp_kernel.py`` + ``csrc/warp.cu``): the least
time of the batches dispatched inside the traced span over K3's device time
in them.  Bytes: the float32 crops written (112 for the embedder; 96 and
192 for the attribute heads) plus one read of each face's 192 x 192 x 3 u8
atlas window, for every face the batches served."""

from portbench import count

LAYER = "kernels"
UNIT = "%"
MOVES = "memory_peak_gib"
KERNEL = "warp_windows_kernel"


def read(run):
    if run.trace is None:
        return None
    us = run.trace.kernel_us(KERNEL)
    faces = sum(run.traced_faces)
    if not us or not faces:
        return None
    cfg = run.config
    heads = cfg.get("attribute_heads") or {}
    sides = [cfg["embed_size"]] + [head["input"] for head in heads.values()]
    t, _ = count.bound(count.warp_bytes(faces, sides), 0.0, "bfloat16")
    return 100.0 * t / (us / 1e6)
