"""The embedder's epilogue kernel (``ops/epilogue_kernel.py`` +
``csrc/epilogue.cu``, IResNet's BatchNorm / PReLU / residual passes in
``arcface.serve_forward``): the least time of the batches dispatched inside
the traced span over the kernel's device time in them.  Bytes: each pass's
activation read and written, and the residual read where the pass adds
it, in the configuration's dtype (``count.epilogue_bytes``), for every
slot the batches embedded: the port's fused program embeds each frame's
``max_faces`` slots, a face detected there or not.  Frames that the port
adds to round a batch up to its bucket are not counted, so such a batch
reads low, never high.  Nothing to read for an embedder that is not an
IResNet, or in a trace without the kernel.  No end-to-end metric of the
cell reads the kernel's gain, which is device time: ``MOVES`` names the
cell's one end-to-end metric besides ``setup_s``, which this kernel does
not move."""

from portbench import count

LAYER = "kernels"
UNIT = "%"
MOVES = "memory_peak_gib"
KERNEL = "::epilogue_kernel<"


def read(run):
    if run.trace is None:
        return None
    us = run.trace.kernel_us(KERNEL)
    moved = count.epilogue_bytes(run.config,
                                 sum(run.traced_dispatches) * run.config["max_faces"])
    if not us or not moved:
        return None
    t, _ = count.bound(moved, 0.0, run.config["dtype"])
    return 100.0 * t / (us / 1e6)
