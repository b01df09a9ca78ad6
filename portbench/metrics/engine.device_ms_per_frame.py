"""The engine and models: the traced span's device busy time (kernels,
copies and memsets, overlaps merged) over the frames of the batches
dispatched inside it (their device work lies wholly inside the trace)."""

LAYER = "engine + models"
UNIT = "ms"
MOVES = "memory_peak_gib"


def read(run):
    if run.trace is None or not run.traced_dispatches or not run.trace.busy:
        return None
    return run.trace.busy_s * 1e3 / sum(run.traced_dispatches)
