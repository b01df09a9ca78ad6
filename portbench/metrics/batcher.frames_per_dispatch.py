"""The batcher: the frames a dispatch takes over the window, from the
port's ``microbatch.frames`` counter over its ``microbatch.dispatch``
timer's count.  Below ``microbatch_max`` the batcher split the load into
smaller batches, each paying the whole per-batch host and launch cost."""

LAYER = "batcher"
UNIT = "frames"
MOVES = "memory_peak_gib"


def read(run):
    frames, _ = run.timers["microbatch.frames"]
    n, _ = run.timers["microbatch.dispatch"]
    return frames / n if n else None
