"""The batcher's dispatch thread, a batch: the facade's host preparation
and upload, and on a two-program path the whole synchronous get_batch.
The port's ``microbatch.dispatch`` timer over the window: its total over
its count (never its 256-entry ring)."""

LAYER = "batcher"
UNIT = "ms"
MOVES = "memory_peak_gib"


def read(run):
    n, total_s = run.timers["microbatch.dispatch"]
    return total_s / n * 1e3 if n else None
