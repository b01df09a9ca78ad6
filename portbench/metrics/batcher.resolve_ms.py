"""The batcher's resolver thread, a batch: the wait for the device, the
download and the ``Face`` objects.  The port's ``microbatch.resolve`` timer
over the window: its total over its count."""

LAYER = "batcher"
UNIT = "ms"
MOVES = "memory_peak_gib"


def read(run):
    n, total_s = run.timers["microbatch.resolve"]
    return total_s / n * 1e3 if n else None
