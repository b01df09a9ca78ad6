"""The device: the share of the traced span with no kernel, copy or memset
running."""

LAYER = "device"
UNIT = "%"
MOVES = "memory_peak_gib"


def read(run):
    if run.trace is None or run.trace.window_s <= 0 or not run.trace.busy:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)
