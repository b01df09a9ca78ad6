"""The serving loop (``engine/microbatch.py`` and the results thread, as
``domain/cameras.py`` runs them): the 95th percentile, nearest rank, of
the time from a client's submit to the return of its frame's
``match_faces``, over the frames submitted in the window.  In a traced run
the frames whose time overlaps the trace's start or stop (which hold every
serving thread up) are left out.  A per-layer metric: the card idles most
of every cell's window, so the tail follows the host's threads."""

import math

LAYER = "serving loop"
UNIT = "ms"
MOVES = "memory_peak_gib"


def read(run):
    lat = sorted(run.latencies)
    return lat[max(0, math.ceil(0.95 * len(lat)) - 1)] if lat else None
