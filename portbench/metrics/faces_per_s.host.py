"""The serving loop (``engine/microbatch.py`` and the results thread, as
``domain/cameras.py`` runs them): faces resolved to a decision over the
window's seconds.  In a traced run the time the trace's start and stop held
the serving threads up, and the frames answered in it, are left out.  A
per-layer metric: the card idles most of the window, so the rate follows
the host's threads, and on these machines the host's speed drifts from
minute to minute by more than any bound allows."""

LAYER = "serving loop"
UNIT = "faces/s"
MOVES = "memory_peak_gib"


def read(run):
    if not run.clear_frames or run.clear_s <= 0:
        return None
    return sum(f.n_faces for f in run.clear_frames) / run.clear_s
