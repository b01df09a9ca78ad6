"""The whole step's share of the card's bf16 peak: the model operations of
the frames answered in the window (detector on the canvas, embedder and
attribute heads on each face served, counted from the configuration's
shapes) over
the window's seconds x 989 TFLOP/s.  In a traced run the time the trace's
start and stop held the serving threads up, and the frames answered in it,
are left out."""

from portbench import count

LAYER = "engine + models"
UNIT = "%"
MOVES = "memory_peak_gib"


def read(run):
    if not run.clear_frames or run.clear_s <= 0:
        return None
    faces = sum(f.n_faces for f in run.clear_frames)
    per_face = (run.flops["embedder"] + run.flops.get("heads", 0.0)) / run.config["max_faces"]
    flops = len(run.clear_frames) * run.flops["detector"] + faces * per_face
    return 100.0 * flops / (run.clear_s * count.PEAK_FLOPS["bfloat16"])
