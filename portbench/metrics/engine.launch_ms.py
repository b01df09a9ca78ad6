"""The engine and models: the Python that launches a traced batch's
programs (the detector, the embedder, the attribute heads, their
preprocessing and the K3 / K4 wrappers), the self time of the port's
``engine.detect``, ``engine.embed``, ``engine.attributes`` and
``engine.fused`` spans (their uploads and downloads left out)."""

from portbench import spans

LAYER = "engine + models"
UNIT = "ms"
MOVES = "memory_peak_gib"


def read(run):
    return spans.self_ms_per_batch(run, spans.ENGINE_MODULES)
