"""Port models vs the reference flax forwards, float32 on both sides.

Synthetic weights (unit BN, He-normal convs) grow activations layer by
layer: the SCRFD heads reach ~1e3 on a full-contrast canvas, where f32
summation order alone moves the last ~2e-6 relative.  Head tolerances are
therefore atol 1e-4 scaled by the head's magnitude (max(1, max|ref|)).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from facerecognition_infrenceengine_tpu.models import arcface as jarcface
from facerecognition_infrenceengine_tpu.models import scrfd as jscrfd
from facerecognition_infrenceengine_tpu.models.weights import load_or_init as jax_load_or_init
from facerecognition_infrenceengine_tpu_torch.models import arcface, scrfd, weights


@pytest.mark.parametrize("arch", ["r18", "r50"])
def test_iresnet_embeddings_match_flax(arch):
    jm = jarcface.iresnet50() if arch == "r50" else jarcface.iresnet18()
    tm = arcface.iresnet50() if arch == "r50" else arcface.iresnet18()
    name = f"arcface_{arch}"
    jv = jax_load_or_init(name, jm, jnp.zeros((1, 112, 112, 3)), 1)
    weights.load_or_init(name, tm, 1)
    crops = np.random.default_rng(0).integers(0, 256, (2, 112, 112, 3), dtype=np.uint8)
    want = np.asarray(jm.apply(jv, jarcface.preprocess(jnp.asarray(crops))))
    with torch.no_grad():
        got = tm(arcface.preprocess(torch.from_numpy(crops))).numpy()
    cos = (want * got).sum(1) / np.linalg.norm(want, axis=1) / np.linalg.norm(got, axis=1)
    assert np.all(1.0 - cos <= 1e-4), cos


@pytest.mark.parametrize("arch", ["det_2.5g", "det_10g"])
def test_scrfd_heads_match_flax(arch):
    jm, tm = jscrfd.SCRFD(jscrfd.CONFIGS[arch]), scrfd.SCRFD(scrfd.CONFIGS[arch])
    name = f"scrfd_{arch}"
    jv = jax_load_or_init(name, jm, jnp.zeros((1, 128, 128, 3)), 0)
    weights.load_or_init(name, tm, 0)
    canvas = np.random.default_rng(1).integers(0, 256, (2, 128, 128, 3), dtype=np.uint8)
    want = jm.apply(jv, jscrfd.preprocess(jnp.asarray(canvas)))
    with torch.no_grad():
        got = tm(scrfd.preprocess(torch.from_numpy(canvas)))
    a = scrfd.num_anchors_total(128, 128)
    for w, g, k in zip(want, got, (1, 4, 10)):
        w, g = np.asarray(w), g.numpy()
        assert g.shape == w.shape == (2, a, k)
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-4 * max(1.0, np.abs(w).max()))


def test_scrfd_det_10g_parameter_count():
    """tests/test_scrfd_census.py pins the flax graph at 3,857,685."""
    tm = scrfd.SCRFD(scrfd.CONFIGS["det_10g"])
    assert sum(p.numel() for p in tm.parameters()) == 3857685
