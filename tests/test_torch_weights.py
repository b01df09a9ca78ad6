"""Port weights vs the reference: synthetic leaves, packs and from_flax.

The port derives the flax leaf paths from its own torch modules, so equal
trees pin both the synthetic values and the module naming.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from facerecognition_infrenceengine_tpu.models import arcface as jarcface
from facerecognition_infrenceengine_tpu.models import genderage as jgenderage
from facerecognition_infrenceengine_tpu.models import landmark106 as jlandmark106
from facerecognition_infrenceengine_tpu.models import scrfd as jscrfd
from facerecognition_infrenceengine_tpu.models.weights import (
    flatten_tree, load_or_init as jax_load_or_init, save_variables)
from facerecognition_infrenceengine_tpu_torch.models import (
    arcface, genderage, landmark106, scrfd, weights)


def _pair(name):
    if name == "genderage":
        return jgenderage.GenderAge(), (1, 96, 96, 3), genderage.GenderAge()
    if name == "landmark_2d_106":
        return jlandmark106.Landmark106(), (1, 192, 192, 3), landmark106.Landmark106()
    if name.startswith("scrfd_"):
        arch = name[len("scrfd_"):]
        return (jscrfd.SCRFD(jscrfd.CONFIGS[arch]), (1, 64, 64, 3),
                scrfd.SCRFD(scrfd.CONFIGS[arch]))
    jm = jarcface.iresnet50() if name.endswith("r50") else jarcface.iresnet18()
    tm = arcface.iresnet50() if name.endswith("r50") else arcface.iresnet18()
    return jm, (1, 112, 112, 3), tm


@pytest.mark.parametrize("name,seed", [("scrfd_det_10g", 0), ("arcface_r50", 1),
                                       ("genderage", 7), ("landmark_2d_106", 8)])
def test_synthetic_tree_equals_reference_leaf_for_leaf(name, seed):
    jm, shape, tm = _pair(name)
    ref = flatten_tree(jax_load_or_init(name, jm, jnp.zeros(shape), seed))
    mine = weights.synthetic_tree(tm, seed)
    assert set(mine) == set(ref)
    for path, leaf in ref.items():
        assert mine[path].dtype == leaf.dtype, path
        np.testing.assert_array_equal(mine[path], leaf, err_msg=path)


@pytest.mark.parametrize("name", ["scrfd_det_10g", "arcface_r50", "genderage",
                                  "landmark_2d_106"])
def test_from_flax_round_trips_shapes(name):
    _, _, tm = _pair(name)
    flat = weights.synthetic_tree(tm, 3)
    state = weights.from_flax(flat, tm)
    expect = {k: tuple(v.shape) for k, v in tm.state_dict().items()
              if not k.endswith("num_batches_tracked")}
    assert {k: tuple(v.shape) for k, v in state.items()} == expect
    weights.load_tree(tm, flat)
    # the inverse permutations bring every leaf back unchanged
    for key, path, _, _ in weights.flax_layout(tm):
        t = tm.state_dict()[key].numpy()
        if t.ndim == 4:
            t = t.transpose(2, 3, 1, 0)
        elif key.endswith("Dense_0.weight") and hasattr(tm.Dense_0, "flatten_chw"):
            c, h, w = tm.Dense_0.flatten_chw
            t = t.reshape(-1, c, h, w).transpose(2, 3, 1, 0).reshape(h * w * c, -1)
        elif key.endswith("Dense_0.weight"):  # a Dense after a spatial mean
            t = t.T
        np.testing.assert_array_equal(t, flat[path], err_msg=path)


def test_from_flax_rejects_missing_and_misshapen_leaves():
    tm = scrfd.SCRFD(scrfd.CONFIGS["det_500m"])
    flat = weights.synthetic_tree(tm, 0)
    missing = dict(flat)
    missing.pop("params/head/cls/bias")
    with pytest.raises(KeyError):
        weights.from_flax(missing, tm)
    bad = dict(flat)
    bad["params/head/cls/bias"] = np.zeros(3, np.float32)
    with pytest.raises(ValueError):
        weights.from_flax(bad, tm)


def test_npz_pack_loads_like_the_reference(tmp_path, monkeypatch):
    """A pack saved by the reference loads into the port with the same
    leaves, and load_or_init prefers it over synthetic weights."""
    jm, shape, tm = _pair("scrfd_det_500m")
    ref = jax_load_or_init("scrfd_det_500m", jm, jnp.zeros(shape), 7)
    save_variables(str(tmp_path / "scrfd_det_500m.npz"), ref)
    monkeypatch.setenv("FRE_WEIGHTS_DIR", str(tmp_path))
    weights.load_or_init("scrfd_det_500m", tm, seed=0)  # seed ignored: pack wins
    want = weights.from_flax(flatten_tree(ref), tm)
    for key, val in want.items():
        torch.testing.assert_close(tm.state_dict()[key], val, rtol=0, atol=0)
