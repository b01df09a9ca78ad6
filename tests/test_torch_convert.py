"""ONNX conversion inside the port (``models/convert_onnx.py``) against the
reference's tool (``tools/convert_onnx.py``), with no JAX on the port's side.

- Each port ``layer_execution_order`` (det_10g, det_2.5g, det_500m, r50,
  r18, MobileFaceNet) equals the reference's list, and its expansion covers
  the port's own ``flax_layout`` paths one to one (the bijection cases of
  tests/test_scrfd_census.py).
- ``save_variables`` / ``load_variables`` / ``flatten_shapes`` keep the
  reference's ``.npz`` format: the arrays round-trip bit for bit, and each
  package reads the other's file.
- On one ``tools/synthetic_pack.make_pack`` pack, written once for the
  module, the port's converter writes the same files as the reference's:
  the same ``.npz`` keys with bit-equal float32 arrays, and the attribute
  graphs byte for byte.  A layer too few or too many, or a shape that
  disagrees, raises, and a pack that fails writes nothing.
"""

import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

from facerecognition_infrenceengine_tpu.models import arcface as jarcface
from facerecognition_infrenceengine_tpu.models import mobilefacenet as jmobilefacenet
from facerecognition_infrenceengine_tpu.models import scrfd as jscrfd
from facerecognition_infrenceengine_tpu.models import weights as jweights
from facerecognition_infrenceengine_tpu_torch.models import (arcface, convert_onnx,
                                                              mobilefacenet, scrfd, weights)
from tools import convert_onnx as ref_convert
from tools import synthetic_pack

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CONFIGS = {
    "det_10g": (lambda m: m.layer_execution_order(m.CONFIGS["det_10g"]), "scrfd",
                lambda: scrfd.SCRFD(scrfd.CONFIGS["det_10g"])),
    "det_2.5g": (lambda m: m.layer_execution_order(m.CONFIGS["det_2.5g"]), "scrfd",
                 lambda: scrfd.SCRFD(scrfd.CONFIGS["det_2.5g"])),
    "det_500m": (lambda m: m.layer_execution_order(m.CONFIGS["det_500m"]), "scrfd",
                 lambda: scrfd.SCRFD(scrfd.CONFIGS["det_500m"])),
    "r50": (lambda m: m.layer_execution_order((3, 4, 14, 3)), "arcface", arcface.iresnet50),
    "r18": (lambda m: m.layer_execution_order((2, 2, 2, 2)), "arcface", arcface.iresnet18),
    "mobilefacenet": (lambda m: m.layer_execution_order(), "mobilefacenet",
                      mobilefacenet.mobilefacenet),
}
PORT = {"scrfd": scrfd, "arcface": arcface, "mobilefacenet": mobilefacenet}
REF = {"scrfd": jscrfd, "arcface": jarcface, "mobilefacenet": jmobilefacenet}


@pytest.mark.parametrize("name", list(CONFIGS))
def test_layer_execution_order_is_the_reference_list(name):
    order, family, _ = CONFIGS[name]
    got, want = order(PORT[family]), order(REF[family])
    assert got == want
    assert all(isinstance(e, tuple) for e in got)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_layer_execution_order_covers_the_flax_layout(name):
    """The expanded order maps one to one onto the port module's flax
    layers: convs, BatchNorms, PReLUs, Denses and bbox scales."""
    order, family, factory = CONFIGS[name]
    tree = {path: shape for _, path, shape, _ in weights.flax_layout(factory())}
    expanded = convert_onnx._expand_order(order(PORT[family]))
    paths = [e[1] for e in expanded]
    assert len(paths) == len(set(paths))

    def of(kinds):
        return {e[1] for e in expanded if e[0] in kinds}

    assert of(("conv",)) == {k.rsplit("/", 1)[0] for k in tree
                             if k.endswith("/kernel") and "Dense" not in k}
    assert of(("bn",)) == {k.rsplit("/", 1)[0] for k in tree if k.startswith("params/")
                           and "BatchNorm" in k and k.endswith("/scale")}
    assert of(("prelu",)) == {k.rsplit("/", 1)[0] for k in tree if k.endswith("/alpha")}
    assert of(("dense", "dense_flatten")) == {k.rsplit("/", 1)[0] for k in tree
                                              if k.endswith("/kernel") and "Dense" in k}
    assert of(("scale",)) == {k for k in tree if "bbox_scale" in k}
    # every leaf of the layout belongs to a listed layer
    layers = {e[1] for e in expanded}
    for k in tree:
        owner = k if "bbox_scale" in k else k.rsplit("/", 1)[0]
        if k.startswith("batch_stats/"):
            owner = "params/" + owner[len("batch_stats/"):]
        assert owner in layers, k


def _tree():
    rng = np.random.default_rng(0)
    return {"params": {"Conv_0": {"kernel": rng.normal(size=(3, 3, 3, 8)).astype(np.float32)},
                       "BatchNorm_0": {"scale": np.ones(8, np.float32),
                                       "bias": rng.normal(size=8).astype(np.float32)},
                       "bbox_scale_0": np.array([1.5], np.float32)},
            "batch_stats": {"BatchNorm_0": {"mean": rng.normal(size=8).astype(np.float32),
                                            "var": rng.uniform(0.5, 2, 8).astype(np.float32)}}}


def _assert_trees_equal(got, want):
    flat_got, flat_want = weights.flatten_tree(got), weights.flatten_tree(want)
    assert sorted(flat_got) == sorted(flat_want)
    for k, v in flat_want.items():
        assert flat_got[k].dtype == v.dtype and flat_got[k].shape == v.shape, k
        np.testing.assert_array_equal(flat_got[k], v, err_msg=k)


def test_save_and_load_variables_round_trip(tmp_path):
    tree = _tree()
    path = str(tmp_path / "w.npz")
    weights.save_variables(path, tree)
    with np.load(path) as z:
        assert sorted(z.files) == sorted(jweights.flatten_tree(tree))
    got = weights.load_variables(path)
    _assert_trees_equal(got, tree)
    assert isinstance(got["params"]["Conv_0"]["kernel"], np.ndarray)


def test_each_package_reads_the_others_file(tmp_path):
    tree = _tree()
    mine, theirs = str(tmp_path / "port.npz"), str(tmp_path / "ref.npz")
    weights.save_variables(mine, tree)
    jweights.save_variables(theirs, tree)
    _assert_trees_equal(jweights.load_variables(mine), tree)  # jnp leaves
    _assert_trees_equal(weights.load_variables(theirs), tree)
    with np.load(mine) as a, np.load(theirs) as b:
        assert sorted(a.files) == sorted(b.files)


def test_flatten_shapes_is_the_reference_walk():
    shapes = {"params": {"a": {"kernel": (3, 3, 1, 4), "bias": (4,)}, "s": (1,)},
              "batch_stats": {"a": {"mean": (4,)}}}
    assert weights.flatten_shapes(shapes) == jweights.flatten_shapes(shapes)
    tree = _tree()
    assert sorted(weights.flatten_tree(tree)) == sorted(jweights.flatten_tree(tree))


@pytest.fixture(scope="module")
def packs(tmp_path_factory):
    """One synthetic pack, converted by the reference's tool and by the port's."""
    pack_dir = str(tmp_path_factory.mktemp("fake_buffalo_l"))
    want_dir = str(tmp_path_factory.mktemp("ref_converted"))
    got_dir = str(tmp_path_factory.mktemp("port_converted"))
    synthetic_pack.make_pack(pack_dir, seed=0)
    ref_convert.convert(pack_dir, want_dir)
    written = convert_onnx.convert(pack_dir, got_dir)
    return pack_dir, want_dir, got_dir, written


def test_converter_writes_the_reference_files(packs):
    _, want_dir, got_dir, written = packs
    assert sorted(os.listdir(got_dir)) == sorted(os.listdir(want_dir)) == sorted(
        [f"{n}.npz" for n in ("scrfd_det_10g", "arcface_r50", "arcface_mobilefacenet")]
        + [dst for _, dst in convert_onnx.ATTRIBUTE_GRAPHS])
    assert written["scrfd_det_10g"] == 47 + 13 + 34 * 4 + 3  # det_10g's 199 initializers


@pytest.mark.parametrize("name", ["scrfd_det_10g", "arcface_r50", "arcface_mobilefacenet"])
def test_converted_npz_is_bit_equal_to_the_reference(packs, name):
    _, want_dir, got_dir, written = packs
    with np.load(os.path.join(want_dir, f"{name}.npz")) as w, \
            np.load(os.path.join(got_dir, f"{name}.npz")) as g:
        assert sorted(g.files) == sorted(w.files)
        assert written[name] == len(g.files)
        for k in w.files:
            assert g[k].dtype == w[k].dtype == np.float32, k
            assert g[k].shape == w[k].shape, k
            assert g[k].tobytes() == w[k].tobytes(), k


@pytest.mark.parametrize("dst", [dst for _, dst in convert_onnx.ATTRIBUTE_GRAPHS])
def test_attribute_graphs_are_copied_byte_for_byte(packs, dst):
    pack_dir, want_dir, got_dir, _ = packs
    src = dict((d, s) for s, d in convert_onnx.ATTRIBUTE_GRAPHS)[dst]
    with open(os.path.join(got_dir, dst), "rb") as g, open(os.path.join(want_dir, dst), "rb") as w, \
            open(os.path.join(pack_dir, src), "rb") as s:
        got = g.read()
        assert got == w.read() == s.read()


def test_convert_attribute_graphs_alone_is_the_reference(packs, tmp_path):
    pack_dir = packs[0]
    mine, theirs = tmp_path / "port", tmp_path / "ref"
    theirs.mkdir()
    written = convert_onnx.convert_attribute_graphs(pack_dir, str(mine))
    ref_convert.convert_attribute_graphs(pack_dir, str(theirs))
    assert sorted(os.listdir(mine)) == sorted(os.listdir(theirs)) == sorted(written)
    for name in written:
        assert (mine / name).read_bytes() == (theirs / name).read_bytes()


@pytest.fixture(scope="module")
def mbf_graph(packs):
    return convert_onnx.load_onnx_graph(os.path.join(packs[0], "w600k_mbf.onnx"))


def _mbf_template():
    return weights.synthetic_tree(mobilefacenet.mobilefacenet(), seed=0)


def test_a_missing_layer_raises(mbf_graph):
    """The model lists a layer the graph does not hold, or the other way round."""
    inits, nodes = mbf_graph
    order = mobilefacenet.layer_execution_order()
    extra = order + [("conv", "params/ConvBlock_3/Conv_0")]
    with pytest.raises(ValueError, match="unmapped flax layers remain"):
        convert_onnx.assign_by_execution_order(_mbf_template(), extra, nodes, inits)
    # the graph holds a layer the model does not list (its tail Dense and BN)
    with pytest.raises(ValueError, match="more ONNX Gemm/MatMuls than expected"):
        convert_onnx.assign_by_execution_order(_mbf_template(), order[:-2], nodes, inits)


def test_a_shape_mismatch_raises(mbf_graph):
    inits, nodes = mbf_graph
    first_conv = next(ins[1] for op, ins, _, _ in nodes if op == "Conv")
    bad = dict(inits)
    bad[first_conv] = np.zeros((32,) + inits[first_conv].shape[1:], np.float32)
    with pytest.raises(ValueError, match="params/ConvBlock_0/Conv_0/kernel"):
        convert_onnx.assign_by_execution_order(_mbf_template(),
                                               mobilefacenet.layer_execution_order(),
                                               nodes, bad)


def test_a_failing_pack_writes_nothing(packs, tmp_path):
    """w600k_mbf.onnx replaced by the r50 graph: the conversion raises after
    det_10g and r50 mapped, and the output directory stays empty."""
    pack_dir = str(tmp_path / "pack")
    shutil.copytree(packs[0], pack_dir)
    shutil.copyfile(os.path.join(pack_dir, "w600k_r50.onnx"),
                    os.path.join(pack_dir, "w600k_mbf.onnx"))
    out = tmp_path / "out"
    with pytest.raises(ValueError):
        convert_onnx.convert(pack_dir, str(out))
    assert not out.exists() or not os.listdir(out)


def test_the_entry_point_converts_into_the_weights_dir(packs, tmp_path):
    """``python -m ...models.convert_onnx --pack DIR`` writes into
    FRE_WEIGHTS_DIR by default, in a process that has no JAX module loaded."""
    pack_dir, want_dir, _, _ = packs
    out = tmp_path / "weights"
    code = ("import sys, runpy; sys.argv = ['convert_onnx', '--pack', sys.argv[1]]; "
            "runpy.run_module('facerecognition_infrenceengine_tpu_torch.models.convert_onnx', "
            "run_name='__main__'); "
            "assert not [m for m in sys.modules if m == 'jax' or m.startswith(("
            "'jax.', 'flax', 'facerecognition_infrenceengine_tpu.'))], 'JAX imported'")
    env = dict(os.environ, FRE_WEIGHTS_DIR=str(out), PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", code, pack_dir], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert sorted(os.listdir(out)) == sorted(os.listdir(want_dir))
    with np.load(out / "arcface_r50.npz") as g, \
            np.load(os.path.join(want_dir, "arcface_r50.npz")) as w:
        assert all(g[k].tobytes() == w[k].tobytes() for k in w.files)
