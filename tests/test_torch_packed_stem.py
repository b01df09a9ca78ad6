"""The packed SCRFD stem as plain convs (models/packed_stem.py) against the
reference and against the port's own unpacked stem, on the CPU, float32:
``packed_stem=True`` on the raw program and ``packed_stem_impl="xla"`` on
the packed and yuv420 programs.

Exact: ``space_to_depth``, ``pack_kernel``, ``pack_stem1_direct``, the
packed max-pool and the BN-folded packed weights of
``precompute_packed_stem(_s2d4)``.  Within rtol 1e-3 / atol 2e-3
(tests/test_packed_stem.py:158-160): the packed stems' outputs and the
engines' programs against the reference's.

The three engine cases of tests/test_packed_stem.py run here unchanged
through ``exec_port_cases`` (their slow mark dropped: the port's engines
build in seconds); its cases that build flax models or pass jax arrays to
the port run as hand-written equivalents below, on random weights with
non-trivial BatchNorm (the reference's ``_rand_variables`` rule, drawn with
numpy).
"""

import flax.linen as nn
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from facerecognition_infrenceengine_tpu.core.config import EngineConfig as RefEngineConfig
from facerecognition_infrenceengine_tpu.engine.pipeline import FaceEngine as RefFaceEngine
from facerecognition_infrenceengine_tpu.models import packed_stem as jpacked
from facerecognition_infrenceengine_tpu.models import scrfd as jscrfd
from facerecognition_infrenceengine_tpu.models.weights import load_or_init as jax_load_or_init
from facerecognition_infrenceengine_tpu.ops.stem_pallas import space_to_depth4 as jspace_to_depth4
from facerecognition_infrenceengine_tpu_torch import native
from facerecognition_infrenceengine_tpu_torch.core.config import EngineConfig
from facerecognition_infrenceengine_tpu_torch.engine.pipeline import FaceEngine
from facerecognition_infrenceengine_tpu_torch.models import packed_stem, scrfd, weights
from facerecognition_infrenceengine_tpu_torch.ops.stem_kernel import space_to_depth4
from test_torch_port_cases import cpu_by_default, exec_port_cases

exec_port_cases("test_packed_stem.py", globals(),
                only=("test_engine_packed_default_unpack_is_exact",
                      "test_engine_packed_paths_match_raw_across_stem_impls",
                      "test_engine_packed_stem_opt_in_matches_default"),
                unmark=("slow",))

SMALL = dict(det_size=(64, 64), max_faces=4, pre_nms_topk=16, dtype="float32")
TOL = dict(rtol=1e-3, atol=2e-3)


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    cpu_by_default(monkeypatch)


def _rand_tree(tree, seed):
    """Random leaves for a flax tree by tests/test_packed_stem.py's rule:
    fan-in scaled normal conv kernels, variances in [0.5, ...), scales near
    1 and biases / means near 0."""
    rng = np.random.default_rng(seed)

    def leaf(path, a):
        v = rng.normal(size=a.shape).astype(np.float32)
        if a.ndim == 4:
            return v / np.sqrt(a.shape[0] * a.shape[1] * a.shape[2])
        if "var" in path:
            return np.abs(v) * 0.2 + 0.5
        return v * 0.2 + (1.0 if path.endswith("scale") else 0.0)

    flat = weights.flatten_tree(tree)
    return {k: leaf(k, np.asarray(a)) for k, a in flat.items()}


def _unflatten(flat):
    out = {}
    for path, v in flat.items():
        node = out
        *parents, last = path.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[last] = jnp.asarray(v)
    return out


@pytest.fixture(scope="module", params=["det_10g", "det_500m"])
def dets(request):
    """(arch, flax variables, the port's SCRFD) with the same random weights."""
    arch = request.param
    shape_tree = jax_load_or_init(f"scrfd_{arch}", jscrfd.SCRFD(jscrfd.CONFIGS[arch]),
                                  jnp.zeros((1, 64, 64, 3)), 0)
    flat = _rand_tree(shape_tree, seed=1)
    return arch, _unflatten(flat), weights.load_tree(scrfd.SCRFD(scrfd.CONFIGS[arch]), flat)


def _stem_unpacked(model, x):
    """The port's own stem: stem1-3 and the 3x3/2 max-pool, NHWC."""
    bb = model.backbone
    with torch.no_grad():
        h = bb.stem3(bb.stem2(bb.stem1(x.permute(0, 3, 1, 2))))
        return F.max_pool2d(h, 3, 2, 1).permute(0, 2, 3, 1)


# ------------------------------------------------------------------- exact
def test_space_to_depth_and_pack_kernels_bit_identical():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 8, 12, 5)).astype(np.float32)
    np.testing.assert_array_equal(packed_stem.space_to_depth(torch.from_numpy(x)).numpy(),
                                  np.asarray(jpacked.space_to_depth(jnp.asarray(x))))
    w = rng.normal(size=(3, 3, 5, 7)).astype(np.float32)
    for stride in (1, 2):
        np.testing.assert_array_equal(packed_stem.pack_kernel(torch.from_numpy(w), stride).numpy(),
                                      np.asarray(jpacked.pack_kernel(jnp.asarray(w), stride)))
    np.testing.assert_array_equal(packed_stem.pack_stem1_direct(torch.from_numpy(w)).numpy(),
                                  np.asarray(jpacked.pack_stem1_direct(jnp.asarray(w))))


def test_pack_kernel_matches_direct_conv():
    """Hand-written equivalent of test_packed_stem.py::
    test_pack_kernel_matches_direct_conv: conv(x, W) equals the packed conv
    of the packed input, unpacked, for both strides."""
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(2, 16, 16, 5)).astype(np.float32))
    for stride in (1, 2):
        w = torch.from_numpy(rng.normal(size=(3, 3, 5, 7)).astype(np.float32))
        ref = F.conv2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1), stride=stride, padding=1)
        out = F.conv2d(packed_stem.space_to_depth(x).permute(0, 3, 1, 2),
                       packed_stem.pack_kernel(w, stride).permute(3, 2, 0, 1),
                       stride=stride, padding=1).permute(0, 2, 3, 1)
        b, hp, wp, _ = out.shape
        got = out.reshape(b, hp, wp, 2, 2, 7).permute(0, 1, 3, 2, 4, 5).reshape(b, 2 * hp,
                                                                             2 * wp, 7)
        np.testing.assert_allclose(got.numpy(), ref.permute(0, 2, 3, 1).numpy(), atol=1e-5)


def test_packed_maxpool_matches_flax_and_torch():
    """Hand-written equivalent of test_packed_stem.py::
    test_packed_maxpool_matches_flax, plus the reference's packed pool: all
    bit for bit."""
    x = np.random.default_rng(1).normal(size=(2, 24, 24, 6)).astype(np.float32)
    got = packed_stem._packed_maxpool_3x3s2(packed_stem.space_to_depth(torch.from_numpy(x)), 6)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(nn.max_pool(jnp.asarray(x), (3, 3), (2, 2),
                                            padding=[(1, 1), (1, 1)])))
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jpacked._packed_maxpool_3x3s2(
            jpacked.space_to_depth(jnp.asarray(x)), 6)))
    np.testing.assert_array_equal(
        got.numpy(), F.max_pool2d(torch.from_numpy(x).permute(0, 3, 1, 2), 3, 2, 1)
        .permute(0, 2, 3, 1).numpy())


def test_precomputed_packed_weights_bit_identical(dets):
    arch, jv, model = dets
    for port_fn, ref_fn in ((packed_stem.precompute_packed_stem, jpacked.precompute_packed_stem),
                            (packed_stem.precompute_packed_stem_s2d4,
                             jpacked.precompute_packed_stem_s2d4)):
        got, want = port_fn(model), ref_fn(jv)
        for key in ("w", "b"):
            assert len(got[key]) == len(want[key]) == 3
            for g, w in zip(got[key], want[key]):
                assert g.dtype == torch.float32
                np.testing.assert_array_equal(g.numpy(), np.asarray(w))


# --------------------------------------------------------------- tolerances
def test_packed_stems_match_the_reference_and_the_unpacked_stem(dets):
    """Hand-written equivalent of test_packed_stem.py::
    test_s2d4_stem_matches_flax_stem, for both packed stems."""
    arch, jv, model = dets
    sw = scrfd.CONFIGS[arch].stem_width
    frames = np.random.default_rng(4).integers(0, 255, (2, 64, 64, 3), dtype=np.uint8)
    x = scrfd.preprocess(torch.from_numpy(frames))
    want_stem = _stem_unpacked(model, x).numpy()
    got = packed_stem.packed_stem_forward(x, packed_stem.precompute_packed_stem(model), sw)
    want = jpacked.packed_stem_forward(jscrfd.preprocess(jnp.asarray(frames)),
                                       jpacked.precompute_packed_stem(jv), sw)
    assert got.shape == (2, 16, 16, 2 * sw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(got.numpy(), want_stem, rtol=1e-4, atol=1e-4)
    x48 = space_to_depth4(torch.from_numpy(frames))
    got = packed_stem.packed_stem_forward_s2d4(
        x48, packed_stem.precompute_packed_stem_s2d4(model), sw)
    want = jpacked.packed_stem_forward_s2d4(jspace_to_depth4(jnp.asarray(frames)),
                                            jpacked.precompute_packed_stem_s2d4(jv), sw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(got.numpy(), want_stem, rtol=1e-4, atol=1e-4)


def test_full_detector_forward_equivalent(dets):
    """Hand-written equivalent of test_packed_stem.py::
    test_full_detector_forward_equivalent: SCRFD(x) == SCRFD(x,
    stem_out=packed_stem(x)) within its 1e-4."""
    arch, jv, model = dets
    x = torch.from_numpy(np.random.default_rng(2).normal(size=(2, 64, 64, 3)).astype(np.float32))
    stem_out = packed_stem.packed_stem_forward(x, packed_stem.precompute_packed_stem(model),
                                               scrfd.CONFIGS[arch].stem_width)
    with torch.no_grad():
        ref, got = model(x), model(None, stem_out=stem_out)
    for r, g in zip(ref, got):
        np.testing.assert_allclose(g.numpy(), r.numpy(), rtol=1e-4, atol=1e-4)


def test_packed_stem_engines_match_the_reference():
    """``packed_stem=True`` on the raw program and ``packed_stem_impl="xla"``
    on the packed and yuv420 programs, the port's engine against the
    reference's on the same frames."""
    cfg = dict(SMALL, packed_stem=True, packed_stem_impl="xla")
    ref = RefFaceEngine(RefEngineConfig(**cfg), det_arch="det_500m", rec_arch="r18", seed=5)
    port = FaceEngine(EngineConfig(**cfg), det_arch="det_500m", rec_arch="r18", seed=5)
    assert {"packed_stem", "packed_stem_s2d4", "stem_pallas"} <= set(port.det_variables)
    assert port._has_packed_stem()
    frames = np.random.default_rng(5).integers(0, 255, (2, 64, 64, 3), dtype=np.uint8)
    want, got = ref.detect(frames), port.detect(frames)
    np.testing.assert_array_equal(got.valid, want.valid)
    for k in ("boxes", "scores", "kps"):
        np.testing.assert_allclose(getattr(got, k), getattr(want, k), **TOL)
    packed = FaceEngine.pack_frames(frames)
    want = ref.detect_align_embed_packed(jnp.asarray(packed))
    got = port.detect_align_embed_packed(packed)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy().astype(np.float32),
                                   np.asarray(w, np.float32), **TOL)
    packs = np.stack([native.pack_yuv420_s2d4(f) for f in frames])
    want = ref.detect_align_embed_yuv420_flat(jnp.asarray(packs))
    got = port.detect_align_embed_yuv420_flat(packs)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)

