"""The int8 PTQ scale modes of the port against the reference, on the CPU:
``models/quant.py``, ``ops/int8_conv.py`` and FaceEngine's ``embed_int8``,
``det_int8`` and ``recalibrate_int8``.  Float32 on both sides unless a case
says bf16; r18 and det_500m at 64x64, the weights carried across by
``models/weights.from_flax``.

Exact: the int8 weights and their scales, the calibration order, the
calibration crops, and the s8 x s8 -> s32 convolution (against its float64
form and the reference's XLA int32 conv).  Within tolerances: the
calibrated scales (rel 1e-5), the float twins (atol 1e-4), the int8
embedder on the reference's own scales and weights (1 - cos 1e-3), the
clip fractions (one element's
share), and the int8 engines' detections (valid equal, scores 5e-2).
The reference's synthetic weights (unit BN, He-normal convs) grow the
activations layer by layer (the r18 twin's outputs reach ~1e2), so the
float twins' atol 1e-4 is scaled by max(1, max|ref|), as in
tests/test_torch_models.py.

The two engine cases of tests/test_quant.py run here unchanged through
``exec_port_cases`` (their slow mark dropped: the port builds these engines
in seconds); its four cases that build flax models or pass jax arrays to
the port run as hand-written equivalents below, on the reference's
synthetic weights (``load_or_init``) instead of ``init``'s.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from facerecognition_infrenceengine_tpu.core.config import EngineConfig as RefEngineConfig
from facerecognition_infrenceengine_tpu.engine.pipeline import FaceEngine as RefFaceEngine
from facerecognition_infrenceengine_tpu.engine.pipeline import (
    _calibration_crops as ref_calibration_crops)
from facerecognition_infrenceengine_tpu.models import arcface as jarcface
from facerecognition_infrenceengine_tpu.models import quant as jquant
from facerecognition_infrenceengine_tpu.models import scrfd as jscrfd
from facerecognition_infrenceengine_tpu_torch.core.config import EngineConfig
from facerecognition_infrenceengine_tpu_torch.engine.pipeline import (
    FaceEngine, _calibration_crops)
from facerecognition_infrenceengine_tpu_torch.models import arcface, quant, scrfd, weights
from facerecognition_infrenceengine_tpu_torch.ops import int8_conv
from test_torch_port_cases import cpu_by_default, exec_port_cases

exec_port_cases("test_quant.py", globals(),
                only=("test_engine_embed_int8_flag", "test_engine_det_int8_close_to_float"),
                unmark=("slow",))

D18 = (2, 2, 2, 2)
SMALL = dict(det_size=(64, 64), max_faces=4, pre_nms_topk=16, dtype="float32")


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    cpu_by_default(monkeypatch)


@pytest.fixture(scope="module")
def ref_int8():
    """The reference's engine with both int8 modes (its int8 weights are
    quantized eagerly, as it serves them), and the port's modules holding
    the same float weights."""
    ref = RefFaceEngine(RefEngineConfig(**SMALL, embed_int8=True, det_int8=True),
                        det_arch="det_500m", rec_arch="r18", seed=3)

    def port_module(model, variables):
        tree = {k: variables[k] for k in ("params", "batch_stats")}
        return weights.load_tree(model, weights.flatten_tree(tree))

    return (ref, port_module(arcface.iresnet18(), ref.rec_variables),
            port_module(scrfd.SCRFD(scrfd.CONFIGS["det_500m"]), ref.det_variables))


@pytest.fixture(scope="module")
def ref_scales(ref_int8):
    """The reference's calibration of its embedder on 4 seeded crops."""
    return jquant.calibrate(ref_int8[0].rec_variables, _both(_crops(4, 2))[0], depths=D18,
                            dtype=jnp.float32)


@pytest.fixture(scope="module")
def port_int8():
    """The port's engine with both int8 modes and the "xla" packed stem."""
    return FaceEngine(EngineConfig(**SMALL, embed_int8=True, det_int8=True,
                                   packed_stem_impl="xla"),
                      det_arch="det_500m", rec_arch="r18", seed=3, device="cpu")


def _crops(n, seed):
    return np.random.default_rng(seed).integers(0, 255, (n, 112, 112, 3), dtype=np.uint8)


def _both(u8):
    """The same crops preprocessed by both packages."""
    return jarcface.preprocess(jnp.asarray(u8)), arcface.preprocess(torch.from_numpy(u8))


def _cos(a, b):
    return (a * b).sum(1) / (np.linalg.norm(a, axis=1) * np.linalg.norm(b, axis=1))


def _as_torch(qw):
    return {k: (torch.from_numpy(np.asarray(w8)), torch.from_numpy(np.asarray(sw)))
            for k, (w8, sw) in qw.items()}


# ------------------------------------------------------------------- exact
@pytest.mark.parametrize("depths", [D18, quant.DEPTHS])
def test_calibration_order_is_the_reference(depths):
    assert quant.calibration_order(depths) == jquant.calibration_order(depths)


@pytest.mark.parametrize("arch", ["det_500m", "det_2.5g", "det_10g"])
def test_scrfd_quant_points_are_the_reference(arch):
    want = [tuple(n) for n in jquant._scrfd_names(jscrfd.CONFIGS[arch])]
    assert quant._scrfd_names(scrfd.CONFIGS[arch]) == want
    for i, blocks in enumerate(scrfd.CONFIGS[arch].stage_blocks):
        for j in range(blocks):
            assert (scrfd.block_has_downsample(scrfd.CONFIGS[arch], i, j)
                    == jscrfd.block_has_downsample(jscrfd.CONFIGS[arch], i, j))


@pytest.mark.parametrize("n,size,seed", [(8, 112, 1234), (4, 64, 4321), (2, 112, 1234)])
def test_calibration_crops_bit_identical(n, size, seed):
    got = _calibration_crops(n, size, seed=seed)
    assert got.dtype == np.uint8 and got.shape == (n, size, size, 3)
    np.testing.assert_array_equal(got, ref_calibration_crops(n, size, seed=seed))


def test_quantize_weights_bit_identical(ref_int8):
    ref, tm, sm = ref_int8
    want = ref.rec_variables["int8"]
    got = quant.quantize_weights(tm)
    assert list(got) == list(want) == quant.calibration_order(D18)
    for name, (w8, sw) in want.items():
        assert got[name][0].dtype == torch.int8 and got[name][1].dtype == torch.float32
        np.testing.assert_array_equal(got[name][0].numpy(), np.asarray(w8))
        np.testing.assert_array_equal(got[name][1].numpy(), np.asarray(sw))
        # stored Cout-major: the GEMM operand is a view, no copy
        assert int8_conv.gemm_weight(got[name][0]).data_ptr() == got[name][0].data_ptr()
    assert list(quant.quantize_weights(tm, min_block=3)) == [
        n for n in want if int(n.split("/")[0].split("_")[1]) >= 3]


def test_quantize_scrfd_weights_bit_identical(ref_int8):
    """det_500m's backbone, stem1 (K = 27) included."""
    ref, tm, sm = ref_int8
    want = ref.det_variables["int8"]
    got = quant.quantize_scrfd_weights(sm, scrfd.CONFIGS["det_500m"])
    assert list(got) == list(want)
    for name, (w8, sw) in want.items():
        np.testing.assert_array_equal(got[name][0].numpy(), np.asarray(w8))
        np.testing.assert_array_equal(got[name][1].numpy(), np.asarray(sw))


# (B, H, W, Cin, Cout, kernel, stride, pad): det_10g's stem1 (K = 27, Cout 28),
# stem2 (K = 252), stem3, a downsample, r50's stride-2 shortcut and conv, odd
# sizes and channel counts
CONV_SHAPES = [(2, 9, 7, 3, 28, 3, 2, 1), (2, 8, 8, 28, 28, 3, 1, 1),
               (2, 8, 8, 28, 56, 3, 1, 1), (1, 6, 6, 56, 88, 1, 1, 0),
               (2, 7, 7, 64, 64, 1, 2, 0), (2, 8, 8, 64, 128, 3, 2, 1),
               (3, 5, 3, 6, 10, 3, 1, 1), (1, 3, 3, 5, 7, 3, 1, 1)]


@pytest.mark.parametrize("shape", CONV_SHAPES)
def test_int8_conv_exact_and_equal_to_the_reference(shape):
    b, h, w, ci, co, k, s, p = shape
    rng = np.random.default_rng(sum(shape))
    x8 = rng.integers(-127, 128, (b, h, w, ci), dtype=np.int8)
    w8 = rng.integers(-127, 128, (k, k, ci, co), dtype=np.int8)
    want = np.asarray(jax.lax.conv_general_dilated(
        jnp.asarray(x8), jnp.asarray(w8), (s, s), [(p, p), (p, p)],
        dimension_numbers=("NHWC", "HWIO", "NHWC"), preferred_element_type=jnp.int32))
    tx, tw = torch.from_numpy(x8), torch.from_numpy(w8)
    calls = int8_conv.int8_conv2d_nhwc.calls
    got = int8_conv.int8_conv2d_nhwc(tx, tw, s, p)
    assert int8_conv.int8_conv2d_nhwc.calls == calls + 1
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(int8_conv.int8_conv2d_exact(tx, tw, s, p).numpy(), want)
    scale = torch.from_numpy(rng.uniform(1e-4, 1e-2, co).astype(np.float32))
    assert torch.equal(int8_conv.int8_conv2d_nhwc(tx, tw, s, p, scale=scale),
                       got.float() * scale)


def test_int8_conv_chunks_the_batch_within_its_budget(monkeypatch):
    rng = np.random.default_rng(7)
    x8 = torch.from_numpy(rng.integers(-127, 128, (5, 9, 9, 16), dtype=np.int8))
    w8 = torch.from_numpy(rng.integers(-127, 128, (3, 3, 16, 24), dtype=np.int8))
    per_image = 81 * (144 + 4 * 24)
    monkeypatch.setattr(int8_conv, "IM2COL_BUDGET", 2 * per_image)
    calls = int8_conv.int8_conv2d_nhwc.calls
    got = int8_conv.int8_conv2d_nhwc(x8, w8, 1, 1)
    assert int8_conv.int8_conv2d_nhwc.calls == calls + 3  # 2 + 2 + 1 images
    assert torch.equal(got, int8_conv.int8_conv2d_exact(x8, w8, 1, 1))


def test_int8_conv_refuses_other_devices_and_dtypes():
    """No fallback: a tensor neither on the card nor on the CPU, or a float
    operand, raises instead of being computed some other way."""
    w8 = torch.zeros((3, 3, 8, 8), dtype=torch.int8)
    with pytest.raises(ValueError):
        int8_conv.int8_conv2d_nhwc(torch.zeros((1, 4, 4, 8), dtype=torch.int8, device="meta"),
                                   w8.to("meta"), 1, 1)
    with pytest.raises(TypeError):
        int8_conv.int8_conv2d_nhwc(torch.zeros((1, 4, 4, 8)), w8, 1, 1)


def test_quantize_act_rounds_half_to_even_and_clips():
    x = torch.tensor([0.5, 1.5, 2.5, -0.5, -2.5, 300.0, -300.0, 126.49])
    assert quant.quantize_act(x, 1.0).tolist() == [0, 2, 2, 0, -2, 127, -127, 126]
    xs = np.random.default_rng(3).normal(0, 3, 1000).astype(np.float32)
    want = np.asarray(jnp.clip(jnp.round(jnp.asarray(xs) / 0.037), -127, 127).astype(jnp.int8))
    np.testing.assert_array_equal(quant.quantize_act(torch.from_numpy(xs), 0.037).numpy(), want)


# --------------------------------------------------------------- tolerances
def test_calibrate_scales_match_the_reference(ref_int8, ref_scales):
    """Scales rel 1e-5 on user crops (the engines' default and det scales:
    test_int8_engines_match_the_reference)."""
    want = ref_scales
    got = quant.calibrate(ref_int8[1], _both(_crops(4, 2))[1],
                          dtype=torch.float32)
    assert list(got) == list(want) and all(isinstance(v, float) for v in got.values())
    assert all(abs(got[k] - want[k]) <= 1e-5 * want[k] for k in want)


def test_float_twin_matches_the_reference_and_the_module(ref_int8):
    """Hand-written equivalent of test_quant.py::test_float_twin_matches_flax:
    the twin against the reference's twin and the port's IResNet."""
    jv, tm = ref_int8[0].rec_variables, ref_int8[1]
    jx, tx = _both(_crops(3, 1))
    got = quant.apply_float(tm, tx, dtype=torch.float32).numpy()
    want = np.asarray(jax.jit(lambda v, x: jquant.apply_float(
        v, x, depths=D18, dtype=jnp.float32))(jv, jx))
    atol = 1e-4 * max(1.0, np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=0, atol=atol)
    with torch.no_grad():
        np.testing.assert_allclose(got, tm(tx).numpy(), rtol=0, atol=atol)


def test_scrfd_backbone_float_twin_matches_the_reference_and_the_module(ref_int8):
    """Hand-written equivalent of test_quant.py::
    test_scrfd_backbone_float_twin_matches_flax."""
    jv, sm = ref_int8[0].det_variables, ref_int8[2]
    frames = np.random.default_rng(5).integers(0, 255, (2, 64, 64, 3), dtype=np.uint8)
    tx = scrfd.preprocess(torch.from_numpy(frames))
    got = quant.scrfd_backbone_forward(sm, tx, scrfd.CONFIGS["det_500m"], dtype=torch.float32)
    want = jquant.scrfd_backbone_forward(jv, jscrfd.preprocess(jnp.asarray(frames)),
                                         jscrfd.CONFIGS["det_500m"], dtype=jnp.float32)
    with torch.no_grad():
        mod = sm.backbone(tx.permute(0, 3, 1, 2))
    assert len(got) == len(want) == len(mod) == 3
    for g, w, m in zip(got, want, mod):
        atol = 1e-4 * max(1.0, float(np.abs(np.asarray(w)).max()))
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=atol)
        np.testing.assert_allclose(g.numpy(), m.permute(0, 2, 3, 1).numpy(), rtol=0, atol=atol)


def test_apply_int8_on_the_reference_scales_and_weights(ref_int8, record_property):
    """1 - cos <= 1e-3 (BASELINE.md:36) against the reference's
    ``apply_int8`` on its engine's scales and int8 weights; the measured
    max goes to the junit report as ``max_1_minus_cos``.  (The reference
    engine's jitted program rounds otherwise than its own eager
    ``apply_int8``: test_int8_engines_match_the_reference reports that gap.)"""
    ref, tm, sm = ref_int8
    jx, tx = _both(_crops(4, 3))
    want = np.asarray(jquant.apply_int8(ref.rec_variables, ref.rec_variables["int8"],
                                        ref._embed_scales, jx, depths=D18,
                                        dtype=jnp.float32))
    got = quant.apply_int8(tm, _as_torch(ref.rec_variables["int8"]), ref._embed_scales, tx,
                           dtype=torch.float32).numpy()
    assert got.shape == (4, 512) and got.dtype == np.float32
    record_property("max_1_minus_cos", float(np.max(1.0 - _cos(got, want))))
    assert np.all(1.0 - _cos(got, want) <= 1e-3), 1.0 - _cos(got, want)


def test_int8_close_to_float(ref_int8):
    """Hand-written equivalent of test_quant.py::test_int8_close_to_float."""
    tm = ref_int8[1]
    scales = quant.calibrate(tm, _both(_crops(4, 2))[1], dtype=torch.float32)
    qw = quant.quantize_weights(tm)
    assert set(scales) == set(qw)
    tx = _both(_crops(6, 3))[1]
    with torch.no_grad():
        ref = tm(tx).numpy()
    got = quant.apply_int8(tm, qw, scales, tx, dtype=torch.float32).numpy()
    assert _cos(ref, got).min() > 0.98, _cos(ref, got)
    # bf16: against the bf16 float twin
    ref = quant.apply_float(tm, tx[:2], dtype=torch.bfloat16).numpy()
    got = quant.apply_int8(tm, qw, scales, tx[:2], dtype=torch.bfloat16).numpy()
    assert _cos(ref, got).min() > 0.98, _cos(ref, got)


def test_clip_fractions_match_the_reference(ref_int8, ref_scales, monkeypatch):
    """At a quarter of the calibrated scales (so that points clip): each
    point's share within one element of that point's activation."""
    jv, tm = ref_int8[0].rec_variables, ref_int8[1]
    jx, tx = _both(_crops(4, 2))
    sizes = []
    real = quant._collect_point
    monkeypatch.setattr(quant, "_collect_point",
                        lambda c, x, *a: (sizes.append(x.numel()), real(c, x, *a)))
    s = {n: v * 0.25 for n, v in ref_scales.items()}
    got = quant.clip_fractions(tm, s, tx, dtype=torch.float32)
    want = jquant.clip_fractions(jv, s, jx, depths=D18, dtype=jnp.float32)
    assert list(got) == list(want) and len(sizes) == len(want)
    for (name, w), n in zip(want.items(), sizes):
        assert abs(got[name] - w) <= 1.0 / n + 1e-7, (name, got[name], w)
    assert max(got.values()) > 0.0


def test_recalibrate_and_clip_fractions():
    """Hand-written equivalent of test_quant.py::
    test_recalibrate_and_clip_fractions on the port's engine."""
    e = FaceEngine(EngineConfig(**SMALL, embed_int8=True), det_arch="det_500m",
                   rec_arch="r18", seed=3)
    assert e._int8_calibration == "synthetic-structured"
    s0 = e._embed_scales
    crops = np.random.default_rng(11).integers(0, 255, (4, 112, 112, 3), dtype=np.uint8)
    e.recalibrate_int8(crops)
    assert e._int8_calibration == "user(4 crops)"
    assert e._embed_scales != s0 and e._embed_scales is not s0
    assert e.embed_crops(crops).shape == (4, 512)
    x = arcface.preprocess(torch.from_numpy(crops))
    fr = quant.clip_fractions(e.embedder, e._embed_scales, x, dtype=torch.float32)
    assert all(0.0 <= v <= 1e-6 for v in fr.values()), fr
    shrunk = {k: v * 0.25 for k, v in e._embed_scales.items()}
    assert max(quant.clip_fractions(e.embedder, shrunk, x,
                                    dtype=torch.float32).values()) > 0.0
    np.testing.assert_array_equal(_calibration_crops(2, 112), _calibration_crops(2, 112))


def test_int8_engines_match_the_reference(ref_int8, port_int8, record_property):
    """The same calibration (scales rel 1e-5), detections with equal valid
    slots and scores within 5e-2 (tests/test_quant.py:153-154), embeddings
    within 1 - cos 1e-3."""
    ref, port = ref_int8[0], port_int8
    assert ref._int8_calibration == port._int8_calibration == "synthetic-structured"
    for want, got in ((ref._embed_scales, port._embed_scales),
                      (ref._det_scales, port._det_scales)):
        assert list(got) == list(want)
        assert all(abs(got[k] - want[k]) <= 1e-5 * want[k] for k in want)
    frames = np.random.default_rng(6).integers(0, 255, (2, 64, 64, 3), dtype=np.uint8)
    want, got = ref.detect(frames), port.detect(frames)
    np.testing.assert_array_equal(got.valid, want.valid)
    np.testing.assert_allclose(got.scores, want.scores, atol=5e-2)
    crops = _crops(4, 9)
    cos = _cos(port.embed_crops(crops), np.asarray(ref.embed_crops(crops)))
    record_property("max_1_minus_cos", float(np.max(1.0 - cos)))
    assert np.all(1.0 - cos <= 1e-3), 1.0 - cos


def test_int8_error_on_high_contrast_crops_is_the_reference(ref_int8, port_int8):
    """On crops the structured calibration does not cover (binary 0 / 255
    noise: their activations clip at the build's scales), the int8 embedder
    loses cosine against float in both packages alike: each package's int8
    against its own float forward, the two within 1e-3 of each other."""
    ref, tm, _ = ref_int8
    u8 = (np.random.default_rng(12).integers(0, 2, (4, 112, 112, 3)) * 255).astype(np.uint8)
    port = port_int8
    jx, tx = _both(u8)
    ref_float = np.asarray(jax.jit(lambda v, x: jquant.apply_float(
        v, x, depths=D18, dtype=jnp.float32))(ref.rec_variables, jx))
    with torch.no_grad():
        port_float = tm(tx).numpy()
    cos_ref = _cos(np.asarray(ref.embed_crops(u8)), ref_float)
    cos_port = _cos(port.embed_crops(u8), port_float)
    assert np.all(np.abs(cos_port - cos_ref) <= 1e-3), (cos_port, cos_ref)
    fr = quant.clip_fractions(port.embedder, port._embed_scales, tx,
                              dtype=torch.float32)
    assert max(fr.values()) > 1e-3, fr


@pytest.mark.parametrize("impl", ["xla", "pallas", "unpack"])
def test_packed_programs_keep_the_float_backbone_under_det_int8(impl, port_int8, monkeypatch):
    """As the reference's: the packed "xla" / "pallas" programs run the
    float backbone with det_int8 set (their detections equal a float
    engine's bit for bit), "unpack" goes through the raw program's int8
    backbone.  Both engines are built with the "xla" stem weights; the
    strategy is read at call time."""
    frames = np.random.default_rng(4).integers(0, 255, (2, 64, 64, 3), dtype=np.uint8)
    packed = torch.from_numpy(FaceEngine.pack_frames(frames))
    flt = FaceEngine(EngineConfig(**SMALL, packed_stem_impl="xla"), det_arch="det_500m",
                     rec_arch="r18", seed=3, device="cpu")
    outs = {}
    for q, e in ((False, flt), (True, port_int8)):
        assert ("int8" in e.det_variables) == q
        monkeypatch.setattr(e, "cfg", dataclasses.replace(e.cfg, packed_stem_impl=impl))
        with torch.inference_mode():
            outs[q] = [t.numpy() for t in e._detect_packed_impl(packed, 0.3)]
    same = all(np.array_equal(a, b) for a, b in zip(outs[False], outs[True]))
    assert same == (impl != "unpack")
    if impl == "unpack":
        with torch.inference_mode():
            raw = port_int8._detect_impl(torch.from_numpy(frames), 0.3)
        for a, b in zip(outs[True], raw):
            np.testing.assert_array_equal(a, b.numpy())


def test_embed_int8_engine_never_serves_the_float_embedder(port_int8, monkeypatch):
    """As tests/test_quant.py:73-74 pins it, and on every embedding program:
    the module's own forward is never called."""
    e = port_int8

    def refuse(*_):
        raise AssertionError("the float embedder served an int8 engine")

    monkeypatch.setattr(e.embedder, "forward", refuse)
    frames = np.random.default_rng(2).integers(0, 255, (2, 64, 64, 3), dtype=np.uint8)
    calls = int8_conv.int8_conv2d_nhwc.calls
    e.embed_crops(_crops(2, 1))
    e.detect_align_embed(frames)
    e.detect_align_embed_packed(FaceEngine.pack_frames(frames))
    assert int8_conv.int8_conv2d_nhwc.calls >= calls + 3 * len(e.rec_variables["int8"])


def test_mobilefacenet_ignores_embed_int8():
    e = FaceEngine(EngineConfig(**SMALL, embed_int8=True), det_arch="det_500m",
                   rec_arch="mobilefacenet", seed=3)
    assert "int8" not in e.rec_variables and e._int8_calibration is None
    with pytest.raises(ValueError, match="embed_int8"):
        e.recalibrate_int8()
