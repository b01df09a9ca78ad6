"""The port's ONNX parser and torch executor vs the reference's, and the
engine's exact-graph attribute path.

Every graph of tests/test_onnx_exec.py (torch exports and hand-built
models) parses into the same nodes, attributes and initializers in both
packages, and the port's ``OnnxRunner`` gives the reference runner's outputs
within rtol 1e-5 / atol 1e-5.  Hand-built graphs cover the ops whose torch
spelling differs from the reference's function (Resize, pools, Slice,
Gather, Split, Cast, Erf, Clip from inputs).  The engine test is the
counterpart of the reference's slow
``tests/test_models_engine.py::test_engine_attributes_use_exact_onnx_graphs``:
both engines with the two converted files in ``FRE_WEIGHTS_DIR``.
"""

import numpy as np
import pytest
import torch
from torch import nn

from facerecognition_infrenceengine_tpu.models import onnx_exec as jonnx_exec
from facerecognition_infrenceengine_tpu.models import onnxlite as jonnxlite
from facerecognition_infrenceengine_tpu_torch.models import onnx_exec, onnxlite
from test_onnx_exec import export_onnx

TOL = dict(rtol=1e-5, atol=1e-5)


class _Block(nn.Module):  # tests/test_onnx_exec.py's depthwise landmark block
    def __init__(self, cin, cout, stride):
        super().__init__()
        self.dw = nn.Conv2d(cin, cin, 3, stride, 1, groups=cin)
        self.bn1 = nn.BatchNorm2d(cin)
        self.pw = nn.Conv2d(cin, cout, 1)
        self.bn2 = nn.BatchNorm2d(cout)
        self.act = nn.PReLU(cout)

    def forward(self, x):
        return self.act(self.bn2(self.pw(self.bn1(self.dw(x)))))


class _Plumbing(nn.Module):  # view(x.size(0), -1): Shape -> Gather -> Concat
    def __init__(self):
        super().__init__()
        self.conv = nn.Conv2d(3, 4, 3, 2, 1)
        self.fc = nn.Linear(4 * 8 * 8, 7)

    def forward(self, x):
        h = self.conv(x)
        return self.fc(h.reshape(h.size(0), -1))


class _Batch1(nn.Module):  # exported at batch 1: a hardcoded (1, -1) target
    def __init__(self):
        super().__init__()
        self.conv = nn.Conv2d(3, 4, 3, 2, 1)
        self.fc = nn.Linear(4 * 4 * 4, 5)

    def forward(self, x):
        h = self.conv(x)
        h = h.view(1, -1) if x.shape[0] == 1 else h.reshape(x.shape[0], -1)
        return self.fc(h)


class _Residual(nn.Module):  # Add, Concat, Resize (nearest x2)
    def __init__(self):
        super().__init__()
        self.c1 = nn.Conv2d(3, 4, 3, 1, 1)
        self.c2 = nn.Conv2d(4, 4, 3, 1, 1)
        self.up = nn.Upsample(scale_factor=2, mode="nearest")

    def forward(self, x):
        h = self.c1(x)
        h = h + self.c2(h)
        return self.up(torch.cat([h, h], dim=1))


def _normal(seed, shape):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _exported(name):
    """(model bytes, input) of one of tests/test_onnx_exec.py's torch graphs."""
    if name == "genderage_like":
        torch.manual_seed(0)
        m = nn.Sequential(
            nn.Conv2d(3, 8, 3, 2, 1), nn.BatchNorm2d(8), nn.PReLU(8),
            nn.Conv2d(8, 16, 3, 2, 1), nn.BatchNorm2d(16), nn.PReLU(16),
            nn.AdaptiveAvgPool2d(1), nn.Flatten(), nn.Linear(16, 3))
        x = _normal(0, (1, 3, 32, 32))
    elif name == "depthwise_landmark_like":
        torch.manual_seed(1)
        m = nn.Sequential(nn.Conv2d(3, 8, 3, 2, 1), nn.PReLU(8), _Block(8, 16, 2),
                          _Block(16, 16, 1), nn.AdaptiveAvgPool2d(1), nn.Flatten(),
                          nn.Linear(16, 212))
        x = _normal(1, (1, 3, 48, 48))
    elif name == "shape_plumbing":
        torch.manual_seed(2)
        m, x = _Plumbing(), _normal(2, (2, 3, 16, 16))
    elif name == "batch_agnostic_reshape":
        torch.manual_seed(3)
        m = _Batch1()
        return export_onnx(m, torch.from_numpy(_normal(3, (1, 3, 8, 8)))), _normal(4, (3, 3, 8, 8))
    elif name == "pools_softmax":
        torch.manual_seed(4)
        m = nn.Sequential(nn.Conv2d(3, 4, 3, 1, 1), nn.ReLU(), nn.MaxPool2d(3, 2, 1),
                          nn.AvgPool2d(2, 2), nn.Flatten(), nn.Linear(4 * 4 * 4, 6),
                          nn.Softmax(dim=1))
        x = _normal(5, (2, 3, 16, 16))
    else:
        torch.manual_seed(5)
        m, x = _Residual(), _normal(6, (1, 3, 8, 8))
    return export_onnx(m, torch.from_numpy(x)), x


def _handbuilt(name):
    """(model bytes, input) of one of tests/test_onnx_exec.py's hand-built
    graphs, or of the op-coverage graphs below."""
    rng = np.random.default_rng(7)
    if name == "handbuilt_bn_leaky":
        w = rng.normal(size=(4, 3, 3, 3)).astype(np.float32)
        inits = {"w": w, "s": rng.uniform(0.5, 2, 4).astype(np.float32),
                 "b": rng.normal(size=4).astype(np.float32),
                 "m": rng.normal(size=4).astype(np.float32),
                 "v": rng.uniform(0.5, 2, 4).astype(np.float32)}
        nodes = [("Conv", ["x", "w"], ["c"],
                  {"strides": [2, 2], "pads": [1, 1, 1, 1], "kernel_shape": [3, 3]}),
                 ("BatchNormalization", ["c", "s", "b", "m", "v"], ["bn"], {"epsilon": 1e-5}),
                 ("LeakyRelu", ["bn"], ["y"], {"alpha": 0.1})]
        return onnxlite.build_model(nodes, inits, {"x": (1, 3, 8, 8)},
                                    {"y": (1, 4, 4, 4)}), _normal(8, (1, 3, 8, 8))
    if name == "gemm_clip":
        rng = np.random.default_rng(8)
        a = rng.normal(size=(2, 6)).astype(np.float32)
        inits = {"w": rng.normal(size=(5, 6)).astype(np.float32),
                 "b": rng.normal(size=(5,)).astype(np.float32)}
        nodes = [("Gemm", ["x", "w", "b"], ["g"], {"transB": 1, "alpha": 0.5, "beta": 2.0}),
                 ("Clip", ["g"], ["y"], {"min": -1.0, "max": 1.0})]
        return onnxlite.build_model(nodes, inits, {"x": (2, 6)}, {"y": (2, 5)}), a
    if name == "resize_linear_shrink_and_grow":
        # jax.image.resize: antialiased when shrinking, half-pixel centres
        nodes = [("Resize", ["x", "", "sc1"], ["a"], {"mode": "linear"}),
                 ("Resize", ["a", "", "", "sz2"], ["y"], {"mode": "cubic"})]
        inits = {"sc1": np.asarray([1, 1, 0.375, 0.5], np.float32),
                 "sz2": np.asarray([2, 3, 10, 11], np.int64)}
        return onnxlite.build_model(nodes, inits, {"x": (2, 3, 16, 12)},
                                    {"y": (2, 3, 10, 11)}), _normal(9, (2, 3, 16, 12))
    if name == "pools_ceil_asymmetric":
        nodes = [("MaxPool", ["x"], ["a"], {"kernel_shape": [3, 3], "strides": [2, 2],
                                            "pads": [0, 1, 1, 0], "ceil_mode": 1}),
                 ("AveragePool", ["a"], ["b"], {"kernel_shape": [3, 2], "strides": [1, 2],
                                                "pads": [1, 1, 1, 0]}),
                 ("AveragePool", ["a"], ["c"], {"kernel_shape": [2, 2], "strides": [2, 1],
                                                "pads": [1, 0, 0, 1],
                                                "count_include_pad": 1}),
                 ("GlobalAveragePool", ["c"], ["d"], {}),
                 ("Flatten", ["b"], ["e"], {"axis": 1}),
                 ("Flatten", ["d"], ["f"], {"axis": 1}),
                 ("Concat", ["e", "f"], ["y"], {"axis": 1})]
        return onnxlite.build_model(nodes, {}, {"x": (2, 3, 11, 9)}, {"y": (2, 1)}), \
            _normal(10, (2, 3, 11, 9))
    if name == "slice_gather_split_cast":
        inits = {"st": np.asarray([0, -1, 1], np.int64),
                 "en": np.asarray([2, -(1 << 63), 1 << 63 - 1], np.int64),
                 "ax": np.asarray([0, 2, 3], np.int64),
                 "sp": np.asarray([1, -2, 2], np.int64),
                 "gi": np.asarray([2, -1, 0], np.int64),
                 "lo": np.asarray(-0.5, np.float32), "hi": np.asarray(0.75, np.float32)}
        nodes = [("Slice", ["x", "st", "en", "ax", "sp"], ["a"], {}),
                 ("Gather", ["a", "gi"], ["b"], {"axis": 1}),
                 ("Split", ["b"], ["c0", "c1"], {"axis": 3, "split": [1, 2]}),
                 ("Erf", ["c1"], ["e"], {}),
                 ("Clip", ["e", "lo", "hi"], ["f"], {}),
                 ("Cast", ["c0"], ["g"], {"to": 6}),
                 ("Cast", ["g"], ["h"], {"to": 1}),
                 ("Shape", ["f"], ["s"], {}),
                 ("Gather", ["s", "zero"], ["s0"], {"axis": 0}),
                 ("Unsqueeze", ["s0"], ["s1"], {"axes": [0]}),
                 ("Concat", ["s1", "m1"], ["tgt"], {"axis": 0}),
                 ("Reshape", ["f", "tgt"], ["r"], {}),
                 ("Reshape", ["h", "tgt"], ["q"], {}),
                 ("Sigmoid", ["r"], ["t"], {}),
                 ("Concat", ["t", "q"], ["y"], {"axis": 1})]
        inits.update({"zero": np.asarray(0, np.int64), "m1": np.asarray([-1], np.int64)})
        return onnxlite.build_model(nodes, inits, {"x": (3, 4, 9, 7)}, {"y": (2, 1)}), \
            _normal(11, (3, 4, 9, 7)) * 3
    # an op the executor does not know
    return onnxlite.build_model([("SomeFutureOp", ["x"], ["y"], {})], {}, {"x": (1, 4)},
                                {"y": (1, 4)}), np.zeros((1, 4), np.float32)


EXPORTED = ["genderage_like", "depthwise_landmark_like", "shape_plumbing",
            "batch_agnostic_reshape", "pools_softmax", "residual_concat_upsample"]
HANDBUILT = ["handbuilt_bn_leaky", "gemm_clip", "resize_linear_shrink_and_grow",
             "pools_ceil_asymmetric", "slice_gather_split_cast"]


def _graph(name):
    return _exported(name) if name in EXPORTED else _handbuilt(name)


def _nodes(g):
    def norm(v):
        return (v.dtype.str, v.shape, v.tobytes()) if isinstance(v, np.ndarray) else v

    return [(n.op_type, n.name, list(n.inputs), list(n.outputs),
             {k: norm(v) for k, v in n.attrs.items()}) for n in g.nodes]


@pytest.mark.parametrize("name", EXPORTED + HANDBUILT)
def test_onnxlite_parses_like_the_reference(name):
    data, _ = _graph(name)
    got, want = onnxlite.parse_model(data), jonnxlite.parse_model(data)
    assert _nodes(got) == _nodes(want)
    assert got.inputs == want.inputs and got.outputs == want.outputs
    assert set(got.initializers) == set(want.initializers)
    for key, t in want.initializers.items():
        a, b = got.initializers[key].to_numpy(), t.to_numpy()
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b, err_msg=key)
    mine, ref = onnxlite.read_initializers(data), jonnxlite.read_initializers(data)
    assert set(mine) == set(ref)
    for key in ref:
        np.testing.assert_array_equal(mine[key], ref[key], err_msg=key)


@pytest.mark.parametrize("name", EXPORTED + HANDBUILT)
def test_runner_equals_the_reference_runner(name):
    data, x = _graph(name)
    runner = onnx_exec.OnnxRunner(onnxlite.parse_model(data), device="cpu")
    ref_runner = jonnx_exec.OnnxRunner(jonnxlite.parse_model(data))
    got = runner(x)
    want = ref_runner(x)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        g = g.numpy() if isinstance(g, torch.Tensor) else np.asarray(g)
        w = np.asarray(w)
        assert g.shape == w.shape and g.dtype == w.dtype, (g.shape, w.shape)
        np.testing.assert_allclose(g, w, **TOL)
    assert runner.param_census() == ref_runner.param_census()
    assert runner.input_names == ref_runner.input_names
    assert runner.input_shapes == ref_runner.input_shapes
    # float initializers are float32 tensors on the runner's device, the
    # integer ones numpy constants
    for key, val in runner.params.items():
        ref = np.asarray(ref_runner.params[key])
        if ref.dtype.kind == "f":
            assert isinstance(val, torch.Tensor) and val.dtype == torch.float32
        else:
            assert isinstance(val, np.ndarray) and val.dtype == ref.dtype


def test_exported_graphs_equal_the_torch_modules():
    """The runner against the exporter's own module on its input (the
    reference test's oracle), at batch 3 for the batch-1 export."""
    torch.manual_seed(3)
    m = _Batch1().eval()
    data = export_onnx(m, torch.from_numpy(_normal(3, (1, 3, 8, 8))))
    x3 = _normal(4, (3, 3, 8, 8))
    runner = onnx_exec.OnnxRunner(onnxlite.parse_model(data), device="cpu")
    with torch.no_grad():
        want = m(torch.from_numpy(x3)).numpy()
    np.testing.assert_allclose(runner(x3)[0].numpy(), want, **TOL)
    no_rebind = onnx_exec.OnnxRunner(onnxlite.parse_model(data), batch_agnostic=False,
                                     device="cpu")
    with pytest.raises(RuntimeError):
        no_rebind(x3)


def test_unknown_op_raises_naming_it():
    data, x = _handbuilt("unknown")
    runner = onnx_exec.OnnxRunner(onnxlite.parse_model(data), device="cpu")
    with pytest.raises(ValueError, match="SomeFutureOp"):
        runner(x)


def test_auto_pad_other_than_explicit_raises():
    data = onnxlite.build_model(
        [("Conv", ["x", "w"], ["y"], {"kernel_shape": [3, 3], "auto_pad": "SAME_UPPER"})],
        {"w": np.ones((2, 3, 3, 3), np.float32)}, {"x": (1, 3, 8, 8)}, {"y": (1, 2, 8, 8)})
    runner = onnx_exec.OnnxRunner(onnxlite.parse_model(data), device="cpu")
    with pytest.raises(ValueError, match="auto_pad"):
        runner(np.zeros((1, 3, 8, 8), np.float32))


def _attribute_graphs(kind):
    """(genderage bytes, 2d106det bytes, (genderage module, landmark module)).
    "torch_exports": the reference's slow test's heads, exported by torch (no
    input normalization, so their untrained landmark outputs reach thousands
    of px); "synthetic_heads": the port's synthetic heads (seeds 7, 8) as
    buffalo_l-shaped graphs (``onnx_export.head_graph``: Sub/Div, Conv + BN +
    PRelu stages, a batch-1 Reshape in the landmark graph)."""
    if kind == "torch_exports":
        torch.manual_seed(0)
        ga = nn.Sequential(nn.Conv2d(3, 4, 7, 4, 3), nn.PReLU(4), nn.AdaptiveAvgPool2d(1),
                           nn.Flatten(), nn.Linear(4, 3)).eval()
        lm = nn.Sequential(nn.Conv2d(3, 4, 7, 4, 3), nn.PReLU(4), nn.AdaptiveAvgPool2d(1),
                           nn.Flatten(), nn.Linear(4, 212)).eval()
        return (export_onnx(ga, torch.zeros(1, 3, 96, 96)),
                export_onnx(lm, torch.zeros(1, 3, 192, 192)), (ga, lm))
    from facerecognition_infrenceengine_tpu_torch.models import genderage, landmark106
    from facerecognition_infrenceengine_tpu_torch.models.onnx_export import head_graph
    from facerecognition_infrenceengine_tpu_torch.models.weights import load_or_init

    ga = load_or_init("genderage", genderage.GenderAge(), 7)
    lm = load_or_init("landmark_2d_106", landmark106.Landmark106(), 8)
    return head_graph(ga, 96), head_graph(lm, 192, batch1_reshape=True), (ga, lm)


@pytest.mark.parametrize("kind", ["torch_exports", "synthetic_heads"])
def test_engine_attributes_run_the_exact_graphs(kind, tmp_path, monkeypatch):
    """With converted attr_genderage.onnx / attr_2d106det.onnx in the weights
    dir, both engines run the graphs (runners picked, sizes from the graphs'
    inputs): gender equal and age within 1; landmarks within 1e-3 px on the
    buffalo_l-shaped graphs, and within 1e-6 of the largest coordinate on the
    torch exports, whose untrained outputs reach ~1,500 px (float32 sums in
    another order differ there by ~1e-3 px).  The port's outputs are the
    graphs' module on the engine's own K3 crops."""
    from facerecognition_infrenceengine_tpu.core.config import EngineConfig as JaxEngineConfig
    from facerecognition_infrenceengine_tpu.engine.pipeline import FaceEngine as JaxFaceEngine
    from facerecognition_infrenceengine_tpu_torch.core.config import EngineConfig
    from facerecognition_infrenceengine_tpu_torch.engine.pipeline import FaceEngine
    from facerecognition_infrenceengine_tpu_torch.models.genderage import preprocess
    from facerecognition_infrenceengine_tpu_torch.ops.warp2pass import warp_boxes_two_pass

    ga_bytes, lm_bytes, (ga, lm) = _attribute_graphs(kind)
    (tmp_path / "attr_genderage.onnx").write_bytes(ga_bytes)
    (tmp_path / "attr_2d106det.onnx").write_bytes(lm_bytes)
    monkeypatch.setenv("FRE_WEIGHTS_DIR", str(tmp_path))
    kw = dict(det_size=(64, 64), max_faces=4, pre_nms_topk=32, dtype="float32")
    jax_eng = JaxFaceEngine(JaxEngineConfig(**kw), det_arch="det_500m", rec_arch="r18")
    eng = FaceEngine(EngineConfig(**kw), det_arch="det_500m", rec_arch="r18", device="cpu")
    rng = np.random.default_rng(11)
    frames = rng.integers(0, 255, (2, 160, 160, 3), dtype=np.uint8)
    idx = np.asarray([0, 1, 1], np.int32)
    boxes = np.asarray([[20, 20, 90, 100], [40, 10, 120, 110], [5, 60, 70, 150]], np.float32)
    want = jax_eng.attributes(frames, idx, boxes)
    got = eng.attributes(frames, idx, boxes)
    assert jax_eng._attr_runners is not None and eng._attr_runners is not None
    assert eng._attr_sizes == jax_eng._attr_sizes == (96, 192)
    assert got[0].shape == (3,) and got[2].shape == (3, 106, 2)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_allclose(got[1], want[1], rtol=0, atol=1.0)
    lm_tol = 1e-3 if kind == "synthetic_heads" else 1e-6 * float(np.abs(want[2]).max())
    np.testing.assert_allclose(got[2], want[2], rtol=0, atol=lm_tol)
    # decode: gender = argmax(out[:2]), age = round(out[2] * 100) of the
    # graph's module on the engine's own crops
    crops = warp_boxes_two_pass(torch.from_numpy(frames), torch.from_numpy(idx).long(),
                                torch.from_numpy(boxes), 96, scale_factor=1.5)
    with torch.no_grad():
        ref = (ga(crops.permute(0, 3, 1, 2).float()) if kind == "torch_exports"
               else ga(preprocess(crops))).numpy()
    np.testing.assert_array_equal(got[0], np.argmax(ref[:, :2], axis=1))
    np.testing.assert_allclose(got[1], np.round(ref[:, 2] * 100.0), atol=1.0)
