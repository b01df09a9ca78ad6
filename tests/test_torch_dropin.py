"""The drop-in pack through the port: pack on disk -> convert -> the port's
loaders -> serve (ROADMAP Queue 1 item 1).

As tests/test_weight_dropin.py does for the reference, a module fixture runs
``tools/synthetic_pack.make_pack`` (torch mirrors of det_10g, w600k_r50 and
w600k_mbf with random weights and BN statistics, plus attribute heads with
the real output contracts, written as ONNX) and ``tools/convert_onnx.convert``
once.  The port's ``models/weights.load_or_init`` must load each converted
``.npz`` leaf for leaf, and its forwards must match the torch mirrors within
the reference test's budgets: r50 and MobileFaceNet 1 - cos 1e-5 and atol
1e-4 on L2-normalized embeddings, det_10g's scores, bbox and kps 1 - cos 1e-5
and atol / rtol 1e-3.  ``FaceEngine`` picks the pack up from
``FRE_WEIGHTS_DIR``, and ``FaceAnalysis.get`` serves a frame with the
converted detector, embedder and the exact-graph attribute heads.  Every
case is float32 on the CPU.
"""

import os

import numpy as np
import pytest
import torch

from facerecognition_infrenceengine_tpu_torch.core.config import EngineConfig
from facerecognition_infrenceengine_tpu_torch.engine.pipeline import FaceEngine
from facerecognition_infrenceengine_tpu_torch.models import arcface, mobilefacenet, scrfd
from facerecognition_infrenceengine_tpu_torch.models.weights import (
    flax_layout, load_flat, load_or_init)
from facerecognition_infrenceengine_tpu_torch.models.zoo import FaceAnalysis
from tools import convert_onnx, synthetic_pack

CFG = dict(det_size=(128, 128), max_faces=4, pre_nms_topk=64, dtype="float32")


def cosine(a, b) -> float:
    a = np.asarray(a, np.float64).reshape(-1)
    b = np.asarray(b, np.float64).reshape(-1)
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b) + 1e-30))


@pytest.fixture(scope="module")
def pack(tmp_path_factory):
    """The synthetic pack, written and converted once for the module."""
    pack_dir = str(tmp_path_factory.mktemp("fake_buffalo_l"))
    wdir = str(tmp_path_factory.mktemp("converted_weights"))
    models = synthetic_pack.make_pack(pack_dir, seed=0)
    convert_onnx.convert(pack_dir, wdir)
    return models, wdir


@pytest.fixture
def weights_env(pack, monkeypatch):
    monkeypatch.setenv("FRE_WEIGHTS_DIR", pack[1])
    return pack


def _mirror(model, x_nhwc):
    with torch.no_grad():
        out = model(torch.from_numpy(np.ascontiguousarray(x_nhwc.transpose(0, 3, 1, 2))))
    return tuple(o.numpy() for o in out) if isinstance(out, tuple) else out.numpy()


def _port(model, x_nhwc):
    with torch.no_grad():
        out = model(torch.from_numpy(x_nhwc))
    return tuple(o.numpy() for o in out) if isinstance(out, (tuple, list)) else out.numpy()


MODELS = {"arcface_r50": arcface.iresnet50,
          "arcface_mobilefacenet": mobilefacenet.mobilefacenet,
          "scrfd_det_10g": lambda: scrfd.SCRFD(scrfd.CONFIGS["det_10g"])}


@pytest.mark.parametrize("name", list(MODELS))
def test_load_or_init_loads_each_converted_leaf(weights_env, name):
    """Every tensor of the module is its converted .npz leaf, in the
    module's layout, and every leaf of the pack is used."""
    _, wdir = weights_env
    model = load_or_init(name, MODELS[name]())
    flat = load_flat(os.path.join(wdir, f"{name}.npz"))
    state = model.state_dict()
    layout = flax_layout(model)
    assert {path for _, path, _, _ in layout} == set(flat)
    for key, path, _, convert in layout:
        np.testing.assert_array_equal(state[key].numpy(), convert(flat[path]), err_msg=path)


@pytest.mark.parametrize("name,onnx,seed", [("arcface_r50", "w600k_r50.onnx", 0),
                                            ("arcface_mobilefacenet", "w600k_mbf.onnx", 1)])
def test_embedders_match_the_torch_mirrors(weights_env, name, onnx, seed):
    models, _ = weights_env
    model = load_or_init(name, MODELS[name]())
    x = np.random.default_rng(seed).uniform(-1, 1, (2, 112, 112, 3)).astype(np.float32)
    got, ref = _port(model, x), _mirror(models[onnx], x)
    assert got.shape == ref.shape == (2, 512)
    gn = got / np.linalg.norm(got, axis=1, keepdims=True)
    rn = ref / np.linalg.norm(ref, axis=1, keepdims=True)
    assert min(cosine(g, r) for g, r in zip(gn, rn)) > 1 - 1e-5
    np.testing.assert_allclose(gn, rn, atol=1e-4)


def test_det10g_matches_the_torch_mirror(weights_env):
    models, _ = weights_env
    model = load_or_init("scrfd_det_10g", MODELS["scrfd_det_10g"]())
    x = np.random.default_rng(2).uniform(-1, 1, (1, 128, 128, 3)).astype(np.float32)
    got, ref = _port(model, x), _mirror(models["det_10g.onnx"], x)
    for g, r, name in zip(got, ref, ("scores", "bbox", "kps")):
        assert g.shape == r.shape, name
        assert cosine(g, r) > 1 - 1e-5, name
        np.testing.assert_allclose(g, r, atol=1e-3, rtol=1e-3, err_msg=name)


@pytest.mark.parametrize("rec_arch,onnx", [("r50", "w600k_r50.onnx"),
                                           ("mobilefacenet", "w600k_mbf.onnx")])
def test_engine_serves_the_converted_pack(weights_env, rec_arch, onnx):
    """FaceEngine picks the pack up from FRE_WEIGHTS_DIR (not the synthetic
    weights): its detector and embedder hold the converted leaves, and uint8
    crops -> preprocess -> embedder -> L2 normalize match the torch mirror."""
    models, wdir = weights_env
    engine = FaceEngine(EngineConfig(**CFG), det_arch="det_10g", rec_arch=rec_arch,
                        device="cpu")
    for module, name in ((engine.embedder, f"arcface_{rec_arch}"),
                         (engine.detector, "scrfd_det_10g")):
        flat = load_flat(os.path.join(wdir, f"{name}.npz"))
        state = module.state_dict()
        for key, path, _, convert in flax_layout(module):
            np.testing.assert_array_equal(state[key].numpy(), convert(flat[path]), err_msg=path)
    crops = np.random.default_rng(3).integers(0, 255, (2, 112, 112, 3), dtype=np.uint8)
    got = engine.embed_crops(crops)
    ref = _mirror(models[onnx], (crops.astype(np.float32) - 127.5) / 127.5)
    ref = ref / np.linalg.norm(ref, axis=1, keepdims=True)
    np.testing.assert_allclose(got, ref, atol=1e-4)
    assert cosine(got[0], ref[0]) > 1 - 1e-5


def test_face_analysis_serves_the_converted_pack(weights_env):
    """The whole drop-in, FaceAnalysis.get on a frame: the converted det_10g
    detects, the converted r50 embeds what it found, and the attribute heads
    are the pack's exact graphs (attr_genderage.onnx, attr_2d106det.onnx)."""
    models, _ = weights_env
    engine = FaceEngine(EngineConfig(**CFG), det_arch="det_10g", rec_arch="r50", device="cpu")
    app = FaceAnalysis(cfg=EngineConfig(**CFG), engine=engine)
    app.prepare(det_thresh=0.05)  # random weights: a low threshold
    frame = np.random.default_rng(4).integers(0, 255, (128, 128, 3), dtype=np.uint8)
    faces = app.get(frame)
    assert engine._attr_runners is not None and engine._attr_sizes == (96, 192)
    assert faces
    crops = []
    for face in faces:
        assert face.normed_embedding.shape == (512,)
        assert abs(float(np.linalg.norm(face.normed_embedding)) - 1) < 1e-3
        assert face.gender in (0, 1) and face.age >= 0
        assert face.landmark_2d_106.shape == (106, 2)
        assert np.isfinite(face.landmark_2d_106).all()
        crops.append(face.kps)
    # each embedding is the converted embedder on the face's own crop
    want = engine.embed_faces(np.ascontiguousarray(frame[None, ..., ::-1]),
                              np.zeros(len(faces), np.int32), np.stack(crops))
    for face, w in zip(faces, want):
        assert float(face.normed_embedding @ w) > 1 - 1e-5
