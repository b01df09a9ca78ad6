"""Each model's input made once in its own dtype (``pipeline.model_input``)
on the CPU.

The engine makes an embedder's or an attribute head's input from K3's
float32 crops by normalising them in place and casting them to the dtype
the model's forward casts to; the float32 crops go before the model runs.
These tests hold that to the composition it replaced (``preprocess``, then
the model's own cast) bit for bit in every engine dtype and embedder, hold
that a caller's tensor is never written, that no float32 crops are alive
while a model runs, and the ``engine.crops_released`` counter.  The peak it
saves is measured on the card (``tests/test_torch_gpu.py``).  This file
imports no JAX.
"""

import dataclasses
import functools
import types
import weakref

import numpy as np
import pytest
import torch

from facerecognition_infrenceengine_tpu_torch.core import metrics
from facerecognition_infrenceengine_tpu_torch.core.config import EngineConfig
from facerecognition_infrenceengine_tpu_torch.engine import pipeline
from facerecognition_infrenceengine_tpu_torch.engine.pipeline import FaceEngine, model_input
from facerecognition_infrenceengine_tpu_torch.models import arcface, genderage, vit
from facerecognition_infrenceengine_tpu_torch.ops.matching import l2_normalize
from facerecognition_infrenceengine_tpu_torch.ops.stem_kernel import space_to_depth4
from facerecognition_infrenceengine_tpu_torch.ops.warp2pass import (
    boxes_to_affines, build_atlas, warp_boxes_two_pass, warp_faces_two_pass,
    warp_faces_two_pass_packed)

KW = dict(det_size=(64, 64), max_faces=4, pre_nms_topk=16, packed_stem_impl="xla")
# (rec_arch, dtype, embed_int8): every embedder the engine serves, each
# serving path's dtype
ENGINES = {"r18-f32": ("r18", "float32", False), "r18-bf16": ("r18", "bfloat16", False),
           "r18-int8": ("r18", "bfloat16", True), "mfn-bf16": ("mobilefacenet", "bfloat16", False),
           "vit-bf16": ("vit_l", "bfloat16", False)}
SMALL_VIT = dict(patch=9, width=96, depth=2, heads=2, mlp=384, embed_dim=512)
FRAMES = np.random.default_rng(11).integers(0, 256, (2, 64, 64, 3), np.uint8)
BOXES = np.array([[4, 6, 40, 44], [10, 2, 60, 30], [0, 0, 63, 63]], np.float32)
BOX_FRAMES = np.array([0, 1, 1])


def _engine(kind: str) -> FaceEngine:
    arch, dtype, int8 = ENGINES[kind]
    with pytest.MonkeyPatch.context() as mp:
        if arch == "vit_l":  # two blocks at a small width: the same code at published widths
            mp.setitem(pipeline._EMBEDDERS, "vit_l", dataclasses.replace(
                pipeline._EMBEDDERS["vit_l"],
                build=functools.partial(vit.VisionTransformer, **SMALL_VIT)))
        return FaceEngine(EngineConfig(**KW, dtype=dtype, embed_int8=int8), det_arch="det_500m",
                          rec_arch=arch, seed=2, device="cpu")


@pytest.fixture(scope="module")
def engines():
    return {}


def engine_of(engines: dict, kind: str) -> FaceEngine:
    if kind not in engines:
        engines[kind] = _engine(kind)
    return engines[kind]


# ---- the composition the helper replaced, as the engine ran it before
def _parent_embed_crops_impl(self, crops):
    return l2_normalize(self._apply_embedder(arcface.preprocess(crops)))


def _parent_embed_impl(self, frames_u8, frame_idx, kps):
    crops = warp_faces_two_pass(frames_u8, frame_idx, kps, self.cfg.embed_size, dst=self._dst)
    return _parent_embed_crops_impl(self, crops)


def _parent_fused_packed_impl(self, frames_p4, det_threshold):
    boxes, scores, kps, valid = self._detect_packed_impl(frames_p4, det_threshold)
    b, f = valid.shape
    frame_idx = torch.arange(b).repeat_interleave(f)
    crops = warp_faces_two_pass_packed(frames_p4, frame_idx, kps.reshape(b * f, 5, 2),
                                       self.cfg.embed_size, dst=self._dst)
    emb = _parent_embed_crops_impl(self, crops)
    return boxes, scores, kps, valid, emb.reshape(b, f, -1)


def _parent_attributes_impl(self, frames_u8, frame_idx, bboxes):
    ga_model, lm_model = self._ensure_attr_models()
    ga_size, lm_size = self._attr_sizes
    atlas = build_atlas(frames_u8)
    ga_crops = warp_boxes_two_pass(frames_u8, frame_idx, bboxes, ga_size, scale_factor=1.5,
                                   atlas=atlas)
    lm_crops = warp_boxes_two_pass(frames_u8, frame_idx, bboxes, lm_size, scale_factor=1.5,
                                   atlas=atlas)
    ga_out = ga_model(genderage.preprocess(ga_crops))
    lm = lm_model(genderage.preprocess(lm_crops))
    gender = torch.argmax(ga_out[:, :2], dim=1)
    age = torch.round(ga_out[:, 2] * 100.0)
    lm_px = (lm + 1.0) * (lm_size / 2.0)
    m_inv = boxes_to_affines(bboxes, lm_size, 1.5)
    lm_src = torch.einsum("mij,mkj->mki", m_inv[:, :, :2], lm_px) + m_inv[:, None, :, 2]
    return gender.to(torch.int32), age.float(), lm_src


PARENT = {"_embed_impl": _parent_embed_impl, "_embed_crops_impl": _parent_embed_crops_impl,
          "_fused_packed_impl": _parent_fused_packed_impl,
          "_attributes_impl": _parent_attributes_impl}


def _entry_outputs(engine: FaceEngine, entry: str) -> list:
    """The entry's outputs on a fixed small batch, as numpy arrays."""
    if entry == "embed_faces":
        flat = engine.detect_align_embed_flat(FRAMES, det_threshold=0.0).numpy()
        b, f, _ = flat.shape
        outs = engine.embed_faces(FRAMES, np.arange(b).repeat(f), flat[..., 5:15].reshape(-1, 5, 2))
    elif entry == "embed_crops":
        outs = engine.embed_crops(pipeline._calibration_crops(3, 112, 9))
    elif entry == "detect_align_embed_flat":
        outs = engine.detect_align_embed_flat(FRAMES, det_threshold=0.0)
    elif entry == "packed":
        outs = engine.detect_align_embed_packed(space_to_depth4(torch.from_numpy(FRAMES)),
                                                det_threshold=0.0)
    else:
        outs = engine.attributes(FRAMES, BOX_FRAMES, BOXES)
    outs = outs if isinstance(outs, tuple) else (outs,)
    return [np.asarray(o) for o in outs]


@pytest.mark.parametrize("scale,preprocess", [(127.5, arcface.preprocess),
                                              (128.0, genderage.preprocess)],
                         ids=["arcface", "genderage"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("given", ["uint8", "float32", "float32-own"])
def test_model_input_is_preprocess_then_the_models_cast(scale, preprocess, dtype, given):
    """Bit for bit ``preprocess(crops).to(dtype)``, on u8 uploads and on
    K3-like float crops (fractional values over the whole range); a
    caller's tensor is left as it was, the program's own float32 crops are
    normalised in their own storage."""
    gen = torch.Generator().manual_seed(3)
    if given == "uint8":
        crops = torch.randint(0, 256, (5, 24, 24, 3), generator=gen, dtype=torch.uint8)
    else:
        crops = torch.rand(5, 24, 24, 3, generator=gen) * 255.0
    before = crops.clone()
    want = preprocess(crops).to(dtype)
    got = model_input(crops, scale, dtype, own=given == "float32-own")
    assert got.dtype == dtype and got.shape == crops.shape
    assert torch.equal(got.view(torch.int16 if dtype == torch.bfloat16 else torch.int32),
                       want.view(torch.int16 if dtype == torch.bfloat16 else torch.int32))
    if given == "float32-own":
        assert torch.equal(crops.to(dtype), want)  # normalised where it lies
        assert (got.data_ptr() == crops.data_ptr()) == (dtype == torch.float32)
    else:
        assert torch.equal(crops, before)


@pytest.mark.parametrize("given", ["uint8-tensor", "float32-tensor", "float32-numpy"])
def test_embedding_a_callers_crops_leaves_them_as_they_were(engines, given):
    """``embed_crops`` / ``_embed_crops_impl`` never write the crops they
    are given (an upload, a user's float crops) and embed them as the
    parent's composition did."""
    engine = engine_of(engines, "r18-bf16")
    crops = pipeline._calibration_crops(4, 112, 5)
    if given == "float32-numpy":
        crops = crops.astype(np.float32) + 0.25
        before = crops.copy()
        got = engine.embed_crops(crops)
        assert np.array_equal(crops, before)
        with torch.inference_mode():
            want = _parent_embed_crops_impl(engine, torch.from_numpy(before)).numpy()
    else:
        t = torch.from_numpy(crops)
        t = t.float() + 0.25 if given == "float32-tensor" else t
        before = t.clone()
        with torch.inference_mode():
            got = engine._embed_crops_impl(t).numpy()
            want = _parent_embed_crops_impl(engine, before).numpy()
        assert torch.equal(t, before)
    assert np.array_equal(got, want)


@pytest.mark.parametrize("entry", ["embed_faces", "embed_crops", "detect_align_embed_flat",
                                   "packed", "attributes"])
@pytest.mark.parametrize("kind", list(ENGINES))
def test_the_entries_are_bit_equal_to_the_parents_composition(engines, kind, entry):
    """Each entry's outputs with the inputs made by ``model_input`` equal,
    bit for bit, the outputs of the same engine running the composition it
    replaced (``preprocess`` then each forward's own cast): f32, bf16, the
    int8 twin, MobileFaceNet and the ViT; the raw, packed and crop routes
    and the attribute heads."""
    engine = engine_of(engines, kind)
    got = _entry_outputs(engine, entry)
    with pytest.MonkeyPatch.context() as mp:
        for name, fn in PARENT.items():
            mp.setattr(engine, name, types.MethodType(fn, engine))
        want = _entry_outputs(engine, entry)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and np.array_equal(g, w)


@pytest.mark.parametrize("kind,route", [("r18-bf16", "fused"), ("r18-bf16", "packed"),
                                        ("vit-bf16", "fused"), ("r18-f32", "attributes"),
                                        ("r18-bf16", "attributes")])
def test_no_float32_crops_are_alive_while_a_model_runs(engines, kind, route, monkeypatch):
    """K3's crops are gone when the embedder starts; the atlas and each
    head's crops when that head starts, and the genderage input when the
    landmark head starts (in float32 too: the input is the crops,
    normalised in place, handed on)."""
    engine = engine_of(engines, kind)
    made, seen = {}, []

    def recorded(name, fn):
        def call(*args, **kw):
            out = fn(*args, **kw)
            made.setdefault(name, []).append(weakref.ref(out[0] if name == "atlas" else out))
            return out
        return call

    def alive(name):
        return [r for r in made.get(name, []) if r() is not None]

    for name, fn in (("faces", warp_faces_two_pass), ("packed", warp_faces_two_pass_packed),
                     ("boxes", warp_boxes_two_pass), ("atlas", build_atlas)):
        monkeypatch.setattr(pipeline, {"faces": "warp_faces_two_pass",
                                       "packed": "warp_faces_two_pass_packed",
                                       "boxes": "warp_boxes_two_pass",
                                       "atlas": "build_atlas"}[name], recorded(name, fn))
    if route == "attributes":
        ga_model, lm_model = engine._ensure_attr_models()

        def at_ga(_, args):
            seen.append(("ga", len(alive("boxes")), len(alive("atlas"))))
            made["ga_in"] = [weakref.ref(args[0])]

        def at_lm(_, args):
            seen.append(("lm", len(alive("boxes")), len(alive("atlas")), len(alive("ga_in"))))

        hooks = [ga_model.register_forward_pre_hook(at_ga),
                 lm_model.register_forward_pre_hook(at_lm)]
        try:
            engine.attributes(FRAMES, BOX_FRAMES, BOXES)
        finally:
            for h in hooks:
                h.remove()
        if kind == "r18-f32":  # the landmark crops are the landmark head's input
            assert seen == [("ga", 2, 0), ("lm", 1, 0, 0)]
        else:  # the landmark crops wait for the genderage head, then go
            assert seen == [("ga", 1, 0), ("lm", 0, 0, 0)]
        return
    serve = engine._serve_embedder

    def embedder(model, x):
        seen.append((x.dtype, len(alive("faces")) + len(alive("packed"))))
        return serve(model, x)

    monkeypatch.setattr(engine, "_serve_embedder", embedder)
    if route == "fused":
        engine.detect_align_embed_flat(FRAMES, det_threshold=0.0)
    else:
        engine.detect_align_embed_packed(space_to_depth4(torch.from_numpy(FRAMES)),
                                         det_threshold=0.0)
    assert len(made["packed" if route == "packed" else "faces"]) == 1
    assert seen == [(torch.bfloat16, 0)]


@pytest.mark.parametrize("kind", ["r18-f32", "r18-bf16"])
def test_crops_released_counts_the_float32_crops_let_go(engines, kind):
    """``engine.crops_released``: the bytes of float32 crops dropped before
    their model runs, K3's 112-pixel crops of every slot, the genderage
    (96) and landmark (192) crops of every padded box, and the float32 copy
    of an uploaded crop batch; in float32 the crops are the input and
    nothing is released."""
    engine = engine_of(engines, kind)
    slots = FRAMES.shape[0] * KW["max_faces"]
    boxes = pipeline.bucket(len(BOXES))
    want = [slots * 112 * 112 * 3 * 4, boxes * (96 * 96 + 192 * 192) * 3 * 4,
            pipeline.bucket(3) * 112 * 112 * 3 * 4]
    if kind == "r18-f32":
        want = [0, 0, 0]
    got = []
    metrics.reset()
    try:
        for run in (lambda: engine.detect_align_embed_flat(FRAMES, det_threshold=0.0),
                    lambda: engine.attributes(FRAMES, BOX_FRAMES, BOXES),
                    lambda: engine.embed_crops(pipeline._calibration_crops(3, 112, 9))):
            before = metrics.counter("engine.crops_released").value
            run()
            got.append(metrics.counter("engine.crops_released").value - before)
    finally:
        metrics.reset()
    assert got == want
