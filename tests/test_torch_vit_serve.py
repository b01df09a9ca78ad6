"""The ViT's serving forward (``models/vit.serve_forward``) and its residual
add + LayerNorm pass (``ops/layernorm_kernel.py``) on the CPU, where the
pass runs its plain version.

The serving forward must equal the module forward bit for bit, leave the
crops it is given as they were, send every LayerNorm through the pass, and
serve every ViT the engine embeds with.  The kernel itself is held to ATen
on the card (``tests/test_torch_gpu.py``).  This file imports no JAX.
"""

import dataclasses

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch import nn
from torch.nn.attention import SDPBackend

from facerecognition_infrenceengine_tpu_torch.core import metrics
from facerecognition_infrenceengine_tpu_torch.core.config import EngineConfig
from facerecognition_infrenceengine_tpu_torch.engine import pipeline
from facerecognition_infrenceengine_tpu_torch.engine.pipeline import FaceEngine
from facerecognition_infrenceengine_tpu_torch.models import arcface, vit, weights
from facerecognition_infrenceengine_tpu_torch.models.layers import cast_keep_bn_f32
from facerecognition_infrenceengine_tpu_torch.ops import layernorm_kernel
from facerecognition_infrenceengine_tpu_torch.ops.layernorm_kernel import (
    residual_layernorm, residual_layernorm_plain)
from facerecognition_infrenceengine_tpu_torch.ops.matching import l2_normalize
from portbench import data
from test_torch_vit import SMALL, _crops, random_leaves, small_vit  # noqa: F401


def _model(dtype, seed=0):
    model = weights.load_tree(vit.VisionTransformer(**SMALL), random_leaves(seed))
    return cast_keep_bn_f32(model.eval(), "cpu", dtype)


def _bits(t):
    return t.view(torch.int32)


def _norm(width, dtype, seed=0):
    gen = torch.Generator().manual_seed(seed)
    norm = nn.LayerNorm(width, eps=vit.LN_EPS)
    with torch.no_grad():
        norm.weight.copy_(1 + 0.1 * torch.randn(width, generator=gen))
        norm.bias.copy_(0.1 * torch.randn(width, generator=gen))
    return norm.to(dtype)


def _rows(shape, dtype, seed):
    return (3 * torch.randn(shape, generator=torch.Generator().manual_seed(seed))).to(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("seed", [0, 1])
def test_serve_forward_bit_equal_to_the_module(dtype, seed):
    model = _model(dtype, seed)
    x = _crops(5, seed)
    with torch.inference_mode():
        want = model(x)
        got = vit.serve_forward(model, x)
    assert got.dtype == want.dtype == torch.float32 and got.shape == (5, 512)
    assert torch.equal(_bits(got), _bits(want))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_serve_forward_leaves_the_crops_as_they_were(dtype):
    model = _model(dtype)
    x = _crops(3, 2)
    before = x.clone()
    with torch.inference_mode():
        vit.serve_forward(model, x)
    assert torch.equal(x, before)


def test_serve_forward_refuses_training_mode():
    model = _model(torch.float32).train()
    with pytest.raises(ValueError, match="eval mode"):
        vit.serve_forward(model, _crops(2))


def test_every_layernorm_goes_through_the_pass(monkeypatch):
    """Block 0's norm1 by the plain form, each block's norm2 and the next
    norm1 (the last block: the final norm) by the fused form, each fused
    pass writing into the branch's own buffer."""
    calls = []

    def recorded(x, a, norm):
        calls.append(("plain" if a is None else "fused", norm))
        n = residual_layernorm(x, a, norm)
        assert a is None or n.data_ptr() == a.data_ptr()
        return n

    monkeypatch.setattr(vit, "residual_layernorm", recorded)
    model = _model(torch.float32)
    with torch.inference_mode():
        vit.serve_forward(model, _crops(2))
    b0, b1 = model.blocks
    assert calls == [("plain", b0.norm1), ("fused", b0.norm2), ("fused", b1.norm1),
                     ("fused", b1.norm2), ("fused", model.norm)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_the_plain_pass_is_atens_add_then_layer_norm(dtype):
    """Both outputs: the stream ``x + a`` written into x, its LayerNorm
    into a's buffer (or into ``out``); without a residual, x is only read."""
    norm = _norm(96, dtype)
    x, a = _rows((4, 7, 96), dtype, 1), _rows((4, 7, 96), dtype, 2)
    h = x + a
    n = F.layer_norm(h, (96,), norm.weight, norm.bias, norm.eps)
    with torch.no_grad():
        xs, ax = x.clone(), a.clone()
        got = residual_layernorm_plain(xs, ax, norm)
        assert got.data_ptr() == ax.data_ptr()
        assert torch.equal(xs, h) and torch.equal(got, n)
        xs, out = x.clone(), torch.empty_like(x)
        got = residual_layernorm_plain(xs, a.clone(), norm, out=out)
        assert got.data_ptr() == out.data_ptr() and torch.equal(xs, h) and torch.equal(got, n)
        xs = h.clone()
        got = residual_layernorm(xs, None, norm)
        assert torch.equal(xs, h) and torch.equal(got, n)
        assert torch.equal(residual_layernorm(xs, None, norm, out=xs), n)


@pytest.mark.parametrize("fault,match", [
    ("dtype", "float32 or bfloat16"), ("a_dtype", "a:"), ("norm_dtype", "LayerNorm weight"),
    ("noncontiguous", "x:"), ("a_noncontiguous", "a:"), ("width", "width 96"),
    ("too_wide", "width 1152"), ("norm_width", "LayerNorm over"), ("sound", "CUDA tensor")])
def test_the_kernel_wrapper_refuses_what_the_kernel_does_not_take(fault, match):
    """Off the CPU the wrapper checks its arguments before a launch (here on
    the meta device, which it then refuses as not a card's)."""
    dtype = torch.float16 if fault == "dtype" else torch.bfloat16
    width = {"width": 96, "too_wide": 1152}.get(fault, 768)
    x = torch.empty(2, 144, width, dtype=dtype, device="meta")
    a = torch.empty_like(x, dtype=torch.float32 if fault == "a_dtype" else None)
    norm = _norm(512 if fault == "norm_width" else width,
                 torch.float32 if fault == "norm_dtype" else dtype).to("meta")
    if fault == "noncontiguous":
        x = torch.empty(2, width, 144, dtype=dtype, device="meta").transpose(1, 2)
    if fault == "a_noncontiguous":
        a = torch.empty(144, 2, width, dtype=dtype, device="meta").transpose(0, 1)
    before = residual_layernorm.launches
    with pytest.raises(ValueError, match=match):
        residual_layernorm(x, a, norm)
    assert residual_layernorm.launches == before


@pytest.mark.parametrize("width", [128, 384, 1024])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_the_kernel_takes_rows_of_128_to_1024(width, dtype):
    """A row is a whole number of a warp's 4-element vectors, up to 8 of
    them: such a row reaches the device check."""
    x = torch.empty(3, width, dtype=dtype, device="meta")
    with pytest.raises(ValueError, match="CUDA tensor"):
        residual_layernorm(x, None, _norm(width, dtype).to("meta"))


def test_the_engine_serves_a_vit_through_serve_forward_on_the_cpu(small_vit,  # noqa: F811
                                                                  monkeypatch):
    """``_apply_embedder`` sends a ViT through its registered
    ``vit.serve_forward`` on the CPU as on the card, never through the
    module forward, one ``engine.embedder`` span a call; the embeddings are
    the module's.  The forward owns its attention pin: FlashAttention in
    bf16, the memory-efficient kernel in float32."""
    assert vit._ATTENTION == {torch.bfloat16: SDPBackend.FLASH_ATTENTION,
                              torch.float32: SDPBackend.EFFICIENT_ATTENTION}
    row = pipeline._EMBEDDERS["vit_l"]
    assert row.serve is vit.serve_forward
    served = []

    def recorded(model, x):
        served.append(x.shape[0])
        return row.serve(model, x)

    monkeypatch.setitem(pipeline._EMBEDDERS, "vit_l", dataclasses.replace(row, serve=recorded))
    cfg = EngineConfig(det_size=(64, 64), max_faces=2, pre_nms_topk=16, dtype="float32")
    engine = FaceEngine(cfg, rec_variables=data.nested(small_vit), det_arch="det_500m",
                        rec_arch="vit_l", device="cpu")
    forwards = []
    engine.embedder.register_forward_hook(lambda *_: forwards.append(1))
    crops = pipeline._calibration_crops(3, 112, 4)
    metrics.reset()
    try:
        metrics.record_spans(True)
        got = engine.embed_crops(crops)
        engine.embed_crops(crops[:2])
        spans = [s for s in metrics.spans() if s.name == "engine.embedder"]
    finally:
        metrics.reset()
    assert len(served) == 2 and not forwards and len(spans) == 2
    assert all(s.attrs["arch"] == "vit_l" for s in spans)
    pad = np.zeros((pipeline.bucket(3), 112, 112, 3), np.uint8)
    pad[:3] = crops
    with torch.inference_mode():
        want = l2_normalize(engine.embedder(arcface.preprocess(torch.from_numpy(pad))))[:3]
    assert np.array_equal(got, want.numpy())


def test_the_launch_count_starts_at_zero_and_the_cpu_adds_none():
    assert isinstance(layernorm_kernel.residual_layernorm.launches, int)
    before = residual_layernorm.launches
    norm = _norm(96, torch.float32)
    residual_layernorm(_rows((2, 96), torch.float32, 0), _rows((2, 96), torch.float32, 1), norm)
    assert residual_layernorm.launches == before
