"""IResNet's serving forward (``models/arcface.serve_forward``) and its
in-place epilogues (``ops/epilogue_kernel.py``) on the CPU, where the
epilogue runs its plain version.

The serving forward must equal the module forward bit for bit, reuse block
0's input storage for its BatchNorm_0, and run only where the engine serves
a float IResNet: the int8 twin and the trainer keep the module forward.
The kernel itself is held to the plain version on the card
(``tests/test_torch_gpu.py``).  This file imports no JAX.
"""

import numpy as np
import pytest
import torch
from torch import nn

from facerecognition_infrenceengine_tpu_torch.core.config import EngineConfig
from facerecognition_infrenceengine_tpu_torch.engine import training
from facerecognition_infrenceengine_tpu_torch.engine.pipeline import FaceEngine
from facerecognition_infrenceengine_tpu_torch.models import arcface, weights
from facerecognition_infrenceengine_tpu_torch.models.layers import cast_keep_bn_f32
from facerecognition_infrenceengine_tpu_torch.ops import epilogue_kernel
from facerecognition_infrenceengine_tpu_torch.ops.matching import l2_normalize

SMALL = dict(det_size=(64, 64), max_faces=4, pre_nms_topk=16, dtype="float32")


def random_bn_stats(model: nn.Module, seed: int = 0) -> nn.Module:
    """Every BatchNorm's weight, bias and statistics drawn near identity
    (the synthetic weights' are exactly 1, 0, 0, 1, which hides how a
    BatchNorm rounds)."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, nn.modules.batchnorm._BatchNorm):
                c = m.num_features
                m.weight.copy_(1 + 0.1 * torch.randn(c, generator=gen))
                m.bias.copy_(0.1 * torch.randn(c, generator=gen))
                m.running_mean.copy_(0.1 * torch.randn(c, generator=gen))
                m.running_var.copy_((0.2 * torch.randn(c, generator=gen)).exp())
    return model


def _model(arch, dtype, fmt=torch.channels_last):
    model = arcface.iresnet50() if arch == "r50" else arcface.iresnet18()
    weights.load_or_init(f"arcface_{arch}", model, 1)
    return cast_keep_bn_f32(random_bn_stats(model), "cpu", dtype, fmt)


def _crops(n, seed=0):
    crops = np.random.default_rng(seed).integers(0, 256, (n, 112, 112, 3), dtype=np.uint8)
    return arcface.preprocess(torch.from_numpy(crops))


def _bits(t):
    return t.view(torch.int32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("arch", ["r18", "r50"])
def test_serve_forward_bit_equal_to_the_module(arch, dtype):
    model = _model(arch, dtype)
    x = _crops(3)
    with torch.inference_mode():
        want = model(x)
        got = arcface.serve_forward(model, x)
    assert got.dtype == want.dtype == torch.float32
    assert torch.equal(_bits(got), _bits(want))


@pytest.mark.parametrize("kind", ["float32", "bfloat16", "bfloat16-over-float32"])
def test_serve_forward_in_the_engines_cpu_layout(kind):
    """The engine keeps contiguous NCHW modules on the CPU; a module built
    with a bf16 compute dtype over f32 parameters (the trainer's) too."""
    if kind == "bfloat16-over-float32":
        model = weights.load_or_init("arcface_r18", arcface.iresnet18(torch.bfloat16), 1)
        model = random_bn_stats(model).eval()
    else:
        model = _model("r18", getattr(torch, kind), torch.contiguous_format)
    x = _crops(2, seed=1)
    with torch.inference_mode():
        assert torch.equal(_bits(arcface.serve_forward(model, x)), _bits(model(x)))


def test_block0_reuses_its_input_storage_and_identity_blocks_do_not():
    """The stem's epilogue writes into the stem conv's output, and block 0
    (a stage entry) convolves that same storage after its BatchNorm_0; an
    identity block's BatchNorm_0 writes a new tensor (its input stays for
    the residual)."""
    model = _model("r18", torch.float32)
    ptrs = {}

    def keep(name):
        def hook(module, args, out):
            ptrs[name] = (args[0].data_ptr(), out.data_ptr())
        return hook

    handles = [model.Conv_0.register_forward_hook(keep("stem")),
               model.IBasicBlock_0.Conv_0.register_forward_hook(keep("b0")),
               model.IBasicBlock_1.Conv_0.register_forward_hook(keep("b1")),
               model.IBasicBlock_0.Conv_1.register_forward_hook(keep("b0_conv1"))]
    try:
        with torch.inference_mode():
            arcface.serve_forward(model, _crops(2))
    finally:
        for h in handles:
            h.remove()
    assert ptrs["b0"][0] == ptrs["stem"][1]
    # block 1's input is block 0's Conv_1 output (its last epilogue wrote
    # there); block 1's Conv_0 reads a new tensor
    assert ptrs["b1"][0] != ptrs["b0_conv1"][1]


def test_serve_forward_refuses_a_training_module():
    model = _model("r18", torch.float32).train()
    with pytest.raises(ValueError, match="eval"):
        arcface.serve_forward(model, _crops(1))


def test_epilogue_plain_writes_into_x_or_out():
    """The plain version: BN, + BN(r) or + r, then PReLU, into x itself or
    into out, equal to ATen's separate passes."""
    gen = torch.Generator().manual_seed(3)
    bn_a, bn_b = (random_bn_stats(nn.BatchNorm2d(16), s).eval() for s in (1, 2))
    x = torch.randn(2, 16, 5, 5, generator=gen).contiguous(memory_format=torch.channels_last)
    r = torch.randn(2, 16, 5, 5, generator=gen).contiguous(memory_format=torch.channels_last)
    slope = 0.25 * torch.randn(16, generator=gen)
    with torch.inference_mode():
        want = torch.nn.functional.prelu(bn_a(x) + bn_b(r), slope)
        out = torch.empty_like(x)
        assert epilogue_kernel.epilogue(x, bn_a, prelu=slope, res=r, res_bn=bn_b, out=out) is out
        assert torch.equal(out, want)
        y = x.clone()
        assert epilogue_kernel.epilogue(y, bn_a, res=r).data_ptr() == y.data_ptr()
        assert torch.equal(y, bn_a(x) + r)


def _counted(monkeypatch):
    """arcface.serve_forward's epilogue calls: the shape of each x."""
    calls = []
    real = arcface.epilogue

    def spy(*args, **kw):
        calls.append(args[0].shape)
        return real(*args, **kw)

    monkeypatch.setattr(arcface, "epilogue", spy)
    return calls


def test_the_float_engine_embeds_through_the_serving_forward(monkeypatch):
    """A float r18 engine embeds through serve_forward: 1 + 3 x 8 epilogues
    a forward, each over every crop, embeddings equal to the module
    forward's."""
    engine = FaceEngine(EngineConfig(**SMALL), det_arch="det_500m", rec_arch="r18", seed=3,
                         device="cpu")
    random_bn_stats(engine.embedder, 4)
    calls = _counted(monkeypatch)
    # a bucket's worth: the engine pads a batch to its bucket
    crops = np.random.default_rng(5).integers(0, 256, (4, 112, 112, 3), dtype=np.uint8)
    launches = epilogue_kernel.epilogue.launches
    got = engine.embed_crops(crops)
    assert len(calls) == 1 + 3 * engine.embedder.num_blocks
    assert all(shape[0] == 4 for shape in calls)
    assert epilogue_kernel.epilogue.launches == launches  # the plain version on the CPU
    with torch.inference_mode():
        want = l2_normalize(engine.embedder(arcface.preprocess(torch.from_numpy(crops))))
    np.testing.assert_array_equal(np.asarray(got), want.numpy())


def test_int8_engine_and_trainer_keep_the_module_forward(monkeypatch):
    """The int8 twin and the trainer run no epilogue."""
    calls = _counted(monkeypatch)
    launches = epilogue_kernel.epilogue.launches
    e = FaceEngine(EngineConfig(**SMALL, embed_int8=True), det_arch="det_500m", rec_arch="r18",
                   seed=3, device="cpu")
    crops = np.random.default_rng(6).integers(0, 256, (2, 112, 112, 3), dtype=np.uint8)
    assert e.embed_crops(crops).shape == (2, 512)
    model = arcface.IResNet(depths=(1, 1, 1, 1), widths=(8, 8, 8, 8), input_size=32)
    images = np.random.default_rng(7).normal(size=(4, 32, 32, 3)).astype(np.float32)
    state, opt = training.make_train_state(model, 10, images[:2], learning_rate=0.01)
    _, loss = training.make_train_step(model, opt)(state, images, np.arange(4) % 10)
    assert np.isfinite(float(loss))
    assert calls == []
    assert epilogue_kernel.epilogue.launches == launches
