"""The harness takes a configuration whose embedder it has never met by new
files alone (its reference found by the architecture's name, its weights
drawn as flax names them, every matmul counted), and the epilogue kernel's
count of bytes."""

import functools
import json
import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch import nn

from portbench import count, data, spec, trace
from portbench.reference.pipeline import (Reference, canvas_of, detector_factory,
                                          embedder_factory, head_factory)

TESTS = os.path.dirname(os.path.abspath(__file__))
LOOKUP = spec.embedder  # the fixture ``toy`` points ``spec.embedder`` elsewhere


def _config(name: str) -> dict:
    with open(os.path.join(spec.ROOT, "portbench", "configs", f"{name}.json")) as f:
        return json.load(f)


def _tiny() -> dict:
    with open(os.path.join(TESTS, "tiny_config.json")) as f:
        return json.load(f)


@pytest.mark.parametrize("model,flops", [
    ("det_10g", 26_395_904_000), ("r50", 12_618_661_888), ("genderage", 67_683_840),
    ("landmark_2d_106", 161_324_544), ("mobilefacenet", 444_732_416)])
def test_published_models_count_as_before(model, flops):
    """Every count the benchmark's metrics read, exact: det_10g on the 640
    x 640 canvas, the embedders and the attribute heads on one face."""
    buffalo = _config("buffalo_l")
    if model == "det_10g":
        make, side = detector_factory(buffalo["detector"]), 640
    elif model in buffalo["attribute_heads"]:
        head = buffalo["attribute_heads"][model]
        make, side = head_factory(model, head), head["input"]
    else:
        rec = (buffalo if model == "r50" else _config("mobile_facenet"))["recognizer"]
        make, side = embedder_factory(rec), 112
    assert count.model_flops(make, (side, side, 3)) == flops


S, D, HEADS = 144, 768, 8


class Attention(nn.Module):
    """One self-attention block over [B, S, D] tokens: qkv with no bias,
    QK^T and AV, the output projection."""

    def __init__(self, sdpa: bool, width: int = D, heads: int = HEADS):
        super().__init__()
        self.sdpa, self.heads = sdpa, heads
        self.Dense_qkv = nn.Linear(width, 3 * width, bias=False)
        self.Dense_out = nn.Linear(width, width)

    def forward(self, x):
        b, s, d = x.shape
        q, k, v = self.Dense_qkv(x).reshape(b, s, 3, self.heads, d // self.heads).permute(
            2, 0, 3, 1, 4)
        if self.sdpa:
            o = F.scaled_dot_product_attention(q, k, v)
        else:
            o = torch.softmax(q @ k.transpose(-1, -2) / (d // self.heads) ** 0.5, dim=-1) @ v
        return self.Dense_out(o.transpose(1, 2).reshape(b, s, d))


@pytest.mark.parametrize("sdpa", [False, True], ids=["matmuls", "sdpa"])
def test_attention_block_counted_by_hand(sdpa):
    """S = 144, D = 768, 8 heads: the dense layers 2 x S x 4D^2 =
    679,477,248, QK^T and AV 2 x 2 x S^2 x D = 63,700,992."""
    dense, scores = 2 * S * 4 * D * D, 2 * 2 * S * S * D
    assert (dense, scores) == (679_477_248, 63_700_992)
    assert count.model_flops(lambda: Attention(sdpa), (S, D)) == dense + scores == 743_178_240


TOY = '''"""A toy transformer embedder: patches, a pre-norm self-attention block,
the tokens flattened into one dense layer, BatchNorm."""

import torch
import torch.nn.functional as F
from torch import nn


class Toy(nn.Module):
    def __init__(self, rec):
        super().__init__()
        width, patch, self.heads = rec["width"], rec["patch"], rec["heads"]
        self.Conv_0 = nn.Conv2d(3, width, patch, patch)
        self.LayerNorm_0 = nn.LayerNorm(width)
        self.Dense_qkv = nn.Linear(width, 3 * width, bias=False)
        self.Dense_out = nn.Linear(width, width)
        self.Dense_0 = nn.Linear((112 // patch) ** 2 * width, rec["embed_dim"])
        self.BatchNorm_0 = nn.BatchNorm1d(rec["embed_dim"])

    def forward(self, x):
        x = self.Conv_0(x.permute(0, 3, 1, 2)).flatten(2).transpose(1, 2)
        b, s, d = x.shape
        q, k, v = self.Dense_qkv(self.LayerNorm_0(x)).reshape(
            b, s, 3, self.heads, d // self.heads).permute(2, 0, 3, 1, 4)
        o = F.scaled_dot_product_attention(q, k, v).transpose(1, 2).reshape(b, s, d)
        return self.BatchNorm_0(self.Dense_0((x + self.Dense_out(o)).flatten(1)))


def build(rec):
    if rec["width"] % rec["heads"]:
        raise ValueError("the width is not a whole number of heads")
    return Toy(rec)
'''
TOY_REC = {"arch": "toy_vit", "patch": 16, "width": 32, "heads": 2, "embed_dim": 512}


@pytest.fixture
def toy(tmp_path, monkeypatch):
    """The tiny configuration with the toy embedder, whose reference is a
    file under a temporary checkout that the lookup finds by name."""
    embedders = tmp_path / "portbench" / "reference" / "embedders"
    embedders.mkdir(parents=True)
    (embedders / "toy_vit.py").write_text(TOY)
    monkeypatch.setattr(spec, "embedder", functools.partial(spec.embedder, root=str(tmp_path)))
    return dict(_tiny(), recognizer=dict(TOY_REC)), str(tmp_path)


def test_a_new_architecture_is_found_by_its_name(toy):
    config, root = toy
    assert LOOKUP("toy_vit", root).build is not None
    with pytest.raises(ValueError, match="'toy_vit'"):
        LOOKUP("toy_vit")
    model = embedder_factory(config["recognizer"])()
    assert type(model).__name__ == "Toy"
    assert type(embedder_factory(config["recognizer"])()) is type(model), "loaded once"
    with pytest.raises(ValueError, match="whole number of heads"):
        embedder_factory(dict(config["recognizer"], heads=3))()


@pytest.mark.parametrize("where", ["checkout", "tmp"])
def test_an_unknown_architecture_is_refused(toy, where):
    """No branch and no file: the lookup finds nothing, and the reference,
    the weights and the count refuse it by name."""
    _, tmp = toy
    with pytest.raises(ValueError, match="no reference embedder for 'vit_nope'"):
        LOOKUP("vit_nope", tmp if where == "tmp" else spec.ROOT)
    config = dict(_tiny(), recognizer={"arch": "vit_nope"})
    with pytest.raises(ValueError, match="no reference embedder for 'vit_nope'"):
        embedder_factory(config["recognizer"])
    with pytest.raises(ValueError, match="'vit_nope'"):
        data.embedder_weights(config, 1, "cpu")
    with pytest.raises(ValueError, match="'vit_nope'"):
        count.frame_flops(config)


@pytest.mark.parametrize("arch", ["../arcface", "embedders/r50", "r50.py", ""])
def test_an_architecture_that_is_not_a_bare_name_is_refused(arch):
    """The name is joined into a path: one that could reach a file outside
    ``reference/embedders/`` is refused, though ``reference/arcface.py``
    exists."""
    with pytest.raises(ValueError, match="no reference embedder"):
        LOOKUP(arch)


def test_layer_norm_leaves_are_drawn_as_flax_names_them(toy):
    """flax's nn.LayerNorm holds ``scale`` (ones) and ``bias`` (zeros); the
    drawn tree loads into the module."""
    config, _ = toy
    rec = data.embedder_weights(config, 2160000801, "cpu")
    assert "params/LayerNorm_0/weight" not in rec
    np.testing.assert_array_equal(rec["params/LayerNorm_0/scale"], np.ones(32, np.float32))
    np.testing.assert_array_equal(rec["params/LayerNorm_0/bias"], np.zeros(32, np.float32))
    assert rec["params/Dense_qkv/kernel"].shape == (32, 96)
    assert rec["params/Dense_0/kernel"].std() > 0
    from portbench.reference.weights import load_tree

    model = load_tree(embedder_factory(config["recognizer"])(), rec)
    assert torch.equal(model.LayerNorm_0.weight, torch.ones(32))
    assert torch.equal(model.Dense_0.weight, torch.from_numpy(rec["params/Dense_0/kernel"].T))


@pytest.fixture
def toy_served(toy):
    config, _ = toy
    det, rec = data.model_weights(config, 7, "cpu")
    frames = data.camera_frames(2, 96, 128, 7, "cpu")
    canvases = np.stack([canvas_of(f, config["canvas"], "rgb") for f in frames])
    ref = Reference(config, det, rec, "cpu")
    kps = ref.detect(canvases)["kps"]
    return config, det, rec, canvases, kps


def test_reference_embeds_a_new_architecture(toy_served):
    """Unit rows, each the same whether its frame is embedded alone or with
    the others."""
    config, det, rec, canvases, kps = toy_served
    ref = Reference(config, det, rec, "cpu")
    n = config["max_faces"]
    idx = np.repeat(np.arange(len(canvases)), n)
    whole = ref.embed(canvases, idx, kps.reshape(-1, 5, 2))
    assert whole.shape == (len(canvases) * n, 512)
    np.testing.assert_allclose(np.linalg.norm(whole, axis=1), 1.0, atol=1e-5)
    part = ref.embed(canvases[1:2], np.zeros(n, np.int64), kps[1])
    np.testing.assert_allclose(part, whole[n:2 * n], atol=1e-5)
    assert np.abs(whole - whole[:1]).max() > 1e-3, "faces embed apart"


def test_frame_flops_counts_a_new_architectures_attention(toy):
    config, _ = toy
    tokens, width, patch = 49, 32, 16
    per_face = 2 * (tokens * width * patch * patch * 3       # patch conv
                    + tokens * width * 4 * width             # qkv and output
                    + 2 * tokens * tokens * width            # QK^T and AV
                    + tokens * width * 512)                  # token flatten -> 512
    flops = count.frame_flops(config)
    assert flops["embedder"] == config["max_faces"] * per_face
    assert flops["detector"] == count.model_flops(detector_factory(config["detector"]),
                                                  (128, 128, 3))


def _iresnet50_epilogue_per_face() -> int:
    """Elements x tensors of every epilogue pass of IResNet-50 at 112, by
    hand: the stem's BN + PReLU; each block's BN_0 and BN_1 + PReLU at its
    input side, BN_2 + residual (3 tensors) at its output side."""
    total, side, c_in = 2 * 64 * 112 * 112, 112, 64
    for depth, width in zip((3, 4, 14, 3), (64, 128, 256, 512)):
        for j in range(depth):
            out = side // 2 if j == 0 else side
            total += 2 * c_in * side * side + 2 * width * side * side + 3 * width * out * out
            side, c_in = out, width
    return total


def test_epilogue_passes_of_iresnet50():
    config = _config("buffalo_l")
    passes = count.epilogue_passes(config["recognizer"], config["embed_size"])
    assert len(passes) == 73
    assert passes[0] == ((64, 112, 112), 2) and passes[-1] == ((512, 7, 7), 3)
    assert sum(t == 3 for _, t in passes) == 24
    assert count.epilogue_bytes(config, 1024) == 1024 * 2 * _iresnet50_epilogue_per_face()
    assert count.epilogue_passes(_config("mobile_facenet")["recognizer"], 112) == []
    assert count.epilogue_bytes(_config("mobile_facenet"), 1024) == 0.0


@pytest.mark.parametrize("tensors,ms", [(2, 0.9816), (3, 1.4724)], ids=["bn_prelu", "bn_bn_r"])
def test_epilogue_bounds_match_the_kernel_table(tensors, ms):
    """112 x 112, B = 1,024, 64 channels, bf16: the kernel table's bounds
    of BN + PReLU and BN + BN(r)."""
    moved = count.epilogue_pass_bytes(1024, (64, 112, 112), tensors, "bfloat16")
    t, by = count.bound(moved, 0.0, "bfloat16")
    assert by == "bytes" and t * 1e3 == pytest.approx(ms, abs=1e-4)


def _run(config: dict, by_name: dict, frames: list, faces=None) -> SimpleNamespace:
    tr = trace.Trace(0.0, 2e6, [(0.0, 1e6)], by_name, [])
    return SimpleNamespace(trace=tr, config=config, traced_dispatches=frames,
                           traced_faces=faces or [n * config["max_faces"] for n in frames])


def test_epilogue_reader():
    """The kernel's instances (every template) against the count for the
    slots embedded, each frame's ``max_faces`` whether detected or not;
    cuDNN's and CUTLASS's own epilogues are not its."""
    reader = spec.reader("kernel.epilogue.roofline_pct")
    config = _config("buffalo_l")
    names = {"void (anonymous namespace)::epilogue_kernel<(anonymous namespace)::Bf16, 0, "
             "true>(uint4 const*)": 6000.0,
             "void (anonymous namespace)::epilogue_kernel<(anonymous namespace)::Bf16, 1, "
             "false>(uint4 const*)": 6000.0,
             "void cutlass::Kernel<cutlass_80_tensorop_bf16_s16816fprop_epilogue_kernel>": 9e5}
    moved = count.epilogue_bytes(config, 1024)
    want = 100.0 * moved / count.HBM_BYTES_PER_S / 12e-3
    assert reader.read(_run(config, names, [16, 16])) == pytest.approx(want)
    assert reader.read(_run(config, names, [16, 16], [100, 3])) == pytest.approx(want)
    assert 50 < want < 100
    assert reader.read(_run(config, {"top1_f32_kernel": 10.0}, [32])) is None
    assert reader.read(_run(_config("mobile_facenet"), names, [32])) is None
    assert reader.read(SimpleNamespace(trace=None, config=config, traced_dispatches=[],
                                       traced_faces=[])) is None

