"""The port's ViT face embedder (``models/vit.py``) against the benchmark's
plain reference (``portbench/reference/vit.py``) on the CPU, and the ViT on
the port's serving path: the flax layout, the engine's embedding program,
the pack name that selects it, and the ``engine.embedder`` span.

The port and the reference load the same seeded random flax tree, with
LayerNorm and BatchNorm parameters drawn away from identity (the synthetic
leaves' ones and zeros would hide a swapped scale or bias).  At published
widths only the meta device is used.  This file imports no JAX.
"""

import functools

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from facerecognition_infrenceengine_tpu_torch.core import metrics
from facerecognition_infrenceengine_tpu_torch.core.config import EngineConfig
from facerecognition_infrenceengine_tpu_torch.engine import pipeline
from facerecognition_infrenceengine_tpu_torch.engine.pipeline import FaceEngine, bucket
from facerecognition_infrenceengine_tpu_torch.models import arcface, vit, weights, zoo
from facerecognition_infrenceengine_tpu_torch.models.layers import cast_keep_bn_f32
from facerecognition_infrenceengine_tpu_torch.ops.warp2pass import warp_faces_two_pass
from portbench import count, data, spec
from portbench.reference import vit as ref_vit
from portbench.reference import weights as ref_weights

SMALL = dict(patch=9, width=96, depth=2, heads=2, mlp=384, embed_dim=512)
REC = dict(arch="vit_l", tokens=144, act="relu6", qkv_bias=False, ln_eps=1e-6, bn_eps=2e-5,
           **SMALL)
# f32 against f32: the two differ only in summation order (the attention's
# CPU kernel against its written-out form); the cosine of two normalised
# f32 embeddings itself carries ~1e-7 (measured 0.5-1.5e-7 on seeds 0-2)
F32_GAP = 1e-6
# bf16 against the f32 reference: every activation rounded to bf16 (2^-9
# relative) through two blocks and the head; measured 3.1-5.2e-5 on seeds
# 0-2, and the fp8 reference 4.2-8.4e-3
BF16_GAP = 5e-4
ENGINE = EngineConfig(det_size=(128, 128), max_faces=4, pre_nms_topk=64, dtype="float32")


def _reference(rec=REC):
    return spec.embedder("vit_l").build(rec)


def random_leaves(seed: int) -> dict:
    """{flax path: float32 leaf} of the small ViT: the benchmark's draw for
    kernels and positions, LayerNorm / BatchNorm scales near 1, biases and
    means near 0, variances near 1."""
    flat = data.make_weights(data.layout(_reference), seed, "cpu", 1)
    rng = np.random.default_rng(seed)
    out = {}
    for path, leaf in flat.items():
        name = path.rsplit("/", 1)[-1]
        if name == "scale":
            leaf = 1 + 0.1 * rng.standard_normal(leaf.shape)
        elif name in ("bias", "mean"):
            leaf = 0.1 * rng.standard_normal(leaf.shape)
        elif name == "var":
            leaf = np.exp(0.2 * rng.standard_normal(leaf.shape))
        out[path] = np.asarray(leaf, np.float32)
    return out


def _crops(n: int, seed: int = 0) -> torch.Tensor:
    return arcface.preprocess(torch.from_numpy(pipeline._calibration_crops(n, 112, seed)))


def _gap(got: torch.Tensor, want: torch.Tensor) -> float:
    """The widest 1 - cos of two embedding batches."""
    got, want = F.normalize(got.double(), dim=1), F.normalize(want.double(), dim=1)
    return float((1 - (got * want).sum(1)).max())


def _pair(seed: int, dtype=torch.float32):
    flat = random_leaves(seed)
    port = weights.load_tree(vit.VisionTransformer(**SMALL), flat)
    ref = ref_weights.load_tree(_reference(), flat)
    return cast_keep_bn_f32(port, "cpu", dtype), ref, flat


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("dtype,bound", [(torch.float32, F32_GAP), (torch.bfloat16, BF16_GAP)],
                         ids=["f32", "bf16"])
def test_port_matches_the_reference(seed, dtype, bound):
    port, ref, _ = _pair(seed, dtype)
    x = _crops(8, seed)
    with torch.inference_mode():
        got, want = port(x), ref(x)
    assert got.dtype == torch.float32 and got.shape == (8, 512)
    assert _gap(got, want) <= bound


def _no_scale(self, x):
    b, n, c = x.shape
    qkv = self.qkv(x).reshape(b, n, 3, self.heads, self.head_dim).permute(2, 0, 3, 1, 4)
    attn = torch.softmax(qkv[0] @ qkv[1].transpose(-2, -1), dim=-1)
    return self.proj((attn @ qkv[2]).transpose(1, 2).reshape(b, n, c))


def _no_positions(self, x):
    x = self.patch_embed(x.permute(0, 3, 1, 2).float())
    for block in self.blocks:
        x = block(x)
    return self.feature(self.norm(x).reshape(x.shape[0], -1))


def _channel_major(self, x):
    x = self.patch_embed(x.permute(0, 3, 1, 2).float()) + self.pos_embed
    for block in self.blocks:
        x = block(x)
    return self.feature(self.norm(x).transpose(1, 2).reshape(x.shape[0], -1))


def _relu(self, x):
    return self.fc2(torch.relu(self.fc1(x)))


@pytest.mark.parametrize("where,fault", [
    (ref_vit.Attention, _no_scale), (ref_vit.VisionTransformer, _no_positions),
    (ref_vit.VisionTransformer, _channel_major), (ref_vit.Mlp, _relu)],
    ids=["scale_dropped", "pos_embed_dropped", "flatten_swapped", "relu_for_relu6"])
def test_a_planted_fault_in_the_reference_fails(where, fault, monkeypatch):
    """Each fault, planted in a copy of the reference, puts it past the f32
    bound from the port; ReLU for ReLU6 at fc1 kernels scaled so that fc1
    passes 6 (as trained weights do)."""
    port, ref, flat = _pair(0)
    if fault is _relu:
        flat = {k: v * 20 if "/fc1/kernel" in k else v for k, v in flat.items()}
        port = weights.load_tree(vit.VisionTransformer(**SMALL), flat)
        ref = ref_weights.load_tree(_reference(), flat)
    x = _crops(8)
    with torch.inference_mode():
        got = port(x)
        assert _gap(got, ref(x)) <= F32_GAP
        if fault is _relu:
            assert (port.blocks[0].mlp.fc1(port.blocks[0].norm2(port.patch_embed(
                x.permute(0, 3, 1, 2)) + port.pos_embed)) > 6).any()
        monkeypatch.setattr(where, "forward", fault)
        assert _gap(got, ref(x)) > 100 * F32_GAP


def test_flax_layouts_agree_leaf_for_leaf():
    """The port's ``flax_layout`` (its new LayerNorm branch) and the frozen
    reference's give the same flax path and shape for each state-dict key,
    and carry a tree into equal tensors."""
    port, ref = vit.VisionTransformer(**SMALL), _reference()
    ours = [(k, p, s) for k, p, s, _ in weights.flax_layout(port)]
    theirs = [(k, p, s) for k, p, s, _ in ref_weights.flax_layout(ref)]
    assert ours == theirs
    paths = {p for _, p, _ in ours}
    assert {"params/pos_embed", "params/blocks/1/norm2/scale", "params/norm/bias",
            "params/feature/1/scale", "batch_stats/feature/3/var",
            "params/blocks/0/attn/qkv/kernel", "params/patch_embed/proj/kernel"} <= paths
    assert "params/blocks/0/attn/qkv/bias" not in paths
    flat = random_leaves(3)
    a, b = weights.from_flax(flat, port), ref_weights.from_flax(flat, ref)
    assert a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)
    assert weights.to_flax(a, port).keys() == flat.keys()


def test_published_widths_on_the_meta_device():
    """ViT-L: 255,683,584 parameters, and 50,675,589,120 operations a face
    (block GEMMs 48,922,361,856; QK^T + AV 1,528,823,808; the patch conv
    53,747,712; the head 170,655,744)."""
    with torch.device("meta"):
        model = vit.vit_l()
    assert sum(p.numel() for p in model.parameters()) == 255_683_584
    assert count.model_flops(vit.vit_l, (112, 112, 3)) == 50_675_589_120
    with torch.device("meta"):
        ref = spec.embedder("vit_l").build(dict(REC, **dict(patch=9, width=768, depth=24,
                                                            heads=8, mlp=3072)))
    assert data.layout(lambda: ref) == data.layout(vit.vit_l)


@pytest.fixture
def small_vit(monkeypatch):
    monkeypatch.setitem(pipeline._EMBEDDERS, "vit_l",
                        functools.partial(vit.VisionTransformer, **SMALL))
    return random_leaves(4)


def test_the_engine_embeds_each_slot_as_the_reference_does(small_vit):
    """``FaceEngine(rec_arch="vit_l")`` through ``detect_align_embed_flat``:
    every slot's embedding equals the reference's on the engine's own crops
    (its warp at the slot's landmarks)."""
    engine = FaceEngine(ENGINE, rec_variables=data.nested(small_vit), det_arch="det_2.5g",
                        rec_arch="vit_l", device="cpu")
    assert isinstance(engine.embedder, vit.VisionTransformer)
    frames = np.random.default_rng(5).integers(0, 256, (2, 128, 128, 3), np.uint8)
    flat = engine.detect_align_embed_flat(frames, det_threshold=0.0)
    b, f, _ = flat.shape
    kps = flat[..., 5:15].reshape(b * f, 5, 2)
    crops = warp_faces_two_pass(torch.from_numpy(frames), torch.arange(b).repeat_interleave(f),
                                kps, 112, dst=engine._dst)
    ref = ref_weights.load_tree(_reference(), small_vit)
    with torch.inference_mode():
        want = ref(arcface.preprocess(crops))
    assert bool(flat[..., 15].all())
    assert _gap(flat[..., 16:].reshape(b * f, -1), want) <= F32_GAP


def test_no_int8_vit():
    with pytest.raises(ValueError, match="no int8 ViT"):
        FaceEngine(EngineConfig(embed_int8=True), rec_arch="vit_l", device="cpu")


@pytest.mark.parametrize("pack,arch", [("vit_l", "vit_l"), ("buffalo_l", "r50"),
                                       ("mobile_facenet_v1", "mobilefacenet"),
                                       ("antelopev2", "r50")])
def test_the_pack_name_selects_the_recognizer(pack, arch, monkeypatch):
    built = []

    class Engine:
        device = torch.device("cpu")

        def __init__(self, cfg, rec_arch, device):
            built.append(rec_arch)

    monkeypatch.setattr(zoo, "FaceEngine", Engine)
    zoo.FaceAnalysis(pack, cfg=ENGINE, device="cpu")._ensure_engine()
    assert built == [arch]


@pytest.fixture
def spans():
    metrics.reset()
    yield
    metrics.reset()


@pytest.mark.parametrize("arch", ["vit_l", "r18", "mobilefacenet", "r18-int8"])
def test_every_embedder_call_is_one_span(arch, small_vit, spans):
    """``embed_crops``, ``embed_faces`` and the fused program each open one
    ``engine.embedder`` span, with the arch and the crops it embeds."""
    name = arch.split("-")[0]
    cfg = EngineConfig(det_size=(64, 64), max_faces=2, pre_nms_topk=16, dtype="float32",
                       embed_int8=arch.endswith("int8"))
    engine = FaceEngine(cfg, rec_variables=data.nested(small_vit) if name == "vit_l" else None,
                        det_arch="det_500m", rec_arch=name, device="cpu")
    frames = np.random.default_rng(6).integers(0, 256, (3, 64, 64, 3), np.uint8)
    for _ in range(2):  # the second time past each shape's first call
        metrics.record_spans(False)
        metrics.record_spans(True)
        engine.embed_crops(np.zeros((3, 112, 112, 3), np.uint8))
        engine.embed_faces(frames, np.array([0, 2]), np.full((2, 5, 2), 30.0, np.float32))
        engine.detect_align_embed_flat(frames)
    got = [s for s in metrics.spans() if s.name == "engine.embedder"]
    assert [s.attrs for s in got] == [{"arch": name, "crops": n}
                                      for n in (bucket(3), bucket(2), 3 * 2)]
    parents = {s.id: s.name for s in metrics.spans()}
    assert [parents[s.parent] for s in got] == ["engine.embed", "engine.embed", "engine.fused"]
