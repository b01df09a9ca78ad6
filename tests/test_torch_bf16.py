"""bf16 parity of the port's models with the reference's flax modules.

The reference's ``nn.BatchNorm(dtype=bf16)`` keeps its scale, bias and
running statistics in float32, computes in f32 and rounds once; the port's
bf16 engine keeps every BatchNorm in f32 the same way
(``models/layers.cast_keep_bn_f32``), so ``F.batch_norm`` takes the bf16
activation with f32 parameters in one pass.

Weights: the reference's synthetic tree with random BN scale and bias, and
running statistics from one train-mode pass of the f32 torch module over 32
seeded crops (the synthetic tree's zero mean / unit variance would leave
the statistics' rounding untested).  Both sides get the same tree and the
same inputs, made with numpy.
"""

import copy

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from flax import linen as fnn

from facerecognition_infrenceengine_tpu.models import arcface as jarcface
from facerecognition_infrenceengine_tpu.models import scrfd as jscrfd
from facerecognition_infrenceengine_tpu.models.weights import unflatten_tree
from facerecognition_infrenceengine_tpu_torch.models import arcface, scrfd, weights
from facerecognition_infrenceengine_tpu_torch.models.layers import cast_keep_bn_f32

COS_BUDGET = 1e-3  # BASELINE.md: embeddings within 1e-3 cosine of the reference


def _trained_tree(tm, seed, inputs):
    """The synthetic tree with random BN scale/bias, loaded into the f32
    torch module ``tm``; running statistics from one train-mode pass over
    ``inputs`` (momentum 1: the batch's own statistics).  Returns the flat
    flax tree with those statistics."""
    flat = weights.synthetic_tree(tm, seed)
    rng = np.random.default_rng(seed + 100)
    for path in flat:
        if path.endswith("/scale") and "BatchNorm" in path:
            flat[path] = rng.uniform(0.5, 1.5, flat[path].shape).astype(np.float32)
        elif path.endswith("/bias") and "BatchNorm" in path:
            flat[path] = rng.normal(0.0, 0.2, flat[path].shape).astype(np.float32)
    weights.load_tree(tm, flat)
    for m in tm.modules():
        if isinstance(m, torch.nn.modules.batchnorm._BatchNorm):
            m.momentum = 1.0
    tm.train()
    with torch.no_grad():
        tm(inputs)
    tm.eval()
    for key, path, _, convert in weights.flax_layout(tm):
        if path.startswith("batch_stats/"):
            flat[path] = convert(tm.state_dict()[key].numpy())
    return flat


@pytest.mark.parametrize("arch", ["r18", "r50"])
def test_iresnet_bf16_holds_the_cosine_budget(arch):
    """max 1 - cos of the port's bf16 embedder against flax
    ``iresnet(dtype=bfloat16)`` on the same tree <= 1e-3."""
    tm = arcface.iresnet50() if arch == "r50" else arcface.iresnet18()
    jm = (jarcface.iresnet50 if arch == "r50" else jarcface.iresnet18)(dtype=jnp.bfloat16)
    rng = np.random.default_rng(7)
    stats_crops = rng.integers(0, 256, (32, 112, 112, 3), dtype=np.uint8)
    crops = rng.integers(0, 256, (8, 112, 112, 3), dtype=np.uint8)
    flat = _trained_tree(tm, 1, arcface.preprocess(torch.from_numpy(stats_crops)))
    mean = flat["batch_stats/IBasicBlock_0/BatchNorm_0/mean"]
    assert np.abs(mean).max() > 0.05  # the pass set real statistics
    want = np.asarray(jm.apply(unflatten_tree(flat), jarcface.preprocess(jnp.asarray(crops))))
    x = arcface.preprocess(torch.from_numpy(crops))
    # the earlier cast, every tensor to bf16 (BN statistics rounded first)
    all_bf16 = copy.deepcopy(tm).to(torch.bfloat16)
    cast_keep_bn_f32(tm, "cpu", torch.bfloat16)
    assert tm.BatchNorm_0.running_var.dtype == torch.float32
    assert tm.Conv_0.weight.dtype == torch.bfloat16
    with torch.no_grad():
        got, old = tm(x).numpy(), all_bf16(x).numpy()

    def worst(e):
        cos = (want * e).sum(1) / np.linalg.norm(want, axis=1) / np.linalg.norm(e, axis=1)
        return float((1.0 - cos).max())

    print(f"{arch} bf16 vs flax bf16: max 1-cos {worst(got):.3e} "
          f"(every tensor cast to bf16: {worst(old):.3e})")
    assert worst(got) <= COS_BUDGET
    assert worst(got) < worst(old)


def test_batchnorm_bf16_rounds_once_like_flax():
    """One BatchNorm: the port's (bf16 input, f32 parameters and statistics)
    equals the f32 computation rounded once to bf16, bit for bit, in
    contiguous and channels_last layout; against flax
    ``nn.BatchNorm(dtype=bf16)`` every value is equal or one bf16 step
    apart (torch evaluates x * a + b with a = scale / sqrt(var + eps),
    flax (x - mean) * (rsqrt(var + eps) * scale) + bias: the f32 results
    can differ in the last bits and round to neighbouring bf16 values)."""
    rng = np.random.default_rng(3)
    c = 64
    x = jnp.asarray(rng.normal(0.0, 3.0, (8, 14, 14, c)).astype(np.float32), jnp.bfloat16)
    mean = rng.normal(0.0, 2.0, c).astype(np.float32)
    var = np.exp(rng.normal(0.0, 1.0, c)).astype(np.float32) * 5
    scale = rng.normal(0.0, 1.0, c).astype(np.float32)
    bias = rng.normal(0.0, 1.0, c).astype(np.float32)
    fbn = fnn.BatchNorm(use_running_average=True, epsilon=1e-5, dtype=jnp.bfloat16)
    want = np.asarray(fbn.apply({"params": {"scale": scale, "bias": bias},
                                 "batch_stats": {"mean": mean, "var": var}}, x)
                      .astype(jnp.float32))
    bn = torch.nn.BatchNorm2d(c, eps=1e-5).eval()
    bn.load_state_dict({"weight": torch.from_numpy(scale), "bias": torch.from_numpy(bias),
                        "running_mean": torch.from_numpy(mean),
                        "running_var": torch.from_numpy(var),
                        "num_batches_tracked": torch.tensor(0)})
    cast_keep_bn_f32(bn, "cpu", torch.bfloat16)
    assert all(t.dtype == torch.float32 for t in (bn.weight, bn.bias, bn.running_mean,
                                                  bn.running_var))
    xt = torch.from_numpy(np.array(x.astype(jnp.float32))).bfloat16().permute(0, 3, 1, 2)
    for fmt in (torch.contiguous_format, torch.channels_last):
        xi = xt.contiguous(memory_format=fmt)
        with torch.no_grad():
            got = bn(xi)
            f32 = F.batch_norm(xi.float(), bn.running_mean, bn.running_var, bn.weight,
                               bn.bias, False, 0.0, 1e-5)
        assert got.dtype == torch.bfloat16
        assert torch.equal(got, f32.bfloat16())
        g = got.float().permute(0, 2, 3, 1).numpy()
        step = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want), 1e-30))) - 7)
        assert np.all(np.abs(g - want) <= step)
        print(f"BN {fmt}: {int((g != want).sum())} of {g.size} values one bf16 step from flax")
        assert np.mean(g != want) <= 1e-3, np.mean(g != want)


def test_scrfd_det_2_5g_bf16_heads_match_flax():
    """det_2.5g in bf16 at 128x128 against flax ``SCRFD(dtype=bfloat16)``
    on the same tree (random BN scale/bias, statistics from a train-mode
    pass over 32 seeded canvases).  Each side rounds every layer's output
    to bf16 (8 significant bits) after f32 sums in different orders, over
    ~20 layers: the heads agree to 2**-4 of their largest magnitude."""
    cfg = "det_2.5g"
    tm, jm = scrfd.SCRFD(scrfd.CONFIGS[cfg]), jscrfd.SCRFD(jscrfd.CONFIGS[cfg], dtype=jnp.bfloat16)
    rng = np.random.default_rng(11)
    stats = rng.integers(0, 256, (32, 128, 128, 3), dtype=np.uint8)
    canvas = rng.integers(0, 256, (2, 128, 128, 3), dtype=np.uint8)
    flat = _trained_tree(tm, 0, scrfd.preprocess(torch.from_numpy(stats)))
    want = jm.apply(unflatten_tree(flat), jscrfd.preprocess(jnp.asarray(canvas)))
    cast_keep_bn_f32(tm, "cpu", torch.bfloat16)
    with torch.no_grad():
        got = tm(scrfd.preprocess(torch.from_numpy(canvas)))
    for w, g in zip(want, got):
        w, g = np.asarray(w), g.numpy()
        assert g.shape == w.shape
        err = float(np.abs(g - w).max() / max(1.0, np.abs(w).max()))
        print(f"det_2.5g bf16 head err {err:.3e} of max {np.abs(w).max():.3e}")
        assert err <= 2.0 ** -4
