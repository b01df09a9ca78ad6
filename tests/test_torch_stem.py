"""K4, the fused SCRFD stem, vs the reference on the CPU: the port's plain
version against the Pallas kernel in the interpreter
(``stem_pallas.fused_stem(interpret=True)``) and against the flax stem
(stem1-3 + max-pool), following tests/test_stem_pallas.py; the BN fold
against the reference's packed weights; the s2d4 layouts and paddings.

Weights: the synthetic det_10g / det_500m trees with the stem's BN
statistics redrawn from a numpy seed (scale ~ 1 +- 0.2, var in 0.5..0.9),
so the fold is not the identity; both packages load the same tree.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from facerecognition_infrenceengine_tpu.models import scrfd as jax_scrfd
from facerecognition_infrenceengine_tpu.ops import stem_pallas
from facerecognition_infrenceengine_tpu_torch.models import packed_stem, scrfd, weights
from facerecognition_infrenceengine_tpu_torch.ops import stem_kernel

from test_stem_pallas import _StemOnly


def _nested(flat: dict) -> dict:
    tree: dict = {}
    for path, leaf in flat.items():
        node = tree
        *parents, name = path.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[name] = jnp.asarray(leaf)
    return tree


def _stem_tree(arch: str, seed: int = 0):
    """(torch SCRFD in f32, flax variables) holding the same weights."""
    model = scrfd.SCRFD(scrfd.CONFIGS[arch])
    flat = weights.synthetic_tree(model, seed)
    rng = np.random.default_rng(seed + 100)
    for path, leaf in flat.items():
        if "/stem" not in path or "BatchNorm_0" not in path:
            continue
        if path.endswith("/var"):
            flat[path] = (np.abs(rng.normal(size=leaf.shape)) * 0.2 + 0.5).astype(np.float32)
        else:
            base = 1.0 if path.endswith("/scale") else 0.0
            flat[path] = (rng.normal(size=leaf.shape) * 0.2 + base).astype(np.float32)
    return weights.load_tree(model, flat), _nested(flat)


@pytest.fixture(scope="module")
def trees():
    return {arch: _stem_tree(arch) for arch in ("det_10g", "det_500m")}


def _flax_stem(variables, sw, frames):
    stem = _StemOnly(sw)
    stem_vars = {"params": variables["params"]["backbone"],
                 "batch_stats": variables["batch_stats"]["backbone"]}
    return np.asarray(stem.apply(stem_vars, jax_scrfd.preprocess(jnp.asarray(frames))))


@pytest.mark.parametrize("arch", ["det_10g", "det_500m"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fold_equals_reference_packed_weights(trees, arch, dtype):
    """The port's BN-folded 3x3 weights, re-packed with the port's
    pack_stem1_4to2 / pack_kernel, are the reference's packed weights bit for
    bit (same f32 fold, same cast); the biases too."""
    model, variables = trees[arch]
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    got = stem_kernel.precompute_fused_stem(model, tdt)
    want = stem_pallas.precompute_fused_stem(variables, jdt)
    w1 = stem_kernel.pack_stem1_4to2(got["w1"])
    w1 = torch.cat([w1, torch.zeros(2, 2, 128 - w1.shape[2], w1.shape[3], dtype=tdt)], dim=2)
    packed = {"w1": w1, "w2": packed_stem.pack_kernel(got["w2"], 1),
              "w3": packed_stem.pack_kernel(got["w3"], 1)}
    for key in ("w1", "w2", "w3"):
        np.testing.assert_array_equal(packed[key].float().numpy(),
                                      np.asarray(want[key].astype(jnp.float32)), err_msg=key)
        assert packed[key].dtype == tdt
    for key in ("b1", "b2", "b3"):
        np.testing.assert_array_equal(np.tile(got[key].numpy(), 4)[None],
                                      np.asarray(want[key]), err_msg=key)


def _unfragment(frag: torch.Tensor) -> np.ndarray:
    """Invert the MMA B-fragment order: [k-steps, N/8, 32, 4] -> [k-steps,
    16, N], from the m16n8k16 layout (lane l, value e holds B[k][8t + l/4]
    with k = 2(l%4) + e%2 + 8(e//2)), written out independently of
    ``stem_kernel._b_fragments``."""
    f = frag.float().numpy()
    ks, nt = f.shape[:2]
    out = np.full((ks, 16, nt * 8), np.nan, np.float32)
    for lane in range(32):
        for e in range(4):
            k = 2 * (lane % 4) + e % 2 + 8 * (e // 2)
            out[:, k, lane // 4::8] = f[:, :, lane, e]
    return out


@pytest.mark.parametrize("arch,sw,cp", [("det_10g", 28, 32), ("det_2.5g", 12, 16),
                                        ("det_500m", 8, 16)])
def test_mma_fragments_unpack_to_the_fold(arch, sw, cp):
    """The padded, fragment-ordered bf16 weights the tensor-core kernel reads
    unpack exactly to precompute_fused_stem's HWIO fold, with zeros in every
    padded row and column."""
    model, _ = _stem_tree(arch)
    got = stem_kernel.precompute_fused_stem(model, torch.bfloat16)
    assert stem_kernel.stem_channel_pad(sw) == cp
    b1 = _unfragment(got["f1"]).reshape(3, 4, 4, cp)  # [ky, raw column j, channel, n]
    b2 = _unfragment(got["f2"]).reshape(3, 3, cp, cp)
    b3 = _unfragment(got["f3"]).reshape(3, 3, cp, 2 * sw)
    for key, full, real in (("w1", b1, b1[:, :3, :3, :sw]), ("w2", b2, b2[:, :, :sw, :sw]),
                            ("w3", b3, b3[:, :, :sw, :])):
        want = got[key].float().numpy()
        np.testing.assert_array_equal(real, want, err_msg=key)
        assert np.count_nonzero(np.nan_to_num(full, nan=1.0)) == np.count_nonzero(want), key
        assert got["f" + key[1]].dtype == torch.bfloat16 and got["f" + key[1]].is_contiguous()
    assert "f1" not in stem_kernel.precompute_fused_stem(model, torch.float32)


@pytest.mark.parametrize("stride", [1, 2])
def test_select_tensor_and_pack_kernel_match_reference(stride):
    from facerecognition_infrenceengine_tpu.models import packed_stem as jax_packed

    np.testing.assert_array_equal(packed_stem._select_tensor(stride),
                                  jax_packed._select_tensor(stride))
    w = np.random.default_rng(stride).normal(size=(3, 3, 5, 7)).astype(np.float32)
    np.testing.assert_array_equal(packed_stem.pack_kernel(torch.from_numpy(w), stride).numpy(),
                                  np.asarray(jax_packed.pack_kernel(jnp.asarray(w), stride)))


@pytest.mark.parametrize("hw", [(64, 64), (128, 64), (48, 96)])
def test_layouts_and_paddings_match_reference(hw):
    frames = np.random.default_rng(5).integers(0, 256, (2, *hw, 3), dtype=np.uint8)
    t = torch.from_numpy(frames)
    x48 = stem_kernel.space_to_depth4(t)
    np.testing.assert_array_equal(x48.numpy(),
                                  np.asarray(stem_pallas.space_to_depth4(jnp.asarray(frames))))
    np.testing.assert_array_equal(stem_kernel.depth_to_space4(x48).numpy(), frames)
    for tdt, jdt in ((torch.uint8, jnp.uint8), (torch.float32, jnp.float32),
                     (torch.bfloat16, jnp.bfloat16)):
        got = stem_kernel.prepare_input(t, dtype=tdt)
        want = np.asarray(stem_pallas.prepare_input(jnp.asarray(frames), dtype=jdt))
        assert tuple(got.shape) == want.shape
        np.testing.assert_array_equal(got.float().numpy(), want.astype(np.float32))
    np.testing.assert_array_equal(stem_kernel.pad_packed_u8(x48).numpy(),
                                  stem_kernel.prepare_input(t, dtype=torch.uint8).numpy())


# hw, arch: (64, 64) and (128, 64) are single-tile in the reference,
# (128, 128) runs its 16-row tiles with inter-tile halos; the port's plain
# version has no tiles, its kernel 8x8 pooled tiles (test_torch_gpu.py)
CASES = [((64, 64), "det_10g"), ((128, 64), "det_10g"), ((128, 128), "det_10g"),
         ((64, 64), "det_500m")]


@pytest.mark.parametrize("hw,arch", CASES)
@pytest.mark.parametrize("x4_dtype", ["uint8", "float32"])
def test_fused_stem_f32_matches_pallas_and_flax(trees, hw, arch, x4_dtype):
    """f32 weights: within 1e-4 (abs and rel) of the Pallas kernel in the
    interpreter and of the flax stem -- f32 summation order, as the
    reference's own test holds its kernel to the flax stem."""
    model, variables = trees[arch]
    sw = scrfd.CONFIGS[arch].stem_width
    h, w = hw
    frames = np.random.default_rng(h + w).integers(0, 256, (2, h, w, 3), dtype=np.uint8)
    jdt = jnp.uint8 if x4_dtype == "uint8" else jnp.float32
    x4_ref = stem_pallas.prepare_input(jnp.asarray(frames), dtype=jdt)
    want = np.asarray(stem_pallas.fused_stem(
        x4_ref, stem_pallas.precompute_fused_stem(variables, jnp.float32), w // 4, sw,
        interpret=True))
    x4 = stem_kernel.prepare_input(torch.from_numpy(frames), dtype=getattr(torch, x4_dtype))
    got = stem_kernel.fused_stem(x4, stem_kernel.precompute_fused_stem(model, torch.float32),
                                 w // 4, sw)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape == (2, h // 4, w // 4,
                                                                           2 * sw)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got.numpy(), _flax_stem(variables, sw, frames),
                               rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("hw,arch", [((128, 64), "det_10g"), ((64, 64), "det_500m")])
def test_fused_stem_bf16_matches_pallas(trees, hw, arch):
    """bf16 weights and intermediates: both cast each conv's output to bf16
    after f32 accumulation in different orders, so a value near a rounding
    boundary can land one bf16 step (2**-8 relative) apart and carry into
    the next conv.  Held to 2**-6 of the output's largest value everywhere
    and to exact equality on at least 90% of values."""
    model, variables = trees[arch]
    sw = scrfd.CONFIGS[arch].stem_width
    h, w = hw
    frames = np.random.default_rng(7).integers(0, 256, (2, h, w, 3), dtype=np.uint8)
    want = np.asarray(stem_pallas.fused_stem(
        stem_pallas.prepare_input(jnp.asarray(frames), dtype=jnp.uint8),
        stem_pallas.precompute_fused_stem(variables, jnp.bfloat16), w // 4, sw,
        interpret=True).astype(jnp.float32))
    got = stem_kernel.fused_stem(
        stem_kernel.prepare_input(torch.from_numpy(frames), dtype=torch.uint8),
        stem_kernel.precompute_fused_stem(model, torch.bfloat16), w // 4, sw)
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=2.0 ** -6 * np.abs(want).max())
    assert np.mean(got == want) >= 0.9, np.mean(got == want)


def test_fused_stem_refuses_float_x4_on_cuda_and_counts_no_cpu_launch(trees):
    model, _ = trees["det_500m"]
    wts = stem_kernel.precompute_fused_stem(model, torch.float32)
    frames = torch.from_numpy(np.zeros((1, 64, 64, 3), np.uint8))
    before = stem_kernel.fused_stem.launches
    stem_kernel.fused_stem(stem_kernel.prepare_input(frames, torch.uint8), wts, 16, 8)
    assert stem_kernel.fused_stem.launches == before  # the CPU runs the plain version
    with pytest.raises(TypeError, match="float32"):
        stem_kernel.precompute_fused_stem(scrfd.SCRFD(scrfd.CONFIGS["det_500m"]).bfloat16())
