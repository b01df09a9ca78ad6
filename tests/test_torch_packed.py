"""The packed / yuv420 wire formats vs the reference on the CPU: the packed
pyramid atlas, packed ROIs and the packed warp (following
tests/test_ops_warp2pass.py), the yuv mix, and the host packers against the
reference's C++ library.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from facerecognition_infrenceengine_tpu import native as jax_native
from facerecognition_infrenceengine_tpu.ops import warp2pass as jw
from facerecognition_infrenceengine_tpu.ops import yuv as jax_yuv
from facerecognition_infrenceengine_tpu.ops.align import ARCFACE_DST
from facerecognition_infrenceengine_tpu.ops.align import _invert_affine as jax_invert
from facerecognition_infrenceengine_tpu.ops.align import umeyama_similarity as jax_umeyama
from facerecognition_infrenceengine_tpu_torch import native
from facerecognition_infrenceengine_tpu_torch.native import plain
from facerecognition_infrenceengine_tpu_torch.ops import stem_kernel, warp2pass, warp_kernel, yuv

from test_torch_warp import _assert_path_close, _faces, kps_for, smooth_frame


@pytest.mark.parametrize("hw,levels", [((128, 192), 4), ((64, 64), 2)])
def test_packed_atlas_bit_identical(hw, levels):
    """u8 levels: the reference's packed atlas byte for byte, and the port's
    raw atlas permuted into packed layout; (64, 64) edge-pads its coarse
    level up to the ROI in raw-pixel terms."""
    frames = np.random.default_rng(3).integers(0, 255, (2, *hw, 3), dtype=np.uint8)
    want, want_offs = jw.build_atlas_packed(jw.space_to_depth4(jnp.asarray(frames)), levels)
    p4 = warp2pass.space_to_depth4(torch.from_numpy(frames))
    got, offs = warp2pass.build_atlas_packed(p4, levels)
    assert offs == want_offs and got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    raw, raw_offs = warp2pass.build_atlas(torch.from_numpy(frames), levels)
    for (xo_r, lw_r, lh_r), (xo_p, lw_p, lh_p) in zip(raw_offs, offs):
        level = raw[:, :lh_r, xo_r:xo_r + lw_r]
        np.testing.assert_array_equal(warp2pass.space_to_depth4(level).numpy(),
                                      got[:, :lh_p, xo_p:xo_p + lw_p].numpy())


def test_packed_atlas_float_levels():
    frames = np.random.default_rng(4).uniform(0, 255, (1, 128, 128, 3)).astype(np.float32)
    want, _ = jw.build_atlas_packed(jw.space_to_depth4(jnp.asarray(frames)), 4)
    got, _ = warp2pass.build_atlas_packed(warp2pass.space_to_depth4(torch.from_numpy(frames)))
    assert got.dtype == torch.float32
    # sums of up to 64 values in another order: f32 rounding
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-4)


def test_packed_rois_and_affines_match_reference():
    """Level pick with the packed halo, ROI origins on the packed grid
    (round half to even), the matrix into raw ROI coordinates."""
    frames, fidx, kps = _faces(m=6, seed=0)
    kps[1] = kps_for(0.2, 3.5, (160, 128))  # coarse pyramid level
    kps[2] -= 70.0                           # origin clamps at the border
    m_inv = jax.vmap(lambda k: jax_invert(jax_umeyama(k, jnp.asarray(ARCFACE_DST))))(
        jnp.asarray(kps))
    want_rois, want_mats = jw.extract_rois_packed(
        jw.space_to_depth4(jnp.asarray(frames)), jnp.asarray(fidx), m_inv, 112)
    got_rois, got_mats = warp2pass.extract_rois_packed(
        warp2pass.space_to_depth4(torch.from_numpy(frames)), torch.from_numpy(fidx),
        torch.tensor(np.asarray(m_inv)), 112)
    np.testing.assert_array_equal(got_rois.numpy(), np.asarray(want_rois))
    np.testing.assert_allclose(got_mats.numpy(), np.asarray(want_mats), rtol=0, atol=1e-4)
    unpacked = warp2pass.unpack_roi4(got_rois)
    assert tuple(unpacked.shape) == (6, 192, 192, 3)
    np.testing.assert_array_equal(
        unpacked.numpy(), np.stack([np.asarray(jw.unpack_roi4(r)) for r in want_rois]))


CASES = [(0, 1.0), (15, 1.2), (-25, 0.9), (10, 3.0)]  # tests/test_ops_warp2pass.py's


@pytest.mark.parametrize("theta_deg,scale", CASES)
def test_packed_warp_matches_reference(theta_deg, scale):
    """On the same affine, the port's packed warp (plain K3 on the unpacked
    ROI) is the reference's ``_warp_one_from_packed_roi`` within 1e-3 (0..255
    units), K3's tolerance against the reference's XLA twin; and it stays
    within the reference's own 0.51 of the raw path."""
    frame = smooth_frame(256, 320).astype(np.uint8)
    kps = kps_for(np.deg2rad(theta_deg), scale, (160, 128))[None]
    m_inv = jax.vmap(lambda k: jax_invert(jax_umeyama(k, jnp.asarray(ARCFACE_DST))))(
        jnp.asarray(kps))
    rois, mats = jw.extract_rois_packed(jw.space_to_depth4(jnp.asarray(frame)[None]),
                                        jnp.zeros(1, jnp.int32), m_inv, 112)
    want = np.asarray(jax.vmap(lambda r, m: jw._warp_one_from_packed_roi(r, m, 112))(rois, mats))
    p4 = warp2pass.space_to_depth4(torch.from_numpy(frame)[None])
    got_rois, got_mats = warp2pass.extract_rois_packed(
        p4, torch.zeros(1, dtype=torch.int64), torch.tensor(np.asarray(m_inv)), 112)
    got = warp_kernel.warp_rois(warp2pass.unpack_roi4(got_rois).float(), got_mats).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-3)
    raw = warp2pass.warp_faces_two_pass(torch.from_numpy(frame)[None],
                                        torch.zeros(1, dtype=torch.int64),
                                        torch.from_numpy(kps)).numpy()
    assert np.abs(got - raw).max() < 0.51


def test_packed_warp_from_landmarks_matches_reference():
    """The four cases in one batch from landmarks, with the landmark-to-crop
    tolerance of tests/test_torch_warp.py (1e-3 on all but 0.1% of values,
    5e-3 everywhere: the two packages' f32 Umeyama differ at its rounding
    floor)."""
    frame = smooth_frame(256, 320).astype(np.uint8)
    kps = np.stack([kps_for(np.deg2rad(t), s, (160, 128)) for t, s in CASES])
    fidx = np.zeros(len(kps), np.int32)
    want = np.asarray(jw.warp_faces_two_pass_packed(
        jw.space_to_depth4(jnp.asarray(frame)[None]), jnp.asarray(fidx), jnp.asarray(kps)))
    got = warp2pass.warp_faces_two_pass_packed(
        warp2pass.space_to_depth4(torch.from_numpy(frame)[None]), torch.from_numpy(fidx),
        torch.from_numpy(kps)).numpy()
    _assert_path_close(got, want)


def test_packed_warp_frame_routing():
    frames = np.stack([np.full((256, 256, 3), 40, np.uint8), np.full((256, 256, 3), 200, np.uint8)])
    kps = np.stack([kps_for(0.0, 0.8, (128, 128))] * 2)
    out = warp2pass.warp_faces_two_pass_packed(warp2pass.space_to_depth4(torch.from_numpy(frames)),
                                               torch.tensor([0, 1]), torch.from_numpy(kps)).numpy()
    assert abs(out[0].mean() - 40) < 1.0 and abs(out[1].mean() - 200) < 1.0


def _every_yuv_triple() -> np.ndarray:
    """[65536 * 16, 24] packs holding every (Y, U, V): one (U, V) per pack
    (all four chroma blocks) and 16 Y values."""
    u, v, g = np.meshgrid(np.arange(256), np.arange(256), np.arange(16), indexing="ij")
    x = np.empty(u.shape + (24,), np.uint8)
    x[..., :16] = g[..., None] * 16 + np.arange(16)
    x[..., 16:20] = u[..., None]
    x[..., 20:24] = v[..., None]
    return x.reshape(-1, 24)


def test_yuv_mix_bit_identical_on_every_triple():
    """The f32 mix on all 2**24 (Y, U, V) triples, in every phase: the
    reference's bytes exactly (no u8 value differs)."""
    x = _every_yuv_triple()
    want = np.asarray(jax_yuv.yuv420p4_to_rgbp4(jnp.asarray(x)))
    got = yuv.yuv420p4_to_rgbp4(torch.from_numpy(x)).numpy()
    assert got.dtype == np.uint8
    assert int((got != want).sum()) == 0
    k, b = yuv._mix_constants()
    k_ref, b_ref = jax_yuv._mix_constants()
    np.testing.assert_array_equal(k, k_ref)
    np.testing.assert_array_equal(b, b_ref)


def test_yuv_host_decode_matches_reference():
    pack = np.random.default_rng(6).integers(0, 256, (30, 40, 24), dtype=np.uint8)
    np.testing.assert_array_equal(yuv.yuv420p4_to_rgb_host(pack),
                                  jax_yuv.yuv420p4_to_rgb_host(pack))


def _every_rgb_row_block(i: int) -> np.ndarray:
    """Rows [512 i, 512 i + 512) of a 4096 x 4096 image holding every RGB
    color once (2x2 chroma blocks then mix neighbouring colors)."""
    c = np.arange(i * 512 * 4096, (i + 1) * 512 * 4096, dtype=np.int64)
    img = np.stack([c >> 16, (c >> 8) & 255, c & 255], -1).astype(np.uint8)
    return img.reshape(512, 4096, 3)


def test_pack_yuv420_bit_identical_to_cpp_on_every_color():
    assert jax_native.have_native(), "the reference's C++ imaging library did not build"
    for i in range(8):
        img = _every_rgb_row_block(i)
        want = jax_native.pack_yuv420_s2d4(img)
        np.testing.assert_array_equal(native.pack_yuv420_s2d4(img), want)
        np.testing.assert_array_equal(plain.pack_yuv420_s2d4_plain(img), want)


def test_host_packers_match_reference():
    rng = np.random.default_rng(7)
    img = rng.integers(0, 256, (480, 640, 3), dtype=np.uint8)
    np.testing.assert_array_equal(native.pack_s2d4(img), jax_native.pack_s2d4(img))
    np.testing.assert_array_equal(native.pack_s2d4(img),
                                  stem_kernel.space_to_depth4(torch.from_numpy(img)[None])[0].numpy())
    got, scale = native.letterbox_yuv420_s2d4(img, 640, 640)
    want, want_scale = jax_native.letterbox_yuv420_s2d4(img, 640, 640)
    assert scale == want_scale == 1.0
    np.testing.assert_array_equal(got, want)
    # a 720p camera: the resizing letterbox, as the reference's
    hd = rng.integers(0, 256, (720, 1280, 3), dtype=np.uint8)
    got, scale = native.letterbox_yuv420_s2d4(hd, 640, 640)
    want, want_scale = jax_native.letterbox_yuv420_s2d4(hd, 640, 640)
    assert scale == want_scale == 0.5
    np.testing.assert_array_equal(got, want)
