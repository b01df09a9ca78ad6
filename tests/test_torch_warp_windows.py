"""The warp read straight from the pyramid atlas (``roi_windows*`` +
``warp_windows``) against the JAX package's extract + warp, on the CPU.

``roi_windows`` / ``roi_windows_packed`` must give the reference's windows
and affines exactly: gathering each face's window from the atlas gives the
reference's ROI byte for byte.  ``warp_windows`` on the CPU is its plain
version (the windows gathered, then the plain K3), held to the reference's
XLA twins ``_warp_one_from_roi`` / ``_warp_one_from_packed_roi`` within
K3's 1e-3 in 0..255 units, as tests/test_torch_warp.py states it.

Cases: faces on every pyramid level, windows at the atlas's right and
bottom edges, rotated faces, an affine with m11 = 0 (|m11| < 1e-6 is
guarded to 1e-6), M = 1 and a bucketed M.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from facerecognition_infrenceengine_tpu.ops import warp2pass as jw
from facerecognition_infrenceengine_tpu.ops.align import ARCFACE_DST
from facerecognition_infrenceengine_tpu.ops.align import _invert_affine as jax_invert
from facerecognition_infrenceengine_tpu.ops.align import umeyama_similarity as jax_umeyama
from facerecognition_infrenceengine_tpu_torch.core.config import EngineConfig
from facerecognition_infrenceengine_tpu_torch.engine import pipeline
from facerecognition_infrenceengine_tpu_torch.ops import warp2pass, warp_kernel

from test_torch_warp import kps_for

H, W = 256, 320
# (theta, scale, centre): levels 0-3 by scale, rotations, and faces whose
# windows clamp at the frame's top-left and at its right and bottom edges
FACES = [(0.0, 0.5, (100, 90)), (0.3, 1.2, (160, 128)), (-0.6, 1.0, (60, 200)),
         (0.1, 2.6, (200, 130)), (-0.2, 5.0, (160, 128)), (0.0, 9.0, (150, 120)),
         (0.4, 1.0, (315, 250)), (0.0, 0.8, (5, 5)), (0.2, 3.0, (310, 240)),
         (-0.1, 6.0, (300, 250))]


def _frames(dtype, seed=0):
    frames = np.random.default_rng(seed).integers(0, 256, (2, H, W, 3))
    return frames.astype(dtype)


def _affines(out_size, faces=FACES):
    """Reference dst->frame affines of the faces, plus one with m11 = 0 (a
    quarter turn: its guard keeps |m11| at 1e-6)."""
    dst = jnp.asarray(ARCFACE_DST) * (out_size / 112.0)
    kps = np.stack([kps_for(t, s, c) for t, s, c in faces])
    m_inv = np.asarray(jax.vmap(lambda k: jax_invert(jax_umeyama(k, dst)))(jnp.asarray(kps)))
    turn = np.array([[[0.0, -1.2, 200.0], [1.2, 0.0, 40.0]]], np.float32)
    m_inv = np.concatenate([m_inv, turn]).astype(np.float32)
    fidx = np.arange(len(m_inv), dtype=np.int32) % 2
    return m_inv, fidx


def _atlas(frames, packed):
    x = torch.from_numpy(frames)
    if packed:
        return warp2pass.build_atlas_packed(warp2pass.space_to_depth4(x))
    return warp2pass.build_atlas(x)


LAYOUTS = [("raw", np.uint8), ("raw", np.float32), ("packed", np.uint8)]


@pytest.mark.parametrize("out_size", [112, 96, 192])
@pytest.mark.parametrize("layout,dtype", LAYOUTS)
def test_roi_windows_equal_reference_extract(layout, dtype, out_size):
    """The windows cut the reference's ROIs out of the atlas exactly, and the
    affines equal the reference's; every level is used and some window
    reaches the atlas's last row or last column."""
    packed = layout == "packed"
    frames = _frames(dtype)
    m_inv, fidx = _affines(out_size)
    if packed:
        want_rois, want_mats = jw.extract_rois_packed(
            jw.space_to_depth4(jnp.asarray(frames)), jnp.asarray(fidx), jnp.asarray(m_inv),
            out_size)
    else:
        want_rois, want_mats = jw.extract_rois_from_affines(
            jnp.asarray(frames), jnp.asarray(fidx), jnp.asarray(m_inv), out_size)
    atlas, offsets = _atlas(frames, packed)
    fn = warp2pass.roi_windows_packed if packed else warp2pass.roi_windows
    windows, mats = fn(offsets, torch.from_numpy(fidx), torch.from_numpy(m_inv), out_size)
    assert windows.dtype == torch.int32 and tuple(windows.shape) == (len(m_inv), 3)
    side = warp2pass.ROI // 4 if packed else warp2pass.ROI
    got = warp_kernel.gather_windows(atlas, windows, side)
    want = np.asarray(want_rois)
    np.testing.assert_array_equal(got.numpy().astype(want.dtype), want)
    np.testing.assert_array_equal(mats.numpy(), np.asarray(want_mats))
    np.testing.assert_array_equal(windows[:, 0].numpy(), fidx)
    halo = warp2pass.HALO_P if packed else warp2pass.HALO
    levels = warp2pass.pyramid_level(torch.from_numpy(m_inv), out_size, halo=halo)
    assert set(levels.tolist()) == {0, 1, 2, 3}
    w = windows.numpy()
    assert (w[:, 1] + side == atlas.shape[1]).any() or (w[:, 1] + side == offsets[0][2]).any()
    assert (w[:, 2] + side == atlas.shape[2]).any()
    # extract_rois* are built from the same windows
    rois, _ = (warp2pass.extract_rois_packed(warp2pass.space_to_depth4(torch.from_numpy(frames)),
                                             torch.from_numpy(fidx), torch.from_numpy(m_inv),
                                             out_size) if packed else
               warp2pass.extract_rois_from_affines(torch.from_numpy(frames),
                                                   torch.from_numpy(fidx),
                                                   torch.from_numpy(m_inv), out_size))
    np.testing.assert_array_equal(rois.numpy().astype(want.dtype), want)


def _reference_crops(frames, fidx, m_inv, out_size, packed):
    if packed:
        rois, mats = jw.extract_rois_packed(jw.space_to_depth4(jnp.asarray(frames)),
                                            jnp.asarray(fidx), jnp.asarray(m_inv), out_size)
        one = jw._warp_one_from_packed_roi
    else:
        rois, mats = jw.extract_rois_from_affines(jnp.asarray(frames), jnp.asarray(fidx),
                                                  jnp.asarray(m_inv), out_size)
        one = jw._warp_one_from_roi
    return np.asarray(jax.vmap(lambda r, m: one(r, m, out_size))(rois, mats))


@pytest.mark.parametrize("out_size", [112, 96, 192])
@pytest.mark.parametrize("layout,dtype", LAYOUTS)
def test_warp_windows_plain_matches_reference(layout, dtype, out_size):
    """warp_windows on the CPU (its plain version) against the reference's
    extract + warp, within K3's 1e-3."""
    packed = layout == "packed"
    frames = _frames(dtype, seed=1)
    m_inv, fidx = _affines(out_size)
    want = _reference_crops(frames, fidx, m_inv, out_size, packed)
    atlas, offsets = _atlas(frames, packed)
    fn = warp2pass.roi_windows_packed if packed else warp2pass.roi_windows
    windows, mats = fn(offsets, torch.from_numpy(fidx), torch.from_numpy(m_inv), out_size)
    got = warp_kernel.warp_windows(atlas, windows, mats, out_size, packed=packed)
    assert got.dtype == torch.float32 and tuple(got.shape) == (len(m_inv), out_size, out_size, 3)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-3)
    # the plain version is the plain K3 on the gathered windows, exactly
    rois = warp_kernel.gather_windows(atlas, windows, 48 if packed else 192)
    if packed:
        rois = warp2pass.unpack_roi4(rois)
    np.testing.assert_array_equal(got.numpy(),
                                  warp_kernel.warp_rois_plain(rois.float(), mats, out_size).numpy())


@pytest.mark.parametrize("m", [1, 16])
@pytest.mark.parametrize("out_size", [96, 192])
def test_warp_boxes_matches_reference(out_size, m):
    """The attribute heads' crops: the reference's warp_boxes_two_pass at 96
    and 192, within 1e-3; with a prebuilt atlas the same crops bit for bit.
    M = 16 is a bucket padded with [0, 0, 32, 32] boxes of frame 0, as
    ``FaceEngine.attributes`` pads it; its boxes reach past the frame and
    the bottom-right corner, and one is degenerate."""
    frames = _frames(np.uint8, seed=2)
    boxes = np.array([[10, 20, 60, 90], [100, 50, 300, 250], [-50, -40, 400, 300],
                      [5, 5, 4, 4], [280, 200, 330, 262], [30, 30, 156, 156],
                      [200, 100, 210, 180]], np.float32)
    pad = np.tile(np.array([[0, 0, 32, 32]], np.float32), (16, 1))
    pad[:len(boxes)] = boxes
    boxes, idx = pad[:m], (np.arange(16) % 2)[:m]
    if m == 1:
        boxes = np.array([[280, 200, 330, 262]], np.float32)  # at the bottom-right corner
    want = np.asarray(jw.warp_boxes_two_pass(jnp.asarray(frames), jnp.asarray(idx),
                                             jnp.asarray(boxes), out_size))
    args = (torch.from_numpy(frames), torch.from_numpy(idx), torch.from_numpy(boxes), out_size)
    got = warp2pass.warp_boxes_two_pass(*args)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-3)
    atlas = warp2pass.build_atlas(torch.from_numpy(frames))
    assert torch.equal(warp2pass.warp_boxes_two_pass(*args, atlas=atlas), got)


def test_warp_windows_rejects_bad_inputs():
    atlas = torch.zeros(1, 192, 400, 3, dtype=torch.uint8)
    win, mats = torch.zeros(2, 3, dtype=torch.int32), torch.zeros(2, 2, 3)
    with pytest.raises(ValueError):  # windows and mats disagree on M
        warp_kernel.warp_windows(atlas, win, torch.zeros(3, 2, 3))
    with pytest.raises(ValueError):  # not [M, 3]
        warp_kernel.warp_windows(atlas, torch.zeros(2, 2, dtype=torch.int32), mats)
    with pytest.raises(ValueError):  # the window does not fit the atlas
        warp_kernel.warp_windows(atlas[:, :100], win, mats)
    with pytest.raises(ValueError):  # five channels
        warp_kernel.warp_windows(torch.zeros(1, 192, 400, 5, dtype=torch.uint8), win, mats)
    with pytest.raises(ValueError):  # packed needs 16C channels
        warp_kernel.warp_windows(atlas, win, mats, packed=True)
    with pytest.raises(ValueError):
        warp_kernel.warp_windows(atlas, win, mats, variant="tiled")
    with pytest.raises(ValueError):
        warp_kernel.warp_windows(atlas, win, mats, out_size=5000)


def test_windows_are_clamped_into_the_atlas():
    """A window past the atlas is clamped into it, as the kernel clamps it."""
    frames = _frames(np.uint8)
    atlas, _ = _atlas(frames, False)
    win = torch.tensor([[5, -3, 10_000]], dtype=torch.int32)
    got = warp_kernel.gather_windows(atlas, win, 192)
    want = atlas[1, :192, -192:]
    assert torch.equal(got[0], want)


def test_attributes_build_the_atlas_once(monkeypatch):
    """Both attribute crop sizes (96 and 192) come from one pyramid atlas."""
    calls = []
    real = pipeline.build_atlas

    def counting(frames, *args, **kwargs):
        calls.append(tuple(frames.shape))
        return real(frames, *args, **kwargs)

    monkeypatch.setattr(pipeline, "build_atlas", counting)
    monkeypatch.setattr(warp2pass, "build_atlas", counting)
    engine = pipeline.FaceEngine(
        EngineConfig(det_size=(128, 128), max_faces=8, pre_nms_topk=64, dtype="float32"),
        det_arch="det_2.5g", rec_arch="r18", device="cpu")
    frames = _frames(np.uint8, seed=3)
    boxes = np.array([[10, 20, 60, 90], [100, 50, 300, 250]], np.float32)
    gender, age, lms = engine.attributes(frames, np.array([0, 1]), boxes)
    assert calls == [frames.shape]
    assert gender.shape == (2,) and age.shape == (2,) and lms.shape == (2, 106, 2)
