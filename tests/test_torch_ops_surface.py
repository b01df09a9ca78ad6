"""The port's public ``ops`` surface against the reference's.

- ``ops/__init__.py`` re-exports the reference's 11 names, and importing it
  builds no kernel (``kernels/build.py`` and the warp modules stay
  unimported, so no import cycle through ``ops/warp2pass.py``).
- ``warp_affine_bilinear`` equals the reference's on the same numpy inputs
  (noise and smooth frames, rotated, scaled, identity, degenerate and
  non-square affines, uint8 and float32) within atol 1e-4 (0..255 units).
- ``warp_face`` / ``warp_faces`` are that warp on the port's own Umeyama
  affine (atol 1e-4 against the reference's warp on the same affine); from
  degenerate landmarks they equal the reference's ``warp_face`` /
  ``warp_faces`` within 1e-4.  From other landmarks the two packages' f32
  Umeyama affines differ at their rounding floor (the port's 2-D closed
  form, the reference's f32 SVD: up to ~3e-5 in the translation; the
  reference's vmapped inverse also rounds its translation its own way),
  which moves a crop of the smooth test frame by up to ~2.4e-3: there they
  are held within 5e-3 (tests/test_torch_warp.py's landmark-path budget).
- Port twins of ``tests/test_ops_align_matching.py``'s
  ``test_warp_matches_cv2`` (interior mean < 0.5, median < 0.1 against
  cv2.warpAffine) and ``test_warp_identity`` (atol 1e-3), and of
  ``tests/test_ops_warp2pass.py::test_two_pass_matches_exact_within_budget``
  at 0, 10, -20 and 30 degrees (the port's two-pass warp against its own
  bilinear warp: max < 0.35 at 0 degrees, mean < 1 and median < 0.5).
- ``cosine_scores`` equals the reference's within 1e-5 (f32 and bf16
  inputs, f32 accumulate), and ``cosine_topk`` picks the linear scan's best.
"""

import ast
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from facerecognition_infrenceengine_tpu.ops import align as ref_align
from facerecognition_infrenceengine_tpu.ops import matching as ref_matching
from facerecognition_infrenceengine_tpu_torch import ops
from facerecognition_infrenceengine_tpu_torch.ops import align, matching, warp2pass

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NAMES = ("anchor_centers", "distance2bbox", "distance2kps", "pairwise_iou", "nms_padded",
         "umeyama_similarity", "warp_face", "ARCFACE_DST", "l2_normalize", "cosine_scores",
         "cosine_topk")


def _exported(package: str) -> set:
    with open(os.path.join(ROOT, package, "ops", "__init__.py")) as f:
        tree = ast.parse(f.read())
    return {a.asname or a.name for n in tree.body if isinstance(n, ast.ImportFrom)
            for a in n.names}


def test_ops_exports_the_reference_names():
    assert _exported("facerecognition_infrenceengine_tpu") == set(NAMES)
    assert _exported("facerecognition_infrenceengine_tpu_torch") == set(NAMES)
    for name in NAMES:
        assert getattr(ops, name) is not None
    np.testing.assert_array_equal(ops.ARCFACE_DST, ref_align.ARCFACE_DST)


def test_importing_ops_builds_no_kernel():
    code = ("import sys, facerecognition_infrenceengine_tpu_torch.ops; "
            "from facerecognition_infrenceengine_tpu_torch.ops import cosine_topk, warp_face; "
            "print(sorted(m for m in sys.modules if m.startswith("
            "'facerecognition_infrenceengine_tpu_torch.')))")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=120, env=dict(os.environ, PYTHONPATH=ROOT))
    assert proc.returncode == 0, proc.stderr[-2000:]
    loaded = ast.literal_eval(proc.stdout.strip().splitlines()[-1])
    assert not [m for m in loaded if m.endswith((".kernels.build", ".warp2pass", ".warp_kernel",
                                                 ".match_kernel", ".stem_kernel"))], loaded


def smooth_frame(h=480, w=640, seed=0):
    """tests/test_ops_warp2pass.py's smooth frame."""
    rng = np.random.default_rng(seed)
    small = rng.uniform(0, 255, (h // 16, w // 16, 3)).astype(np.float32)
    yy = np.linspace(0, small.shape[0] - 1, h)
    xx = np.linspace(0, small.shape[1] - 1, w)
    y0, x0 = yy.astype(int), xx.astype(int)
    y1, x1 = np.minimum(y0 + 1, small.shape[0] - 1), np.minimum(x0 + 1, small.shape[1] - 1)
    fy, fx = (yy - y0)[:, None, None], (xx - x0)[None, :, None]
    img = ((small[y0][:, x0] * (1 - fy) + small[y1][:, x0] * fy) * (1 - fx)
           + (small[y0][:, x1] * (1 - fy) + small[y1][:, x1] * fy) * fx)
    return img.astype(np.float32)


def kps_for(theta, scale, center):
    base = np.asarray(ref_align.ARCFACE_DST, np.float32)
    rot = np.array([[np.cos(theta), -np.sin(theta)],
                    [np.sin(theta), np.cos(theta)]], np.float32) * scale
    return (base - base.mean(0)) @ rot.T + np.asarray(center, np.float32)


def _noise(h=200, w=180, seed=4):
    return np.random.default_rng(seed).uniform(0, 255, (h, w, 3)).astype(np.float32)


def _ref_m(kps, size=112):
    return np.asarray(ref_align.umeyama_similarity(
        jnp.asarray(kps), jnp.asarray(ref_align.ARCFACE_DST) * (size / 112.0)))


def _ref_warp(img, m, out_hw):
    return np.asarray(ref_align.warp_affine_bilinear(jnp.asarray(img), jnp.asarray(m), out_hw))


AFFINES = {
    "noise_rot0": (_noise, lambda: _ref_m(kps_for(0.0, 1.3, (90, 100))), (112, 112)),
    "noise_rot10": (_noise, lambda: _ref_m(kps_for(np.deg2rad(10), 1.1, (90, 100))), (112, 112)),
    "noise_rot-35": (_noise, lambda: _ref_m(kps_for(np.deg2rad(-35), 0.9, (80, 110))),
                     (112, 112)),
    "noise_mirrored": (_noise, lambda: _ref_m(kps_for(0.3, 1.0, (90, 90)) * [-1, 1] + [180, 0]),
                       (112, 112)),
    "smooth_rot30_far": (smooth_frame, lambda: _ref_m(kps_for(np.deg2rad(30), 2.5, (500, 380))),
                         (112, 112)),
    "smooth_size96": (smooth_frame, lambda: _ref_m(kps_for(0.2, 1.7, (320, 240)), 96),
                      (96, 96)),
    "non_square": (_noise, lambda: np.array([[0.8, 0.1, -5.0], [-0.1, 0.8, 12.0]], np.float32),
                   (60, 90)),
    "out_of_frame": (_noise, lambda: np.array([[0.5, 0.0, 300.0], [0.0, 0.5, -400.0]],
                                              np.float32), (112, 112)),
    "identity": (lambda: np.arange(100 * 100, dtype=np.float32).reshape(100, 100, 1),
                 lambda: np.array([[1.0, 0, 0], [0, 1.0, 0]], np.float32), (100, 100)),
    "degenerate_zero": (_noise, lambda: np.zeros((2, 3), np.float32), (112, 112)),
    "degenerate_rank1": (_noise, lambda: np.array([[1.0, 2.0, 3.0], [2.0, 4.0, 6.0]], np.float32),
                         (112, 112)),
    "uint8": (lambda: _noise().astype(np.uint8), lambda: _ref_m(kps_for(-0.2, 1.2, (90, 95))),
              (112, 112)),
}


@pytest.mark.parametrize("case", list(AFFINES))
def test_warp_affine_bilinear_matches_the_reference(case):
    make_img, make_m, out_hw = AFFINES[case]
    img, m = make_img(), make_m()
    want = _ref_warp(img, m, out_hw)
    got = align.warp_affine_bilinear(torch.from_numpy(img), torch.from_numpy(m), out_hw)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    assert np.isfinite(got.numpy()).all()
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4)


FACES = [kps_for(t, s, c) for t, s, c in ((0.0, 1.2, (320, 240)), (0.17, 0.8, (100, 90)),
                                          (-0.35, 2.0, (450, 300)), (0.52, 1.5, (600, 60)),
                                          (1.2, 0.6, (30, 450)))]


@pytest.mark.parametrize("size", [112, 96, 192])
def test_warp_face_is_the_bilinear_warp_on_its_own_affine(size):
    """warp_face and warp_faces (one batched gather) against the reference's
    bilinear warp on the port's Umeyama affine, and against each other."""
    img = smooth_frame()
    kps = np.stack(FACES)
    got = align.warp_faces(torch.from_numpy(img), torch.from_numpy(kps), size).numpy()
    assert got.shape == (len(FACES), size, size, 3)
    dst = torch.from_numpy(ref_align.ARCFACE_DST) * (size / 112.0)
    for k, face in enumerate(FACES):
        m = align.umeyama_similarity(torch.from_numpy(face), dst).numpy()
        want = _ref_warp(img, m, (size, size))
        one = align.warp_face(torch.from_numpy(img), torch.from_numpy(face), size).numpy()
        np.testing.assert_allclose(one, want, rtol=0, atol=1e-4)
        np.testing.assert_allclose(got[k], one, rtol=0, atol=1e-4)


@pytest.mark.parametrize("kps", [np.zeros((5, 2), np.float32),
                                 np.full((5, 2), 37.5, np.float32),
                                 np.tile(np.float32([[1e6, -1e6]]), (5, 1))],
                         ids=["zeros", "all_equal", "far_outside"])
def test_warp_face_on_degenerate_landmarks_matches_the_reference(kps):
    img = _noise()
    want = np.asarray(ref_align.warp_face(jnp.asarray(img), jnp.asarray(kps)))
    got = align.warp_face(torch.from_numpy(img), torch.from_numpy(kps)).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    batch = np.stack([kps, kps])
    want_b = np.asarray(ref_align.warp_faces(jnp.asarray(img), jnp.asarray(batch)))
    got_b = align.warp_faces(torch.from_numpy(img), torch.from_numpy(batch)).numpy()
    np.testing.assert_allclose(got_b, want_b, rtol=0, atol=1e-4)


def test_warp_faces_from_landmarks_match_the_reference():
    """End to end from landmarks: within the Umeyama's rounding floor."""
    img = smooth_frame()
    kps = np.stack(FACES)
    want = np.asarray(ref_align.warp_faces(jnp.asarray(img), jnp.asarray(kps)))
    got = align.warp_faces(torch.from_numpy(img), torch.from_numpy(kps)).numpy()
    singles = np.stack([np.asarray(ref_align.warp_face(jnp.asarray(img), jnp.asarray(f)))
                        for f in FACES])
    for w in (want, singles):
        diff = np.abs(got - w)
        print(f"warp_faces from landmarks: max |diff| {diff.max():.2e}, mean {diff.mean():.2e}")
        assert diff.max() <= 5e-3


def test_warp_matches_cv2():
    """tests/test_ops_align_matching.py::test_warp_matches_cv2 on the port."""
    import cv2

    rng = np.random.default_rng(4)
    img = rng.uniform(0, 255, (200, 180, 3)).astype(np.float32)
    kps = ops.ARCFACE_DST * 1.3 + np.array([30.0, 40.0], np.float32)
    m = ops.umeyama_similarity(torch.from_numpy(kps), torch.from_numpy(ops.ARCFACE_DST)).numpy()
    want = cv2.warpAffine(img, m, (112, 112))
    got = ops.warp_face(torch.from_numpy(img), torch.from_numpy(kps), 112).numpy()
    # interiors must agree; borders differ (replicate vs zero padding)
    diff = np.abs(got[4:-4, 4:-4] - want[4:-4, 4:-4])
    assert diff.mean() < 0.5
    assert np.median(diff) < 0.1


def test_warp_identity():
    """tests/test_ops_align_matching.py::test_warp_identity on the port."""
    img = np.arange(100 * 100 * 1, dtype=np.float32).reshape(100, 100, 1)
    m = torch.tensor([[1.0, 0, 0], [0, 1.0, 0]])
    out = align.warp_affine_bilinear(torch.from_numpy(img), m, (100, 100)).numpy()
    np.testing.assert_allclose(out, img, atol=1e-3)


@pytest.mark.parametrize("theta_deg", [0, 10, -20, 30])
def test_two_pass_matches_exact_within_budget(theta_deg):
    """tests/test_ops_warp2pass.py's case on the port: the two-pass warp
    (K3's plain version here) against the port's bilinear warp."""
    frame = smooth_frame()
    kps = kps_for(np.deg2rad(theta_deg), 1.2, (320, 240))
    want = align.warp_face(torch.from_numpy(frame), torch.from_numpy(kps)).numpy()
    got = warp2pass.warp_faces_two_pass(torch.from_numpy(frame)[None],
                                        torch.zeros(1, dtype=torch.int32),
                                        torch.from_numpy(kps)[None])[0].numpy()
    diff = np.abs(got - want)
    if theta_deg == 0:
        assert diff.max() < 0.35, f"no-rotation warp must be near-exact: {diff.max()}"
    else:
        assert diff.mean() < 1.0, f"theta={theta_deg}: mean {diff.mean()}"
        assert np.median(diff) < 0.5


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cosine_scores_match_the_reference(dtype):
    rng = np.random.default_rng(7)
    q = rng.normal(size=(7, 512)).astype(np.float32)
    g = rng.normal(size=(300, 512)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    g /= np.linalg.norm(g, axis=1, keepdims=True)
    jd, td = (jnp.float32, torch.float32) if dtype == "float32" else (jnp.bfloat16, torch.bfloat16)
    want = np.asarray(ref_matching.cosine_scores(jnp.asarray(q, jd), jnp.asarray(g, jd)))
    got = matching.cosine_scores(torch.from_numpy(q).to(td), torch.from_numpy(g).to(td))
    assert got.dtype == torch.float32 and tuple(got.shape) == (7, 300)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


def test_cosine_topk_matches_linear_scan():
    """tests/test_ops_align_matching.py::test_cosine_topk_matches_linear_scan
    on the port: its scores come from cosine_scores."""
    rng = np.random.default_rng(5)
    g = rng.normal(size=(300, 512)).astype(np.float32)
    q = rng.normal(size=(7, 512)).astype(np.float32)
    gn = g / np.linalg.norm(g, axis=1, keepdims=True)
    qn = q / np.linalg.norm(q, axis=1, keepdims=True)
    valid = torch.ones(300, dtype=torch.bool)
    vals, idx = ops.cosine_topk(torch.from_numpy(qn), torch.from_numpy(gn), valid, k=1)
    scores = ops.cosine_scores(torch.from_numpy(qn), torch.from_numpy(gn)).numpy()
    for b in range(7):
        linear = [float(np.dot(qn[b], gn[i])) for i in range(300)]
        best = int(np.argmax(linear))
        assert int(idx[b, 0]) == best
        assert abs(float(vals[b, 0]) - linear[best]) < 1e-5
        assert float(vals[b, 0]) == float(scores[b, best])
