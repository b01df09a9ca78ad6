"""The CUDA kernels against their plain PyTorch versions, on the card.

Marked ``gpu``; each test decides inside a fixture whether a card is there
and skips with a reason when it is not.  This file imports no JAX, so it
also runs on a machine without it:
``python -m pytest --noconftest -m gpu tests/test_torch_gpu.py``.
"""

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from facerecognition_infrenceengine_tpu_torch.core.device import resolve_device
from facerecognition_infrenceengine_tpu_torch.ops import match_kernel, warp2pass, warp_kernel
from facerecognition_infrenceengine_tpu_torch.ops.align import (
    ARCFACE_DST, _invert_affine, umeyama_similarity)

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU form")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def test_resolving_cuda_turns_tf32_off(cuda):
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = True
    assert resolve_device() == torch.device("cuda")
    assert not torch.backends.cudnn.allow_tf32
    assert not torch.backends.cuda.matmul.allow_tf32


def _unit(rng, n, d=512):
    x = rng.normal(size=(n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def test_warp_kernel_matches_plain(cuda):
    rng = np.random.default_rng(0)
    frames = torch.from_numpy(rng.integers(0, 256, (2, 256, 320, 3), dtype=np.uint8))
    base = ARCFACE_DST - ARCFACE_DST.mean(0)
    kps = []
    for scale, theta, center in [(0.5, 0.2, (100, 90)), (2.4, -0.3, (160, 130)),
                                 (1.0, 0.0, (5, 5)), (4.0, 0.1, (300, 250))]:
        rot = np.array([[np.cos(theta), -np.sin(theta)],
                        [np.sin(theta), np.cos(theta)]], np.float32) * scale
        kps.append(base @ rot.T + np.asarray(center, np.float32))
    kps = torch.from_numpy(np.stack(kps).astype(np.float32))
    fidx = torch.tensor([0, 1, 0, 1])
    rois, mats = warp2pass.extract_rois(frames.to(cuda), fidx.to(cuda), kps.to(cuda))
    before = warp_kernel.warp_rois.launches
    got = warp_kernel.warp_rois(rois, mats)
    torch.cuda.synchronize()
    assert warp_kernel.warp_rois.launches == before + 1
    want = warp_kernel.warp_rois_plain(rois, mats)
    assert (got - want).abs().max().item() <= 1e-3


@pytest.mark.parametrize("out_size", [96, 192])
def test_warp_kernel_matches_plain_at_attribute_sizes(cuda, out_size):
    """K3 at the attribute heads' crop sizes (genderage 96, landmark 192)
    on bbox-centred windows through the pyramid: small, ROI-sized, larger
    than the frame and degenerate boxes."""
    rng = np.random.default_rng(2)
    frames = torch.from_numpy(rng.integers(0, 256, (2, 1088, 1920, 3), dtype=np.uint8))
    boxes = torch.tensor([[10, 20, 60, 90], [100, 50, 300, 250], [-50, -40, 2400, 1300],
                          [0, 0, 32, 32], [5, 5, 4, 4], [1800, 1000, 1930, 1100],
                          [30, 30, 156, 156], [400, 300, 900, 800]], dtype=torch.float32)
    fidx = torch.tensor([0, 1, 0, 1, 0, 1, 0, 1])
    m_inv = warp2pass.boxes_to_affines(boxes.to(cuda), out_size)
    rois, mats = warp2pass.extract_rois_from_affines(frames.to(cuda), fidx.to(cuda), m_inv,
                                                     out_size)
    before = warp_kernel.warp_rois.launches
    got = warp2pass.warp_boxes_two_pass(frames.to(cuda), fidx.to(cuda), boxes.to(cuda), out_size)
    torch.cuda.synchronize()
    assert warp_kernel.warp_rois.launches == before + 1
    assert got.shape == (8, out_size, out_size, 3)
    want = warp_kernel.warp_rois_plain(rois, mats, out_size)
    assert (got - want).abs().max().item() <= 1e-3
    cpu = warp2pass.warp_boxes_two_pass(frames, fidx, boxes, out_size)
    assert (got.cpu() - cpu).abs().max().item() <= 1e-3


# ------------------------------------------------- K3 read from the atlas
ATTR_BOXES = [[10, 20, 60, 90], [100, 50, 300, 250], [-50, -40, 2400, 1300], [0, 0, 32, 32],
              [5, 5, 4, 4], [1800, 1000, 1930, 1100], [30, 30, 156, 156], [400, 300, 900, 800]]


def _hd_faces(m, out_size, seed=3):
    """2 frames of 1088x1920 and m faces' dst->frame affines: the boxes of
    test_warp_kernel_matches_plain_at_attribute_sizes (larger than the frame,
    degenerate, at the edges), then faces from landmarks at scales 0.5-6 and
    rotations up to 0.6 rad, some on the frames' edges."""
    rng = np.random.default_rng(seed)
    frames = torch.from_numpy(rng.integers(0, 256, (2, 1088, 1920, 3), dtype=np.uint8))
    fixed = warp2pass.boxes_to_affines(torch.tensor(ATTR_BOXES, dtype=torch.float32), out_size)
    dst = torch.from_numpy(ARCFACE_DST) * (out_size / 112.0)
    base = ARCFACE_DST - ARCFACE_DST.mean(0)
    kps = []
    for _ in range(max(m - len(ATTR_BOXES), 0)):
        scale, theta = rng.uniform(0.5, 6.0), rng.uniform(-0.6, 0.6)
        rot = np.array([[np.cos(theta), -np.sin(theta)],
                        [np.sin(theta), np.cos(theta)]]) * scale
        kps.append(base @ rot.T + rng.uniform((-20, -20), (1940, 1100)))
    m_inv = fixed
    if kps:
        kps = torch.from_numpy(np.stack(kps).astype(np.float32))
        m_inv = torch.cat([fixed, _invert_affine(umeyama_similarity(kps, dst))])
    return frames, torch.arange(m) % 2, m_inv[:m]


@pytest.mark.parametrize("out_size", [96, 112, 192])
@pytest.mark.parametrize("layout", ["raw-uint8", "packed-uint8", "raw-float32", "packed-float32"])
def test_warp_windows_bit_equal_to_warp_rois(cuda, layout, out_size):
    """K3 read straight from the atlas gives the kernel's crops on the
    extracted ROIs bit for bit (the same taps on the same values: uint8 ->
    float32 is exact), in both uint8 reads, and its plain version's within
    1e-3; one launch a call; M = 1, 255, 256, 257."""
    packed = layout.startswith("packed")
    for m in (1, 255, 256, 257):
        frames, fidx, m_inv = _hd_faces(m, out_size)
        frames = frames.to(cuda)
        if layout.endswith("float32"):
            frames = frames.float()
        if packed:
            atlas, offsets = warp2pass.build_atlas_packed(warp2pass.space_to_depth4(frames))
            windows, mats = warp2pass.roi_windows_packed(offsets, fidx.to(cuda), m_inv.to(cuda),
                                                         out_size)
            rois = warp2pass.unpack_roi4(warp_kernel.gather_windows(atlas, windows, 48))
        else:
            atlas, offsets = warp2pass.build_atlas(frames)
            windows, mats = warp2pass.roi_windows(offsets, fidx.to(cuda), m_inv.to(cuda),
                                                  out_size)
            rois = warp_kernel.gather_windows(atlas, windows, 192)
        want = warp_kernel.warp_rois(rois.float().contiguous(), mats, out_size)
        plain = warp_kernel.warp_windows_plain(atlas, windows, mats, out_size, packed)
        for variant in ("direct", "staged"):
            before = warp_kernel.warp_rois.launches_by_size[out_size]
            got = warp_kernel.warp_windows(atlas, windows, mats, out_size, packed=packed,
                                           variant=variant)
            torch.cuda.synchronize()
            assert warp_kernel.warp_rois.launches_by_size[out_size] == before + 1
            assert got.shape == (m, out_size, out_size, 3)
            assert torch.equal(got, want), (m, variant)
            assert (got - plain).abs().max().item() <= 1e-3, (m, variant)


class _Outputs(TorchDispatchMode):
    """(op, shape) of every tensor the aten ops under it return."""

    def __init__(self):
        super().__init__()
        self.seen = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in out if isinstance(out, (tuple, list)) else (out,):
            if isinstance(t, torch.Tensor):
                self.seen.append((str(func), tuple(t.shape)))
        return out


@pytest.mark.parametrize("out_size", [96, 112, 192])
def test_warp_step_allocates_no_roi_tensor(cuda, out_size):
    """warp_faces_two_pass, warp_boxes_two_pass and warp_faces_two_pass_packed
    launch K3 once on the atlas: no op on the card path returns a
    [M, 192, 192, *] or [M, 48, 48, *] ROI stack (the crops themselves are
    the one empty [M, out, out, 3] the wrapper allocates)."""
    m = 64
    frames, fidx, m_inv = _hd_faces(m, out_size)
    frames, fidx = frames.to(cuda), fidx.to(cuda)
    rng = np.random.default_rng(4)
    kps = torch.from_numpy((ARCFACE_DST * rng.uniform(1, 4, (m, 1, 1))
                            + rng.uniform(0, 1500, (m, 1, 2))).astype(np.float32)).to(cuda)
    boxes = torch.tensor(ATTR_BOXES * (m // len(ATTR_BOXES)), dtype=torch.float32, device=cuda)
    dst = torch.from_numpy(ARCFACE_DST) * (out_size / 112.0)
    p4 = warp2pass.space_to_depth4(frames).contiguous()
    for name, call in (
            ("faces", lambda: warp2pass.warp_faces_two_pass(frames, fidx, kps, out_size, dst=dst)),
            ("boxes", lambda: warp2pass.warp_boxes_two_pass(frames, fidx, boxes, out_size)),
            ("packed", lambda: warp2pass.warp_faces_two_pass_packed(p4, fidx, kps, out_size,
                                                                    dst=dst))):
        before = warp_kernel.warp_rois.launches
        with _Outputs() as seen:
            crops = call()
        torch.cuda.synchronize()
        assert warp_kernel.warp_rois.launches == before + 1, name
        assert crops.shape == (m, out_size, out_size, 3)
        rois = [(op, shape) for op, shape in seen.seen if len(shape) == 4 and shape[0] == m
                and shape[1:3] in ((192, 192), (48, 48)) and not op.startswith("aten.empty")]
        assert not rois, (name, rois)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,n,nv", [(1, 4096, 4000), (37, 3000, 2999), (256, 8192, 8192),
                                    (5, 1024, 0), (33, 5000, 4999), (64, 65536, 50000)])
def test_top1_kernel_matches_plain(cuda, dtype, b, n, nv):
    rng = np.random.default_rng(1)
    g = torch.from_numpy(_unit(rng, n)).to(cuda, dtype)
    q = torch.from_numpy(_unit(rng, b)).to(cuda)
    if nv:
        q[0] = g[nv - 1].float()  # exact self-match at the last valid row
    v, i = match_kernel.gallery_top1(q, g, nv)
    pv, pi = match_kernel.gallery_top1_plain(q, g, nv)
    torch.cuda.synchronize()
    if nv == 0:
        assert torch.all(v == float("-inf")) and torch.all(i == 0)
        return
    assert int(i[0]) == nv - 1
    assert (v - pv).abs().max().item() <= 1e-5
    # ids agree wherever the plain top-2 gap exceeds the kernels' f32
    # summation-order difference
    cols = torch.arange(n, device=cuda)
    top2 = torch.where(cols < nv, q.to(dtype).float() @ g.float().T,
                       torch.tensor(float("-inf"), device=cuda)).topk(2, dim=1).values
    clear = (top2[:, 0] - top2[:, 1]) > 1e-5
    assert torch.equal(i[clear], pi[clear])


def test_top1_kernel_ties_go_to_lowest_index(cuda):
    g = torch.zeros(70000, 512, device=cuda)
    for row in (60001, 129, 33000):  # the same identity in three row chunks
        g[row, 3] = 1.0
    q = torch.zeros(3, 512, device=cuda)
    q[:, 3] = 1.0
    _, i = match_kernel.gallery_top1(q, g, 70000)
    assert i.tolist() == [129, 129, 129]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_top1_equal_rows_score_equal_wherever_they_sit(cuda, dtype):
    """Two equal rows at different positions in their 32-row chunks (and in
    their warps' 4-row groups) give bit-equal scores, and the lower row
    wins: the kernel's summation order does not depend on a row's place."""
    rng = np.random.default_rng(5)
    g = torch.from_numpy(_unit(rng, 9000)).to(cuda, dtype)
    pairs = [(5, 70), (33, 8191), (1000, 1003), (4095, 4128)]
    q = torch.zeros(len(pairs), 512, device=cuda)
    for k, (lo, hi) in enumerate(pairs):
        g[hi] = g[lo]
        q[k] = g[lo].float() + 0.01 * torch.from_numpy(_unit(rng, 1)[0]).to(cuda)
    v, i = match_kernel.gallery_top1(q, g, 9000)
    assert i.tolist() == [lo for lo, _ in pairs]
    for k, (lo, hi) in enumerate(pairs):
        alone = g.clone()
        alone[lo] = 0  # the lower copy gone: the upper one wins alone
        v_hi, i_hi = match_kernel.gallery_top1(q[k:k + 1], alone, 9000)
        assert int(i_hi) == hi and v_hi.item() == v[k].item()


def test_mixed_dtype_batch_norm_rounds_once(cuda):
    """The bf16 engine's BatchNorm on the card: bf16 input, f32 weight, bias
    and statistics, returned in bf16 equal bit for bit to the f32
    computation rounded once, contiguous and channels_last."""
    from facerecognition_infrenceengine_tpu_torch.models.layers import cast_keep_bn_f32

    rng = np.random.default_rng(6)
    c = 64
    bn = torch.nn.BatchNorm2d(c).eval()
    with torch.no_grad():
        for t, scale in ((bn.weight, 1.0), (bn.bias, 1.0), (bn.running_mean, 2.0)):
            t.copy_(torch.from_numpy(rng.normal(0, scale, c).astype(np.float32)))
        bn.running_var.copy_(torch.from_numpy(np.exp(rng.normal(0, 1, c)).astype(np.float32)))
    cast_keep_bn_f32(bn, cuda, torch.bfloat16)
    assert bn.running_var.dtype == torch.float32 and bn.weight.dtype == torch.float32
    x = torch.from_numpy(rng.normal(0, 3, (8, c, 28, 28)).astype(np.float32)).to(cuda)
    x = x.bfloat16()
    for fmt in (torch.contiguous_format, torch.channels_last):
        xi = x.contiguous(memory_format=fmt)
        with torch.no_grad():
            got = bn(xi)
            want = torch.nn.functional.batch_norm(xi.float(), bn.running_mean, bn.running_var,
                                                  bn.weight, bn.bias, False, 0.0, bn.eps)
        assert got.dtype == torch.bfloat16
        assert torch.equal(got, want.bfloat16())


# ------------------------------------------------------------------- K4
def _stem_weights(sw, dtype, device, seed=0):
    """Random BN-folded stem weights in the kernel's layout (HWIO)."""
    rng = np.random.default_rng(seed)
    out = {}
    for i, (cin, cout) in enumerate([(3, sw), (sw, sw), (sw, 2 * sw)]):
        w = rng.normal(size=(3, 3, cin, cout)) / np.sqrt(9 * cin)
        out[f"w{i + 1}"] = torch.from_numpy(w.astype(np.float32)).to(device, dtype).contiguous()
        out[f"b{i + 1}"] = torch.from_numpy(
            rng.normal(size=cout).astype(np.float32) * 0.2).to(device)
    return out


@pytest.mark.parametrize("b,h,w,sw", [(2, 640, 640, 28), (2, 128, 64, 12), (1, 36, 44, 8),
                                      (3, 80, 80, 28)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_stem_kernel_matches_plain(cuda, b, h, w, sw, dtype):
    """f32: within 1e-4 of the largest output (summation order).  bf16: each
    conv's output is cast to bf16 after f32 sums in another order, so a value
    near a rounding boundary can land one bf16 step (2**-8 relative) away and
    carry into the next conv: within 2**-6 of the largest output, and equal
    on at least 90% of values."""
    from facerecognition_infrenceengine_tpu_torch.ops import stem_kernel

    rng = np.random.default_rng(h + w)
    frames = torch.from_numpy(rng.integers(0, 256, (b, h, w, 3), dtype=np.uint8)).to(cuda)
    x48 = stem_kernel.space_to_depth4(frames).contiguous()
    wts = _stem_weights(sw, dtype, cuda)
    before = stem_kernel.fused_stem.launches
    got = stem_kernel.fused_stem_s2d4(x48, wts, sw)
    torch.cuda.synchronize()
    assert stem_kernel.fused_stem.launches == before + 1
    want = stem_kernel.fused_stem_plain(x48, wts, sw)
    assert got.dtype == dtype and got.shape == want.shape == (b, h // 4, w // 4, 2 * sw)
    err = (got.float() - want.float()).abs().max().item()
    top = want.float().abs().max().item()
    if dtype == torch.float32:
        assert err <= 1e-4 * max(1.0, top), err
    else:
        assert err <= 2.0 ** -6 * top, (err, top)
        assert (got == want).float().mean().item() >= 0.9
    # the reference's padded x4 signature gives the same result
    x4 = stem_kernel.pad_packed_u8(x48)
    assert torch.equal(stem_kernel.fused_stem(x4, wts, w // 4, sw), got)


# ------------------------------------------------------------------- K2
@pytest.mark.parametrize("b,n,nv", [(1, 4096, 4000), (33, 3000, 2999), (256, 8192, 8192),
                                    (5, 1024, 0), (32, 65536, 50000)])
def test_top1_int8_kernel_matches_plain(cuda, b, n, nv):
    """Integer arithmetic: ids and values equal to the plain version."""
    rng = np.random.default_rng(2)
    gq, gs = match_kernel.quantize_gallery(_unit(rng, n), headroom=1.25)
    g = torch.from_numpy(gq).to(cuda)
    q = torch.from_numpy(_unit(rng, b)).to(cuda)
    if nv:
        q[0] = g[nv - 1].float() * gs  # its own row, the last valid one
    before = match_kernel.gallery_top1_int8.launches
    v, i = match_kernel.gallery_top1_int8(q, g, gs, nv)
    torch.cuda.synchronize()
    assert match_kernel.gallery_top1_int8.launches == before + 1
    pv, pi = match_kernel.gallery_top1_int8_plain(q, g, gs, nv)
    assert torch.equal(i, pi) and torch.equal(v, pv)
    if nv == 0:
        assert torch.all(v == float("-inf")) and torch.all(i == 0)
    else:
        assert int(i[0]) == nv - 1


def test_top1_int8_kernel_ties_and_rows_past_n_valid(cuda):
    """The same identity in three 128-row chunks goes to the lowest row;
    rows past n_valid that would win are never read."""
    g = torch.zeros(70000, 512, dtype=torch.int8, device=cuda)
    for row in (60001, 129, 33000):
        g[row, 3] = 100
    g[60002, 3] = 127  # past n_valid
    q = torch.zeros(3, 512, device=cuda)
    q[:, 3] = 1.0
    v, i = match_kernel.gallery_top1_int8(q, g, 0.01, 60002)
    pv, pi = match_kernel.gallery_top1_int8_plain(q, g, 0.01, 60002)
    assert i.tolist() == pi.tolist() == [129, 129, 129] and torch.equal(v, pv)


@pytest.fixture(scope="module")
def int8_gallery():
    """The N = 65,536 int8 gallery of the K2 edge cases, made once."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU form")
    gq, gs = match_kernel.quantize_gallery(_unit(np.random.default_rng(7), 65536), headroom=1.25)
    return torch.from_numpy(gq).cuda(), gs


def _int8_equal(q, g, gs, nv):
    v, i = match_kernel.gallery_top1_int8(q, g, gs, nv)
    pv, pi = match_kernel.gallery_top1_int8_plain(q, g, gs, nv)
    torch.cuda.synchronize()
    assert torch.equal(i, pi) and torch.equal(v, pv)
    return v, i


@pytest.mark.parametrize("nv", [1, 127, 128, 129, 50000, 65536])
@pytest.mark.parametrize("b", [1, 2, 16, 17, 31, 64, 128, 255, 512])
def test_top1_int8_kernel_bit_equal_at_tile_and_chunk_edges(cuda, int8_gallery, b, nv):
    """Query-tile edges (16-query m-tiles, the 256-query tile, two tiles at
    B = 512) and row-chunk edges (32-row warp units): ids and values equal
    to the plain version, and a planted copy of the last valid row found."""
    g, gs = int8_gallery
    q = torch.from_numpy(_unit(np.random.default_rng(b * 7 + nv), b)).to(cuda)
    q[b - 1] = g[nv - 1].float() * gs
    _, i = _int8_equal(q, g, gs, nv)
    assert int(i[b - 1]) == nv - 1


def test_top1_int8_kernel_all_zero_batch(cuda, int8_gallery):
    """An all-zero (bucket padding) batch: qs = 1e-12 / 127, every dot 0, so
    row 0 wins everywhere with the value 0."""
    g, gs = int8_gallery
    v, i = _int8_equal(torch.zeros(32, 512, device=cuda), g, gs, 50000)
    assert torch.all(i == 0) and torch.all(v == 0)


def test_top1_int8_kernel_all_negative_dots(cuda):
    """Rows of positive bytes queried by their own negation: every valid dot
    is negative, so the best is the least negative (the key's sign flip)."""
    rng = np.random.default_rng(8)
    g = torch.from_numpy(rng.integers(1, 128, (20000, 512)).astype(np.int8)).to(cuda)
    rows = [0, 31, 32, 9000, 19999]
    q = -g[rows].float()
    v, _ = _int8_equal(q, g, 0.01, 20000)
    assert torch.all(v < 0)


def test_top1_int8_kernel_saturated_rows(cuda):
    """Rows at +-127 against a +-1 query: |dot| = 512 * 127**2 = 8,258,048,
    the largest raw value, exact at both signs."""
    rng = np.random.default_rng(9)
    sign = torch.from_numpy(rng.choice([-1.0, 1.0], size=512).astype(np.float32)).to(cuda)
    g = torch.from_numpy(rng.integers(-20, 21, (4096, 512)).astype(np.int8)).to(cuda)
    g[100] = (127 * sign).to(torch.int8)
    g[3000] = (-127 * sign).to(torch.int8)
    q = torch.stack([sign, -sign, sign])
    gs = 0.004
    v, i = _int8_equal(q, g, gs, 4096)
    assert i.tolist() == [100, 3000, 100]
    qs = torch.tensor(1.0, device=cuda) / torch.tensor(127.0, device=cuda)
    assert torch.all(v == 8258048.0 * (qs * gs))


def test_top1_int8_kernel_back_to_back_calls_and_streams(cuda, int8_gallery):
    """Alternating batch sizes and n_valid (0 among them) on one stream, each
    call leaving its keys and counters at zero for the next; then a second
    stream with its own scratch."""
    g, gs = int8_gallery
    rng = np.random.default_rng(10)
    for b, nv in [(32, 50000), (1, 0), (32, 129), (256, 65536), (32, 0), (1, 1), (512, 50000),
                  (32, 50000), (256, 0), (17, 127)]:
        _int8_equal(torch.from_numpy(_unit(rng, b)).to(cuda), g, gs, nv)
    side = torch.cuda.Stream()
    q = torch.from_numpy(_unit(rng, 32)).to(cuda)
    with torch.cuda.stream(side):
        for nv in (50000, 0, 128):
            v, i = match_kernel.gallery_top1_int8(q, g, gs, nv)
            pv, pi = match_kernel.gallery_top1_int8_plain(q, g, gs, nv)
            side.synchronize()
            assert torch.equal(i, pi) and torch.equal(v, pv)


@pytest.mark.parametrize("b", [1, 32, 256, 512])
def test_top1_int8_kernel_is_one_device_kernel_a_call(cuda, int8_gallery, b):
    """torch.profiler sees exactly one device kernel (and no copy or memset)
    for each wrapper call."""
    from torch.profiler import ProfilerActivity, profile

    g, gs = int8_gallery
    q = torch.from_numpy(_unit(np.random.default_rng(11), b)).to(cuda)
    match_kernel.gallery_top1_int8(q, g, gs, 50000)  # scratch made outside the trace
    torch.cuda.synchronize()
    calls = 3
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            match_kernel.gallery_top1_int8(q, g, gs, 50000)
        torch.cuda.synchronize()
    events = [(e.key, e.count) for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0]
    assert len(events) == 1 and events[0][1] == calls, events
    assert "top1_int8" in events[0][0]
