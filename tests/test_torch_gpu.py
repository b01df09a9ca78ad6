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
    assert resolve_device() == torch.device("cuda", torch.cuda.current_device())
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


def test_onnx_runner_and_mobilefacenet_on_the_card_equal_the_cpu(cuda):
    """The exact-graph executor (the synthetic heads as buffalo_l-shaped
    graphs, a batch-1 Reshape rebound to 5) and MobileFaceNet in float32 on
    the card against the CPU; TF32 is off, so only summation order differs."""
    from facerecognition_infrenceengine_tpu_torch.models import (
        arcface, genderage, landmark106, mobilefacenet, onnxlite)
    from facerecognition_infrenceengine_tpu_torch.models.onnx_exec import OnnxRunner
    from facerecognition_infrenceengine_tpu_torch.models.onnx_export import head_graph
    from facerecognition_infrenceengine_tpu_torch.models.weights import load_or_init

    rng = np.random.default_rng(21)
    for model, size, seed, reshape in ((genderage.GenderAge(), 96, 7, False),
                                       (landmark106.Landmark106(), 192, 8, True)):
        graph = onnxlite.parse_model(head_graph(
            load_or_init("genderage" if size == 96 else "landmark_2d_106", model, seed),
            size, reshape))
        x = rng.uniform(0, 255, (5, 3, size, size)).astype(np.float32)
        want = OnnxRunner(graph, device="cpu")(x)[0].numpy()
        got = OnnxRunner(graph, device=cuda)(x)[0].cpu().numpy()
        assert got.shape == want.shape == (5, model.Dense_0.out_features)
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4 * np.abs(want).max())
    m = load_or_init("arcface_mobilefacenet", mobilefacenet.mobilefacenet(), 1)
    crops = torch.from_numpy(rng.integers(0, 256, (8, 112, 112, 3), dtype=np.uint8))
    with torch.no_grad():
        want = m(arcface.preprocess(crops)).numpy()
        got = m.to(cuda)(arcface.preprocess(crops.to(cuda))).cpu().numpy()
    cos = (want * got).sum(1) / np.linalg.norm(want, axis=1) / np.linalg.norm(got, axis=1)
    assert cos.min() >= 1 - 1e-4, cos


def test_umeyama_and_warp_faces_on_the_card_equal_the_cpu(cuda):
    """The Umeyama, its inverse and the bilinear aligner give the same bits
    on the card as on the CPU: the sums run in a fixed elementwise order
    and every division is a true one (rotated, mirrored, out-of-frame and
    degenerate landmarks, on a noise frame where an ulp of a coordinate
    shows)."""
    from facerecognition_infrenceengine_tpu_torch.ops.align import warp_faces

    rng = np.random.default_rng(21)
    frame = torch.from_numpy(rng.integers(0, 256, (480, 640, 3), dtype=np.uint8))
    base = ARCFACE_DST - ARCFACE_DST.mean(0)
    kps = []
    for _ in range(62):
        scale, theta = rng.uniform(0.3, 4.0), rng.uniform(-np.pi, np.pi)
        rot = np.array([[np.cos(theta), -np.sin(theta)],
                        [np.sin(theta), np.cos(theta)]]) * scale
        kps.append(base @ rot.T * rng.choice([-1.0, 1.0], 2) + rng.uniform(-100, 740, 2))
    kps += [np.zeros((5, 2)), np.full((5, 2), 37.5)]
    kps = torch.from_numpy(np.stack(kps).astype(np.float32))
    dst = torch.from_numpy(ARCFACE_DST)
    m_cpu = umeyama_similarity(kps, dst)
    m_card = umeyama_similarity(kps.to(cuda), dst)
    assert torch.equal(m_card.cpu(), m_cpu)
    assert torch.equal(_invert_affine(m_card).cpu(), _invert_affine(m_cpu))
    for size in (112, 96):
        assert torch.equal(warp_faces(frame.to(cuda), kps.to(cuda), size).cpu(),
                           warp_faces(frame, kps, size))


def test_microbatcher_serves_packs_uploaded_on_submit(cuda):
    """The serving host path on the card: two capture threads encode and
    upload yuv420 packs (upload_on_submit), the batcher stacks them on the
    card and dispatches get_batch_async; every frame's faces equal the same
    engine's on the CPU (boxes within 1e-3 px + 5e-6 of the largest
    coordinate, embeddings within 1 - cos 1e-4)."""
    import threading

    from facerecognition_infrenceengine_tpu_torch.core.config import EngineConfig
    from facerecognition_infrenceengine_tpu_torch.engine.microbatch import MicroBatcher
    from facerecognition_infrenceengine_tpu_torch.models.zoo import FaceAnalysis

    cfg = EngineConfig(det_size=(128, 128), max_faces=4, pre_nms_topk=64, dtype="float32",
                       microbatch_max=4, frame_queue_depth=4, stream_transport="yuv420",
                       upload_on_submit=True)
    apps = {dev: FaceAnalysis(cfg=cfg, allowed_modules=("detection", "recognition"),
                              device=dev) for dev in ("cuda", "cpu")}
    for app in apps.values():
        app.prepare(det_thresh=0.5)
    card = apps["cuda"]
    rng = np.random.default_rng(0)
    frames = {src: [rng.integers(0, 256, (96, 128, 3), dtype=np.uint8) for _ in range(4)]
              for src in ("cam0", "cam1")}
    pack = card.encode_frame(frames["cam0"][0])
    assert isinstance(pack, torch.Tensor) and pack.is_cuda
    assert card._stack_yuv([pack, pack, pack], 128).is_cuda
    mb = MicroBatcher(card, cfg)
    mb.start()
    futures = {}
    try:
        def capture(src):
            for k, frame in enumerate(frames[src]):
                futures[src, k] = mb.submit(src, frame, prepare=card.encode_frame)

        threads = [threading.Thread(target=capture, args=(src,)) for src in frames]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        results = {key: fut.result(timeout=120) for key, fut in futures.items()}
    finally:
        mb.stop()
    assert mb.stats["frames"] == 8 and mb.stats["dispatches"] >= 2
    for (src, k), faces in results.items():
        want = apps["cpu"].get_batch([frames[src][k]])[0]
        assert len(faces) == len(want) > 0
        scale = max(np.abs(np.concatenate([f.bbox, f.kps.ravel()])).max() for f in want)
        for g, w in zip(faces, want):
            np.testing.assert_allclose(g.bbox, w.bbox, rtol=0, atol=1e-3 + 5e-6 * scale)
            np.testing.assert_allclose(g.kps, w.kps, rtol=0, atol=1e-3 + 5e-6 * scale)
            assert float(g.normed_embedding @ w.normed_embedding) >= 1 - 1e-4


def test_serving_threads_bind_to_the_engines_card(cuda):
    """An unindexed ``cuda`` resolves to the building thread's current card,
    FaceAnalysis records its engine's resolved device, and the batcher's
    dispatch and resolver threads run on the app's card (the last one)."""
    from facerecognition_infrenceengine_tpu_torch.core.config import EngineConfig
    from facerecognition_infrenceengine_tpu_torch.engine.microbatch import MicroBatcher
    from facerecognition_infrenceengine_tpu_torch.models.zoo import FaceAnalysis

    app = FaceAnalysis(cfg=EngineConfig(det_size=(128, 128), max_faces=4, pre_nms_topk=64),
                       allowed_modules=("detection", "recognition"))
    app.prepare(det_thresh=0.5)
    assert app.device == torch.device("cuda", torch.cuda.current_device())

    class Probe:
        device = torch.device("cuda", torch.cuda.device_count() - 1)
        seen = []

        def get_batch_async(self, frames, max_num=0):
            self.seen.append(torch.cuda.current_device())

            def resolve():
                self.seen.append(torch.cuda.current_device())
                return [[] for _ in frames]
            return resolve

    probe = Probe()
    mb = MicroBatcher(probe, EngineConfig())
    mb.start()
    try:
        assert mb.submit("cam0", np.zeros((8, 8, 3), np.uint8)).result(timeout=60) == []
    finally:
        mb.stop()
    assert probe.seen and set(probe.seen) == {probe.device.index}


def test_get_batch_async_on_uploaded_packs_makes_no_synchronizing_call(cuda):
    """The streaming dispatch does not wait for the card: on yuv packs
    uploaded by encode_frame (upload_on_submit), get_batch_async through K4,
    K3 on the packed windows and the embedder makes no synchronizing CUDA
    call (torch's sync debug mode raises on one), and resolve() gives
    get_batch's faces."""
    from facerecognition_infrenceengine_tpu_torch.core.config import EngineConfig
    from facerecognition_infrenceengine_tpu_torch.models.zoo import FaceAnalysis

    cfg = EngineConfig(det_size=(128, 128), max_faces=4, pre_nms_topk=64,
                       stream_transport="yuv420", upload_on_submit=True,
                       packed_stem_impl="pallas")
    app = FaceAnalysis(cfg=cfg, allowed_modules=("detection", "recognition"), device="cuda")
    app.prepare(det_thresh=0.5)
    rng = np.random.default_rng(1)
    frames = [rng.integers(0, 256, (96, 128, 3), dtype=np.uint8) for _ in range(3)]
    packs = [app.encode_frame(f) for f in frames]
    want = app.get_batch(packs)  # also the warm-up: first calls upload constants
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        resolve = app.get_batch_async(packs)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    got = resolve()
    assert [len(f) for f in got] == [len(f) for f in want] and sum(len(f) for f in got) > 0
    for g, w in zip(sum(got, []), sum(want, [])):
        np.testing.assert_array_equal(g.bbox, w.bbox)
        np.testing.assert_array_equal(g.normed_embedding, w.normed_embedding)


def test_enrollment_and_counting_threads_bind_to_the_engines_card(cuda, monkeypatch):
    """The enrollment worker's executor threads and a counting camera thread
    run on their FaceAnalysis's card (the last one): each binds to it before
    it calls ``get``."""
    import time

    import cv2

    from facerecognition_infrenceengine_tpu_torch.api import create_app
    from facerecognition_infrenceengine_tpu_torch.core.config import Config
    from facerecognition_infrenceengine_tpu_torch.domain.campus import (
        CameraType, CampusPeopleManager)
    from facerecognition_infrenceengine_tpu_torch.domain.counting import CameraStreamManager
    from facerecognition_infrenceengine_tpu_torch.domain.enrollment import FaceEmbeddingWorker
    from facerecognition_infrenceengine_tpu_torch.engine.gallery import GalleryManager
    from facerecognition_infrenceengine_tpu_torch.models.zoo import (
        FakeFaceAnalysis, encode_fake_face)
    from facerecognition_infrenceengine_tpu_torch.store import Datastore

    card = torch.device("cuda", torch.cuda.device_count() - 1)

    class Probe(FakeFaceAnalysis):
        device = card
        seen = []

        def get(self, frame, max_num=0):
            self.seen.append(torch.cuda.current_device())
            return super().get(frame, max_num)

    cfg = Config()
    ds = Datastore(cfg)
    client = create_app(ds, cfg).test_client()
    cid = client.post("/bharatlytics/v1/companies/seed").get_json()["company"]["_id"]
    files = {pose: (f"{pose}.png", cv2.imencode(".png", encode_fake_face(7, j))[1].tobytes(),
                    "image/png") for pose, j in (("center", 0.0), ("left", 0.1), ("right", 0.2))}
    r = client.post("/bharatlytics/v1/employees/register",
                    data={"employeeId": "E1", "employeeName": "P", "companyId": cid}, files=files)
    assert r.status_code == 200
    worker = FaceEmbeddingWorker(ds, cfg, detector=Probe())
    assert worker.process_available_jobs() == 1
    worker.executor.shutdown(wait=True)
    assert ds.employee_info.find_one({"employeeId": "E1"})[
        "employeeEmbeddings"]["buffalo_l"]["status"] == "done"
    assert len(Probe.seen) == 3 and set(Probe.seen) == {card.index}

    class Capture:  # three frames, then the camera stops answering
        def __init__(self, source):
            self.frames = [encode_fake_face(7, 0.0)] * 4

        def isOpened(self):
            return True

        def read(self):
            return (True, self.frames.pop()) if self.frames else (False, None)

        def release(self):
            pass

    monkeypatch.setattr(cv2, "VideoCapture", Capture)
    Probe.seen = []
    cfg.campus.max_camera_errors = 1
    manager = CampusPeopleManager(ds, cfg, start_background=False)
    streams = CameraStreamManager(GalleryManager(ds, cfg, device=card), manager,
                                  face_app=Probe(), cfg=cfg)
    streams.start_camera("cam0", 0, "campus", CameraType.ENTRY)
    thread = streams.camera_threads["cam0"]
    thread.join(timeout=60)
    assert not thread.is_alive()
    streams.stop_all()
    assert len(Probe.seen) == 2 and set(Probe.seen) == {card.index}


# (B, H, W, Cin, Cout, kernel, stride, pad): IResNet-50's block convs at
# each stage (block 0's Conv_0 / Conv_1 / Conv_2 and a stage-4 conv, 7x7 with
# M = 49 rows at B = 1), det_10g's stem1 (K = 27, Cout 28), stem2 (K = 252),
# stem3 and a stage downsample at 640x640
INT8_CONV_SHAPES = [(32, 112, 112, 64, 64, 3, 1, 1), (32, 112, 112, 64, 64, 3, 2, 1),
                    (32, 112, 112, 64, 64, 1, 2, 0), (32, 56, 56, 64, 128, 3, 2, 1),
                    (32, 28, 28, 128, 256, 3, 2, 1), (32, 14, 14, 256, 512, 3, 2, 1),
                    (1, 7, 7, 512, 512, 3, 1, 1), (8, 640, 640, 3, 28, 3, 2, 1),
                    (8, 320, 320, 28, 28, 3, 1, 1), (8, 320, 320, 28, 56, 3, 1, 1),
                    (8, 80, 80, 56, 88, 1, 1, 0)]


@pytest.mark.parametrize("shape", INT8_CONV_SHAPES)
def test_int8_conv_on_the_card_is_exact(cuda, shape, monkeypatch):
    """int8_conv2d_nhwc runs torch._int_mm on the card (never another
    path) and equals the float64 convolution bit for bit."""
    from facerecognition_infrenceengine_tpu_torch.ops import int8_conv

    b, h, w, ci, co, k, s, p = shape
    gen = torch.Generator(device=cuda).manual_seed(sum(shape))
    x8 = torch.randint(-127, 128, (b, h, w, ci), dtype=torch.int8, device=cuda, generator=gen)
    w8 = torch.randint(-127, 128, (k, k, ci, co), dtype=torch.int8, device=cuda, generator=gen)
    seen = []
    real = torch._int_mm

    def spy(a, m):
        seen.append((a.device.type, m.device.type))
        return real(a, m)

    monkeypatch.setattr(torch, "_int_mm", spy)
    got = int8_conv.int8_conv2d_nhwc(x8, w8, s, p)
    assert seen and all(d == ("cuda", "cuda") for d in seen)
    assert got.device.type == "cuda" and got.dtype == torch.int32
    assert torch.equal(got, int8_conv.int8_conv2d_exact(x8, w8, s, p))


def test_int8_embedder_on_the_card_is_close_to_bf16(cuda):
    """An embed_int8 IResNet-50 engine's embeddings lie within min cosine
    0.98 of the bf16 engine's (the reference's bound, tests/test_quant.py:51)
    on 32 structured crops."""
    from facerecognition_infrenceengine_tpu_torch.core.config import EngineConfig
    from facerecognition_infrenceengine_tpu_torch.engine.pipeline import (
        FaceEngine, _calibration_crops)

    crops = _calibration_crops(32, 112, seed=7)
    embs = []
    for q in (False, True):
        e = FaceEngine(EngineConfig(det_size=(64, 64), embed_int8=q), det_arch="det_500m",
                       rec_arch="r50", device=cuda)
        assert ("int8" in e.rec_variables) == q
        embs.append(e.embed_crops(crops))
    cos = (embs[0] * embs[1]).sum(1)
    assert cos.min() >= 0.98, cos
    assert not np.allclose(embs[0], embs[1], atol=1e-6)


# ---------------------------------------------- the mesh and the trainer
def _clear_ids(q, g, nv, dtype):
    """Rows whose plain top-2 gap exceeds the kernels' f32 summation-order
    difference (1e-5): there the ids must agree."""
    cols = torch.arange(g.shape[0])
    s = torch.where(cols < nv, q.to(dtype).float() @ g.float().T, torch.tensor(float("-inf")))
    top2 = s.topk(2, dim=1).values
    return (top2[:, 0] - top2[:, 1]) > 1e-5


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_sharded_match_on_a_repeated_card_equals_plain(cuda, dtype):
    """K1 (f32, bf16) or K2 (int8) once a shard on ``cuda:0`` named four
    times, merged with the lowest global index, against the same merge with
    every shard on the CPU through the plain versions: values within 1e-5
    (K1's FFMA / tensor-core order) or equal (K2), ids equal wherever the
    top-2 gap is clear; the live prefix ends inside shard 3; k = 3 through
    ``distributed_topk`` / ``distributed_topk_int8`` likewise."""
    from facerecognition_infrenceengine_tpu_torch.parallel import build_mesh, gallery_sharding
    from facerecognition_infrenceengine_tpu_torch.parallel import topk

    rng = np.random.default_rng(8)
    n, nv = 16384, 13000
    g = _unit(rng, n)
    q = torch.from_numpy(_unit(rng, 37))
    q[0] = torch.from_numpy(g[12999])  # a self-match at the last live row
    mesh = build_mesh([cuda] * 4, data=1, gallery=4)
    scale = None
    if dtype == "int8":
        gq, scale = match_kernel.quantize_gallery(g, headroom=1.25)
        host = torch.from_numpy(gq)
    else:
        host = torch.from_numpy(g).to(getattr(torch, dtype))
    shards = gallery_sharding(mesh).put(host)
    kernel = match_kernel.gallery_top1_int8 if scale is not None else match_kernel.gallery_top1
    before = kernel.launches
    v, i = topk.distributed_top1_fused(q.to(cuda), shards, nv, int8_scale=scale)
    torch.cuda.synchronize()
    assert kernel.launches == before + 4
    pv, pi = topk.distributed_top1_fused_plain(q, shards, nv, scale)
    assert int(i[0]) == 12999 and v.device.type == "cuda"
    if scale is not None:
        assert torch.equal(v.cpu(), pv) and torch.equal(i.cpu(), pi)
    else:
        assert (v.cpu() - pv).abs().max().item() <= 1e-5
        clear = _clear_ids(q, host, nv, host.dtype)
        assert torch.equal(i.cpu()[clear], pi[clear])
    if scale is not None:
        kv, ki = topk.distributed_topk_int8(q.to(cuda), shards, scale, nv, k=3)
        pkv, pki = topk.distributed_topk_int8_plain(q, shards, scale, nv, k=3)
        assert torch.equal(kv.cpu(), pkv) and torch.equal(ki.cpu(), pki)
    else:
        valid = gallery_sharding(mesh).put(torch.arange(n) < nv)
        kv, ki = topk.distributed_topk(q.to(cuda), shards, valid, k=3)
        pkv, pki = topk.distributed_topk_plain(q, shards, valid, k=3)
        assert (kv.cpu() - pkv).abs().max().item() <= 1e-5


def test_kernels_launch_on_their_tensors_card(cuda):
    """From a thread whose current device is card 0, K1, K2, K3 and K4 on
    card 1's tensors launch on card 1 (``kernels/build.launch_device``) and
    equal their plain versions; the thread's current device is left as it
    was."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards: the launch-device check crosses cards")
    from facerecognition_infrenceengine_tpu_torch.ops import stem_kernel

    torch.cuda.set_device(0)
    one = torch.device("cuda", 1)
    rng = np.random.default_rng(9)
    g = torch.from_numpy(_unit(rng, 4096))
    q = torch.from_numpy(_unit(rng, 8))
    v, i = match_kernel.gallery_top1(q.to(one), g.to(one), 4000)
    pv, pi = match_kernel.gallery_top1_plain(q, g, 4000)
    gq, gs = match_kernel.quantize_gallery(g.numpy())
    v8, i8 = match_kernel.gallery_top1_int8(q.to(one), torch.from_numpy(gq).to(one), gs, 4000)
    pv8, pi8 = match_kernel.gallery_top1_int8_plain(q, torch.from_numpy(gq), gs, 4000)
    frames = torch.from_numpy(rng.integers(0, 256, (2, 256, 320, 3), dtype=np.uint8))
    kps = torch.from_numpy((ARCFACE_DST + np.float32([100, 80]))[None].repeat(2, 0)
                           .astype(np.float32))
    rois, mats = warp2pass.extract_rois(frames.to(one), torch.tensor([0, 1], device=one),
                                        kps.to(one))
    crops = warp_kernel.warp_rois(rois, mats)
    w = _stem_weights(8, torch.float32, one)
    x48 = torch.from_numpy(rng.integers(0, 256, (1, 16, 16, 48), dtype=np.uint8))
    stem = stem_kernel.fused_stem_s2d4(x48.to(one), w, 8)
    torch.cuda.synchronize(1)
    assert torch.cuda.current_device() == 0
    assert (v.cpu() - pv).abs().max().item() <= 1e-5 and torch.equal(i8.cpu(), pi8)
    assert torch.equal(v8.cpu(), pv8)
    assert (crops.cpu() - warp_kernel.warp_rois_plain(rois.cpu(), mats.cpu())).abs().max() <= 1e-3
    want = stem_kernel.fused_stem_plain(x48, {k: t.cpu() for k, t in w.items()}, 8)
    assert (stem.cpu() - want).abs().max().item() <= 1e-4 * max(1.0, want.abs().max().item())


def test_train_step_on_the_card_matches_the_cpu(cuda):
    """One IResNet-18 step (112x112, B = 8, 1,000 classes, f32, TF32 off)
    on the card against the same step on the CPU, from one state: the loss
    within 1e-4 relative, the step's update of the model and of W within
    1e-3 relative (L2 over all leaves: cuDNN's and the CPU's summation
    orders; a BatchNorm bias's gradient is a sum whose terms cancel, so a
    leaf's own largest error says little)."""
    from facerecognition_infrenceengine_tpu_torch.core.device import resolve_device
    from facerecognition_infrenceengine_tpu_torch.engine import training
    from facerecognition_infrenceengine_tpu_torch.models import arcface

    resolve_device(cuda)  # TF32 off, as every f32 program of the port
    torch.manual_seed(0)
    model = arcface.iresnet18()
    rng = np.random.default_rng(10)
    images = rng.normal(size=(8, 112, 112, 3)).astype(np.float32)
    labels = rng.integers(0, 1000, 8)
    out = {}
    for dev in ("cpu", cuda):
        m = model.to(dev)
        state, opt = training.make_train_state(m, 1000, images[:2], learning_rate=0.01)
        new, loss = training.make_train_step(m, opt)(state, images, labels)
        out[str(dev)] = (float(loss), torch.cat(
            [(new["params"]["model"][k] - t).cpu().double().flatten()
             for k, t in state["params"]["model"].items()]),
            (new["params"]["w"] - state["params"]["w"]).cpu().double())
    (l_cpu, u_cpu, w_cpu), (l_gpu, u_gpu, w_gpu) = out.values()
    assert abs(l_gpu - l_cpu) <= 1e-4 * abs(l_cpu)
    assert (u_gpu - u_cpu).norm() <= 1e-3 * u_cpu.norm()
    assert (w_gpu - w_cpu).norm() <= 1e-3 * w_cpu.norm()


def test_bf16_train_step_on_the_card_matches_the_cpu(cuda):
    """One IResNet-18 step in bf16 mixed precision (``iresnet18(dtype=
    torch.bfloat16)``: float32 master weights, momentum and statistics;
    112x112, B = 8, 1,000 classes) on the card against the same step on
    the CPU, from one state: the loss within 1e-2 relative, the gradient
    (the momentum after the step) within 5e-2 relative L2 (cuDNN's and the
    CPU's bf16 convolutions round in different places; the bf16 step lies
    ~2-3% from the f32 step on the CPU); the state stays float32."""
    from facerecognition_infrenceengine_tpu_torch.engine import training
    from facerecognition_infrenceengine_tpu_torch.models import arcface

    resolve_device(cuda)
    torch.manual_seed(0)
    model = arcface.iresnet18(dtype=torch.bfloat16)
    rng = np.random.default_rng(11)
    images = rng.normal(size=(8, 112, 112, 3)).astype(np.float32)
    labels = rng.integers(0, 1000, 8)
    out = {}
    for dev in ("cpu", cuda):
        m = model.to(dev)
        state, opt = training.make_train_state(m, 1000, images[:2], learning_rate=0.01)
        new, loss = training.make_train_step(m, opt)(state, images, labels)
        leaves = [t for part in ("params", "opt_state")
                  for t in list(new[part]["model"].values()) + [new[part]["w"]]]
        assert {t.dtype for t in leaves} == {torch.float32}
        out[str(dev)] = (float(loss), torch.cat(
            [t.cpu().double().flatten() for t in new["opt_state"]["model"].values()]
            + [new["opt_state"]["w"].cpu().double().flatten()]))
    (l_cpu, g_cpu), (l_gpu, g_gpu) = out.values()
    print(f"bf16 r18 step, card against CPU: loss {abs(l_gpu - l_cpu) / abs(l_cpu):.2e}, "
          f"gradient {float((g_gpu - g_cpu).norm() / g_cpu.norm()):.2e}")
    assert abs(l_gpu - l_cpu) <= 1e-2 * abs(l_cpu)
    assert (g_gpu - g_cpu).norm() <= 5e-2 * g_cpu.norm()


# ------------------------------------------------------------ epilogue
# IResNet-50's epilogue shapes (C, side): the stem and stage 1's entry at
# 112, then each stage's entry width at the side it reads and the side it
# writes
EPILOGUE_SHAPES = [(64, 112), (64, 56), (128, 56), (128, 28), (256, 28), (256, 14), (512, 14),
                   (512, 7)]
_INT = {torch.float32: torch.int32, torch.bfloat16: torch.int16}


def _bits_equal(a, b):
    return a.dtype == b.dtype and torch.equal(a.view(_INT[a.dtype]), b.view(_INT[b.dtype]))


def _random_bn(c, device, seed):
    rng = np.random.default_rng(seed)
    bn = torch.nn.BatchNorm2d(c).eval()
    with torch.no_grad():
        for t, scale in ((bn.weight, 1.0), (bn.bias, 1.0), (bn.running_mean, 2.0)):
            t.copy_(torch.from_numpy(rng.normal(0, scale, c).astype(np.float32)))
        bn.running_var.copy_(torch.from_numpy(np.exp(rng.normal(0, 1, c)).astype(np.float32)))
    return bn.to(device)


@pytest.mark.parametrize("b", [1, 1024])
@pytest.mark.parametrize("c,side", EPILOGUE_SHAPES)
def test_epilogue_kernel_bit_equal_to_plain(cuda, c, side, b):
    """The epilogue kernel against its plain version (ATen's BatchNorm, add
    and PReLU) bit for bit, in bf16 and f32, in place and into a second
    tensor: BN alone, BN + PReLU, BN + r, BN + BN(r), BN + BN(r) + PReLU.
    In f32 the plain version runs with cuDNN off (ATen's own BatchNorm
    kernel; cuDNN's f32 BatchNorm rounds otherwise, see
    test_serve_forward_in_f32_on_the_card)."""
    from facerecognition_infrenceengine_tpu_torch.ops import epilogue_kernel

    bn_a, bn_b = _random_bn(c, cuda, 1), _random_bn(c, cuda, 2)
    gen = torch.Generator(cuda).manual_seed(c * side + b)
    for dtype in (torch.bfloat16, torch.float32):
        shape = (b, c, side, side)
        x = (3 * torch.randn(shape, generator=gen, device=cuda)).to(dtype).contiguous(
            memory_format=torch.channels_last)
        r = (3 * torch.randn(shape, generator=gen, device=cuda)).to(dtype).contiguous(
            memory_format=torch.channels_last)
        slope = torch.randn(c, generator=gen, device=cuda) * 0.25
        for kw in ({}, {"prelu": slope}, {"res": r}, {"res": r, "res_bn": bn_b},
                   {"res": r, "res_bn": bn_b, "prelu": slope}):
            with torch.inference_mode(), torch.backends.cudnn.flags(enabled=False):
                want = epilogue_kernel.epilogue_plain(x, bn_a, out=torch.empty_like(x), **kw)
            with torch.inference_mode():
                before = epilogue_kernel.epilogue.launches
                got = epilogue_kernel.epilogue(x, bn_a, out=torch.empty_like(x), **kw)
                inplace = x.clone()
                same = epilogue_kernel.epilogue(inplace, bn_a, **kw)
            torch.cuda.synchronize()
            assert epilogue_kernel.epilogue.launches == before + 2
            assert same.data_ptr() == inplace.data_ptr()
            assert _bits_equal(got, want), (dtype, sorted(kw), int((got != want).sum()))
            assert _bits_equal(same, want), (dtype, sorted(kw))


def _r50(device, dtype, seed=1):
    """IResNet-50's synthetic weights with drawn BatchNorm statistics."""
    from test_torch_epilogue import random_bn_stats

    from facerecognition_infrenceengine_tpu_torch.models import arcface, weights
    from facerecognition_infrenceengine_tpu_torch.models.layers import cast_keep_bn_f32

    model = random_bn_stats(weights.load_or_init("arcface_r50", arcface.iresnet50(), seed))
    return cast_keep_bn_f32(model, device, dtype, torch.channels_last)


def test_serve_forward_at_1024_crops_equals_the_module_in_two_slabs(cuda):
    """IResNet-50 in bf16 (the engine's cast) on 1,024 crops: the serving
    forward's embeddings equal the module forward's bit for bit, and its
    peak over the call holds the 112x112 stage's two 64-channel slabs, the
    shortcut's quarter slab and the input (+10%), where the module forward
    needs three slabs."""
    from facerecognition_infrenceengine_tpu_torch.models import arcface

    model = _r50(cuda, torch.bfloat16)
    b = 1024
    gen = torch.Generator(cuda).manual_seed(5)
    crops = torch.randint(0, 256, (b, 112, 112, 3), generator=gen, device=cuda,
                          dtype=torch.uint8)
    x = arcface.preprocess(crops)
    slab = b * 64 * 112 * 112 * 2
    peaks = {}
    with torch.inference_mode():
        for name, fn in (("module", model), ("serve", lambda t: arcface.serve_forward(model, t)),
                         ("module_again", model)):
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            peaks[name] = (fn(x), torch.cuda.max_memory_allocated() - base + x.nbytes)
    (want, p_module), (got, p_serve), (again, _) = peaks.values()
    print(f"r50 bf16 B={b}: peak over the call, input included: module {p_module / 2**30:.4f} "
          f"GiB, serve {p_serve / 2**30:.4f} GiB; a slab {slab / 2**30:.4f} GiB")
    assert _bits_equal(want, again)
    assert _bits_equal(got, want), int((got != want).sum())
    assert p_module >= 3 * slab
    assert p_serve <= 1.1 * (2.25 * slab + x.nbytes)


def test_serve_forward_in_f32_on_the_card(cuda):
    """IResNet-50 in f32 on 64 crops: the serving forward against the
    module forward, whose f32 BatchNorm is cuDNN's (the kernel follows
    ATen's own, which rounds otherwise in ~half the elements, by an ulp);
    the widest gap is printed and held to 1 - cos <= 1e-9 (measured on an
    H100: 1 - cos 1.6e-11, 112 ulps of an embedding's largest element)."""
    from facerecognition_infrenceengine_tpu_torch.core.device import resolve_device
    from facerecognition_infrenceengine_tpu_torch.models import arcface

    resolve_device(cuda)
    model = _r50(cuda, torch.float32)
    gen = torch.Generator(cuda).manual_seed(6)
    x = arcface.preprocess(torch.randint(0, 256, (64, 112, 112, 3), generator=gen, device=cuda,
                                         dtype=torch.uint8))
    with torch.inference_mode():
        want, got = model(x), arcface.serve_forward(model, x)
    # the gap in ulps of each embedding's largest element (elements near 0
    # differ in sign, where a count of ulps says nothing)
    top = want.abs().amax(1, keepdim=True)
    ulp = torch.nextafter(top, torch.full_like(top, float("inf"))) - top
    ulps = float(((got - want).abs() / ulp).max())
    cos = torch.nn.functional.cosine_similarity(got.double(), want.double(), dim=1)
    print(f"r50 f32 B=64, serve against module: equal {_bits_equal(got, want)}, widest gap "
          f"{ulps:.1f} ulp of the row's largest element, 1 - cos {float((1 - cos).max()):.3e}")
    assert float((1 - cos).max()) <= 1e-9


def test_vit_l_at_published_widths_against_the_f32_reference(cuda):
    """ViT-L (``vit_l``) in bf16 through the engine's embedder call on 256
    structured crops, weights drawn as the benchmark draws them: within the
    ``vit_l.crowd`` cell's ``embed.cos_gap`` of the float32 reference (TF32
    off), and its attention run by the pinned FlashAttention-2 kernel."""
    import json
    import os

    from torch.profiler import ProfilerActivity, profile

    from facerecognition_infrenceengine_tpu_torch.core.config import EngineConfig
    from facerecognition_infrenceengine_tpu_torch.engine import pipeline
    from facerecognition_infrenceengine_tpu_torch.models import arcface
    from portbench import data, spec
    from portbench.reference.pipeline import _module, embedder_factory

    torch.backends.cudnn.allow_tf32 = False
    root = os.path.join(spec.ROOT, "portbench")
    with open(os.path.join(root, "configs", "vit_l.json")) as f:
        config = json.load(f)
    with open(os.path.join(root, "limits", "vit_l.crowd.json")) as f:
        limit = json.load(f)["embed.cos_gap"]
    rec = data.embedder_weights(config, 2**33 + 21, cuda)
    engine = pipeline.FaceEngine(EngineConfig(dtype="bfloat16"), rec_variables=data.nested(rec),
                                 rec_arch="vit_l", device=cuda)
    x = arcface.preprocess(torch.from_numpy(pipeline._calibration_crops(256, 112)).to(cuda))
    with torch.inference_mode(), profile(activities=[ProfilerActivity.CUDA]) as prof:
        got = engine._apply_embedder(x)
        torch.cuda.synchronize()
    names = [e.key for e in prof.key_averages()]
    del engine
    ref = _module(embedder_factory(config["recognizer"]), rec, cuda)
    with torch.inference_mode():
        want = ref(x)
    cos = torch.nn.functional.cosine_similarity(got.double(), want.double(), dim=1)
    gap = float((1 - cos).max())
    print(f"vit_l bf16 B=256 against the f32 reference: 1 - cos {gap:.3e} (limit {limit})")
    assert any("flash_fwd_kernel" in n for n in names), names
    assert gap <= limit


# ViT-L's residual stream at a vit_l.crowd batch: 1,024 crops of 144 tokens, 768 wide
VIT_ROWS, VIT_WIDTH = 1024 * 144, 768


def _layernorm(width, dtype, device, gen):
    norm = torch.nn.LayerNorm(width, eps=1e-6).to(device)
    with torch.no_grad():
        norm.weight.copy_(1 + 0.1 * torch.randn(width, generator=gen, device=device))
        norm.bias.copy_(0.1 * torch.randn(width, generator=gen, device=device))
    return norm.to(dtype)


def _assert_within_a_rounding(got, want, h):
    """The kernel's LayerNorm against ``F.layer_norm`` of the same rows h:
    bf16 within one ulp of the larger of the two values (at least 2**-16,
    the ulp at 2**-9, where n = gamma * t + beta cancels); f32 within 2e-6
    times the value's size (at least 1) and the row's |mean| / std + 1, the
    f32 rounding of a mean far off zero carried through rstd."""
    g, w = got.float(), want.float()
    err = (g - w).abs()
    if got.dtype == torch.bfloat16:
        _, e = torch.frexp(torch.maximum(g.abs(), w.abs()))
        tol = torch.ldexp(torch.ones_like(g), e - 8).clamp_min(2.0 ** -16)
    else:
        hd = h.double()
        off = (hd.mean(-1, keepdim=True).abs() / hd.std(-1, keepdim=True)).float()
        tol = 2e-6 * w.abs().clamp_min(1.0) * (1 + off)
    worst = float((err / tol).max())
    assert worst <= 1.0, f"{got.dtype}: {int((err > tol).sum())} values beyond, worst {worst:.2f}"


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("scale,offset", [(0.7, 0.0), (3.0, 0.0), (1.0, 5.0)])
def test_residual_layernorm_kernel_against_aten(cuda, dtype, scale, offset):
    """At ViT-L's served residual stream (147,456 x 768), on rows of unit
    and wider scale and on rows far off zero mean: the fused form's stream
    bit-equal to ATen's ``x + a``, written into x, and its LayerNorm,
    written into a's buffer, within a rounding of ``F.layer_norm`` of the
    same sum (the kernel's two-pass statistics are not ATen's Welford
    order); the plain form the same.  Two launches."""
    from facerecognition_infrenceengine_tpu_torch.ops import layernorm_kernel as lk

    gen = torch.Generator(cuda).manual_seed(23)
    norm = _layernorm(VIT_WIDTH, dtype, cuda, gen)
    x = (scale * torch.randn(VIT_ROWS, VIT_WIDTH, generator=gen, device=cuda)
         + offset * torch.randn(VIT_ROWS, 1, generator=gen, device=cuda)).to(dtype)
    a = (scale * torch.randn(VIT_ROWS, VIT_WIDTH, generator=gen, device=cuda)).to(dtype)
    with torch.inference_mode():
        h = x + a
        want = torch.nn.functional.layer_norm(h, (VIT_WIDTH,), norm.weight, norm.bias, norm.eps)
        before = lk.residual_layernorm.launches
        got = lk.residual_layernorm(x, a, norm)
        alone = lk.residual_layernorm(h.clone(), None, norm)
    torch.cuda.synchronize()
    assert lk.residual_layernorm.launches == before + 2
    assert got.data_ptr() == a.data_ptr()
    assert _bits_equal(x, h), int((x != h).sum())
    _assert_within_a_rounding(got, want, h)
    _assert_within_a_rounding(alone, want, h)


@pytest.mark.parametrize("width", [128, 256, 384, 512, 640, 896, 1024])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_residual_layernorm_kernel_at_every_width(cuda, dtype, width):
    """Every width the kernel takes (1 to 8 of a warp's 4-element vectors)
    on 4,099 rows, an odd count: the stream bit-equal to ATen's add, both
    forms' LayerNorm within a rounding of ATen's."""
    from facerecognition_infrenceengine_tpu_torch.ops import layernorm_kernel as lk

    gen = torch.Generator(cuda).manual_seed(width)
    norm = _layernorm(width, dtype, cuda, gen)
    x, a = ((2 * torch.randn(4099, width, generator=gen, device=cuda) + 1).to(dtype)
            for _ in range(2))
    with torch.inference_mode():
        h = x + a
        want = torch.nn.functional.layer_norm(h, (width,), norm.weight, norm.bias, norm.eps)
        got = lk.residual_layernorm(x, a, norm)
        alone = lk.residual_layernorm(h.clone(), None, norm)
    torch.cuda.synchronize()
    assert _bits_equal(x, h)
    _assert_within_a_rounding(got, want, h)
    _assert_within_a_rounding(alone, want, h)


def _vit_l(device, seed=7):
    """ViT-L at its published widths in bf16 (the engine's cast), PyTorch's
    default initialisation with the LayerNorms and positions drawn."""
    from facerecognition_infrenceengine_tpu_torch.models import vit
    from facerecognition_infrenceengine_tpu_torch.models.layers import cast_keep_bn_f32

    torch.manual_seed(seed)
    with torch.device(device):
        model = vit.vit_l().eval()
    gen = torch.Generator(device).manual_seed(seed)
    with torch.no_grad():
        model.pos_embed.normal_(0, 0.02, generator=gen)
        for m in model.modules():
            if isinstance(m, torch.nn.LayerNorm):
                m.weight.copy_(1 + 0.1 * torch.randn(m.weight.shape, generator=gen,
                                                     device=device))
                m.bias.copy_(0.1 * torch.randn(m.bias.shape, generator=gen, device=device))
    return cast_keep_bn_f32(model, device, torch.bfloat16)


def _vit_crops(n, device, seed):
    from facerecognition_infrenceengine_tpu_torch.models import arcface

    gen = torch.Generator(device).manual_seed(seed)
    return arcface.preprocess(torch.randint(0, 256, (n, 112, 112, 3), generator=gen,
                                            device=device, dtype=torch.uint8))


def _gap(got, want):
    """The widest 1 - cos over a batch of embeddings."""
    cos = torch.nn.functional.cosine_similarity(got.double(), want.double(), dim=1)
    return float((1 - cos).max())


def test_vit_l_serve_forward_against_the_module_at_256_crops(cuda):
    """ViT-L in bf16 on 256 crops under the engine's attention pin: the
    served forward within 1 - cos 1e-4 of the module forward (their
    LayerNorms differ by a rounding), 49 kernel launches (48 fused, block
    0's norm1 plain), and no ATen layer norm in a trace of it."""
    from torch.nn.attention import SDPBackend, sdpa_kernel
    from torch.profiler import ProfilerActivity, profile

    from facerecognition_infrenceengine_tpu_torch.models import vit
    from facerecognition_infrenceengine_tpu_torch.ops import layernorm_kernel as lk

    model = _vit_l(cuda)
    x = _vit_crops(256, cuda, 8)
    with torch.inference_mode(), sdpa_kernel(SDPBackend.FLASH_ATTENTION):
        want = model(x)
        before = lk.residual_layernorm.launches
        got = vit.serve_forward(model, x)
        launched = lk.residual_layernorm.launches - before
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            vit.serve_forward(model, x)
            torch.cuda.synchronize()
    names = [e.key for e in prof.key_averages()]
    gap = _gap(got, want)
    print(f"vit_l bf16 B=256, served against the module: 1 - cos {gap:.3e}, "
          f"{launched} launches")
    assert launched == 2 * len(model.blocks) + 1 == 49
    assert any("residual_layernorm_kernel" in n for n in names), names
    assert not any("layer_norm_kernel" in n for n in names), names
    assert gap <= 1e-4


def test_vit_l_serve_forward_at_1024_crops_holds_one_mlp_slab(cuda):
    """ViT-L in bf16 on 1,024 crops (a vit_l.crowd batch): the served
    forward's peak over the call's base holds the residual stream, LN2's
    output and fc1's slab (2 x 226,492,416 + 905,969,664 B) and at most 16
    MiB more, where the module forward also holds the block input, the
    post-attention residual and ReLU6's slab; the two embeddings within
    1 - cos 1e-4."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    from facerecognition_infrenceengine_tpu_torch.models import vit

    model = _vit_l(cuda)
    b = 1024
    x = _vit_crops(b, cuda, 9)
    stream = b * 144 * 768 * 2
    hidden = b * 144 * 3072 * 2
    peaks, outs = {}, {}
    with torch.inference_mode(), sdpa_kernel(SDPBackend.FLASH_ATTENTION):
        vit.serve_forward(model, x[:8])  # the library and cuBLAS's workspaces
        model(x[:8])
        for name, fn in (("module", model), ("serve", lambda t: vit.serve_forward(model, t))):
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            outs[name] = fn(x)
            torch.cuda.synchronize()
            peaks[name] = torch.cuda.max_memory_allocated() - base
    print(f"vit_l bf16 B={b}: peak over the call's base: module {peaks['module']:,} B, serve "
          f"{peaks['serve']:,} B; stream {stream:,} B, fc1's slab {hidden:,} B")
    assert peaks["module"] >= 3 * stream + 2 * hidden
    assert peaks["serve"] <= 2 * stream + hidden + 16 * 2**20
    assert _gap(outs["serve"], outs["module"]) <= 1e-4


# A crowd batch's faces: 32 frames of a 640x640 canvas, 32 faces each
def _crowd_faces(device, seed):
    """Frames [32, 640, 640, 3] u8, frame_idx [1,024], and each face's box
    [1,024, 4] and landmarks [1,024, 5, 2] (ARCFACE_DST scaled 0.6-1.8
    and moved inside its frame)."""
    rng = np.random.default_rng(seed)
    frames = torch.from_numpy(rng.integers(0, 256, (32, 640, 640, 3), np.uint8)).to(device)
    m = 32 * 32
    scale = rng.uniform(0.6, 1.8, m).astype(np.float32)
    origin = rng.uniform(0, 640 - 112 * 1.8, (m, 2)).astype(np.float32)
    kps = ARCFACE_DST[None] * scale[:, None, None] + origin[:, None]
    side = 112 * scale[:, None]
    boxes = np.concatenate([origin, origin + side], axis=1)
    idx = torch.arange(32, device=device).repeat_interleave(32)
    return frames, idx, torch.from_numpy(boxes).to(device), torch.from_numpy(kps).to(device)


def _same_bits(a, b):
    return a.dtype == b.dtype and torch.equal(a.contiguous().view(torch.uint8),
                                              b.contiguous().view(torch.uint8))


def _bf16_engine(device):
    from facerecognition_infrenceengine_tpu_torch.core.config import EngineConfig
    from facerecognition_infrenceengine_tpu_torch.engine.pipeline import FaceEngine

    return FaceEngine(EngineConfig(dtype="bfloat16"), det_arch="det_500m", rec_arch="r50",
                      device=device)


def test_attributes_at_1024_boxes_hold_the_landmark_input_and_one_stage(cuda):
    """The attribute program on a crowd batch's 1,024 boxes in bf16: its
    peak over entry is the landmark head's first stage, its bf16 192x192
    input and the stage's conv and BatchNorm outputs (2 x 452,984,832 B),
    with at most 16 MiB more (K3's float32 crops, their normalised copies
    and the atlas gone before each head runs); gender, age and landmarks
    bit-equal to the composition the inputs replaced."""
    import types

    from test_torch_model_input import _parent_attributes_impl

    engine = _bf16_engine(cuda)
    frames, idx, boxes, _ = _crowd_faces(cuda, 31)
    m = len(idx)
    lm_input = m * 192 * 192 * 3 * 2
    stage = m * 24 * 96 * 96 * 2
    peaks, outs = {}, {}
    with torch.inference_mode():
        engine._attributes_impl(frames, idx, boxes)  # the heads, cuDNN's plans
        for name, fn in (("change", engine._attributes_impl),
                         ("parent", types.MethodType(_parent_attributes_impl, engine))):
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            outs[name] = fn(frames, idx, boxes)
            torch.cuda.synchronize()
            peaks[name] = torch.cuda.max_memory_allocated() - base
    print(f"attributes bf16 M={m}: peak over entry: change {peaks['change']:,} B, parent "
          f"{peaks['parent']:,} B; landmark input {lm_input:,} B, a stage slab {stage:,} B")
    assert all(_same_bits(g, w) for g, w in zip(outs["change"], outs["parent"]))
    assert peaks["change"] <= lm_input + 2 * stage + 16 * 2**20


def test_embedder_at_1024_crops_starts_with_its_bf16_input_alone(cuda, monkeypatch):
    """IResNet-50 in bf16 on a crowd batch's 1,024 K3 crops: when the
    embedder starts, what the call allocated over its entry is the bf16
    input alone (+1 MiB), through ``_embed_crops_impl`` on crops handed in
    (their float32 copy gone) and ``_embed_impl`` making them (K3's float32
    crops gone); the embeddings bit-equal to ``arcface.preprocess`` then the
    forward's cast."""
    from facerecognition_infrenceengine_tpu_torch.models import arcface
    from facerecognition_infrenceengine_tpu_torch.ops.matching import l2_normalize

    engine = _bf16_engine(cuda)
    frames, idx, _, kps = _crowd_faces(cuda, 32)
    m = len(idx)
    x_bytes = m * 112 * 112 * 3 * 2
    at_start = []
    serve = engine._serve_embedder

    def embedder(model, x):
        at_start.append(torch.cuda.memory_allocated())
        return serve(model, x)

    monkeypatch.setattr(engine, "_serve_embedder", embedder)
    with torch.inference_mode():
        crops = warp2pass.warp_faces_two_pass(frames, idx, kps, 112, dst=engine._dst)
        engine._embed_crops_impl(crops[:8])  # cuDNN's plans, cuBLAS's workspace
        over = {}
        for name, fn in (("crops", lambda: engine._embed_crops_impl(crops)),
                         ("frames", lambda: engine._embed_impl(frames, idx, kps))):
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            got = fn()
            over[name] = (got, at_start[-1] - base)
        monkeypatch.setattr(engine, "_serve_embedder", serve)
        want = l2_normalize(engine._apply_embedder(arcface.preprocess(crops)))
    print(f"embedder bf16 M={m}: allocated over entry when the embedder starts: "
          f"{ {k: v[1] for k, v in over.items()} } B; bf16 input {x_bytes:,} B, "
          f"f32 crops {2 * x_bytes:,} B")
    for got, extra in over.values():
        assert _same_bits(got, want)
        assert x_bytes <= extra <= x_bytes + 2**20
