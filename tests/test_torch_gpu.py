"""The CUDA kernels against their plain PyTorch versions, on the card.

Marked ``gpu``; each test decides inside a fixture whether a card is there
and skips with a reason when it is not.  This file imports no JAX, so it
also runs on a machine without it:
``python -m pytest --noconftest -m gpu tests/test_torch_gpu.py``.
"""

import numpy as np
import pytest
import torch

from facerecognition_infrenceengine_tpu_torch.core.device import resolve_device
from facerecognition_infrenceengine_tpu_torch.ops import match_kernel, warp2pass, warp_kernel
from facerecognition_infrenceengine_tpu_torch.ops.align import ARCFACE_DST

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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,n,nv", [(1, 4096, 4000), (37, 3000, 2999), (256, 8192, 8192),
                                    (5, 1024, 0)])
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
