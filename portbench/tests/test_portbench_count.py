"""Operations and bytes at known shapes, against the published figures and
the repository's earlier hand counts."""

import json
import os

import pytest
import torch

from portbench import count, spec
from portbench.reference import arcface
from portbench.reference.pipeline import detector_factory


def _config(name: str) -> dict:
    with open(os.path.join(spec.ROOT, "portbench", "configs", f"{name}.json")) as f:
        return json.load(f)


def test_published_multiply_adds():
    """SCRFD-10GF is 10 G multiply-adds at VGA (640 x 480), w600k_r50 6.3 G
    at 112 x 112: operations are multiply-adds x 2."""
    det = count.model_flops(detector_factory(_config("buffalo_l")["detector"]), (480, 640, 3))
    assert det / 2 == pytest.approx(10e9, rel=0.02)
    r50 = count.model_flops(arcface.iresnet50, (112, 112, 3))
    assert r50 / 2 == pytest.approx(6.3e9, rel=0.01)


def test_conv_and_dense_count_by_hand():
    class Two(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.conv = torch.nn.Conv2d(3, 8, 3, 2, 1)
            self.dense = torch.nn.Linear(8, 4)

        def forward(self, x):
            return self.dense(self.conv(x.permute(0, 3, 1, 2)).mean(dim=(2, 3)))

    # conv: 8 x 8 outputs x 8 channels x 27 taps; dense: 8 x 4
    assert count.model_flops(Two, (16, 16, 3)) == 2.0 * (8 * 8 * 8 * 27 + 8 * 4)


@pytest.mark.parametrize("name,heads", [("buffalo_l", True), ("mobile_facenet", False)])
def test_frame_flops_parts(name, heads):
    flops = count.frame_flops(_config(name))
    assert ("heads" in flops) == heads
    assert flops["detector"] == pytest.approx(26.395904e9)
    per_face = flops["embedder"] / 32
    assert per_face == pytest.approx(12.6186e9 if name == "buffalo_l" else 0.44473e9, rel=1e-4)


def test_stem_bound_matches_the_kernel_table():
    """K4 at B = 8 on 640 x 640: the kernel table's 0.0363 ms bf16 bound,
    by operations."""
    flops, moved = count.stem_work(8, (640, 640), 28)
    t, by = count.bound(moved, flops, "bfloat16")
    assert by == "operations"
    assert t * 1e3 == pytest.approx(0.0363, abs=1e-4)


def test_match_bytes():
    """K1 and K2 read each valid row once and the queries once."""
    assert count.match_f32_bytes(50_000, 32) == 50_000 * 2048 + 32 * 2048
    assert count.match_int8_bytes(50_000, 32) == 50_000 * 512 + 32 * 512 + 8
    t, by = count.bound(count.match_f32_bytes(50_000, 32), 0.0, "float32")
    assert by == "bytes" and t == pytest.approx((50_032 * 2048) / 3.35e12)


def test_warp_bytes():
    assert count.warp_bytes(2, [112]) == 2 * (112 * 112 * 12 + 192 * 192 * 3)
    assert count.warp_bytes(1, [112, 96, 192]) == sum(s * s * 12 + 192 * 192 * 3
                                                     for s in (112, 96, 192))
