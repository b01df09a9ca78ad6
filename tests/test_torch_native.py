"""The port's host codec (``native/`` over ``csrc/imagecodec.cc``) against the
reference's ``native`` and the port's plain numpy versions.

The cases of tests/test_native_imaging.py, held to bytes: the resize at down
x1/3 and x1/2, up x2 and identity; the letterbox's geometry and its float32
scale; the rasterizer, clipping included; the s2d4 / yuv420 packers; the
letterbox-then-pack at scales other than 1.  The JPEG cases skip where the
library was built without libjpeg.  The last test checks that the port's
package, chip_smoke.py and trace_stress.py import neither JAX nor the
reference package.
"""

import io
import os
import re
import struct

import numpy as np
import pytest

from facerecognition_infrenceengine_tpu import native as ref
from facerecognition_infrenceengine_tpu.engine.recognizer import (
    draw_enhanced_bounding_box as ref_hud)
from facerecognition_infrenceengine_tpu_torch import native
from facerecognition_infrenceengine_tpu_torch.engine.pipeline import FaceEngine
from facerecognition_infrenceengine_tpu_torch.engine.recognizer import (
    GREEN, draw_enhanced_bounding_box)
from facerecognition_infrenceengine_tpu_torch.kernels import build
from facerecognition_infrenceengine_tpu_torch.native import plain


@pytest.fixture
def jpeg():
    if not native.have_jpeg():
        pytest.skip("the host codec was built without libjpeg")


@pytest.fixture(scope="module")
def photo():
    img = np.zeros((120, 160, 3), np.uint8)
    yy, xx = np.mgrid[0:120, 0:160]
    img[..., 0] = (xx * 255 / 160).astype(np.uint8)
    img[..., 1] = (yy * 255 / 120).astype(np.uint8)
    img[..., 2] = 128
    img[40:80, 60:100] = (200, 50, 50)
    return img


def _noise(seed, h, w):
    return np.random.default_rng(seed).integers(0, 256, (h, w, 3), dtype=np.uint8)


def test_native_library_builds_with_the_host_compiler():
    assert native.have_native()
    path = build.build_host()
    assert os.path.basename(path).startswith("libfreimage_") and os.path.exists(path)
    assert "-ffp-contract=off" in build.CXX_FLAGS
    assert ref.have_native(), "the reference's C++ imaging library did not build"


@pytest.mark.parametrize("hw,ohw", [((120, 160), (40, 53)),      # down x1/3
                                    ((1080, 1920), (360, 640)),  # down x1/3, the 1080p camera
                                    ((96, 128), (48, 64)),       # down x1/2
                                    ((720, 1280), (360, 640)),   # down x1/2, the 720p camera
                                    ((48, 64), (96, 128)),       # up x2: the edge taps extrapolate
                                    ((7, 5), (20, 33)),          # up, odd sizes
                                    ((120, 160), (120, 160)),    # identity
                                    ((1, 9), (3, 4))])           # one row
def test_resize_bilinear_bytes(photo, hw, ohw):
    img = photo if hw == photo.shape[:2] else _noise(sum(hw), *hw)
    got = native.resize_bilinear(img, *ohw)
    assert got.shape == ohw + (3,)
    np.testing.assert_array_equal(got, ref.resize_bilinear(img, *ohw))
    np.testing.assert_array_equal(got, plain.resize_bilinear_plain(img, *ohw))
    if hw == ohw:
        np.testing.assert_array_equal(got, img)


def test_resize_keeps_a_gradient_monotone(photo):
    col = native.resize_bilinear(photo, 60, 80)[10, :, 0].astype(float)
    assert np.all(np.diff(col) >= 0)
    assert abs(col[-1] - float(photo[20, -1, 0])) < 6


@pytest.mark.parametrize("hw,ohw,scale", [((1080, 1920), (640, 640), 1 / 3),
                                          ((720, 1280), (640, 640), 0.5),
                                          ((480, 640), (640, 640), 1.0),
                                          ((37, 640), (640, 640), 1.0),   # the row copy
                                          ((128, 128), (128, 128), 1.0),
                                          ((120, 160), (640, 640), 4.0),
                                          ((48, 64), (128, 128), 2.0),
                                          ((192, 256), (128, 128), 0.5),
                                          ((100, 70), (128, 96), 1.28)])
def test_letterbox_geometry_and_float32_scale(hw, ohw, scale):
    img = _noise(hw[0], *hw)
    canvas, s = native.letterbox(img, *ohw)
    want, want_s = ref.letterbox(img, *ohw)
    assert canvas.shape == ohw + (3,)
    # the C++ float32 scale, carried as a Python float: 1/3 is 0.33333334
    assert s == want_s == float(np.float32(scale))
    np.testing.assert_array_equal(canvas, want)
    got_plain, plain_s = plain.letterbox_plain(img, *ohw)
    assert plain_s == s
    np.testing.assert_array_equal(canvas, got_plain)
    nh, nw = (min(int(np.float32(n) * np.float32(scale) + np.float32(0.5)), o)
              for n, o in zip(hw, ohw))
    assert canvas[:nh, :nw].any()
    assert not canvas[nh:].any() and not canvas[:, nw:].any()


@pytest.mark.parametrize("hw,ohw", [((1080, 1920), (640, 640)), ((720, 1280), (640, 640)),
                                    ((480, 640), (640, 640)), ((48, 64), (128, 128)),
                                    ((480, 640), (256, 320))])
def test_letterbox_then_pack_at_any_scale(hw, ohw):
    img = _noise(hw[1], *hw)
    canvas, s = native.letterbox(img, *ohw)
    packed, s2 = native.letterbox_s2d4(img, *ohw)
    want, want_s = ref.letterbox_s2d4(img, *ohw)
    assert s == s2 == want_s
    np.testing.assert_array_equal(packed, want)
    np.testing.assert_array_equal(packed, native.pack_s2d4(canvas))
    np.testing.assert_array_equal(packed, plain.pack_s2d4_plain(canvas))
    y24, s3 = native.letterbox_yuv420_s2d4(img, *ohw)
    want24, want_s3 = ref.letterbox_yuv420_s2d4(img, *ohw)
    assert s3 == want_s3 == s
    np.testing.assert_array_equal(y24, want24)
    got_plain, plain_s = plain.letterbox_yuv420_s2d4_plain(img, *ohw)
    assert plain_s == s
    np.testing.assert_array_equal(y24, got_plain)
    # phase (p, q) of packed pixel (Y, X) is canvas pixel (4Y + p, 4X + q)
    np.testing.assert_array_equal(packed[5, 7, (2 * 4 + 3) * 3:(2 * 4 + 3) * 3 + 3],
                                  canvas[4 * 5 + 2, 4 * 7 + 3])


def test_packers_match_reference_and_plain():
    img = _noise(10, 64, 96)
    np.testing.assert_array_equal(native.pack_s2d4(img), ref.pack_s2d4(img))
    np.testing.assert_array_equal(native.pack_s2d4(img), FaceEngine.pack_frames(img[None])[0])
    got = native.pack_yuv420_s2d4(img)
    assert got.shape == (16, 24, 24)
    np.testing.assert_array_equal(got, ref.pack_yuv420_s2d4(img))
    np.testing.assert_array_equal(got, plain.pack_yuv420_s2d4_plain(img))
    gray = native.pack_yuv420_s2d4(np.full((8, 8, 3), 77, np.uint8))
    assert (gray[..., :16] == 77).all() and (gray[..., 16:] == 128).all()
    with pytest.raises(ValueError, match="multiples of 4"):
        native.pack_s2d4(_noise(1, 6, 8))


def _draw_all(mod, img):
    mod.draw_corners(img, 5, 5, 60, 70, (255, 140, 0), length=15, thick=3)
    mod.draw_rect(img, 10, 10, 90, 190, (0, 255, 0), thick=2)
    mod.fill_rect(img, 40, 80, 60, 120, (100, 100, 100), alpha=0.5)
    mod.draw_text(img, 70, 20, "AB 12.5% ~qz", (255, 255, 255))
    mod.draw_bar(img, 80, 20, 95, 180, 0.5, (0, 0, 255))
    return img


def test_rasterizer_bytes_and_in_place():
    img = _draw_all(native, np.zeros((100, 200, 3), np.uint8))
    np.testing.assert_array_equal(img, _draw_all(ref, np.zeros((100, 200, 3), np.uint8)))
    assert (img[10:12, 10:190, 1] == 255).all()
    assert (img[50, 100] == 50).all()  # 0 * (1 - .5) + 100 * .5
    assert (img[85, 24:100, 2] > 0).mean() > 0.9


def test_rasterizer_clips_out_of_bounds():
    def draw(mod):
        img = np.zeros((50, 50, 3), np.uint8)
        mod.draw_rect(img, -10, -10, 200, 200, (255, 0, 0), thick=3)
        mod.fill_rect(img, 40, 40, 500, 500, (0, 255, 0))
        mod.draw_text(img, 45, 45, "CLIPPEDTEXT", (255, 255, 255))
        mod.draw_corners(img, -20, 30, 80, 90, (1, 2, 3), length=40, thick=5)
        mod.draw_bar(img, 44, -30, 60, 70, 1.5, (9, 9, 9))
        return img

    img = draw(native)
    assert img.shape == (50, 50, 3)
    np.testing.assert_array_equal(img, draw(ref))
    with pytest.raises(ValueError, match="C-contiguous"):
        native.fill_rect(np.zeros((8, 8, 3), np.uint8)[:, ::2], 0, 0, 4, 4, (1, 1, 1))


def test_hud_draw_enhanced_bounding_box_bytes():
    frame = np.zeros((480, 640, 3), np.uint8)
    info = {"type": "employee", "name": "Asha Rao", "employeeId": "E001"}
    out = draw_enhanced_bounding_box(frame.copy(), (100, 100, 260, 300), GREEN, info, 0.92, 0.81)
    want = ref_hud(frame.copy(), (100, 100, 260, 300), GREEN, info, 0.92, 0.81)
    np.testing.assert_array_equal(out, want)
    assert (out[:, :, 1] == 255).any()
    for box, info, scores in [((400, 50, 620, 420), {"type": "unknown", "name": "Unknown"},
                               (0.5, 0.0)),
                              ((590, 440, 700, 520), {"type": "visitor", "name": "V"},
                               (0.7, 0.6))]:
        out = draw_enhanced_bounding_box(out, box, (0, 0, 255), info, *scores)
        want = ref_hud(want, box, (0, 0, 255), info, *scores)
        np.testing.assert_array_equal(out, want)
    assert (out[:, :, 2] == 255).any()


def test_jpeg_roundtrip_and_decode_match_reference(jpeg, photo):
    data = native.encode_jpeg(photo, quality=95)
    assert data[:2] == b"\xff\xd8"
    assert data == ref.encode_jpeg(photo, quality=95)
    out = native.decode_jpeg(data)
    assert out.shape == photo.shape and out.dtype == np.uint8
    assert np.abs(out.astype(int) - photo.astype(int)).mean() < 4.0
    np.testing.assert_array_equal(out, ref.decode_jpeg(data))
    np.testing.assert_array_equal(native.decode_image(data), out)
    np.testing.assert_array_equal(out, native._decode_pil(data))  # PIL uses libjpeg too


def test_decode_garbage_and_dimension_cap(jpeg):
    assert native.decode_jpeg(b"not a jpeg at all") is None
    assert native.decode_jpeg(b"\xff\xd8\xff\xe0truncated") is None
    sof = b"\xff\xc0" + struct.pack(">HBHHB", 11, 8, 30000, 30000, 1) + b"\x01\x11\x00"
    assert native.decode_jpeg(b"\xff\xd8" + sof + b"\xff\xd9") is None


def test_decode_cap_applies_to_pil_formats():
    from PIL import Image

    buf = io.BytesIO()
    Image.new("RGB", (9000, 9000)).save(buf, "PNG")  # 81 MP: over the 64 MP cap
    assert native.decode_image(buf.getvalue()) is None
    small = io.BytesIO()
    Image.fromarray(_noise(3, 20, 30)).save(small, "PNG")
    np.testing.assert_array_equal(native.decode_image(small.getvalue()), _noise(3, 20, 30))


def test_build_without_libjpeg_raises_on_jpeg_only(monkeypatch):
    """A host without libjpeg: the rest of the codec builds and runs, the
    JPEG functions raise naming libjpeg, and decode_image decodes every
    format through PIL, JPEG too (None for data PIL cannot read), as the
    reference's decode does where its native library is missing."""
    from PIL import Image

    monkeypatch.setattr(build, "_jpeg_flags", [])
    monkeypatch.setattr(build, "_host_lib", None)
    assert not native.have_jpeg()
    with pytest.raises(RuntimeError, match="libjpeg"):
        native.decode_jpeg(b"\xff\xd8\xff\xe0")
    with pytest.raises(RuntimeError, match="libjpeg"):
        native.encode_jpeg(_noise(1, 8, 8))
    assert native.decode_image(b"\xff\xd8\xff\xe0") is None
    jpg = io.BytesIO()
    Image.fromarray(_noise(6, 24, 32)).save(jpg, "JPEG", quality=90)
    np.testing.assert_array_equal(native.decode_image(jpg.getvalue()),
                                  np.asarray(Image.open(io.BytesIO(jpg.getvalue())).convert("RGB")))
    buf = io.BytesIO()
    Image.fromarray(_noise(4, 12, 16)).save(buf, "PNG")
    np.testing.assert_array_equal(native.decode_image(buf.getvalue()), _noise(4, 12, 16))
    img = _noise(5, 720, 1280)
    np.testing.assert_array_equal(native.letterbox(img, 640, 640)[0],
                                  ref.letterbox(img, 640, 640)[0])


def test_threads_that_first_use_the_codec_together_build_it_once(monkeypatch, tmp_path):
    """Camera and executor threads reach the codec together on a fresh
    checkout: one compiles it and every thread gets the loaded library
    (before, all but the first found the shared temporary name moved away)."""
    import threading

    monkeypatch.setattr(build, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(build, "_host_lib", None)
    start, got, errors = threading.Barrier(4), [], []

    def first_use():
        start.wait()
        try:
            got.append(build.host_lib())
        except Exception as exc:  # noqa: BLE001 - the test reports it
            errors.append(exc)

    threads = [threading.Thread(target=first_use) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors, errors
    assert len(got) == 4 and all(lib is got[0] for lib in got)
    assert [p.name for p in tmp_path.iterdir()] == [os.path.basename(build.host_library_path())]


def test_failed_host_build_raises_with_the_compiler_output(monkeypatch):
    monkeypatch.setattr(build, "CXX_FLAGS", build.CXX_FLAGS + ["-fno-such-flag-here"])
    monkeypatch.setattr(build, "_host_lib", None)
    with pytest.raises(RuntimeError, match="(?s)host imaging build failed.*no-such-flag"):
        native.letterbox(_noise(1, 8, 8), 8, 8)
    assert not native.have_native()


def test_port_imports_neither_jax_nor_the_reference():
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    pkg = os.path.join(root, "facerecognition_infrenceengine_tpu_torch")
    files = [os.path.join(root, "chip_smoke.py"), os.path.join(root, "trace_stress.py")] + [
        os.path.join(d, f) for d, _, fs in os.walk(pkg) for f in fs if f.endswith(".py")]
    bad = re.compile(r"^\s*(import|from)\s+(jax|flax|facerecognition_infrenceengine_tpu)\b(?!_torch)")
    offending = []
    for path in files:
        with open(path) as f:
            offending += [f"{path}:{n}: {line.strip()}"
                          for n, line in enumerate(f, 1) if bad.match(line)]
    assert len(files) > 20 and not offending, offending
    scanned = {os.path.relpath(f, pkg) for f in files}
    assert {"engine/microbatch.py", "domain/cameras.py", "web/framework.py", "web/serving.py",
            "servers/inference_server.py", "api/__init__.py", "api/company.py",
            "api/constants.py", "api/docmodels.py", "api/embeddings.py", "api/employee.py",
            "api/entity.py", "api/utils.py", "api/visitor.py", "domain/campus.py",
            "domain/counting.py", "domain/enrollment.py", "domain/passes.py", "domain/qr.py",
            "web/ui/__init__.py", "servers/api_server.py", "servers/people_count.py",
            "servers/training_server.py"} <= scanned
