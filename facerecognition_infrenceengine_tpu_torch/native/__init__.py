"""Host-side imaging for the port: ctypes bindings over ``csrc/imagecodec.cc``.

The port's own copy of the reference's ``native/`` package
(``facerecognition_infrenceengine_tpu/native/__init__.py``), with the same
API on RGB uint8 HxWx3 numpy arrays:

- ``resize_bilinear(img, oh, ow)``, ``letterbox(img, oh, ow) -> (canvas,
  scale)``, ``letterbox_s2d4`` and ``letterbox_yuv420_s2d4`` at any scale;
  ``pack_s2d4`` and ``pack_yuv420_s2d4``;
- the HUD rasterizer, drawing in place: ``fill_rect``, ``draw_rect``,
  ``draw_corners``, ``draw_text``, ``draw_bar``;
- ``decode_jpeg``, ``encode_jpeg`` and ``decode_image`` (``None`` for an
  image that does not decode or exceeds ``MAX_DECODE_PIXELS``);
- ``have_native()`` and ``have_jpeg()``.

``kernels/build.py`` compiles the library with the host compiler at first
use.  A failed build raises with the compiler's output; nothing falls back
to numpy (``native/plain.py`` holds the plain versions the tests compare
against).  The JPEG codec is compiled in only where libjpeg is found:
without it the JPEG functions raise a ``RuntimeError`` naming libjpeg, and
``decode_image`` decodes other formats through PIL where PIL imports, as
the reference does.

The letterbox scale is the C++ float32 (640/1920 gives 0.33333334, not
1/3); callers map coordinates back with that same value.
"""

from __future__ import annotations

import ctypes
import io

import numpy as np

from ..kernels import build

MAX_DECODE_PIXELS = 64_000_000  # 64 MP cap: a crafted header must not drive
                                # a multi-GB allocation from 200 bytes


def _lib() -> ctypes.CDLL:
    return build.host_lib()


def have_native() -> bool:
    """Whether the host imaging library builds and loads here."""
    try:
        _lib()
    except (RuntimeError, OSError):
        return False
    return True


def have_jpeg() -> bool:
    """Whether the library carries the JPEG codec (libjpeg was found)."""
    return bool(_lib().fre_have_jpeg())


def _ptr(arr: np.ndarray):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def _check_img(img: np.ndarray) -> np.ndarray:
    if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"expected HxWx3 uint8 RGB, got {img.dtype} {img.shape}")
    if not img.flags["C_CONTIGUOUS"]:
        raise ValueError("image must be C-contiguous for in-place drawing")
    return img


def _check_canvas(oh: int, ow: int) -> None:
    if oh % 4 or ow % 4:
        raise ValueError(f"canvas must be a multiple of 4, got {oh}x{ow}")


# ------------------------------------------------------------------- codec
def _jpeg_lib() -> ctypes.CDLL:
    lib = _lib()
    if not lib.fre_have_jpeg():
        raise RuntimeError("the host imaging library was built without libjpeg "
                           "(jpeglib.h or -ljpeg not found): no JPEG codec")
    return lib


def decode_jpeg(data: bytes):
    """JPEG bytes -> HxWx3 RGB uint8, or None when the data does not decode
    (cv2.imdecode's contract); bytes that libjpeg rejects go to PIL, as in
    the reference."""
    lib = _jpeg_lib()
    h, w = ctypes.c_int(), ctypes.c_int()
    rc = lib.fre_jpeg_decode(data, len(data), None, ctypes.byref(h), ctypes.byref(w))
    if rc == -1:
        return _decode_pil(data)
    if h.value <= 0 or w.value <= 0 or h.value * w.value > MAX_DECODE_PIXELS:
        return None
    out = np.empty((h.value, w.value, 3), np.uint8)
    rc = lib.fre_jpeg_decode(data, len(data), _ptr(out), ctypes.byref(h), ctypes.byref(w))
    if rc != 0:
        return _decode_pil(data)
    return out


def decode_image(data: bytes):
    """Any supported image format -> RGB uint8, or None.  JPEG goes through
    the native codec (which hands other formats to PIL); without libjpeg,
    non-JPEG data still decodes through PIL and JPEG data raises."""
    if have_jpeg() or data[:2] == b"\xff\xd8":
        return decode_jpeg(data)
    return _decode_pil(data)


def _decode_pil(data: bytes):
    try:
        from PIL import Image
    except ImportError:
        return None
    try:
        with Image.open(io.BytesIO(data)) as im:
            # the native path's allocation cap holds here too
            if im.width * im.height > MAX_DECODE_PIXELS:
                return None
            return np.asarray(im.convert("RGB"), np.uint8)
    except Exception:
        return None


def encode_jpeg(img: np.ndarray, quality: int = 90) -> bytes:
    img = _check_img(np.ascontiguousarray(img))
    lib = _jpeg_lib()
    cap = img.size + 65536
    dst = np.empty(cap, np.uint8)
    n = lib.fre_jpeg_encode(_ptr(img), img.shape[0], img.shape[1], int(quality), _ptr(dst), cap)
    if n <= 0:
        raise RuntimeError(f"fre_jpeg_encode failed ({n})")
    return dst[:n].tobytes()


# ------------------------------------------------------------------ resize
def resize_bilinear(img: np.ndarray, oh: int, ow: int) -> np.ndarray:
    img = _check_img(np.ascontiguousarray(img))
    out = np.empty((oh, ow, 3), np.uint8)
    _lib().fre_resize_bilinear(_ptr(img), img.shape[0], img.shape[1], _ptr(out), oh, ow)
    return out


def _letterbox_into(fn, img: np.ndarray, shape: tuple, oh: int, ow: int):
    img = _check_img(np.ascontiguousarray(img))
    out = np.empty(shape, np.uint8)
    scale = fn(_ptr(img), img.shape[0], img.shape[1], _ptr(out), oh, ow)
    if scale <= 0:
        raise MemoryError(f"letterbox of a {img.shape[0]}x{img.shape[1]} frame failed")
    return out, float(scale)


def letterbox(img: np.ndarray, oh: int, ow: int):
    """Scale-preserving resize into a zero-padded (oh, ow) canvas, top-left
    anchored (the SCRFD det_size convention) -> (canvas, scale)."""
    return _letterbox_into(_lib().fre_letterbox, img, (oh, ow, 3), oh, ow)


def letterbox_s2d4(img: np.ndarray, oh: int, ow: int):
    """``letterbox`` written straight into the s2d4 layout [oh/4, ow/4, 48]
    -> (packed, scale)."""
    _check_canvas(oh, ow)
    return _letterbox_into(_lib().fre_letterbox_s2d4, img, (oh // 4, ow // 4, 48), oh, ow)


def letterbox_yuv420_s2d4(img: np.ndarray, oh: int, ow: int):
    """``letterbox`` then the yuv420 s2d4 pack [oh/4, ow/4, 24]: the
    streaming transport's encoder -> (packed, scale)."""
    _check_canvas(oh, ow)
    return _letterbox_into(_lib().fre_letterbox_yuv420_s2d4, img, (oh // 4, ow // 4, 24),
                           oh, ow)


def _pack(fn, img: np.ndarray, channels: int) -> np.ndarray:
    img = _check_img(np.ascontiguousarray(img))
    h, w = img.shape[:2]
    if h % 4 or w % 4:
        raise ValueError(f"H, W must be multiples of 4, got {h}x{w}")
    out = np.empty((h // 4, w // 4, channels), np.uint8)
    fn(_ptr(img), h, w, _ptr(out))
    return out


def pack_s2d4(img: np.ndarray) -> np.ndarray:
    """[H, W, 3] u8 canvas -> [H/4, W/4, 48] s2d4-packed (channel
    (p*4+q)*3+c = pixel (4Y+p, 4X+q, c)), the fused stem's input layout."""
    return _pack(_lib().fre_pack_s2d4, img, 48)


def pack_yuv420_s2d4(img: np.ndarray) -> np.ndarray:
    """[H, W, 3] RGB u8 -> [H/4, W/4, 24] packed 4:2:0 YUV in s2d4 layout
    (ch 0-15 Y of phase p*4+q, ch 16-19 U and 20-23 V of chroma block
    p2*2+q2), BT.601 full range: 1.5 B/px."""
    return _pack(_lib().fre_pack_yuv420_s2d4, img, 24)


# -------------------------------------------------------------- rasterizer
def _color3(color) -> tuple:
    r, g, b = (int(c) for c in color)
    return r, g, b


def fill_rect(img, y0, x0, y1, x1, color, alpha: float = 1.0):
    img = _check_img(img)
    _lib().fre_fill_rect(_ptr(img), img.shape[0], img.shape[1], int(y0), int(x0), int(y1),
                         int(x1), *_color3(color), float(alpha))
    return img


def draw_rect(img, y0, x0, y1, x1, color, thick: int = 2):
    img = _check_img(img)
    _lib().fre_draw_rect(_ptr(img), img.shape[0], img.shape[1], int(y0), int(x0), int(y1),
                         int(x1), int(thick), *_color3(color))
    return img


def draw_corners(img, y0, x0, y1, x1, color, length: int = 18, thick: int = 3):
    img = _check_img(img)
    _lib().fre_draw_corners(_ptr(img), img.shape[0], img.shape[1], int(y0), int(x0), int(y1),
                            int(x1), int(length), int(thick), *_color3(color))
    return img


def draw_text(img, y, x, text: str, color, scale: int = 1):
    img = _check_img(img)
    _lib().fre_draw_text(_ptr(img), img.shape[0], img.shape[1], int(y), int(x),
                         text.encode("ascii", "replace"), int(scale), *_color3(color))
    return img


def draw_bar(img, y0, x0, y1, x1, frac: float, color):
    img = _check_img(img)
    _lib().fre_draw_bar(_ptr(img), img.shape[0], img.shape[1], int(y0), int(x0), int(y1),
                        int(x1), float(frac), *_color3(color))
    return img
