"""Build and bind the hand-written CUDA kernels (``csrc/*.cu``) and the
host imaging library (``csrc/imagecodec.cc``).

One ``nvcc`` call compiles every ``.cu`` source for ``sm_90a`` into one
shared library with a plain C interface, which ``ctypes`` loads.  The host
codec is a second library, built by the host compiler (``g++``, no nvcc):
``-ffp-contract=off`` keeps every float operation rounding on its own, and
the JPEG codec is compiled in (``-DFRE_HAVE_JPEG -ljpeg``) only when a probe
finds ``jpeglib.h`` and links libjpeg.  Both libraries live under the
package's ``_build/`` directory, each named by a hash of its sources and
flags, and are built at first use (a temporary name, then ``os.replace``,
so concurrent builders never load a partial file).  A build failure raises
with the compiler's output: nothing falls back to the plain versions.

Loading a library, with its build where this checkout has none yet, is
the ``kernels.build`` timer (a span while spans are recorded; ``library``
"cuda" or "host").

Every CUDA C entry returns ``cudaGetLastError()`` after its launches;
``check`` raises on anything but 0.  A C entry launches on the calling
thread's current device, so each wrapper launches inside
``launch_device(tensor.device)``.
"""

from __future__ import annotations

import contextlib
import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading
import time

from ..core import metrics

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P, _I = ctypes.c_void_p, ctypes.c_int
# C entry -> argument types (pointers and the stream as c_void_p).
SIGNATURES = {
    # atlas, windows, mats, out, m, b, ha, wa, c, r, out_size, is_u8, packed, variant, stream
    "fre_warp_windows": [_P, _P, _P, _P, *[_I] * 10, _P],
    "fre_warp_windows_stage_rows": [],
    "fre_gallery_top1": [_P, _P, _I, _I, _I, _P, _P, _P, _P, _P],
    "fre_gallery_top1_rows_per_block": [],
    "fre_gallery_top1_int8": [_P, _P, ctypes.c_float, _I, _I, _P, _P, _P, _P, _P, _P],
    "fre_gallery_top1_int8_rows_per_block": [],
    "fre_fused_stem": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    "fre_fused_stem_bf16": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    # x, out, r, alpha, is_bf16, rows, c, BN_a (w, b, mean, var, eps), BN_b (same), stream
    "fre_epilogue": [_P, _P, _P, _P, _I, ctypes.c_longlong, _I, *[_P] * 4, ctypes.c_float,
                     *[_P] * 4, ctypes.c_float, _P],
    # x, a, out, gamma, beta, eps, is_bf16, rows, width, stream
    "fre_residual_layernorm": [_P, _P, _P, _P, _P, ctypes.c_float, _I, ctypes.c_longlong, _I,
                               _P],
}

# Host codec entry -> (restype, argument types).
_U8P, _F = ctypes.POINTER(ctypes.c_uint8), ctypes.c_float
_U8 = ctypes.c_uint8
_IMG_ARGS = [_U8P, _I, _I, _U8P, _I, _I]  # src, h, w, dst, oh, ow
HOST_SIGNATURES = {
    "fre_have_jpeg": (_I, []),
    "fre_resize_bilinear": (None, _IMG_ARGS),
    "fre_letterbox": (_F, _IMG_ARGS),
    "fre_letterbox_s2d4": (_F, _IMG_ARGS),
    "fre_letterbox_yuv420_s2d4": (_F, _IMG_ARGS),
    "fre_pack_s2d4": (_I, [_U8P, _I, _I, _U8P]),
    "fre_pack_yuv420_s2d4": (_I, [_U8P, _I, _I, _U8P]),
    "fre_fill_rect": (None, [_U8P, _I, _I, _I, _I, _I, _I, _U8, _U8, _U8, _F]),
    "fre_draw_rect": (None, [_U8P, _I, _I, _I, _I, _I, _I, _I, _U8, _U8, _U8]),
    "fre_draw_corners": (None, [_U8P, _I, _I, _I, _I, _I, _I, _I, _I, _U8, _U8, _U8]),
    "fre_draw_text": (None, [_U8P, _I, _I, _I, _I, ctypes.c_char_p, _I, _U8, _U8, _U8]),
    "fre_draw_bar": (None, [_U8P, _I, _I, _I, _I, _I, _I, _F, _U8, _U8, _U8]),
}
JPEG_SIGNATURES = {
    "fre_jpeg_decode": (_I, [ctypes.c_char_p, ctypes.c_long, _U8P,
                             ctypes.POINTER(_I), ctypes.POINTER(_I)]),
    "fre_jpeg_encode": (ctypes.c_long, [_U8P, _I, _I, _I, _U8P, ctypes.c_long]),
}
HOST_SOURCE = os.path.join(CSRC, "imagecodec.cc")
CXX_FLAGS = ["-O3", "-shared", "-fPIC", "-ffp-contract=off"]
_JPEG_PROBE = "#include <cstdio>\n#include <jpeglib.h>\nint main() { jpeg_std_error(nullptr); }\n"

_lib = None
_host_lib = None
_jpeg_flags = None
# one build at a time within the process: threads that first launch together
# (camera threads, executor threads) would otherwise compile to one temporary
# name, and all but the first would find it moved away
_build_lock = threading.RLock()
build_info: dict = {}  # command, seconds and ptxas report of this process's build


def sources() -> list:
    return sorted(glob.glob(os.path.join(CSRC, "*.cu")))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(glob.glob(os.path.join(CSRC, "*.cu*"))):
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:16]


def library_path() -> str:
    return os.path.join(BUILD_DIR, f"libfre_kernels_{_digest()}.so")


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (PATH, CUDA_HOME, /usr/local/cuda): "
                           "the CUDA kernels cannot be built")
    return path


def _compile(out: str, command, what: str):
    """Run ``command(tmp)``, a compiler call writing the library to ``tmp``,
    then move it to ``out`` -> (the command, seconds, compiler output).  A
    failure raises with the compiler's output."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = command(tmp)
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"{what} failed ({proc.returncode}):\n{' '.join(cmd)}\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)  # atomic: a concurrent build never sees a partial file
    return " ".join(cmd), seconds, proc.stdout + proc.stderr


def build() -> str:
    """Compile ``csrc/*.cu`` unless this source hash is already built;
    returns the library path."""
    with _build_lock:
        out = library_path()
        if not os.path.exists(out):
            cmd, seconds, report = _compile(
                out, lambda tmp: [nvcc(), *NVCC_FLAGS, "-o", tmp, *sources()], "nvcc")
            build_info.update(command=cmd, seconds=seconds, ptxas=report)
        return out


def lib() -> ctypes.CDLL:
    """The loaded kernel library, built first if needed."""
    global _lib
    if _lib is not None:
        return _lib
    with _build_lock:
        if _lib is not None:
            return _lib
        with metrics.timer("kernels.build", library="cuda"):
            loaded = ctypes.CDLL(build())
        for name, argtypes in SIGNATURES.items():
            fn = getattr(loaded, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = loaded
    return _lib


def launch_device(device):
    """Make ``device`` the calling thread's current CUDA device for a
    launch: a C entry's ``<<<>>>`` launch goes to the current device,
    whichever card the stream and pointers it is given belong to, so a
    thread driving shards on several cards would otherwise launch each on
    the wrong one.  No switch when ``device`` is already current (one card:
    always)."""
    import torch

    if device.index is None or device.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(device)


def cxx() -> str:
    for name in (os.environ.get("CXX"), "g++", "c++"):
        found = name and shutil.which(name)
        if found:
            return found
    raise RuntimeError("no C++ compiler (CXX, g++, c++): the host imaging library "
                       "cannot be built")


def jpeg_flags() -> list:
    """``["-DFRE_HAVE_JPEG", "-ljpeg"]`` when the compiler finds jpeglib.h
    and links libjpeg, else ``[]`` (probed once a process)."""
    global _jpeg_flags
    if _jpeg_flags is None:
        os.makedirs(BUILD_DIR, exist_ok=True)
        probe = os.path.join(BUILD_DIR, f"jpeg_probe.{os.getpid()}")
        proc = subprocess.run([cxx(), "-x", "c++", "-", "-ljpeg", "-o", probe],
                              input=_JPEG_PROBE, capture_output=True, text=True)
        if os.path.exists(probe):
            os.remove(probe)
        _jpeg_flags = ["-DFRE_HAVE_JPEG", "-ljpeg"] if proc.returncode == 0 else []
    return _jpeg_flags


def host_library_path() -> str:
    h = hashlib.sha256(" ".join(CXX_FLAGS + jpeg_flags()).encode())
    with open(HOST_SOURCE, "rb") as f:
        h.update(f.read())
    return os.path.join(BUILD_DIR, f"libfreimage_{h.hexdigest()[:16]}.so")


def build_host() -> str:
    """Compile ``csrc/imagecodec.cc`` with the host compiler unless this
    source hash is already built; returns the library path."""
    with _build_lock:
        out = host_library_path()
        if not os.path.exists(out):
            flags = jpeg_flags()
            cmd, seconds, _ = _compile(
                out, lambda tmp: [cxx(), *CXX_FLAGS, *flags[:1], HOST_SOURCE, *flags[1:],
                                  "-o", tmp], "the host imaging build")
            build_info.update(host_command=cmd, host_seconds=seconds)
        return out


def host_lib() -> ctypes.CDLL:
    """The loaded host imaging library, built first if needed."""
    global _host_lib
    if _host_lib is not None:
        return _host_lib
    with _build_lock:
        if _host_lib is not None:
            return _host_lib
        with metrics.timer("kernels.build", library="host"):
            loaded = ctypes.CDLL(build_host())
        sigs = dict(HOST_SIGNATURES)
        if loaded.fre_have_jpeg():
            sigs.update(JPEG_SIGNATURES)
        for name, (restype, argtypes) in sigs.items():
            fn = getattr(loaded, name)
            fn.restype, fn.argtypes = restype, argtypes
        _host_lib = loaded
    return _host_lib


def check(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")
