"""Build and bind the hand-written CUDA kernels (``csrc/*.cu``).

One ``nvcc`` call compiles every source for ``sm_90a`` into one shared
library with a plain C interface, which ``ctypes`` loads.  The library
lives under the package's ``_build/`` directory, named by a hash of the
sources and flags, and is built at first use.  A build failure raises:
nothing falls back to the plain PyTorch versions.

Every C entry returns ``cudaGetLastError()`` after its launches;
``check`` raises on anything but 0.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P, _I = ctypes.c_void_p, ctypes.c_int
# C entry -> argument types (pointers and the stream as c_void_p).
SIGNATURES = {
    "fre_warp_rois": [_P, _P, _P, _I, _I, _I, _I, _P],
    "fre_gallery_top1": [_P, _P, _I, _I, _I, _P, _P, _P, _P, _P],
    "fre_gallery_top1_rows_per_block": [],
    "fre_gallery_top1_int8": [_P, _P, ctypes.c_float, _I, _I, _P, _P, _P, _P, _P, _P],
    "fre_gallery_top1_int8_rows_per_block": [],
    "fre_fused_stem": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    "fre_fused_stem_bf16": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
}

_lib = None
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


def build() -> str:
    """Compile ``csrc/*.cu`` unless this source hash is already built;
    returns the library path."""
    out = library_path()
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [nvcc(), *NVCC_FLAGS, "-o", tmp, *sources()]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)  # atomic: a concurrent build never sees a partial file
    build_info.update(command=" ".join(cmd), seconds=seconds,
                      ptxas=proc.stdout + proc.stderr)
    return out


def lib() -> ctypes.CDLL:
    """The loaded kernel library, built first if needed."""
    global _lib
    if _lib is None:
        loaded = ctypes.CDLL(build())
        for name, argtypes in SIGNATURES.items():
            fn = getattr(loaded, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = loaded
    return _lib


def check(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")
