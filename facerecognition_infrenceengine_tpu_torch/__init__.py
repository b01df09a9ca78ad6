"""PyTorch/CUDA port of the face-recognition engine, for NVIDIA Hopper.

The JAX package ``facerecognition_infrenceengine_tpu`` is the reference:
this package mirrors its layout (``core/``, ``models/``, ``ops/``,
``engine/``) and names, keeps its NHWC layouts at every public function,
and is held against it by ``tests/test_torch_*.py``.  It imports torch and
numpy only, never JAX or the reference package.

The reference's four Pallas kernels are hand-written CUDA C++ for
``sm_90a`` (``csrc/``): the face warp (``ops/warp_kernel.py``), the gallery
top-1 for f32/bf16 and for int8 galleries (``ops/match_kernel.py``) and the
fused SCRFD stem of the packed / yuv420 streaming path
(``ops/stem_kernel.py``).  ``kernels/build.py`` compiles them with one
``nvcc`` call at first use and binds them through ``ctypes``.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
with no card and no such argument they raise.
"""

__version__ = "0.1.0"
