"""Device selection for the port's entry points."""

from __future__ import annotations

import torch

from .metrics import on_device


@on_device
def resolve_device(device=None) -> torch.device:
    """``None`` means ``cuda``.  A CUDA device with no card raises: nothing
    falls back to the CPU unless the caller asks for it.  A CUDA device with
    no index gets the calling thread's current one, so an engine or gallery
    records the card it was built on and the threads that serve it can bind
    to that card (:func:`bind_thread`).

    Resolving a CUDA device switches TF32 off for cuDNN convolutions and
    cuBLAS matmuls, process-wide: the port's float32 programs (engines,
    gallery snapshots, ``cosine_topk``) are true f32 on the card, as they
    are on the CPU, whichever entry point runs first.  bfloat16 programs do
    not read these flags."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "plain PyTorch path on the CPU")
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


@on_device
def bind_thread(device) -> None:
    """Make ``device`` (an engine's or a gallery's resolved device) the
    calling thread's current CUDA device: a thread PyTorch has not seen
    starts on device 0, and the kernels launch on the current device.
    None or a CPU device leaves the thread as it is."""
    if device is not None and torch.device(device).type == "cuda":
        torch.cuda.set_device(resolve_device(device))
