"""Device selection for the port's entry points."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means ``cuda``.  A CUDA device with no card raises: nothing
    falls back to the CPU unless the caller asks for it.

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
    return dev
