"""Device resolution shared by every entry point of the port.

An entry point runs on the card unless its caller asks for the CPU; when
no GPU is present and the caller did not ask for the CPU it raises — it
never carries on quietly on the CPU.  Every parity path runs float32 with
TF32 off (the JAX package runs float32 with x64 off).
"""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """``device`` as a ``torch.device``; raises if CUDA is asked for and absent.

    Also pins float32 matmuls and convolutions to full float32 (no TF32)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but CUDA is not available; "
            "pass device='cpu' to run on the CPU"
        )
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return dev
