"""Device resolution shared by every public entry point of the port.

``device=None`` means the CUDA card. When no card is visible the entry
point raises `RuntimeError` instead of quietly running on the CPU; the
CPU is used only when a caller asks for it (``device="cpu"``), as the
tests do.
"""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """The torch device an entry point runs on (None -> ``cuda``).

    Raises RuntimeError for a CUDA device when CUDA is unavailable.
    Resolving a CUDA device also pins fp32 matmuls to full precision:
    the predictor's blocked prefix sum is a matmul whose tolerances
    assume fp32, and TF32 keeps only ~3 decimal digits.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch: CUDA is not available; pass device='cpu' to "
                "run on the CPU")
        torch.backends.cuda.matmul.allow_tf32 = False
    return dev
