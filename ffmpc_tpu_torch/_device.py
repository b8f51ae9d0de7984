"""Device resolution shared by every constructor and entry point.

The package runs on the card unless the caller asks for the CPU: asking for
"cuda" where no card is present raises; nothing falls back to the CPU on its
own.
"""

from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """``torch.device`` for ``device``; raises if it names CUDA and no card
    is available."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device 'cuda' was requested but torch.cuda.is_available() is "
            "False; pass device='cpu' explicitly to run on the host")
    return dev
