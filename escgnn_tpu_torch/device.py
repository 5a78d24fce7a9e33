"""Device selection for the package's entry points.

Entry points take `device="cuda"` by default and never move work to the
CPU on their own: asking for CUDA on a machine without a card raises.
The CPU runs only when a caller names it (as the tests do).
"""

from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device 'cuda' requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run the plain PyTorch path"
        )
    return device
