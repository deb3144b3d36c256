"""Device selection for the port's entry points.

Entry points run on the card unless the caller passes ``device="cpu"``.
Asking for CUDA where there is none raises: nothing carries on quietly on
the CPU.
"""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """``device`` as a :class:`torch.device`; raises RuntimeError when a
    CUDA device is asked for and none is available."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {dev} requested but CUDA is not available; pass "
            "device='cpu' to run on the host"
        )
    return dev
