"""Where the port's entry points build their tensors.

Every entry point that creates tensors takes ``device``; ``None`` means the
NVIDIA card.  Without a card, ``None`` raises instead of dropping to the
CPU: the CPU runs only when the caller asks for it with ``device="cpu"``.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``device`` as a ``torch.device``; ``None`` is ``cuda``, and raises
    when no card is present."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device=\"cpu\" to run on the CPU")
    return torch.device("cuda")
