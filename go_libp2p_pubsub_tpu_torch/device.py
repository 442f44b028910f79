"""The explicit-device rule: every entry point runs on the card unless the
caller asks for the CPU, and never falls back."""

from __future__ import annotations

import torch

DEFAULT_DEVICE = "cuda"


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``device`` as a ``torch.device``; ``None`` means ``cuda``.

    Raises when a CUDA device is asked for (explicitly or by default) and
    none is present — the plain CPU versions run only when the caller
    passes ``device="cpu"``."""
    dev = torch.device(DEFAULT_DEVICE if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch versions on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def check_on(device: torch.device, **tensors) -> None:
    """Raise unless every named tensor lies on ``device``."""
    for name, t in tensors.items():
        if t is not None and t.device.type != device.type:
            raise ValueError(
                f"{name} lies on {t.device}, expected {device}")
