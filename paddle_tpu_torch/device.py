"""Device selection shared by the port's entry points."""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """The torch.device an entry point runs on. Asking for CUDA on a
    machine without a usable card raises: the port never falls back to
    the CPU on its own, the caller passes ``device="cpu"`` for that."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={str(device)!r} asked for CUDA, but "
            "torch.cuda.is_available() is False; pass device='cpu' to run "
            "the port's plain PyTorch versions on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"the port runs on 'cuda' or 'cpu', got {device!r}")
    return dev
