"""PyTorch/CUDA port of the Atomic Active Messages runtime.

Mirrors :mod:`repro` module by module (``repro_torch.core.commit`` is the
counterpart of ``repro.core.commit``, and so on) and imports nothing of
it: the JAX package is the reference the port is tested against.

Device rule: every public entry point that builds tensors takes
``device=`` and defaults to ``"cuda"``; functions that only take tensors
follow their inputs' device.  Without a card, asking for ``"cuda"``
raises — the port never moves to the CPU unasked.
"""
from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """``torch.device(device)``, raising if it names CUDA and no card is
    present."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} requested but no CUDA device is "
            "available; pass device='cpu' to run on the CPU")
    return dev
