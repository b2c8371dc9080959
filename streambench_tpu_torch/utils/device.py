"""Resolve the device an entry point runs on.

The counterpart of the JAX package's ``utils/platform.py:pin_jax_platform``.
Entry points run on the card unless the caller asks for the CPU: the
default is ``"cuda"``, and asking for CUDA where none is available raises
instead of carrying on quietly on the CPU.  Resolving a CPU device
initialises no CUDA context.
"""

from __future__ import annotations

import torch

DEFAULT_DEVICE = "cuda"


def resolve_device(device: torch.device | str | None = None) -> torch.device:
    """``torch.device`` for ``device`` (default ``"cuda"``); raises
    ``RuntimeError`` for CUDA when no CUDA device is available, and
    ``ValueError`` for device types the port does not run on."""
    dev = torch.device(DEFAULT_DEVICE if device is None else device)
    if dev.type == "cpu":
        return dev
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}: the port runs on "
                         "'cuda' or, when asked, 'cpu'")
    if not torch.cuda.is_available():
        raise RuntimeError(
            f"device {dev} requested but CUDA is not available "
            f"(torch {torch.__version__}, built for CUDA "
            f"{torch.version.cuda}); pass device='cpu' (CLI: --device cpu) "
            "to run on the CPU")
    return dev
