"""The device of the port's entry points.

``Schwarz``, ``Decomposition.from_subdomains``, ``pack_local_matrices``,
``interop.state_from_numpy`` and the driver twins put their tensors on the
card (``"cuda"``) unless the caller asks for the CPU. Where no CUDA device
is present they raise; they never move to the CPU on their own.
"""

from __future__ import annotations

import torch

DEFAULT = "cuda"


def as_device(device) -> torch.device:
    """``torch.device(device)``, refusing a CUDA device that is absent."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} was asked for but torch.cuda.is_available() "
            "is false: pass device='cpu' to run on the CPU")
    return dev


def synchronize(device: torch.device) -> None:
    """Wait for the work queued on ``device`` (a CUDA device; nothing to
    wait for on the CPU): the end of every timed setup phase."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
