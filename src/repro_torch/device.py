"""Device resolution for the port's entry points."""

from __future__ import annotations

from typing import Union

import torch

DeviceSpec = Union[str, torch.device, None]


def resolve_device(device: DeviceSpec = None) -> torch.device:
    """``None`` means ``"cuda"``: entry points run on the card unless the
    caller asks for the CPU. A CUDA device that is not there raises —
    there is no silent CPU path."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port runs on the card by default; pass "
            "device='cpu' to run the plain versions on the CPU")
    return dev

