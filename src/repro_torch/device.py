"""The port's one device rule: an entry point that touches a device runs on
the card unless its caller asks for another device.

``None`` means ``torch.device("cuda")``.  Asking for CUDA on a machine
without a usable card raises here, at the entry point, instead of quietly
running the plain CPU versions: a CPU run is only ever one the caller chose
(``device="cpu"``, as the tests do).
"""
from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    dev = torch.device("cuda") if device is None else torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA device requested but torch.cuda.is_available() is false; "
            "pass device='cpu' to run the plain versions on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}; expected cuda or cpu")
    return dev
