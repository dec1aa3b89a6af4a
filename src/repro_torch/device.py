"""Device resolution for the port's entry points.

``device=None`` means the CUDA card: the port exists to run there, so a
missing card is an error, never a silent move to the CPU.  The CPU runs
only when a caller asks for it (``device="cpu"``), as the tests do; there
every kernel wrapper takes its plain PyTorch version."""
from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: the port runs on the card by default; "
                "pass device='cpu' to run the plain PyTorch versions")
        return torch.device("cuda")
    return torch.device(device)
