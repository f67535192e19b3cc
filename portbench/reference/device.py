"""Device choice of the plain reference: the card when there is one."""

from __future__ import annotations

import torch


def default_device(device=None) -> torch.device:
    if device is not None:
        return torch.device(device)
    return torch.device("cuda:0" if torch.cuda.is_available() else "cpu")
