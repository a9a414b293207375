"""Feature padding. The JAX package pads the feature axis to 128 lanes for
the TPU; the port keeps 128 so that shapes match the reference. Zero
padding is exact for squared l2, and 128 is a multiple of the join
kernel's 64-feature tile."""
from __future__ import annotations

import torch

LANE = 128


def ceil_to(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def pad_features(x: torch.Tensor, lane: int = LANE) -> torch.Tensor:
    """Pad (n, d) -> (n, ceil(d/lane)*lane) with zeros."""
    n, d = x.shape
    dp = ceil_to(d, lane)
    if dp == d:
        return x
    return torch.nn.functional.pad(x, (0, dp - d))
