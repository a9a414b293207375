"""Where the port's entry points run: on a CUDA card unless the caller
asks for another device, and never silently on the CPU; and which host
of a ``torch.distributed`` job this process is."""
from __future__ import annotations

import torch


def pin_fp32() -> None:
    """fp32 means fp32: no TF32 in any matrix product or convolution."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def resolve_device(device, caller: str) -> torch.device:
    """``device`` as a ``torch.device``, "cuda" when None. A CUDA device
    with no card present raises; on a card, fp32 is pinned."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"{caller} runs on a CUDA device by default "
                               "and none is available; pass device='cpu' "
                               "to run on the CPU")
        pin_fp32()
    return device


def process_grid() -> tuple[int, int]:
    """(rank, world size) of the default ``torch.distributed`` process
    group when one exists, else (0, 1)."""
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1
