"""The device of an entry point: the card unless the caller asks for the CPU."""

from __future__ import annotations

from typing import Union

import torch

from kantts_tpu_torch.parallel.mesh import local_device


def resolve_device(device: Union[str, torch.device] = "cuda") -> torch.device:
    """``"cuda"`` (the entry points' default) or ``"cpu"`` -> a torch device;
    raises for ``"cuda"`` when there is no card, never falls back. Under
    torchrun (``LOCAL_RANK`` set) each rank gets its own card,
    ``cuda:LOCAL_RANK``."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device; pass --device cpu to run on the CPU")
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"device must be cuda or cpu, got {device}")
    return local_device(device)


def synchronize(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)
