"""Device choice for the port, explicit and free of side effects.

``NGSBITS_TORCH_DEVICE`` selects ``cuda`` (the default) or ``cpu``. Asking for
``cuda`` where no CUDA device is available raises: the port never falls back
to the CPU on its own. Under a process group (``parallel/mesh.py``) each rank
takes the card ``LOCAL_RANK % device_count``.
"""

from __future__ import annotations

import os

import torch

ENV = "NGSBITS_TORCH_DEVICE"


def device_type() -> str:
    """``cuda`` or ``cpu``, as ``NGSBITS_TORCH_DEVICE`` names it (default
    ``cuda``); raises for ``cuda`` without a CUDA device."""
    name = os.environ.get(ENV, "").strip().lower() or "cuda"
    if name not in ("cuda", "cpu"):
        raise ValueError(f"{ENV} must be 'cuda' or 'cpu', got '{name}'")
    if name == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"{ENV}=cuda but no CUDA device is available "
                           f"(set {ENV}=cpu to run on the CPU)")
    return name


def local_rank() -> int:
    """The rank's index on its host: ``LOCAL_RANK`` (torchrun sets it), else
    the rank in the process group, else 0."""
    if "LOCAL_RANK" in os.environ:
        return int(os.environ["LOCAL_RANK"])
    dist = torch.distributed
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def device() -> torch.device:
    """The device named by ``NGSBITS_TORCH_DEVICE`` (default ``cuda``); under
    a process group the rank's card."""
    name = device_type()
    dist = torch.distributed
    if name == "cuda" and dist.is_available() and dist.is_initialized():
        return torch.device("cuda", local_rank() % torch.cuda.device_count())
    return torch.device(name)
