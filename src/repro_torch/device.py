"""Device selection and feature probes (the counterpart of ``repro.compat``).

Nothing here touches the card at import time: the probes answer on
demand, and ``resolve_device`` is the one place an entry point turns its
``device`` argument into a ``torch.device``. Asking for
CUDA on a machine without it raises; there is no quiet drop to the CPU.
"""

from __future__ import annotations

import os
import shutil

import torch

CUDA_HOME = "/usr/local/cuda"


def default_device() -> torch.device:
    """Where entry points run unless told otherwise: the card."""
    return torch.device("cuda")


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``default_device()``; raise if CUDA is asked for and absent.
    ``"meta"`` (shapes without storage: ``launch.dryrun``) is taken as it is."""
    dev = default_device() if device is None else torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but torch.cuda.is_available() is "
            f"False; pass device='cpu' to run the plain PyTorch versions"
        )
    if dev.type not in ("cuda", "cpu", "meta"):
        raise ValueError(f"unsupported device {str(dev)!r}: use 'cuda', 'cpu' or 'meta'")
    return dev


def has_cuda() -> bool:
    return torch.cuda.is_available()


def nvcc_path() -> str | None:
    """The CUDA compiler: ``$PATH`` first, then the toolkit's default home."""
    found = shutil.which("nvcc")
    if found:
        return found
    cand = os.path.join(CUDA_HOME, "bin", "nvcc")
    return cand if os.access(cand, os.X_OK) else None


def features() -> dict:
    return {"cuda": has_cuda(), "nvcc": nvcc_path() is not None}
