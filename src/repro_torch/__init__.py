"""PyTorch + CUDA port of ``repro``'s serving and monitored training paths,
for NVIDIA Hopper.

The JAX package ``repro`` stays the reference; this package mirrors its
module paths (``configs``, ``layers``, ``kernels``, ``models``, ``serve``,
``optim``, ``data``, ``train``, ``core``, ``session``, ``launch``) and
imports nothing of it. Entry points run on ``cuda`` unless
the caller passes ``device="cpu"``; on the CPU every kernel wrapper takes
its plain PyTorch version, on a CUDA tensor it launches the kernel or
raises.

Convenience re-exports, resolved lazily so that ``import repro_torch``
imports neither torch's CUDA state nor any module of the port:

    repro_torch.start(...)      -> a started PerfSession (off unless env enables)
    repro_torch.PerfSession     -> repro_torch.session.PerfSession
    repro_torch.SessionConfig   -> repro_torch.session.SessionConfig
    repro_torch.null_session()  -> the shared disabled session
"""

from __future__ import annotations

import importlib

_SESSION_EXPORTS = ("start", "PerfSession", "SessionConfig", "null_session")

__all__ = [*_SESSION_EXPORTS, "session"]


def __getattr__(name: str):
    if name in _SESSION_EXPORTS:
        return getattr(importlib.import_module("repro_torch.session"), name)
    if name == "session":
        return importlib.import_module("repro_torch.session")
    raise AttributeError(f"module 'repro_torch' has no attribute {name!r}")


def __dir__():
    return sorted(set(globals()) | set(__all__))
