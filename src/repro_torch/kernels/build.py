"""Build the CUDA sources under ``repro_torch/csrc`` at first use.

Each ``.cu`` file compiles with ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface, loaded through ``ctypes``. Libraries go
to ``build/repro_torch/`` at the repository root (listed in
``.gitignore``), named by a hash of the source and the flags, so an edit
rebuilds and an unchanged tree reuses. A failed build raises with the
compiler's output.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import subprocess
import threading

from repro_torch import device as D

PKG = pathlib.Path(__file__).resolve().parent.parent
CSRC = PKG / "csrc"
BUILD_DIR = PKG.parent.parent / "build" / "repro_torch"

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_lock = threading.Lock()


def library_path(name: str) -> pathlib.Path:
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(
        src.read_bytes() + " ".join(NVCC_FLAGS).encode()
    ).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def compile_library(name: str) -> pathlib.Path:
    """Compile ``csrc/<name>.cu`` unless the hashed library exists.

    The ptxas report (registers, shared memory, spills) is kept beside the
    library as ``<lib>.log``."""
    out = library_path(name)
    if out.exists():
        return out
    nvcc = D.nvcc_path()
    if nvcc is None:
        raise RuntimeError(
            f"cannot build {name}.cu: no nvcc on PATH or under {D.CUDA_HOME}"
        )
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}) building {name}.cu:\n"
            f"{proc.stdout}\n{proc.stderr}"
        )
    out.with_name(out.name + ".log").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, out)
    return out


@functools.cache
def load_library(name: str) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<name>.cu``'s shared library."""
    with _lock:
        return ctypes.CDLL(str(compile_library(name)))
