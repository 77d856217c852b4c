"""PyTorch + CUDA port of the ``repro`` serving path, for NVIDIA Hopper.

The JAX package ``repro`` stays the reference; this package mirrors its
module paths (``configs``, ``layers``, ``kernels``, ``models``, ``serve``,
``launch``) and imports nothing of it. Entry points run on ``cuda`` unless
the caller passes ``device="cpu"``; on the CPU every kernel wrapper takes
its plain PyTorch version, on a CUDA tensor it launches the kernel or
raises.
"""
