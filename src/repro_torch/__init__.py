"""PyTorch + CUDA port of ``repro``'s serving and monitored training paths,
for NVIDIA Hopper.

The JAX package ``repro`` stays the reference; this package mirrors its
module paths (``configs``, ``layers``, ``kernels``, ``models``, ``serve``,
``optim``, ``data``, ``train``, ``core``, ``session``, ``launch``) and
imports nothing of it. Entry points run on ``cuda`` unless
the caller passes ``device="cpu"``; on the CPU every kernel wrapper takes
its plain PyTorch version, on a CUDA tensor it launches the kernel or
raises.
"""
