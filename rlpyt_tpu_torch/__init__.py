"""rlpyt_tpu_torch — the PyTorch / CUDA port of rlpyt_tpu for NVIDIA Hopper.

Module names follow the JAX package (``rlpyt_tpu``) so each port can be
read beside its counterpart.  The port imports ``torch`` only; every
entry point takes a ``device`` argument that defaults to ``"cuda"``.
Kernels written by hand live under ``csrc/`` and are built on first use.
"""
__version__ = "0.1.0"
