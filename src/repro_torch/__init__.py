"""PyTorch/CUDA port of the ILP-M single-image CNN inference system.

The JAX package ``repro`` is the reference; this package mirrors its
layout (``core/``, ``configs/``, ``models/``, ``kernels/``, ``serving/``,
``runtime/``) and runs its kernels as CUDA C++ written for Hopper
(``csrc/``); on the card its engine replays CUDA graphs where the
reference jits. It imports neither JAX nor anything of ``repro``.
"""
