"""PyTorch / CUDA port of ``repro`` for NVIDIA Hopper.

A second package beside the JAX package ``repro``, which stays the
reference: module paths mirror it (``repro_torch/kernels/engine.py`` is
the counterpart of ``repro/kernels/engine.py``). The port imports torch
and numpy and never jax or anything under ``repro``.

Entry points run on the card unless the caller asks for the CPU:
``device=None`` means ``"cuda"``, and a missing CUDA device raises (see
``repro_torch.device``). The Pallas kernels of the reference become
hand-written CUDA kernels under ``csrc/``, built with ``nvcc`` at first
use; on a CPU tensor each kernel wrapper runs its plain PyTorch version.
"""
