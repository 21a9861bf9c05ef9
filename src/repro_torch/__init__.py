"""PyTorch/CUDA port of the ``repro`` package, written for an NVIDIA H100.

Same module layout and names as the JAX package (``src/repro/``), which
stays the reference; this package imports ``torch`` and numpy and never
JAX or ``repro``. The Pallas TPU kernels on a ported path are CUDA C++
kernels for ``sm_90a`` under ``kernels/<name>/csrc/``, built at first use
(``kernels/_build.py``). Ported so far: continuous-batching serving of
dense language models (``serving``), with the paged-decode and flash
attention kernels.
"""
