"""Hand-written CUDA kernels of the port, each beside its plain PyTorch
version: ``paged_attention`` (paged flash-decode) and ``flash_attention``
(forward flash attention). ``_build`` compiles ``*/csrc/*.cu`` at first use."""
