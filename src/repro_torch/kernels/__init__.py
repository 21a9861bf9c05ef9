"""Hand-written CUDA kernels of the port, each beside its plain PyTorch
version: ``paged_attention`` (paged flash-decode), ``flash_attention``
(forward flash attention), ``fused_update`` (the grouped momentum update),
``lowering_conv`` (the conv forward, wgrad and dgrad) and ``ssm_decode``
(the Mamba-2 decode recurrence). ``_build`` compiles ``*/csrc/*.cu`` at
first use."""
