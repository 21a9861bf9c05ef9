"""Convolution by lowering + GEMM (paper §III) with its batched-GEMM
backward: the plain versions (``ref``, ``bwd``), the forward, wgrad and
dgrad kernels' wrappers (``lowering_conv.lowering_conv_cuda``,
``bwd.wgrad_cuda``, ``bwd.dgrad_cuda``), and the trainable
``torch.autograd.Function`` arms (``ops``)."""
