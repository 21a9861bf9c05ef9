"""Fused grouped momentum-SGD update: ``ops.fused_update_cuda`` (CUDA kernel
on the card, ``ref.fused_update_ref`` on the CPU) and the tree-level
``ops.fused_group_update``."""
