"""Timing: the port's one clock and its CUDA-synchronizing probe."""
