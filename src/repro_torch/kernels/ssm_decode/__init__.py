"""Mamba-2 decode step: ``ops.ssm_decode`` (CUDA kernel on the card,
``ref.ssm_decode_ref`` on the CPU), each live slot's fp32 state read and
written once."""
