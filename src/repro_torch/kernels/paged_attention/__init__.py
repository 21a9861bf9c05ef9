"""Paged flash-decode: ``ops.paged_attention`` (CUDA kernel on the card,
``ref.paged_attention_ref`` on the CPU)."""
