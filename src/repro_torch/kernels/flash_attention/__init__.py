"""Forward flash attention: ``ops.flash_attention`` (CUDA kernel on the
card, ``ref.flash_attention_ref`` on the CPU)."""
