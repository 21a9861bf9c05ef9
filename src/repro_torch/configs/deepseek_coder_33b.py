"""deepseek-coder-33b [dense] — llama-arch. [arXiv:2401.14196]"""
import dataclasses

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="deepseek-coder-33b",
    arch_type="dense",
    num_layers=62,
    d_model=7168,
    num_heads=56,
    num_kv_heads=8,
    head_dim=128,
    d_ff=19_200,
    vocab_size=32_256,
    rope_theta=100_000.0,
    source="arXiv:2401.14196 (DeepSeek-Coder 33B)",
)


def smoke_config() -> ArchConfig:
    return dataclasses.replace(
        CONFIG, num_layers=2, d_model=128, num_heads=4, num_kv_heads=2,
        head_dim=32, d_ff=256, vocab_size=512)
