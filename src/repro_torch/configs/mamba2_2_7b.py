"""mamba2-2.7b [ssm] — SSD (state-space duality), attention-free. [arXiv:2405.21060]"""
import dataclasses

from repro_torch.configs.base import ArchConfig, SSMConfig

CONFIG = ArchConfig(
    name="mamba2-2.7b",
    arch_type="ssm",
    num_layers=64,
    d_model=2560,
    num_heads=0,                  # attention-free
    num_kv_heads=0,
    d_ff=0,                       # no separate FFN (SSD block is the mixer)
    vocab_size=50_280,
    ssm=SSMConfig(state_dim=128, head_dim=64, expand=2, chunk=256, conv_width=4),
    source="arXiv:2405.21060 (Mamba-2 2.7B)",
)


def smoke_config() -> ArchConfig:
    return dataclasses.replace(
        CONFIG, num_layers=2, d_model=128, vocab_size=512,
        ssm=SSMConfig(state_dim=16, head_dim=16, expand=2, chunk=32, conv_width=4))
