"""recurrentgemma-2b [hybrid] — RG-LRU + local attention, (rec,rec,attn) 1:2.
[arXiv:2402.19427 (Griffin)]"""
import dataclasses

from repro_torch.configs.base import ArchConfig, HybridConfig

CONFIG = ArchConfig(
    name="recurrentgemma-2b",
    arch_type="hybrid",
    num_layers=26,                # Griffin-2B depth; pattern (rec,rec,attn) cyclic
    d_model=2560,
    num_heads=10,
    num_kv_heads=1,               # MQA
    head_dim=256,
    d_ff=7680,
    vocab_size=256_000,
    hybrid=HybridConfig(pattern=("rec", "rec", "attn"),
                        d_rnn=2560, local_window=2048, conv_width=4),
    act="gelu",
    source="arXiv:2402.19427 (RecurrentGemma/Griffin 2B)",
)


def smoke_config() -> ArchConfig:
    return dataclasses.replace(
        CONFIG, num_layers=3, d_model=128, num_heads=4, num_kv_heads=1,
        head_dim=32, d_ff=256, vocab_size=512,
        hybrid=HybridConfig(pattern=("rec", "rec", "attn"),
                            d_rnn=128, local_window=32, conv_width=4))
