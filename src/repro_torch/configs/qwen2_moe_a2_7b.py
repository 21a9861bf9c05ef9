"""qwen2-moe-a2.7b [moe] — 60 routed experts top-4 + 4 shared. [hf:Qwen/Qwen1.5-MoE-A2.7B]"""
import dataclasses

from repro_torch.configs.base import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="qwen2-moe-a2.7b",
    arch_type="moe",
    num_layers=24,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    head_dim=128,
    d_ff=1408,                    # per-expert FFN width
    vocab_size=151_936,
    qkv_bias=True,
    moe=MoEConfig(num_experts=60, top_k=4, d_ff_expert=1408,
                  num_shared_experts=4),
    source="hf:Qwen/Qwen1.5-MoE-A2.7B",
)


def smoke_config() -> ArchConfig:
    return dataclasses.replace(
        CONFIG, num_layers=2, d_model=128, num_heads=4, num_kv_heads=4,
        head_dim=32, d_ff=64, vocab_size=512,
        moe=MoEConfig(num_experts=4, top_k=2, d_ff_expert=64,
                      num_shared_experts=1))
