"""grok-1-314b [moe] — 64L, 8 experts top-2. [hf:xai-org/grok-1]"""
import dataclasses

from repro_torch.configs.base import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="grok-1-314b",
    arch_type="moe",
    num_layers=64,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    head_dim=128,
    d_ff=32_768,
    vocab_size=131_072,
    moe=MoEConfig(num_experts=8, top_k=2, d_ff_expert=32_768),
    param_dtype="bfloat16",       # 314B params: fp32 replica would not fit 256 v5e
    mom_dtype="bfloat16",
    source="hf:xai-org/grok-1",
)


def smoke_config() -> ArchConfig:
    return dataclasses.replace(
        CONFIG, num_layers=2, d_model=128, num_heads=4, num_kv_heads=2,
        head_dim=32, d_ff=256, vocab_size=512,
        moe=MoEConfig(num_experts=4, top_k=2, d_ff_expert=256),
        param_dtype="float32", mom_dtype="float32")
