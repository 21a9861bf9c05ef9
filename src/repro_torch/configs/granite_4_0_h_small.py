"""granite-4.0-h-small [hybrid_moe] — Mamba-2 and GQA (NoPE) mixers in a 9:1
pattern, a dropless 72-expert top-10 MoE with a shared expert in every
layer. [hf:ibm-granite/granite-4.0-h-small]"""
import dataclasses

from repro_torch.configs.base import ArchConfig, MoEConfig, SSMConfig

#: the source's ``layer_types``: attention at layers 5, 15, 25 and 35
LAYER_TYPES = tuple("attention" if i % 10 == 5 else "mamba"
                    for i in range(40))

CONFIG = ArchConfig(
    name="granite-4.0-h-small",
    arch_type="hybrid_moe",
    num_layers=40,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=768,                     # per-expert FFN width
    vocab_size=100_352,
    rope_theta=0.0,               # position_embedding_type "nope"
    norm_eps=1e-5,
    tie_embeddings=True,
    moe=MoEConfig(num_experts=72, top_k=10, d_ff_expert=768,
                  num_shared_experts=1),
    ssm=SSMConfig(state_dim=128, head_dim=64, expand=2, chunk=256,
                  conv_width=4),
    shared_d_ff=1536,
    ssm_gated_norm=True,
    layer_types=LAYER_TYPES,
    embedding_multiplier=12.0,
    residual_multiplier=0.22,
    logits_scaling=16.0,
    attention_multiplier=0.0078125,
    source="hf:ibm-granite/granite-4.0-h-small",
)


def smoke_config() -> ArchConfig:
    """One period of the pattern cut to 4 layers (attention third), at
    small widths."""
    return dataclasses.replace(
        CONFIG, num_layers=4, d_model=64, num_heads=4, num_kv_heads=2,
        head_dim=16, d_ff=32, vocab_size=256,
        layer_types=("mamba", "mamba", "attention", "mamba"),
        moe=MoEConfig(num_experts=8, top_k=3, d_ff_expert=32,
                      num_shared_experts=1),
        ssm=SSMConfig(state_dim=8, head_dim=16, expand=2, chunk=8,
                      conv_width=4),
        shared_d_ff=48,
        attention_multiplier=1.0 / 16)
