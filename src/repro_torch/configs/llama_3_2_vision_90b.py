"""llama-3.2-vision-90b [vlm] — cross-attn image layers every 5th layer; the
vision tower (ViT + projector) is a STUB: input_specs supplies precomputed
patch embeddings. [hf:meta-llama/Llama-3.2-11B-Vision, scaled per 90B card]"""
import dataclasses

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="llama-3.2-vision-90b",
    arch_type="vlm",
    num_layers=100,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=28_672,
    vocab_size=128_256,
    rope_theta=500_000.0,
    cross_attn_every=5,           # 20 cross-attn layers in 100
    num_image_tokens=1024,        # stubbed ViT output tokens
    param_dtype="bfloat16",
    mom_dtype="bfloat16",
    source="hf:meta-llama/Llama-3.2-11B-Vision (90B scaling)",
)


def smoke_config() -> ArchConfig:
    return dataclasses.replace(
        CONFIG, num_layers=5, d_model=128, num_heads=4, num_kv_heads=2,
        head_dim=32, d_ff=256, vocab_size=512, cross_attn_every=5,
        num_image_tokens=16, param_dtype="float32", mom_dtype="float32")
