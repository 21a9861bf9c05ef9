"""llama3-405b [dense] — 126L GQA, 128k vocab. [arXiv:2407.21783]"""
import dataclasses

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="llama3-405b",
    arch_type="dense",
    num_layers=126,
    d_model=16_384,
    num_heads=128,
    num_kv_heads=8,
    head_dim=128,
    d_ff=53_248,
    vocab_size=128_256,
    rope_theta=500_000.0,
    # 405B params: fp32 params+momentum = 3.2 TB > 256x16GB. bf16 keeps the
    # single-pod dry-run within HBM; the multi-pod mesh is the realistic home.
    param_dtype="bfloat16",
    mom_dtype="bfloat16",
    source="arXiv:2407.21783 (Llama 3.1 405B)",
)


def smoke_config() -> ArchConfig:
    return dataclasses.replace(
        CONFIG, num_layers=2, d_model=128, num_heads=4, num_kv_heads=2,
        head_dim=32, d_ff=256, vocab_size=512,
        param_dtype="float32", mom_dtype="float32")
