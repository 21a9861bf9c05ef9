"""whisper-base [audio] — enc-dec transformer backbone; conv frontend is a STUB
(input_specs supplies precomputed mel-frame embeddings). [arXiv:2212.04356]"""
import dataclasses

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="whisper-base",
    arch_type="encdec",
    num_layers=6,                 # decoder layers
    encoder_layers=6,
    encoder_seq=1500,             # 30s audio -> 1500 frames after conv frontend (stubbed)
    d_model=512,
    num_heads=8,
    num_kv_heads=8,
    d_ff=2048,
    vocab_size=51_865,
    act="gelu",
    rope_theta=0.0,               # whisper uses learned/sinusoidal positions, not RoPE
    source="arXiv:2212.04356 (Whisper base)",
)


def smoke_config() -> ArchConfig:
    return dataclasses.replace(
        CONFIG, num_layers=2, encoder_layers=2, encoder_seq=64,
        d_model=128, num_heads=4, num_kv_heads=4, d_ff=256, vocab_size=512)
