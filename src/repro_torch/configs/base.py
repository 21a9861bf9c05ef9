"""Architecture / run configuration, the PyTorch port's copy of the JAX
package's ``repro/configs/base.py``: the same frozen dataclasses with the
same fields, except that ``ArchConfig.dtype`` returns a ``torch.dtype``
and that ``ArchConfig`` has fields of its own for the port's hybrid_moe
family (Granite 4.0-H), each defaulting to what the other families do.

Every assigned architecture gets one module in ``repro_torch/configs/<id>.py``
exporting ``CONFIG`` (the full published config) and ``smoke_config()``
(a reduced same-family variant for CPU smoke tests).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    d_ff_expert: int
    num_shared_experts: int = 0
    router_aux_weight: float = 0.01


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    """Mamba-2 SSD block parameters."""
    state_dim: int = 128          # N
    head_dim: int = 64            # P
    expand: int = 2               # d_inner = expand * d_model
    chunk: int = 256              # SSD chunk length
    conv_width: int = 4           # short depthwise causal conv


@dataclasses.dataclass(frozen=True)
class HybridConfig:
    """RecurrentGemma / Griffin: repeating (recurrent, recurrent, local-attn)."""
    pattern: Tuple[str, ...] = ("rec", "rec", "attn")
    d_rnn: Optional[int] = None   # RG-LRU width (defaults to d_model)
    local_window: int = 2048
    conv_width: int = 4


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    arch_type: str                # dense | moe | ssm | hybrid | encdec | vlm
                                  # | hybrid_moe
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None
    # variants
    qkv_bias: bool = False
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    act: str = "swiglu"           # swiglu | gelu
    sliding_window: Optional[int] = None   # set for sub-quadratic attention variant
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    hybrid: Optional[HybridConfig] = None
    # encoder-decoder (whisper): encoder layers; frontend supplies embeddings
    encoder_layers: int = 0
    encoder_seq: int = 1500       # whisper-base audio frames after conv frontend (stub)
    # vlm: cross-attention to image patch embeddings every k-th layer
    cross_attn_every: int = 0
    num_image_tokens: int = 1024  # patch embeddings from stubbed vision tower
    # hybrid_moe (Granite 4.0-H): each layer's mixer, "mamba" or
    # "attention", the source's list; the first num_layers are run. Every
    # layer's FFN is a dropless MoE with a shared expert.
    layer_types: Optional[Tuple[str, ...]] = None
    # Granite's scalings: embeddings times embedding_multiplier, each
    # residual branch times residual_multiplier, logits over
    # logits_scaling, and attention_multiplier as the softmax scale (None:
    # 1/sqrt(head_dim))
    embedding_multiplier: float = 1.0
    residual_multiplier: float = 1.0
    logits_scaling: float = 1.0
    attention_multiplier: Optional[float] = None
    # hybrid_moe: the shared expert's SwiGLU width (None: num_shared_experts
    # x d_ff_expert), and the Mamba-2 output's gated norm, rms(y * silu(z))
    # before out_proj (off: y * silu(z))
    shared_d_ff: Optional[int] = None
    ssm_gated_norm: bool = False
    # numerics / memory
    param_dtype: str = "float32"
    mom_dtype: str = "float32"    # momentum buffer dtype (bf16 => ZeRO-ish footprint)
    compute_dtype: str = "bfloat16"
    remat: bool = True
    # citation for the config values
    source: str = ""

    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim is not None:
            return self.head_dim
        return self.d_model // max(self.num_heads, 1)

    @property
    def layer_kinds(self) -> Tuple[str, ...]:
        """hybrid_moe: the mixer of each layer that runs."""
        return tuple(self.layer_types[:self.num_layers])

    def dtype(self, which: str) -> torch.dtype:
        return _DTYPES[{"param": self.param_dtype,
                        "mom": self.mom_dtype,
                        "compute": self.compute_dtype}[which]]


@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str                     # train | prefill | decode

    @property
    def is_decode(self) -> bool:
        return self.kind == "decode"


INPUT_SHAPES = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Execution-strategy knobs: the paper's tradeoff space."""
    num_groups: int = 1           # g: compute groups (degree of asynchrony); S = g-1
    learning_rate: float = 0.01   # eta
    momentum: float = 0.9         # mu (explicit)
    weight_decay: float = 0.0     # lambda
    grad_accum: int = 1           # microbatch accumulation steps
    sync_head: bool = True        # paper's "merged FC": head params update synchronously
    remat_policy: str = "full"    # full | none | dots
