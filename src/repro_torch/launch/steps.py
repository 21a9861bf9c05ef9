"""Step factories for the language models (the JAX package's
``launch/steps.py``): the synchronous training step with gradient
accumulation, the prefill step and the decode step, and the long-context
window rule they share.

The ``vlm`` and ``encdec`` families take their modality frontends' outputs
as stubs in the batch: ``img_emb`` (B, num_image_tokens, d) and
``enc_emb`` (B, encoder_seq, d), as the JAX ``batch_specs`` shapes them;
``modality_inputs`` draws them from a numpy seed.

Training runs attention under autograd through ``full_attention`` or
``chunked_attention`` (``attn_impl="torch"``, the reference's ``"xla"``):
the flash kernel is forward-only, as the reference's Pallas kernel is, and
raises if asked for gradients. Prefill may take either arm; decode runs
``transformer.decode_step``. Prefill and decode run under ``no_grad``.

``params_specs``, ``batch_specs`` and ``cache_specs_struct`` are the JAX
functions of those names (``eval_shape`` / ``ShapeDtypeStruct`` trees):
the full-size param tree, a step's data inputs and a decode cache on
``torch.device("meta")``, every shape and dtype and nothing allocated.
They feed ``launch.params_util`` and the meta-device dry-run
(``launch.dryrun``), which counts the steps below on them. The JAX
``make_train_step``'s ``grad_shardings`` pins GSPMD layouts and has no
counterpart: the port's multi-device engine shards explicitly
(``engine.spmd``).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig, InputShape, TrainConfig
from repro_torch.core import tree as T
from repro_torch.core.async_sgd import accumulated_value_and_grad
from repro_torch.models import transformer as M
from repro_torch.optim.sgd import sgd_update

# sliding window used for the long_500k sub-quadratic attention variant
LONG_CONTEXT_WINDOW = 8192


def effective_window(cfg: ArchConfig, shape: InputShape) -> Optional[int]:
    """long_500k on attention-bearing archs runs the sliding-window variant
    (sub-quadratic); other shapes use the config's native attention."""
    if shape.name == "long_500k" and cfg.arch_type in ("dense", "moe", "vlm"):
        return LONG_CONTEXT_WINDOW
    return cfg.sliding_window


def supports_shape(cfg: ArchConfig, shape: InputShape) -> bool:
    """whisper-base: enc-dec over <=30s audio has no 500k-token decode
    regime (the long_500k shape is a decode-regime shape; an encoder
    bounded to 30s of audio never sees it)."""
    return not (cfg.arch_type == "encdec" and shape.name == "long_500k")


#: the stub modality input of each family: (batch key, config field of
#: its length)
_MODALITY = {"encdec": ("enc_emb", "encoder_seq"),
             "vlm": ("img_emb", "num_image_tokens")}


def modality_inputs(cfg: ArchConfig, lead: tuple, *, seed: int = 0,
                    device="cuda") -> dict:
    """The stub modality inputs of a batch with leading axes ``lead`` (e.g.
    ``(B,)``, or ``(grad_accum, b)``): ``{"enc_emb": (*lead, encoder_seq,
    d)}`` for encdec, ``{"img_emb": (*lead, num_image_tokens, d)}`` for
    vlm, ``{}`` otherwise; standard normals from ``numpy`` seeded by
    ``seed``, in the compute dtype on ``device``."""
    key, n = _MODALITY.get(cfg.arch_type, (None, 0))
    if key is None:
        return {}
    x = np.random.default_rng(seed).standard_normal(
        tuple(lead) + (getattr(cfg, n), cfg.d_model), dtype=np.float32)
    return {key: torch.from_numpy(x).to(device=device,
                                        dtype=cfg.dtype("compute"))}


def batch_specs(cfg: ArchConfig, shape: InputShape, *,
                grad_accum: int = 1) -> dict:
    """The data inputs of ``shape``'s step on the meta device, as the JAX
    ``batch_specs`` shapes them: "tokens" and "labels" (B, S) int32 for
    training, with a leading microbatch axis ``(grad_accum, B //
    grad_accum, S)`` when accumulating; "tokens" (B, S) for prefill and
    (B, 1) for decode; plus the modality stubs in the compute dtype
    (``modality_inputs``'s keys and shapes)."""
    B, S = shape.global_batch, shape.seq_len
    meta = torch.device("meta")
    if shape.kind == "train":
        if grad_accum > 1:
            if B % grad_accum:
                raise ValueError(f"batch {B} not divisible by grad_accum "
                                 f"{grad_accum}")
            lead = (grad_accum, B // grad_accum)
        else:
            lead = (B,)
        batch = {k: torch.empty(lead + (S,), dtype=torch.int32, device=meta)
                 for k in ("tokens", "labels")}
    else:
        lead = (B,)
        batch = {"tokens": torch.empty(
            (B, S if shape.kind == "prefill" else 1), dtype=torch.int32,
            device=meta)}
    key, n = _MODALITY.get(cfg.arch_type, (None, 0))
    if key is not None:
        batch[key] = torch.empty(lead + (getattr(cfg, n), cfg.d_model),
                                 dtype=cfg.dtype("compute"), device=meta)
    return batch


def cache_specs_struct(cfg: ArchConfig, shape: InputShape):
    """``transformer.init_cache`` for ``shape``'s batch and length at its
    ``effective_window``, on the meta device."""
    return M.init_cache(cfg, shape.global_batch, shape.seq_len,
                        effective_window(cfg, shape),
                        device=torch.device("meta"))


def params_specs(cfg: ArchConfig, seed: int = 0):
    """The param tree of ``transformer.init_params`` at full size on the
    meta device: shapes and dtypes, no storage, no draws."""
    gen = torch.Generator().manual_seed(seed)
    return M.init_params(gen, cfg, device=torch.device("meta"))


def make_train_step(cfg: ArchConfig, tc: TrainConfig, shape: InputShape,
                    *, attn_impl: str = "torch"):
    """Synchronous (g=1) SGD-momentum step, ``train_step(params, mom,
    batch) -> (params, mom, loss)``; ``batch`` holds "tokens", "labels"
    and, for vlm and encdec, the ``modality_inputs``. With
    ``tc.grad_accum > 1`` every ``batch`` leaf has a leading microbatch
    axis ``(grad_accum, b, ...)``;
    the losses and fp32 gradients of the microbatches are summed and
    divided by ``grad_accum``, then ``optim.sgd.sgd_update`` applies
    them. For g > 1, and for the whole training loop, see ``engine``."""
    window = effective_window(cfg, shape)

    def loss_fn(params, batch):
        return M.lm_loss(params, batch, cfg, attn_impl=attn_impl,
                         window=window)

    def train_step(params, mom, batch):
        loss, grads = accumulated_value_and_grad(loss_fn, params, batch,
                                                 tc.grad_accum)
        params, mom = sgd_update(params, T.unflatten(params, grads), mom,
                                 lr=tc.learning_rate, momentum=tc.momentum,
                                 weight_decay=tc.weight_decay)
        return params, mom, loss

    return train_step


def make_prefill_step(cfg: ArchConfig, shape: InputShape, *,
                      attn_impl: str = "torch"):
    """``prefill_step(params, batch) -> (last-position logits (B,1,V),
    cache)``, the cache ``transformer.forward``'s: ``{"blocks": {"k","v":
    (L,B,S,K,hd)}}`` for dense and MoE stacks, the final states for SSM and
    hybrid ones, with the cross K/V for vlm and encdec (whose ``batch``
    carries the ``modality_inputs``)."""
    window = effective_window(cfg, shape)

    @torch.no_grad()
    def prefill_step(params, batch):
        logits, _, cache = M.forward(params, batch, cfg, return_cache=True,
                                     attn_impl=attn_impl, window=window)
        return logits[:, -1:, :], cache

    return prefill_step


def make_decode_step(cfg: ArchConfig, shape: InputShape):
    """``decode_step(params, cache, batch, pos) -> (next token (B,1)
    int32, cache)``: the greedy (argmax, first of equals) next token after
    ``batch["tokens"]`` (B,1) at position ``pos``; the cache is updated in
    place."""
    window = effective_window(cfg, shape)

    @torch.no_grad()
    def decode_step(params, cache, batch, pos: int):
        logits, cache = M.decode_step(params, cache, batch["tokens"], pos,
                                      cfg, window=window)
        next_tok = logits[:, -1, :].argmax(dim=-1).to(torch.int32)
        return next_tok[:, None], cache

    return decode_step
