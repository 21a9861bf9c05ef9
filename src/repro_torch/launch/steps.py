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

``params_specs`` is the JAX ``params_specs`` (an ``eval_shape`` of
``init_params``): the full-size param tree on ``torch.device("meta")``,
every shape and dtype and nothing allocated, for ``launch.params_util``.
Of the JAX module's ``batch_specs`` only the modality stubs' shapes are
kept (``modality_inputs``); it, ``cache_specs_struct`` and
``make_train_step``'s ``grad_shardings`` are otherwise ``ShapeDtypeStruct``
/ GSPMD helpers of the XLA dry-run lane (ROADMAP Queue A item 15).
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


def modality_inputs(cfg: ArchConfig, lead: tuple, *, seed: int = 0,
                    device="cuda") -> dict:
    """The stub modality inputs of a batch with leading axes ``lead`` (e.g.
    ``(B,)``, or ``(grad_accum, b)``): ``{"enc_emb": (*lead, encoder_seq,
    d)}`` for encdec, ``{"img_emb": (*lead, num_image_tokens, d)}`` for
    vlm, ``{}`` otherwise; standard normals from ``numpy`` seeded by
    ``seed``, in the compute dtype on ``device``."""
    key, n = {"encdec": ("enc_emb", cfg.encoder_seq),
              "vlm": ("img_emb", cfg.num_image_tokens)}.get(cfg.arch_type,
                                                           (None, 0))
    if key is None:
        return {}
    x = np.random.default_rng(seed).standard_normal(
        tuple(lead) + (n, cfg.d_model), dtype=np.float32)
    return {key: torch.from_numpy(x).to(device=device,
                                        dtype=cfg.dtype("compute"))}


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
