"""Step FLOPs on meta tensors (``repro_torch.launch.meta_count``) against
the JAX HLO walk (``repro.launch.hlo_parse.analyze_module``) of the same
step compiled for one device, on the smoke configs at 4 x 32 tokens: one
arch per family, the train step with remat off and on, the prefill step
and the decode step.

The dense, hybrid, vlm and encdec families, and every prefill and decode
step, count the same FLOPs to the flop. The MoE and SSM train steps differ
by the terms below, each an op that one side computes and the other does
not; the test holds the difference to their sum exactly, and to at most
2.5% of the JAX count.

Then the meta counts against real tensors: the same steps on CPU tensors
count the same FLOPs, the same FLOPs by op and the same live bytes.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke
from repro.configs.base import InputShape as JShape
from repro.configs.base import TrainConfig as JTrainConfig
from repro.launch import steps as JS
from repro.launch.hlo_parse import analyze_module
from repro_torch.configs import get_smoke_config
from repro_torch.configs.base import InputShape, TrainConfig
from repro_torch.core import tree as T
from repro_torch.launch import steps as S
from repro_torch.launch.meta_count import count_step
from repro_torch.models import moe
from repro_torch.models import transformer as M

B, SEQ = 4, 32
FAMILIES = ("qwen2-7b", "qwen2-moe-a2.7b", "mamba2-2.7b",
            "recurrentgemma-2b", "llama-3.2-vision-90b", "whisper-base")
MAX_GAP = 0.025                # the MoE / SSM gap, relative to JAX


def jax_flops(arch, kind, remat=True) -> float:
    cfg = dataclasses.replace(jax_smoke(arch), remat=remat)
    shape = JShape("t", SEQ, B, kind)
    p = JS.params_specs(cfg)
    b = JS.batch_specs(cfg, shape)
    if kind == "train":
        m = jax.tree.map(lambda x: jax.ShapeDtypeStruct(
            x.shape, cfg.dtype("mom")), p)
        step = JS.make_train_step(cfg, JTrainConfig(), shape)
        c = jax.jit(step).lower(p, m, b).compile()
    elif kind == "prefill":
        c = jax.jit(JS.make_prefill_step(cfg, shape)).lower(p, b).compile()
    else:
        c = jax.jit(JS.make_decode_step(cfg, shape)).lower(
            p, JS.cache_specs_struct(cfg, shape), b,
            jax.ShapeDtypeStruct((), jnp.int32)).compile()
    return analyze_module(c.as_text()).flops


def step_inputs(arch, kind, remat=True, device="meta"):
    """(step, its inputs) of the port on ``device``: meta specs, or
    on the CPU params from seed 0, zero momentum and numpy-seeded
    tokens and stubs."""
    cfg = dataclasses.replace(get_smoke_config(arch), remat=remat)
    shape = InputShape("t", SEQ, B, kind)
    if device == "meta":
        params = S.params_specs(cfg)
        batch = S.batch_specs(cfg, shape)
        cache = S.cache_specs_struct(cfg, shape)
    else:
        params = M.init_params(torch.Generator().manual_seed(0), cfg)
        rng = np.random.default_rng(0)
        batch = {k: torch.from_numpy(rng.integers(
            0, cfg.vocab_size, x.shape, dtype=np.int32))
            for k, x in S.batch_specs(cfg, shape).items()
            if k in ("tokens", "labels")}
        batch.update(S.modality_inputs(cfg, (B,), device="cpu"))
        cache = M.init_cache(cfg, B, SEQ, S.effective_window(cfg, shape))
    if kind == "train":
        mom = T.tree_map(lambda x: torch.zeros(
            x.shape, dtype=cfg.dtype("mom"), device=device), params)
        return S.make_train_step(cfg, TrainConfig(), shape), \
            (params, mom, batch)
    if kind == "prefill":
        return S.make_prefill_step(cfg, shape), (params, batch)
    return S.make_decode_step(cfg, shape), (params, cache, batch, SEQ - 1)


def port_flops(arch, kind, remat=True) -> int:
    step, args = step_inputs(arch, kind, remat)
    return count_step(step, *args).flops


def moe_gap(cfg, remat: bool) -> int:
    """JAX minus port, a train step of the MoE smoke config (one chunk of
    SEQ tokens a layer, t = SEQ·top_k (token, choice) rows):

    - the gates' gradient: the JAX backward of ``btec,bt,becd->btd``
      contracts the (b, t) gates with the rest as a dot of 2·B·t·E·C
      FLOPs; the port's ``opt_einsum`` path multiplies ``pos_oh`` by the
      gates elementwise first, so their gradient is a product and a sum;
    - remat only: the combine ``btec,bt,becd->btd`` itself (2·B·t·E·C·D):
      the port's checkpoint replays every op of the block, XLA's
      rematerialised block leaves it out (the backward reads its inputs,
      not its output)."""
    m = cfg.moe
    t, cap = SEQ * m.top_k, moe.capacity(SEQ, cfg)
    gates = 2 * B * t * m.num_experts * cap
    combine = gates * cfg.d_model
    return cfg.num_layers * (gates - (combine if remat else 0))


def ssm_gap(cfg, remat: bool) -> int:
    """JAX minus port, a train step of the SSD smoke config (one chunk of
    L = SEQ a layer; H heads of P, state N):

    - the final state's update ``blh,bln,blhp->bhpn`` (2·B·L·H·P·N): the
      port's ``ssm_forward`` returns h_final and computes it, which the
      loss never reads, so autograd takes no gradient through it; XLA
      drops it from the forward, and JAX's scan transpose carries a zero
      cotangent through it: two dots of 2·B·L·H·P·N and two of
      2·B·L·H·N. With remat the port's checkpoint computes it again;
    - the factors' gradients inside the three-operand einsums: JAX takes
      those of ``bln`` and ``blh`` in ``bln,blh,bhpn->blhp`` as two dots of
      2·B·L·H·N, and that of ``bls`` in ``bls,blsh,bshp->blhp`` as one of
      2·B·L·L·H; the port's ``opt_einsum`` path multiplies the factors
      elementwise first, so their gradients are products and sums."""
    s = cfg.ssm
    h = cfg.d_model * s.expand // s.head_dim
    big = 2 * B * SEQ * h * s.head_dim * s.state_dim
    small = 2 * B * SEQ * h * s.state_dim
    cb = 2 * B * SEQ * SEQ * h
    final_state = 2 * big + 2 * small - big * (2 if remat else 1)
    return cfg.num_layers * (final_state + 2 * small + cb)


@pytest.mark.parametrize("remat", [False, True], ids=["remat-off",
                                                      "remat-on"])
@pytest.mark.parametrize("arch", FAMILIES)
def test_train_step_flops_match_jax_hlo(arch, remat):
    want, got = jax_flops(arch, "train", remat), port_flops(arch, "train",
                                                            remat)
    cfg = get_smoke_config(arch)
    gap = {"moe": moe_gap, "ssm": ssm_gap}.get(cfg.arch_type)
    if gap is None:
        assert got == want
        return
    assert want - got == gap(cfg, remat) != 0
    assert abs(want - got) <= MAX_GAP * want


@pytest.mark.parametrize("kind", ["prefill", "decode"])
@pytest.mark.parametrize("arch", FAMILIES)
def test_inference_step_flops_match_jax_hlo(arch, kind):
    assert port_flops(arch, kind) == jax_flops(arch, kind)


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("arch", ["qwen2-7b", "qwen2-moe-a2.7b",
                                  "mamba2-2.7b", "whisper-base"])
def test_meta_counts_equal_cpu_tensors(arch, kind):
    step, args = step_inputs(arch, kind, device="meta")
    meta = count_step(step, *args)
    step, args = step_inputs(arch, kind, device="cpu")
    cpu = count_step(step, *args)
    assert meta == cpu
    assert meta.flops > 0 and meta.peak_live_bytes > 0
    if kind == "train":
        # the new params and momentum outlive the step
        cfg = get_smoke_config(arch)
        p = S.params_specs(cfg)
        assert meta.end_live_bytes >= sum(
            x.numel() * (x.element_size() + cfg.dtype("mom").itemsize)
            for x in T.leaves(p))


def test_live_bytes_count_each_storage_once_until_freed():
    def fn(x):
        y = x * 2                     # 4 KiB
        z = y.view(-1)                # same storage
        y.add_(1)                     # in place: same storage
        w = torch.empty(2048, device=x.device)   # 8 KiB
        del w                         # freed
        return z + 1                  # 4 KiB; y's storage dies with z

    x = torch.ones(1024)
    c = count_step(fn, x)
    assert c.flops == 0
    assert c.peak_live_bytes == 4096 + 8192
    assert c.end_live_bytes == 4096
