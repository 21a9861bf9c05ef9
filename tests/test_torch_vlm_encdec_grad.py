"""Port parity: ``transformer.lm_loss``, its gradients and
``steps.make_train_step`` for the vlm and encdec families against the JAX
package (the configs, params and helpers of ``test_torch_vlm_encdec.py``;
B = 2 sequences of 12 tokens with their stub modality inputs):

- fp32: the loss within 1e-6 relative and every leaf's gradient within
  1e-5 relative RMS of ``jax.value_and_grad``; remat on and off give the
  same bits;
- bf16 compute (the configs' default): forward logits and every leaf's
  gradient within 5e-2 relative RMS of JAX's bf16, and no further from
  the fp32 result than 1.5 x JAX's own distance from it;
- ``make_train_step`` (SGD with momentum and weight decay; one batch, and
  two microbatches accumulated): the loss and the updated params and
  momentum of two steps within 1e-4 of JAX's.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import transformer as JT
from repro_torch.core import tree as T
from repro_torch.core.async_sgd import value_and_grad
from repro_torch.models import transformer as M
from test_torch_vlm_encdec import (B, SEQ, TOL, _cfgs, _np_params, _params,
                                   _tokens, _trees_close)

LOSS_RTOL, GRAD_RMS = 1e-6, 1e-5
BF16_RMS, BF16_RATIO = 5e-2, 1.5
CASES = ("encdec", "vlm7")


def _rel_rms(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _batch(case, seed, lead=(B,)):
    """tokens, labels and the stub modality input, numpy."""
    from repro_torch.launch.steps import modality_inputs
    toks = _tokens(seed, lead + (SEQ + 1,))
    out = {"tokens": toks[..., :-1].copy(), "labels": toks[..., 1:].copy()}
    out.update({k: v.numpy() for k, v in modality_inputs(
        _cfgs(case)[1], lead, seed=seed, device="cpu").items()})
    return out


@functools.lru_cache(maxsize=None)
def _jit_grad(case, compute):
    jcfg = _cfgs(case, compute)[0]
    return jax.jit(jax.value_and_grad(functools.partial(JT.lm_loss,
                                                        cfg=jcfg)))


def _jax_loss_grads(case, batch, compute="float32"):
    jp = _params(case)[0]
    loss, grads = _jit_grad(case, compute)(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})
    return float(loss), [np.asarray(g, np.float32)
                         for g in jax.tree.leaves(grads)]


def _port_loss_grads(tcfg, case, batch):
    tp = _params(case)[1]
    loss, grads = value_and_grad(
        lambda p, b: M.lm_loss(p, b, tcfg), tp,
        {k: torch.from_numpy(v) for k, v in batch.items()})
    return float(loss), [g.float().numpy() for g in grads]


@pytest.mark.parametrize("case", CASES)
def test_lm_loss_and_leaf_grads_match_jax(case):
    _, tcfg = _cfgs(case)
    batch = _batch(case, 3)
    jl, jg = _jax_loss_grads(case, batch)
    tl, tg = _port_loss_grads(tcfg, case, batch)
    assert abs(tl - jl) <= LOSS_RTOL * abs(jl)
    assert len(tg) == len(jg) == len(T.leaves(_params(case)[1]))
    for i, (a, b) in enumerate(zip(tg, jg)):
        assert a.shape == b.shape
        assert np.abs(b).max() > 0, f"leaf {i} has no gradient"
        assert _rel_rms(a, b) <= GRAD_RMS, \
            f"leaf {i}: {_rel_rms(a, b)} > {GRAD_RMS}"


@pytest.mark.parametrize("case", CASES)
def test_remat_on_and_off_give_the_same_gradient_bits(case):
    batch = _batch(case, 4)
    on = _port_loss_grads(_cfgs(case, remat=True)[1], case, batch)
    off = _port_loss_grads(_cfgs(case, remat=False)[1], case, batch)
    assert on[0] == off[0]
    for a, b in zip(on[1], off[1]):
        assert np.array_equal(a, b)


def _two_ways(what, port, jax_bf16, fp32):
    cross = _rel_rms(port, jax_bf16)
    mine, theirs = _rel_rms(port, fp32), _rel_rms(jax_bf16, fp32)
    assert cross <= BF16_RMS, f"{what}: port vs JAX {cross:.3e}"
    assert mine <= BF16_RATIO * theirs, (
        f"{what}: port {mine:.3e} from fp32, JAX {theirs:.3e}")


@pytest.mark.parametrize("case", CASES)
def test_bf16_forward_logits_and_leaf_grads_match_jax(case):
    (j16, t16), (_, t32) = _cfgs(case, "bfloat16"), _cfgs(case)
    jp, tp = _params(case)
    batch = _batch(case, 6)
    fwd = {k: v for k, v in batch.items() if k != "labels"}
    tb = {k: torch.from_numpy(v) for k, v in fwd.items()}
    truth = M.forward(tp, tb, t32)[0]
    lj = jax.jit(functools.partial(JT.forward, cfg=j16))(
        jp, {k: jnp.asarray(v) for k, v in fwd.items()})[0]
    lt = M.forward(tp, tb, t16)[0]
    _two_ways("forward logits", lt.numpy(), np.asarray(lj), truth.numpy())
    batch = _batch(case, 7)
    _, truth = _port_loss_grads(t32, case, batch)
    _, jg = _jax_loss_grads(case, batch, "bfloat16")
    _, tg = _port_loss_grads(t16, case, batch)
    for i, (a, b, c) in enumerate(zip(tg, jg, truth)):
        _two_ways(f"leaf {i} gradient", a, b, c)


@pytest.mark.parametrize("accum", [1, 2])
@pytest.mark.parametrize("case", CASES)
def test_make_train_step_matches_jax(case, accum):
    from repro.configs.base import InputShape as JInputShape
    from repro.configs.base import TrainConfig as JTrainConfig
    from repro.launch import steps as JS
    from repro.optim.sgd import init_momentum as j_init_momentum
    from repro_torch.configs.base import InputShape, TrainConfig
    from repro_torch.launch import steps as S
    from repro_torch.optim.sgd import init_momentum
    jcfg, tcfg = _cfgs(case)
    tc = dict(learning_rate=0.05, momentum=0.6, weight_decay=0.01,
              grad_accum=accum)
    jstep = jax.jit(JS.make_train_step(jcfg, JTrainConfig(**tc), JInputShape(
        "t", SEQ, B * accum, "train")))
    tstep = S.make_train_step(tcfg, TrainConfig(**tc), InputShape(
        "t", SEQ, B * accum, "train"))
    jp = jax.tree.map(jnp.asarray, _np_params(case))
    tp = _params(case)[1]
    jm, tm = j_init_momentum(jp), init_momentum(tp)
    lead = (accum, B) if accum > 1 else (B,)
    for step in range(2):
        batch = _batch(case, 20 + step, lead)
        jp, jm, jl = jstep(jp, jm, {k: jnp.asarray(v)
                                    for k, v in batch.items()})
        tp, tm, tl = tstep(tp, tm, {k: torch.from_numpy(v)
                                    for k, v in batch.items()})
        np.testing.assert_allclose(float(tl), float(jl), **TOL)
    _trees_close(tp, jp, "params")
    _trees_close(tm, jm, "momentum")
