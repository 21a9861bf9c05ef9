"""Port parity: ``transformer.lm_loss`` and its gradients for the MoE, SSM
and hybrid families against the JAX package (the configs, params and
helpers of ``test_torch_families.py``; B = 2 sequences of 64 tokens):

- fp32: the loss within 1e-6 relative and every leaf's gradient within
  1e-5 relative RMS of ``jax.value_and_grad`` (for the SSD, or JAX's own
  distance between two chunkings of the same sum if that is larger: see
  the test); remat on and off give the same bits;
- bf16 compute (the configs' default): forward logits and every leaf's
  gradient within 5e-2 relative RMS of JAX's bf16, and no further from
  the fp32 result than 1.5 x JAX's own distance from it.

MoE under bf16: a token whose 2nd and 3rd expert probabilities nearly tie
is routed by the rounding, and a flip moves the whole gradient by several
per cent. Jitted, XLA keeps fp32 inside its fusions where the port rounds
each op to bf16, and on this batch JAX then routes 3 of the 256 (token,
layer) pairs otherwise than the port: the gradients differ by up to
8.97e-2 relative RMS (ROADMAP Queue C). The MoE case therefore holds the
port to JAX run op by op (``jax.disable_jit``), which rounds as the port
does and routes this batch as it does; other batches can still flip there
(one seed of three did, at 6.8e-2), so no bf16 bound covers MoE routing
in general.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import transformer as JT
from repro_torch.core import tree as T
from repro_torch.core.async_sgd import value_and_grad
from repro_torch.models import transformer as M
from test_torch_families import (FAMILIES, SEQ, B, _cfgs, _jit, _params,
                                 _rel_rms, _tokens)

LOSS_RTOL, GRAD_RMS = 1e-6, 1e-5
BF16_RMS, BF16_RATIO = 5e-2, 1.5


def _batch(seed):
    toks = _tokens(seed, (B, SEQ + 1))
    return {"tokens": toks[:, :-1].copy(), "labels": toks[:, 1:].copy()}


def _jax_loss_grads(fam, batch, compute="float32", **kw):
    jp = _params(fam)[0]
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    if fam == "moe" and compute == "bfloat16":      # see the module doc
        with jax.disable_jit():
            loss, grads = jax.value_and_grad(JT.lm_loss)(
                jp, jb, _cfgs(fam, compute)[0])
    else:
        loss, grads = _jit("grad", fam, compute, **kw)(jp, jb)
    return float(loss), [np.asarray(g, np.float32)
                         for g in jax.tree.leaves(grads)]


def _port_loss_grads(tcfg, fam, batch):
    tp = _params(fam)[1]
    loss, grads = value_and_grad(
        lambda p, b: M.lm_loss(p, b, tcfg), tp,
        {k: torch.from_numpy(v) for k, v in batch.items()})
    return float(loss), [g.float().numpy() for g in grads]


@pytest.mark.parametrize("fam", FAMILIES)
def test_lm_loss_and_leaf_grads_match_jax(fam):
    """For the SSD, a leaf's bound is also no tighter than JAX's own
    distance between two chunkings of the same sum (S and S/2): ``A_log``'s
    gradient, a sum over every position with much cancellation, moves by
    3.7e-5-5.9e-5 relative RMS in JAX between chunk 16, 32 and 64, and the
    port lies 3.5e-5 from JAX at the config's chunk 32."""
    _, tcfg = _cfgs(fam)
    batch = _batch(3)
    jl, jg = _jax_loss_grads(fam, batch)
    tl, tg = _port_loss_grads(tcfg, fam, batch)
    bounds = [GRAD_RMS] * len(jg)
    if fam == "ssm":
        ssm = dataclasses.replace(tcfg.ssm, chunk=SEQ)
        from repro.configs.base import SSMConfig as JSSMConfig
        _, other = _jax_loss_grads(fam, batch, ssm=JSSMConfig(
            **dataclasses.asdict(ssm)))
        bounds = [max(GRAD_RMS, _rel_rms(o, b)) for o, b in zip(other, jg)]
    assert abs(tl - jl) <= LOSS_RTOL * abs(jl)
    assert len(tg) == len(jg) == len(T.leaves(_params(fam)[1]))
    for i, (a, b) in enumerate(zip(tg, jg)):
        assert a.shape == b.shape
        assert _rel_rms(a, b) <= bounds[i], \
            f"leaf {i}: {_rel_rms(a, b)} > {bounds[i]}"


@pytest.mark.parametrize("fam", FAMILIES)
def test_remat_on_and_off_give_the_same_gradient_bits(fam):
    batch = _batch(4)
    on = _port_loss_grads(_cfgs(fam, remat=True)[1], fam, batch)
    off = _port_loss_grads(_cfgs(fam, remat=False)[1], fam, batch)
    assert on[0] == off[0]
    for a, b in zip(on[1], off[1]):
        assert np.array_equal(a, b)


def _two_ways(what, port, jax_bf16, fp32):
    cross = _rel_rms(port, jax_bf16)
    mine, theirs = _rel_rms(port, fp32), _rel_rms(jax_bf16, fp32)
    assert cross <= BF16_RMS, f"{what}: port vs JAX {cross:.3e}"
    assert mine <= BF16_RATIO * theirs, (
        f"{what}: port {mine:.3e} from fp32, JAX {theirs:.3e}")


@pytest.mark.parametrize("fam", FAMILIES)
def test_bf16_forward_logits_and_leaf_grads_match_jax(fam):
    (_, t16), (_, t32) = _cfgs(fam, "bfloat16"), _cfgs(fam)
    jp, tp = _params(fam)
    toks = _tokens(6, (B, SEQ))
    truth = M.forward(tp, {"tokens": torch.from_numpy(toks)}, t32)[0]
    if fam == "moe":                                # see the module doc
        with jax.disable_jit():
            lj = JT.forward(jp, {"tokens": jnp.asarray(toks)},
                            _cfgs(fam, "bfloat16")[0])[0]
    else:
        lj = _jit("forward", fam, "bfloat16")(
            jp, {"tokens": jnp.asarray(toks)})[0]
    lt = M.forward(tp, {"tokens": torch.from_numpy(toks)}, t16)[0]
    _two_ways("forward logits", lt.numpy(), np.asarray(lj), truth.numpy())
    batch = _batch(7)
    _, truth = _port_loss_grads(t32, fam, batch)
    _, jg = _jax_loss_grads(fam, batch, "bfloat16")
    _, tg = _port_loss_grads(t16, fam, batch)
    for i, (a, b, c) in enumerate(zip(tg, jg, truth)):
        _two_ways(f"leaf {i} gradient", a, b, c)


