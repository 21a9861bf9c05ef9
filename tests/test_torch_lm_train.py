"""Port parity: LM training's model and steps against the JAX package.

At the qwen2-7b smoke widths (2 layers, d_model 128, vocab 512), params
from the JAX ``init_params`` with norm scales and QKV biases perturbed in
numpy (so those paths carry signal), through ``params_from_jax``; batches
from numpy seeds. fp32 compute unless stated:

- ``lm_loss`` and the gradients of all 15 leaves against
  ``jax.value_and_grad(lm_loss)``: the loss within 1e-6 relative, each
  leaf within 1e-5 relative RMS (the frameworks reduce in other orders;
  measured 1.4e-6 at most, the loss 2.2e-7);
- remat on and off give the same gradient bits (the recomputed forward
  repeats the same ops on the same inputs);
- ``full_attention`` and ``chunked_attention`` gradients with respect to
  q, k and v against JAX's under ``jax.grad``, causal and windowed,
  within 1e-5;
- ``steps.make_train_step`` against JAX's for ``grad_accum`` in {1, 2} and
  weight decay in {0, 0.05}, two steps: params and momentum within 1e-5
  (and the decay visible: at 0.05 the JAX params move more than 10 x
  that from the decay-free run);
- ``make_prefill_step`` / ``make_decode_step`` logits, caches and next
  tokens against JAX's (1e-4, as ``test_torch_models.py``; tokens equal);
- ``effective_window`` / ``supports_shape`` equal to JAX's everywhere;
- bf16 compute, the configs' default (the card runs it): forward logits,
  decode-step logits and every leaf's ``lm_loss`` gradient held to JAX's
  bf16 two ways: within 5e-2 relative RMS of JAX's (measured up to
  2.5e-2 on the gradients), and no further from the fp32 result than
  1.5 x JAX's own bf16 distance from it (measured 0.87-1.09 x). The two
  frameworks round to bf16 at other places, so the port against JAX is
  about as far apart as either is from fp32.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import INPUT_SHAPES as J_SHAPES
from repro.configs import get_config as j_get_config
from repro.configs import get_smoke_config as j_get_smoke_config
from repro.configs import list_archs as j_list_archs
from repro.configs.base import InputShape as JInputShape
from repro.configs.base import TrainConfig as JTrainConfig
from repro.launch import steps as JS
from repro.models import layers as JL
from repro.models import transformer as JT
from repro.optim.sgd import init_momentum as j_init_momentum
from repro_torch.configs import INPUT_SHAPES, get_config, list_archs
from repro_torch.configs.base import ArchConfig, InputShape, TrainConfig
from repro_torch.core import tree as T
from repro_torch.core.async_sgd import value_and_grad
from repro_torch.launch import steps as S
from repro_torch.models import layers as L
from repro_torch.models import transformer as M
from repro_torch.models.convert import params_from_jax
from repro_torch.optim.sgd import init_momentum

LOSS_RTOL, GRAD_RMS, ATTN_TOL, STEP_TOL = 1e-6, 1e-5, 1e-5, 1e-5
TOL = dict(atol=1e-4, rtol=1e-4)
BF16_RMS, BF16_RATIO = 5e-2, 1.5
B, S_LEN = 2, 32


def _cfgs(compute="float32", remat=True):
    """(JAX cfg, port cfg): the qwen2-7b smoke widths."""
    jcfg = dataclasses.replace(j_get_smoke_config("qwen2-7b"),
                               compute_dtype=compute, remat=remat)
    return jcfg, ArchConfig(**dataclasses.asdict(jcfg))


@functools.lru_cache(maxsize=None)
def _np_params(seed=0):
    """The JAX smoke params as numpy, norm scales and biases perturbed."""
    jcfg, _ = _cfgs()
    tree = jax.device_get(JT.init_params(jax.random.PRNGKey(seed), jcfg))
    rng = np.random.default_rng(seed)

    def perturb(t):
        return {k: (perturb(v) if isinstance(v, dict)
                    else (v + 0.1 * rng.standard_normal(v.shape)).astype(
                        v.dtype) if k.startswith(("ln", "b")) else v)
                for k, v in t.items()}

    return perturb(tree)


def _params(seed=0):
    """(JAX params, port params) of ``_np_params``; the port's are fresh
    tensors each call."""
    tree = _np_params(seed)
    return jax.tree.map(jnp.asarray, tree), params_from_jax(tree)


def _batch(seed, lead=(B,), vocab=512, seq=S_LEN):
    rng = np.random.default_rng(seed)
    toks = rng.integers(vocab, size=lead + (seq + 1,)).astype(np.int32)
    return {"tokens": toks[..., :-1].copy(), "labels": toks[..., 1:].copy()}


def _jb(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def _tb(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


def _rel_rms(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _jax_loss_grads(jcfg, batch, jp=None):
    jp = _params()[0] if jp is None else jp
    loss, grads = jax.value_and_grad(JT.lm_loss)(jp, _jb(batch), jcfg)
    return float(loss), [np.asarray(g, np.float32)
                         for g in jax.tree.leaves(grads)]


def _port_loss_grads(tcfg, batch, tp=None):
    tp = _params()[1] if tp is None else tp
    loss, grads = value_and_grad(lambda p, b: M.lm_loss(p, b, tcfg), tp,
                                 _tb(batch))
    return float(loss), [g.float().numpy() for g in grads]


def test_lm_loss_and_leaf_grads_match_jax():
    jcfg, tcfg = _cfgs()
    batch = _batch(0)
    jl, jg = _jax_loss_grads(jcfg, batch)
    tl, tg = _port_loss_grads(tcfg, batch)
    assert abs(tl - jl) <= LOSS_RTOL * abs(jl)
    assert len(tg) == len(jg) == 15
    for i, (a, b) in enumerate(zip(tg, jg)):
        assert a.shape == b.shape
        assert _rel_rms(a, b) <= GRAD_RMS, f"leaf {i}: {_rel_rms(a, b)}"


def test_lm_loss_casts_int32_labels():
    """``SyntheticLM`` yields int32 labels; the gather takes int64."""
    _, tcfg = _cfgs()
    batch = _tb(_batch(1))
    assert batch["labels"].dtype == torch.int32
    a = M.lm_loss(_params()[1], batch, tcfg)
    b = M.lm_loss(_params()[1], {k: v.long() for k, v in batch.items()},
                  tcfg)
    assert a.dim() == 0 and torch.equal(a, b)


def test_remat_on_and_off_give_the_same_gradient_bits():
    batch = _batch(2)
    on = _port_loss_grads(_cfgs(remat=True)[1], batch)
    off = _port_loss_grads(_cfgs(remat=False)[1], batch)
    assert on[0] == off[0]
    for a, b in zip(on[1], off[1]):
        assert np.array_equal(a, b)


def test_unstack_splits_each_stacked_leaf_once():
    _, tcfg = _cfgs()
    tp = _params()[1]
    per = M.unstack(tp["blocks"], tcfg.num_layers)
    assert len(per) == tcfg.num_layers
    for i, bp in enumerate(per):
        for (path, a), b in zip(T.leaves_with_path(bp),
                                T.leaves(tp["blocks"])):
            assert a.data_ptr() == b[i].data_ptr(), path   # views
    with pytest.raises(ValueError, match="layers"):
        M.unstack(tp["blocks"], tcfg.num_layers + 1)


@pytest.mark.parametrize("impl", ["full", "chunked"])
@pytest.mark.parametrize("causal,window", [(True, None), (True, 8),
                                           (False, 24)])
def test_attention_grads_match_jax(impl, causal, window):
    """S = 64, kv_chunk = 16 (four chunks, the first ones fully masked
    for late windowed rows): d(sum(out * cot)) / d(q, k, v)."""
    rng = np.random.default_rng(3)
    q = rng.standard_normal((2, 64, 4, 16)).astype(np.float32)
    k = rng.standard_normal((2, 64, 2, 16)).astype(np.float32)
    v = rng.standard_normal((2, 64, 2, 16)).astype(np.float32)
    cot = rng.standard_normal((2, 64, 4, 16)).astype(np.float32)
    kw = dict(causal=causal, window=window)
    if impl == "chunked":
        jf = functools.partial(JL.chunked_attention, kv_chunk=16, **kw)
        tf = functools.partial(L.chunked_attention, kv_chunk=16, **kw)
    else:
        jf = functools.partial(JL.full_attention, **kw)
        tf = functools.partial(L.full_attention, **kw)
    jg = jax.grad(lambda a, b, c: jnp.sum(jf(a, b, c) * cot),
                  argnums=(0, 1, 2))(q, k, v)
    ts = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
    out = tf(*ts)
    tg = torch.autograd.grad((out * torch.from_numpy(cot)).sum(), ts)
    for name, a, b in zip("qkv", tg, jg):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=ATTN_TOL,
                                   rtol=ATTN_TOL, err_msg=name)


@functools.lru_cache(maxsize=None)
def _train_runs(grad_accum, wd, steps=2):
    """(port params, momentum), (JAX params, momentum) after ``steps`` of
    ``make_train_step`` from the same params and batches. Cached: the
    tests only read them."""
    jcfg, tcfg = _cfgs()
    kw = dict(learning_rate=0.05, momentum=0.9, weight_decay=wd,
              grad_accum=grad_accum)
    lead = (grad_accum, B // grad_accum) if grad_accum > 1 else (B,)
    jstep = JS.make_train_step(jcfg, JTrainConfig(**kw),
                               JInputShape("t", S_LEN, B, "train"))
    tstep = S.make_train_step(tcfg, TrainConfig(**kw),
                              InputShape("t", S_LEN, B, "train"))
    jp, tp = _params()
    jv, tv = j_init_momentum(jp), init_momentum(tp)
    for s in range(steps):
        batch = _batch(10 + s, lead)
        jp, jv, jl = jstep(jp, jv, _jb(batch))
        tp, tv, tl = tstep(tp, tv, _tb(batch))
        assert abs(float(tl) - float(jl)) <= 1e-5 * abs(float(jl))
    return ((T.leaves(tp), T.leaves(tv)),
            (jax.tree.leaves(jp), jax.tree.leaves(jv)))


@pytest.mark.parametrize("grad_accum", [1, 2])
@pytest.mark.parametrize("wd", [0.0, 0.05])
def test_make_train_step_matches_jax(grad_accum, wd):
    (tp, tv), (jp, jv) = _train_runs(grad_accum, wd)
    assert len(tp) == len(jp) == 15
    for a, b in zip(tp + tv, jp + jv):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=STEP_TOL,
                                   rtol=STEP_TOL)


def test_train_step_weight_decay_is_visible():
    """At 0.05 the decay moves the JAX params by more than 10 x the step
    tolerance, so the cases above would see a port that dropped it."""
    _, (with_wd, _) = _train_runs(1, 0.05)
    _, (without, _) = _train_runs(1, 0.0)
    moved = max(float(np.max(np.abs(np.asarray(a) - np.asarray(b))))
                for a, b in zip(with_wd, without))
    assert moved > 10 * STEP_TOL


def test_prefill_and_decode_steps_match_jax():
    jcfg, tcfg = _cfgs()
    shape = (JInputShape("p", 12, B, "prefill"),
             InputShape("p", 12, B, "prefill"))
    jp, tp = _params(seed=1)
    toks = np.random.default_rng(5).integers(512, size=(B, 12)).astype(
        np.int32)
    lj, cj = JS.make_prefill_step(jcfg, shape[0])(
        jp, {"tokens": jnp.asarray(toks)})
    lt, ct = S.make_prefill_step(tcfg, shape[1])(
        tp, {"tokens": torch.from_numpy(toks)})
    assert lt.shape == (B, 1, 512) and not lt.requires_grad
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **TOL)
    for name in ("k", "v"):
        np.testing.assert_allclose(ct["blocks"][name].numpy(),
                                   np.asarray(cj["blocks"][name]), **TOL)
    dshape = (JInputShape("d", 16, B, "decode"),
              InputShape("d", 16, B, "decode"))
    jstep = JS.make_decode_step(jcfg, dshape[0])
    tstep = S.make_decode_step(tcfg, dshape[1])
    jc, tc = JT.init_cache(jcfg, B, 16), M.init_cache(tcfg, B, 16)
    jt = tt = toks[:, :1]
    for pos in range(4):
        jt, jc = jstep(jp, jc, {"tokens": jnp.asarray(jt)}, pos)
        tt, tc = tstep(tp, tc, {"tokens": torch.from_numpy(np.asarray(tt))},
                       pos)
        assert tt.dtype == torch.int32 and tt.shape == (B, 1)
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
        jt, tt = np.asarray(jt), tt.numpy()
    for name in ("k", "v"):
        np.testing.assert_allclose(tc["blocks"][name].numpy(),
                                   np.asarray(jc["blocks"][name]), **TOL)


def test_effective_window_and_supports_shape_equal_jax():
    assert list_archs() == j_list_archs()
    assert S.LONG_CONTEXT_WINDOW == JS.LONG_CONTEXT_WINDOW
    assert sorted(INPUT_SHAPES) == sorted(J_SHAPES)
    for arch in list_archs():
        for name in INPUT_SHAPES:
            cfg, jcfg = get_config(arch), j_get_config(arch)
            shape, jshape = INPUT_SHAPES[name], J_SHAPES[name]
            assert S.effective_window(cfg, shape) == \
                JS.effective_window(jcfg, jshape), (arch, name)
            assert S.supports_shape(cfg, shape) == \
                JS.supports_shape(jcfg, jshape), (arch, name)


# ---------------------------------------------------------------------------
# bf16 compute against JAX bf16
# ---------------------------------------------------------------------------

def _two_ways(what, port, jax_bf16, fp32):
    """The port's bf16 result within ``BF16_RMS`` of JAX's, and no further
    from the fp32 result than ``BF16_RATIO`` x JAX's own distance."""
    cross = _rel_rms(port, jax_bf16)
    mine, theirs = _rel_rms(port, fp32), _rel_rms(jax_bf16, fp32)
    assert cross <= BF16_RMS, f"{what}: port vs JAX {cross:.3e}"
    assert mine <= BF16_RATIO * theirs, (
        f"{what}: port {mine:.3e} from fp32, JAX {theirs:.3e}")


def test_bf16_forward_and_decode_logits_match_jax():
    (j16, t16), (_, t32) = _cfgs("bfloat16"), _cfgs()
    jp, tp = _params()
    toks = np.random.default_rng(6).integers(512, size=(B, S_LEN)).astype(
        np.int32)
    truth = M.forward(tp, {"tokens": torch.from_numpy(toks)}, t32)[0]
    lj = JT.forward(jp, {"tokens": jnp.asarray(toks)}, j16)[0]
    lt = M.forward(tp, {"tokens": torch.from_numpy(toks)}, t16)[0]
    assert lt.dtype == torch.float32
    _two_ways("forward logits", lt.numpy(), np.asarray(lj), truth.numpy())
    jc, tc = JT.init_cache(j16, B, 16), M.init_cache(t16, B, 16)
    fc = M.init_cache(t32, B, 16)
    for pos in range(6):
        tok = toks[:, pos:pos + 1]
        lj, jc = JT.decode_step(jp, jc, jnp.asarray(tok), jnp.int32(pos), j16)
        lt, tc = M.decode_step(tp, tc, torch.from_numpy(tok), pos, t16)
        lf, fc = M.decode_step(tp, fc, torch.from_numpy(tok), pos, t32)
        _two_ways(f"decode logits at {pos}", lt.numpy(), np.asarray(lj),
                  lf.numpy())


def test_bf16_lm_loss_leaf_grads_match_jax():
    (j16, t16), (_, t32) = _cfgs("bfloat16"), _cfgs()
    batch = _batch(0)
    _, truth = _port_loss_grads(t32, batch)
    _, jg = _jax_loss_grads(j16, batch)
    _, tg = _port_loss_grads(t16, batch)
    for i, (a, b, c) in enumerate(zip(tg, jg, truth)):
        _two_ways(f"leaf {i} gradient", a, b, c)
