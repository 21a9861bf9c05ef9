"""Port parity: the vlm and encdec families of ``models/transformer`` and
their serving paths against the JAX package.

At the smoke widths of whisper-base (2 encoder + 2 decoder layers,
d_model 128, 4 heads of 32, 64 encoder frames) and llama-3.2-vision-90b
(d_model 128, 4 query heads on 2 kv heads of 32, 16 image tokens, a cross
block every 5th layer) at 5 layers (one super-block) and at 7 (two
remainder dense layers), params from the JAX ``init_params`` with the
zero norm scales and biases perturbed in numpy (so those paths carry
signal), through ``params_from_jax``; tokens and the stub modality inputs
from numpy seeds; fp32 compute, within 1e-4. The loss, its gradients, the
training step and bf16 are in ``test_torch_vlm_encdec_grad.py``.

- ``forward`` logits and caches ({"blocks": {"k","v","ck","cv"}} for
  encdec, {"super": {"k","v","ck","cv"}} for the vlm);
- ``init_cache``'s trees; ``prefill`` over 10 tokens and 6
  ``decode_step``s, with the cross caches filled from the forward's cache
  (the vlm's keys copied across the two trees' layouts) and left at zero;
- ``launch/steps.py``'s prefill step (logits, cache) and decode step
  (greedy tokens, cache) with ``modality_inputs`` in the batch;
- ``static_serve_trace`` and ``launch/serve.serve``: the JAX servers'
  tokens (both serve with zero cross caches, as the reference does);
- Whisper's ``enc_ln`` keeps its dtype under ``to_compute_dtype`` (it was
  cast to bf16) and ``init_params(weight_dtype=)``;
- ``init_params`` draws a stacked leaf one layer at a time and gets the
  numbers of a whole-leaf draw.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as j_get_smoke_config
from repro.models import transformer as JT
from repro_torch.configs import get_smoke_config
from repro_torch.core import tree as T
from repro_torch.models import layers as L
from repro_torch.models import transformer as M
from repro_torch.models.convert import params_from_jax, to_compute_dtype

TOL = dict(atol=1e-4, rtol=1e-4)
#: case -> (arch, layers)
CASES = {"encdec": ("whisper-base", 2), "vlm5": ("llama-3.2-vision-90b", 5),
         "vlm7": ("llama-3.2-vision-90b", 7)}
B, SEQ = 2, 12


def _cfgs(case, compute="float32", remat=False):
    """(JAX cfg, port cfg) of a case's smoke config."""
    arch, layers = CASES[case]
    kw = dict(compute_dtype=compute, remat=remat, num_layers=layers)
    return (dataclasses.replace(j_get_smoke_config(arch), **kw),
            dataclasses.replace(get_smoke_config(arch), **kw))


def _is_norm_or_bias(key):
    return key.startswith(("ln", "b")) or key.endswith("_ln")


@functools.lru_cache(maxsize=None)
def _np_params(case, seed=0):
    jcfg, _ = _cfgs(case)
    tree = jax.device_get(JT.init_params(jax.random.PRNGKey(seed), jcfg))
    rng = np.random.default_rng(seed)

    def perturb(t):
        return {k: (perturb(v) if isinstance(v, dict)
                    else (v + 0.1 * rng.standard_normal(v.shape)).astype(
                        v.dtype) if _is_norm_or_bias(k) else v)
                for k, v in t.items()}

    return perturb(tree)


def _params(case, seed=0):
    """(JAX params, port params); the port's are fresh tensors each call."""
    tree = _np_params(case, seed)
    return jax.tree.map(jnp.asarray, tree), params_from_jax(tree)


@functools.lru_cache(maxsize=None)
def _jit(name, case):
    jcfg = _cfgs(case)[0]
    extra = {"return_cache": True} if name == "forward" else {}
    return jax.jit(functools.partial(getattr(JT, name), cfg=jcfg, **extra))


def _tokens(seed, shape, vocab=512):
    return np.random.default_rng(seed).integers(vocab, size=shape).astype(
        np.int32)


def _batch(case, seed, seq=SEQ):
    """The numpy batch: tokens and the case's stub modality input."""
    from repro_torch.launch.steps import modality_inputs
    tcfg = _cfgs(case)[1]
    out = {"tokens": _tokens(seed, (B, seq))}
    out.update({k: v.numpy() for k, v in modality_inputs(
        tcfg, (B,), seed=seed, device="cpu").items()})
    return out


def _both(batch):
    return ({k: jnp.asarray(v) for k, v in batch.items()},
            {k: torch.from_numpy(v) for k, v in batch.items()})


def _trees_close(got, want, what):
    tl, jl = T.leaves_with_path(got), jax.tree.leaves(want)
    assert len(tl) == len(jl), what
    for (path, a), b in zip(tl, jl):
        assert tuple(a.shape) == b.shape, (what, path)
        np.testing.assert_allclose(a.float().numpy(), np.asarray(b),
                                   **TOL, err_msg=f"{what} {path}")


def _fill_cross(case, jcache, tcache, jfwd, tfwd):
    """The cross K/V of ``forward(return_cache=True)`` copied into
    ``init_cache``'s trees (the vlm's forward cache holds them at
    ``super.ck``, as ``init_cache`` does, beside its self K/V)."""
    key = "blocks" if case == "encdec" else "super"
    jcache = dict(jcache)
    jcache[key] = dict(jcache[key], ck=jfwd[key]["ck"], cv=jfwd[key]["cv"])
    for name in ("ck", "cv"):
        tcache[key][name].copy_(tfwd[key][name])
    return jcache, tcache


# ---------------------------------------------------------------------------
# forward, decode, prefill
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", CASES)
def test_forward_logits_and_cache_match_jax(case):
    _, tcfg = _cfgs(case)
    jp, tp = _params(case)
    jb, tb = _both(_batch(case, 1))
    jl, jaux, jc = _jit("forward", case)(jp, jb)
    tl, taux, tc = M.forward(tp, tb, tcfg, return_cache=True)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    assert float(taux) == float(jaux) == 0.0
    _trees_close(tc, jc, "cache")
    if case.startswith("vlm"):      # the rem layers leave nothing cached
        assert sorted(tc) == ["super"]


@pytest.mark.parametrize("filled", [True, False], ids=["filled", "zero"])
@pytest.mark.parametrize("case", CASES)
def test_prefill_and_decode_steps_match_jax(case, filled):
    jcfg, tcfg = _cfgs(case)
    jp, tp = _params(case)
    toks = _tokens(2, (B, 16))
    jc, tc = JT.init_cache(jcfg, B, 20), M.init_cache(tcfg, B, 20)
    _trees_close(tc, jc, "init_cache")
    if filled:
        jb, tb = _both(_batch(case, 3))
        _, _, jf = _jit("forward", case)(jp, jb)
        _, _, tf = M.forward(tp, tb, tcfg, return_cache=True)
        jc, tc = _fill_cross(case, jc, tc, jf, tf)
        key = "blocks" if case == "encdec" else "super"
        assert float(tc[key]["ck"].abs().max()) > 0
    lj, jc = _jit("prefill", case)(jp, jc, jnp.asarray(toks[:, :10]))
    lt, tc = M.prefill(tp, tc, torch.from_numpy(toks[:, :10]), tcfg)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **TOL)
    for pos in range(10, 16):
        tok = toks[:, pos:pos + 1]
        lj, jc = _jit("decode_step", case)(jp, jc, jnp.asarray(tok),
                                           jnp.int32(pos))
        lt, tc = M.decode_step(tp, tc, torch.from_numpy(tok), pos, tcfg)
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **TOL,
                                   err_msg=f"step {pos}")
    _trees_close(tc, jc, "cache")


@pytest.mark.parametrize("case", ["encdec", "vlm7"])
def test_prefill_and_decode_step_factories_match_jax(case):
    """``launch/steps.py``'s prefill step (logits and cache) and greedy
    decode step (tokens and cache), the stub inputs in the batch."""
    from repro.configs.base import InputShape as JInputShape
    from repro.launch import steps as JS
    from repro_torch.configs.base import InputShape
    from repro_torch.launch import steps as S
    jcfg, tcfg = _cfgs(case)
    jp, tp = _params(case)
    jb, tb = _both(_batch(case, 8))
    lj, cj = jax.jit(JS.make_prefill_step(
        jcfg, JInputShape("p", SEQ, B, "prefill")))(jp, jb)
    lt, ct = S.make_prefill_step(tcfg, InputShape("p", SEQ, B, "prefill"))(
        tp, tb)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **TOL)
    _trees_close(ct, cj, "prefill cache")
    jstep = jax.jit(JS.make_decode_step(jcfg,
                                        JInputShape("d", 16, B, "decode")))
    tstep = S.make_decode_step(tcfg, InputShape("d", 16, B, "decode"))
    jc, tc = JT.init_cache(jcfg, B, 16), M.init_cache(tcfg, B, 16)
    jt = tt = jb["tokens"][:, :1]
    for pos in range(4):
        jt, jc = jstep(jp, jc, {"tokens": jnp.asarray(jt)}, jnp.int32(pos))
        tt, tc = tstep(tp, tc, {"tokens": torch.from_numpy(np.array(tt))},
                       pos)
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
        jt, tt = np.asarray(jt), tt.numpy()
    _trees_close(tc, jc, "decode cache")


def test_modality_inputs_shapes():
    from repro_torch.launch.steps import modality_inputs
    for case, key, n in (("encdec", "enc_emb", 64), ("vlm5", "img_emb", 16)):
        cfg = _cfgs(case, "bfloat16")[1]
        out = modality_inputs(cfg, (3, 2), seed=4, device="cpu")
        assert list(out) == [key]
        assert out[key].shape == (3, 2, n, cfg.d_model)
        assert out[key].dtype == torch.bfloat16
        again = modality_inputs(cfg, (3, 2), seed=4, device="cpu")[key]
        assert torch.equal(out[key], again)
    assert modality_inputs(get_smoke_config("qwen2-7b"), (2,),
                           device="cpu") == {}


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["encdec", "vlm7"])
def test_static_serve_trace_tokens_match_jax(case):
    from repro.serving import static_serve_trace as j_static
    from repro_torch.serving import (poisson_trace, sample_requests,
                                     static_serve_trace)
    jcfg, tcfg = _cfgs(case)
    jp, tp = _params(case)
    reqs = sample_requests(poisson_trace(30.0, 4, seed=2), tcfg,
                           prompt_range=(4, 8), gen_range=(3, 5), seed=2)
    want = j_static(jcfg, reqs, batch=2, params=jp)
    got = static_serve_trace(tcfg, reqs, batch=2, params=tp, device="cpu")
    assert sorted(got.tokens) == sorted(want.tokens)
    for rid in want.tokens:
        np.testing.assert_array_equal(got.tokens[rid], want.tokens[rid])


@pytest.mark.parametrize("case", ["encdec", "vlm7"])
def test_launch_serve_tokens_match_jax(case, monkeypatch):
    """``launch/serve.serve`` on both sides from the JAX init's params (the
    port draws its own from ``torch.Generator``)."""
    from repro.launch import serve as JSV
    from repro_torch.launch import serve as SV
    jcfg, tcfg = _cfgs(case)
    tree = _np_params(case)
    monkeypatch.setattr(JSV.T, "init_params", lambda key, cfg: jax.tree.map(
        jnp.asarray, tree))
    monkeypatch.setattr(SV, "random_params",
                        lambda cfg, seed, dev: params_from_jax(tree))
    want, _, _ = JSV.serve(jcfg, batch=2, prompt_len=6, gen=5)
    got, _, _ = SV.serve(tcfg, batch=2, prompt_len=6, gen=5, device="cpu")
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_continuous_server_refuses_both_families():
    from repro_torch.serving import ContinuousServer
    for case in ("encdec", "vlm5"):
        with pytest.raises(ValueError, match="dense/moe"):
            ContinuousServer(_cfgs(case)[1], device="cpu")


# ---------------------------------------------------------------------------
# params: the enc_ln dtype, the layer-at-a-time draw, the tree
# ---------------------------------------------------------------------------

def test_enc_ln_keeps_its_dtype_under_the_compute_cast():
    """The encoder's final norm scale stays in the param dtype, as every
    norm scale does: cast to bf16 it moved the bf16 forward's logits."""
    _, tcfg = _cfgs("encdec", "bfloat16")
    tp = params_from_jax(_np_params("encdec"))
    assert float(tp["enc_ln"].abs().min()) > 0
    cast = to_compute_dtype(tp, tcfg)
    assert cast["enc_ln"].dtype == torch.float32
    assert torch.equal(cast["enc_ln"], tp["enc_ln"])
    drawn = M.init_params(torch.Generator().manual_seed(0), tcfg,
                          weight_dtype=torch.bfloat16)
    assert drawn["enc_ln"].dtype == torch.float32
    batch = _both(_batch("encdec", 5))[1]
    batch["enc_emb"] = batch["enc_emb"].bfloat16()
    with torch.no_grad():
        want = M.forward(tp, batch, tcfg)[0]
        got = M.forward(cast, batch, tcfg)[0]
    assert torch.equal(got, want)


def _whole_leaf_randn(shape, generator, std, dtype, lead=(), device=None):
    """The draw before the layer-at-a-time one: the whole stacked leaf."""
    x = torch.randn(lead + tuple(shape), generator=generator,
                    device=L.init_device(generator, device),
                    dtype=torch.float32)
    return x.mul_(std).to(dtype)


@pytest.mark.parametrize("arch", ["qwen2-7b", "qwen2-moe-a2.7b",
                                  "mamba2-2.7b", "recurrentgemma-2b",
                                  "whisper-base", "llama-3.2-vision-90b"])
def test_layer_at_a_time_draw_gives_the_whole_leaf_numbers(arch,
                                                           monkeypatch):
    cfg = get_smoke_config(arch)
    got = M.init_params(torch.Generator().manual_seed(3), cfg,
                        weight_dtype=torch.bfloat16)
    monkeypatch.setattr(L, "_randn", _whole_leaf_randn)
    want = M.init_params(torch.Generator().manual_seed(3), cfg,
                         weight_dtype=torch.bfloat16)
    gl, wl = T.leaves_with_path(got), T.leaves_with_path(want)
    assert [p for p, _ in gl] == [p for p, _ in wl]
    for (path, a), (_, b) in zip(gl, wl):
        assert a.dtype == b.dtype and torch.equal(a, b), path


def test_require_ported_refuses_an_unknown_family():
    cfg = dataclasses.replace(get_smoke_config("qwen2-7b"),
                              arch_type="rnn")
    with pytest.raises(ValueError, match="rnn"):
        M.init_params(torch.Generator().manual_seed(0), cfg)
