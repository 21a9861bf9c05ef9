"""Port parity: layers and the dense transformer against the JAX package.

Params come from the JAX ``init_params`` (norm scales and QKV biases then
perturbed in numpy, so those paths carry signal) and reach the port
through ``models.convert.params_from_jax``. fp32 compute on both sides,
``atol = rtol = 1e-4``: the frameworks reduce in different orders, and
the error grows through the layers.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as j_get_smoke_config
from repro.models import layers as JL
from repro.models import transformer as JT
from repro_torch.configs import get_smoke_config
from repro_torch.configs.base import ArchConfig
from repro_torch.core.tree import leaves_with_path
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models.convert import params_from_jax, to_compute_dtype

TOL = dict(atol=1e-4, rtol=1e-4)


def _cfgs(window=None):
    """(JAX cfg, port cfg): the qwen2-7b smoke widths in fp32."""
    jcfg = dataclasses.replace(j_get_smoke_config("qwen2-7b"),
                               compute_dtype="float32", remat=False,
                               sliding_window=window)
    return jcfg, ArchConfig(**dataclasses.asdict(jcfg))


@functools.lru_cache(maxsize=None)
def _params(jcfg, seed=0):
    """JAX params with perturbed norm scales and biases: (jax, port).
    Cached: the tests only read them."""
    tree = jax.device_get(JT.init_params(jax.random.PRNGKey(seed), jcfg))
    rng = np.random.default_rng(seed)

    def perturb(t):
        return {k: (perturb(v) if isinstance(v, dict)
                    else (v + 0.1 * rng.standard_normal(v.shape)).astype(
                        v.dtype) if k.startswith(("ln", "b")) else v)
                for k, v in t.items()}

    tree = perturb(tree)
    return jax.tree.map(jnp.asarray, tree), params_from_jax(tree, None)


def _np(x):
    return np.asarray(x)


def test_rms_norm_and_rope_match_jax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 4, 32)).astype(np.float32)
    scale = rng.standard_normal((32,)).astype(np.float32)
    np.testing.assert_allclose(
        L.rms_norm(torch.from_numpy(x), torch.from_numpy(scale)).numpy(),
        _np(JL.rms_norm(jnp.asarray(x), jnp.asarray(scale))), **TOL)
    pos = np.array([[0, 3, 7, 100, 1023]] * 2, np.int32)
    np.testing.assert_allclose(
        L.rope(torch.from_numpy(x), torch.from_numpy(pos), 10_000.0).numpy(),
        _np(JL.rope(jnp.asarray(x), jnp.asarray(pos), 10_000.0)), **TOL)


def test_rms_norm_rope_keep_bf16():
    """bf16 in, bf16 out: the fp32 math is internal, as in JAX."""
    x = torch.randn(2, 3, 4, 8, dtype=torch.bfloat16)
    assert L.rms_norm(x, torch.zeros(8)).dtype == torch.bfloat16
    assert L.rope(x, torch.arange(3)[None], 1e4).dtype == torch.bfloat16


@pytest.mark.parametrize("causal,window", [(True, None), (True, 3),
                                           (False, None)])
def test_full_and_chunked_attention_match_jax(causal, window):
    rng = np.random.default_rng(1)
    q = rng.standard_normal((2, 16, 4, 8)).astype(np.float32)
    k = rng.standard_normal((2, 16, 2, 8)).astype(np.float32)
    v = rng.standard_normal((2, 16, 2, 8)).astype(np.float32)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    np.testing.assert_allclose(
        L.full_attention(tq, tk, tv, causal=causal, window=window).numpy(),
        _np(JL.full_attention(jq, jk, jv, causal=causal, window=window)),
        **TOL)
    np.testing.assert_allclose(
        L.chunked_attention(tq, tk, tv, causal=causal, window=window,
                            kv_chunk=4).numpy(),
        _np(JL.chunked_attention(jq, jk, jv, causal=causal, window=window,
                                 kv_chunk=4)), **TOL)


def test_attention_and_mlp_blocks_match_jax():
    jcfg, tcfg = _cfgs()
    jp, tp = _params(jcfg)
    bp_j = jax.tree.map(lambda a: a[0], jp["blocks"])
    bp_t = T.unstack(tp["blocks"], tcfg.num_layers)[0]
    x = np.random.default_rng(2).standard_normal(
        (2, 6, jcfg.d_model)).astype(np.float32)
    yj, (kj, vj) = JL.attention_forward(bp_j["attn"], jnp.asarray(x), jcfg)
    yt, (kt, vt) = L.attention_forward(bp_t["attn"], torch.from_numpy(x),
                                       tcfg)
    for a, b in ((yt, yj), (kt, kj), (vt, vj)):
        np.testing.assert_allclose(a.numpy(), _np(b), **TOL)
    np.testing.assert_allclose(
        L.mlp_forward(bp_t["mlp"], torch.from_numpy(x), tcfg).numpy(),
        _np(JL.mlp_forward(bp_j["mlp"], jnp.asarray(x), jcfg)), **TOL)


def test_forward_logits_and_cache_match_jax():
    jcfg, tcfg = _cfgs()
    jp, tp = _params(jcfg)
    toks = np.random.default_rng(3).integers(jcfg.vocab_size, size=(2, 12))
    lj, _, cj = JT.forward(jp, {"tokens": jnp.asarray(toks, jnp.int32)},
                           jcfg, return_cache=True)
    lt, aux, ct = T.forward(tp, {"tokens": torch.from_numpy(toks)}, tcfg,
                            return_cache=True)
    assert lt.dtype == torch.float32 and float(aux) == 0.0
    np.testing.assert_allclose(lt.numpy(), _np(lj), **TOL)
    for name in ("k", "v"):
        np.testing.assert_allclose(ct["blocks"][name].numpy(),
                                   _np(cj["blocks"][name]), **TOL)


@pytest.mark.parametrize("window", [None, 4])
def test_decode_step_and_prefill_match_jax(window):
    """Prefill a 5-token prompt, then decode 6 steps (the 4-slot ring wraps
    twice): logits at every step and the final cache agree."""
    jcfg, tcfg = _cfgs(window)
    jp, tp = _params(jcfg, seed=1)
    rng = np.random.default_rng(4)
    B, P, cap = 2, 5, 16
    prompt = rng.integers(jcfg.vocab_size, size=(B, P))
    jc = JT.init_cache(jcfg, B, cap)
    tc = T.init_cache(tcfg, B, cap)
    lj, jc = JT.prefill(jp, jc, jnp.asarray(prompt, jnp.int32), jcfg)
    lt, tc = T.prefill(tp, tc, torch.from_numpy(prompt), tcfg)
    np.testing.assert_allclose(lt.numpy(), _np(lj), **TOL)
    for t in range(P, P + 6):
        tok = rng.integers(jcfg.vocab_size, size=(B, 1))
        lj, jc = JT.decode_step(jp, jc, jnp.asarray(tok, jnp.int32),
                                jnp.int32(t), jcfg)
        lt, tc = T.decode_step(tp, tc, torch.from_numpy(tok), t, tcfg)
        np.testing.assert_allclose(lt.numpy(), _np(lj), **TOL,
                                   err_msg=f"step {t}")
    for name in ("k", "v"):
        np.testing.assert_allclose(tc["blocks"][name].numpy(),
                                   _np(jc["blocks"][name]), **TOL)


def test_params_from_jax_keeps_tree_and_layout():
    jcfg, tcfg = _cfgs()
    tree = jax.device_get(JT.init_params(jax.random.PRNGKey(0), jcfg))
    tp = params_from_jax(tree, tcfg)
    flat_j = jax.tree_util.tree_flatten_with_path(tree)[0]
    for path, leaf in flat_j:
        node = tp
        for key in path:
            node = node[key.key]
        assert tuple(node.shape) == leaf.shape, path
        assert np.array_equal(node.numpy(), leaf), path
    bf = params_from_jax({"w": np.asarray(jnp.ones((3,), jnp.bfloat16))},
                         tcfg)
    assert bf["w"].dtype == torch.bfloat16


def test_to_compute_dtype_casts_weights_not_norms():
    _, tcfg = _cfgs()
    cfg = dataclasses.replace(tcfg, compute_dtype="bfloat16")
    p = T.init_params(torch.Generator().manual_seed(0), cfg)
    c = to_compute_dtype(p, cfg)
    assert c["blocks"]["attn"]["wq"].dtype == torch.bfloat16
    assert c["embed"]["tok"].dtype == torch.bfloat16
    assert c["blocks"]["ln1"].dtype == torch.float32
    assert c["ln_f"] is p["ln_f"]
    # casting at every use == casting once: identical logits
    toks = torch.randint(cfg.vocab_size, (2, 5))
    a, _, _ = T.forward(p, {"tokens": toks}, cfg)
    b, _, _ = T.forward(c, {"tokens": toks}, cfg)
    assert torch.equal(a, b)


def test_init_params_shapes_and_weight_dtype():
    cfg = get_smoke_config("qwen2-7b")
    p = T.init_params(torch.Generator().manual_seed(0), cfg,
                      weight_dtype=torch.bfloat16)
    n, d, h, kv, hd = (cfg.num_layers, cfg.d_model, cfg.num_heads,
                       cfg.num_kv_heads, cfg.resolved_head_dim)
    blocks = p["blocks"]
    assert blocks["attn"]["wq"].shape == (n, d, h, hd)
    assert blocks["attn"]["bk"].shape == (n, kv, hd)
    assert blocks["mlp"]["w_gate"].shape == (n, d, cfg.d_ff)
    assert blocks["ln1"].shape == (n, d)
    assert p["embed"]["unembed"].shape == (d, cfg.vocab_size)
    assert blocks["mlp"]["w_up"].dtype == torch.bfloat16
    assert blocks["ln2"].dtype == torch.float32
    # one seed, one draw
    q = T.init_params(torch.Generator().manual_seed(0), cfg,
                      weight_dtype=torch.bfloat16)
    assert torch.equal(p["embed"]["tok"], q["embed"]["tok"])


@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "mamba2-2.7b",
                                  "recurrentgemma-2b", "whisper-base",
                                  "llama-3.2-vision-90b"])
def test_unported_families_raise_naming_roadmap(arch):
    """Every family the JAX package has, the vlm and encdec ones too, gives
    the JAX tree's keys and shapes (none is refused any longer)."""
    cfg = get_smoke_config(arch)
    gen = torch.Generator().manual_seed(0)
    assert cfg.arch_type in T.PORTED
    want = jax.eval_shape(lambda k: JT.init_params(k, j_get_smoke_config(
        arch)), jax.random.PRNGKey(0))
    got = T.init_params(gen, cfg)
    wl = jax.tree_util.tree_flatten_with_path(want)[0]
    gl = [(p, tuple(t.shape)) for p, t in leaves_with_path(got)]
    assert [(tuple(k.key for k in p), tuple(w.shape)) for p, w in wl] == gl


def test_cuda_attention_on_cpu_raises():
    _, tcfg = _cfgs()
    p = T.init_params(torch.Generator().manual_seed(0), tcfg)
    with pytest.raises(ValueError, match="CUDA"):
        T.forward(p, {"tokens": torch.zeros((1, 4), dtype=torch.int64)},
                  tcfg, attn_impl="cuda")
