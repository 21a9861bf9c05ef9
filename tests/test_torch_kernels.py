"""Port parity: the kernels' plain PyTorch versions against the JAX package.

Same numpy-seeded inputs through the JAX function and the port's
counterpart, fp32, ``atol = rtol = 1e-5`` (the two differ only in
summation order). The bulk compares against the JAX oracles
(``paged_attention_ref``, ``attention_ref``, ``layers.chunked_attention``);
one tiny case each runs the JAX Pallas kernel in interpret mode.

The CUDA kernels themselves run only on the card: ``tests/test_torch_gpu.py``
holds them to these plain versions there (``chip_smoke.py`` does the same
at the serving path's shapes).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import ops as jfa_ops
from repro.kernels.flash_attention.ref import attention_ref as j_attention_ref
from repro.kernels.paged_attention import ops as jpa_ops
from repro.kernels.paged_attention.ref import (
    paged_attention_ref as j_paged_ref, valid_mask as j_valid_mask)
from repro.models import layers as JL
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention.ref import (attention_ref,
                                                     flash_attention_ref)
from repro_torch.kernels.paged_attention import ops as pa_ops
from repro_torch.kernels.paged_attention.ref import (paged_attention_ref,
                                                     valid_mask)

TOL = dict(atol=1e-5, rtol=1e-5)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _paged_case(rng, *, B=3, K=2, G=2, hd=16, page=4, n_pages=4, P=16,
                pos=(5, 0, 13)):
    """Random pools + tables: each row owns distinct pages; row tables
    beyond the live pages keep pointing at scratch page 0."""
    q = rng.standard_normal((B, 1, K * G, hd)).astype(np.float32)
    kp = rng.standard_normal((P, page, K, hd)).astype(np.float32)
    vp = rng.standard_normal((P, page, K, hd)).astype(np.float32)
    table = np.zeros((B, n_pages), np.int32)
    ids = iter(range(1, P))
    for b in range(B):
        live = min(pos[b] // page + 1, n_pages)
        for j in range(live):
            table[b, j] = next(ids)
    return q, kp, vp, table, np.asarray(pos, np.int32)


# ---------------------------------------------------------------------------
# paged attention: plain version vs the JAX oracle
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("G", [1, 2, 4])
@pytest.mark.parametrize("window", [None, 16])
def test_paged_ref_matches_jax(G, window):
    """Full window and a ring of W = window = 16 slots; pos 13 in a
    16-slot table, 0 (first token) and 5 (mid page)."""
    rng = np.random.default_rng(G)
    q, kp, vp, table, pos = _paged_case(rng, G=G)
    want = j_paged_ref(jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
                       jnp.asarray(table), jnp.asarray(pos), window=window)
    got = paged_attention_ref(_t(q), _t(kp), _t(vp), _t(table), _t(pos),
                              window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_paged_ref_ring_wrap_matches_jax():
    """A ring row past its first wrap (pos >= W): every page live, the
    mask (not slot order) carries position."""
    rng = np.random.default_rng(7)
    q, kp, vp, _, _ = _paged_case(rng, B=2, n_pages=2)
    table = np.array([[1, 2], [3, 4]], np.int32)       # W = 8 ring slots
    pos = np.array([13, 21], np.int32)
    for window in (8, 12):
        want = j_paged_ref(jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
                           jnp.asarray(table), jnp.asarray(pos),
                           window=window)
        got = paged_attention_ref(_t(q), _t(kp), _t(vp), _t(table), _t(pos),
                                  window=window)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_valid_mask_matches_jax():
    pos = np.array([0, 3, 7, 8, 13, 900], np.int32)
    for W, window in ((8, None), (8, 8), (8, 5), (16, 16)):
        want = np.asarray(j_valid_mask(jnp.asarray(pos), W, window))
        got = valid_mask(_t(pos), W, window).numpy()
        assert np.array_equal(got, want), (W, window)


def test_paged_ref_stale_retired_row_matches_jax():
    """A retired row keeps a stale position far past its (scratch-only)
    table: the plain version must agree with JAX and stay finite."""
    rng = np.random.default_rng(3)
    q, kp, vp, table, _ = _paged_case(rng, pos=(5, 0, 13))
    table[1] = 0
    pos = np.array([5, 900, 13], np.int32)
    want = j_paged_ref(jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
                       jnp.asarray(table), jnp.asarray(pos))
    got = paged_attention_ref(_t(q), _t(kp), _t(vp), _t(table), _t(pos))
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_paged_ref_masked_entries_cannot_leak():
    """Garbage in every slot the mask excludes (scratch page, the tail of
    the current page, unallocated table columns) changes nothing."""
    rng = np.random.default_rng(4)
    q, kp, vp, table, pos = _paged_case(rng)
    clean_k, clean_v = kp.copy(), vp.copy()
    page = kp.shape[1]
    for b in range(table.shape[0]):
        for j in range(table.shape[1]):
            for t in range(page):
                if j * page + t > pos[b]:
                    clean_k[table[b, j], t] = 0.0
                    clean_v[table[b, j], t] = 0.0
    dirty_k, dirty_v = clean_k.copy(), clean_v.copy()
    dirty_k[0] = dirty_v[0] = 1e3                       # scratch page
    for b in range(table.shape[0]):
        for j in range(table.shape[1]):
            for t in range(page):
                if j * page + t > pos[b] and table[b, j] != 0:
                    dirty_k[table[b, j], t] = 1e3
                    dirty_v[table[b, j], t] = -1e3
    a = paged_attention_ref(_t(q), _t(clean_k), _t(clean_v), _t(table),
                            _t(pos))
    b = paged_attention_ref(_t(q), _t(dirty_k), _t(dirty_v), _t(table),
                            _t(pos))
    assert torch.equal(a, b)
    want = j_paged_ref(jnp.asarray(q), jnp.asarray(dirty_k),
                       jnp.asarray(dirty_v), jnp.asarray(table),
                       jnp.asarray(pos))
    np.testing.assert_allclose(b.numpy(), np.asarray(want), **TOL)


def test_paged_ops_cpu_matches_jax_pallas_interpret():
    """The wrapper on CPU tensors (its plain version) against the JAX Pallas
    kernel run in interpret mode; a CPU call launches nothing."""
    rng = np.random.default_rng(5)
    q, kp, vp, table, pos = _paged_case(rng, B=2, K=1, G=2, hd=8,
                                        n_pages=2, P=6, pos=(5, 2))
    want = jpa_ops.paged_attention(jnp.asarray(q), jnp.asarray(kp),
                                   jnp.asarray(vp), jnp.asarray(table),
                                   jnp.asarray(pos), interpret=True)
    before = pa_ops.paged_attention.launches
    got = pa_ops.paged_attention(_t(q), _t(kp), _t(vp), _t(table), _t(pos))
    assert pa_ops.paged_attention.launches == before
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_paged_ops_rejects_bad_shapes():
    rng = np.random.default_rng(6)
    q, kp, vp, table, pos = _paged_case(rng, n_pages=4)
    with pytest.raises(ValueError, match="one query token"):
        pa_ops.paged_attention(_t(np.concatenate([q, q], 1)), _t(kp), _t(vp),
                               _t(table), _t(pos))
    with pytest.raises(ValueError, match="exceeds"):
        pa_ops.paged_attention(_t(q), _t(kp), _t(vp), _t(table), _t(pos),
                               window=8)                 # W = 16 > 8


# ---------------------------------------------------------------------------
# flash attention: plain version vs the JAX oracles
# ---------------------------------------------------------------------------

def _qkv(rng, B=2, Sq=16, Sk=16, H=4, K=2, hd=16):
    q = rng.standard_normal((B, Sq, H, hd)).astype(np.float32)
    k = rng.standard_normal((B, Sk, K, hd)).astype(np.float32)
    v = rng.standard_normal((B, Sk, K, hd)).astype(np.float32)
    return q, k, v


@pytest.mark.parametrize("causal,window", [(True, None), (True, 5),
                                           (False, None), (False, 6)])
def test_attention_ref_matches_jax(causal, window):
    rng = np.random.default_rng(11)
    q, k, v = _qkv(rng, H=2, K=2)
    want = j_attention_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                           causal=causal, window=window)
    got = attention_ref(_t(q), _t(k), _t(v), causal=causal, window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("H,K", [(4, 2), (4, 1), (2, 2)])
@pytest.mark.parametrize("window", [None, 6])
def test_flash_ref_gqa_matches_jax_chunked(H, K, window):
    """GQA without repeat vs the JAX flash-semantics chunked scan."""
    rng = np.random.default_rng(H * 10 + K)
    q, k, v = _qkv(rng, H=H, K=K)
    want = JL.chunked_attention(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), causal=True, window=window,
                                kv_chunk=8)
    got = flash_attention_ref(_t(q), _t(k), _t(v), causal=True,
                              window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_flash_ref_q_offsets_match_jax_full_attention():
    """Per-row offsets: row b's queries sit at off[b] + i; each row alone
    equals JAX full_attention with that q_offset."""
    rng = np.random.default_rng(12)
    q, k, v = _qkv(rng, Sq=4, Sk=16, H=4, K=2)
    offs = np.array([3, 12], np.int32)
    got = flash_attention_ref(_t(q), _t(k), _t(v), causal=True,
                              q_offsets=_t(offs))
    for b in range(2):
        want = JL.full_attention(jnp.asarray(q[b:b + 1]),
                                 jnp.asarray(k[b:b + 1]),
                                 jnp.asarray(v[b:b + 1]), causal=True,
                                 q_offset=int(offs[b]))
        np.testing.assert_allclose(got[b:b + 1].numpy(), np.asarray(want),
                                   **TOL)


def test_flash_ops_cpu_matches_jax_pallas_interpret():
    """The wrapper on CPU tensors against the JAX Pallas kernel in
    interpret mode, GQA and q_offsets (the decode-over-a-copy contract)."""
    rng = np.random.default_rng(13)
    q, k, v = _qkv(rng, Sq=1, Sk=8, H=2, K=1, hd=8)
    offs = np.array([2, 7], np.int32)
    want = jfa_ops.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), causal=True,
                                   q_offsets=jnp.asarray(offs),
                                   interpret=True)
    before = fa_ops.flash_attention.launches
    got = fa_ops.flash_attention(_t(q), _t(k), _t(v), causal=True,
                                 q_offsets=_t(offs))
    assert fa_ops.flash_attention.launches == before
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
