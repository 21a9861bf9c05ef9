"""Port parity: the lowering conv and the CNN against the JAX package.

Same numpy-seeded inputs through both, fp32:

- the plain arm (``lowering_conv_torch``) forward and both gradients
  (``torch.autograd.grad``) against the JAX ``lowering_conv_xla`` and the
  Pallas kernels in interpret mode, over every smoke layer shape (stride 1
  and 2) and ``needs_dgrad`` both ways, within 1e-5 of the output's scale
  (the frameworks sum in other orders);
- ``wgrad_ref`` / ``dgrad_ref`` / ``col2im_ref`` against ``wgrad_xla`` /
  ``dgrad_xla`` / ``col2im_xla``;
- the kernels' wrappers on CPU tensors take their plain versions and
  launch nothing;
- CNN logits and loss gradients at identical parameters for the three
  smoke archs x ``conv_impl`` in {torch, lowering} (JAX: its "xla" and
  "lowering"), within 1e-5.

The CUDA kernels are held to these plain versions on the card
(``tests/test_torch_gpu.py``, ``chip_smoke.py``).
"""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.lowering_conv import bwd as jbwd
from repro.kernels.lowering_conv import ops as jlc
from repro.kernels.lowering_conv.ref import lower as j_lower
from repro.models import cnn as JC
from repro_torch.core import tree as T
from repro_torch.kernels.lowering_conv import bwd, ops
from repro_torch.kernels.lowering_conv.lowering_conv import (choose_tiles,
                                                             lowering_conv_cuda)
from repro_torch.kernels.lowering_conv.ref import conv_ref, lower
from repro_torch.models import cnn as C
from repro_torch.models.convert import params_from_jax

TOL = 1e-5


def _t(a):
    return torch.from_numpy(np.array(a))


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / (np.abs(b).max() + 1e-30))


def _layer_cases():
    """Every conv layer of the three smoke configs (caffenet-smoke keeps a
    strided 7x7 conv1), plus an 11x11 stride-4 CaffeNet conv1 kernel."""
    cases = []
    for arch in ("lenet", "cifarnet", "caffenet"):
        cfg = C.get_cnn_smoke_config(arch)
        for x_shape, w_shape, stride in C.conv_layer_shapes(cfg, 3):
            cases.append(pytest.param(x_shape, w_shape, stride,
                                      id=f"{arch}-{w_shape[0]}x{w_shape[1]}"
                                         f"s{stride}c{w_shape[3]}"))
    cases.append(pytest.param((2, 31, 31, 3), (11, 11, 3, 8), 4,
                              id="caffenet-conv1-11x11s4"))
    cases.append(pytest.param((2, 12, 12, 4), (3, 3, 4, 6), 2,
                              id="stride2-3x3"))
    return cases


def _inputs(x_shape, w_shape, stride, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(x_shape).astype(np.float32)
    w = (0.1 * rng.standard_normal(w_shape)).astype(np.float32)
    ho = (x_shape[1] - w_shape[0]) // stride + 1
    wo = (x_shape[2] - w_shape[1]) // stride + 1
    dy = rng.standard_normal((x_shape[0], ho, wo, w_shape[3])).astype(
        np.float32)
    return x, w, dy


@pytest.mark.parametrize("x_shape,w_shape,stride", _layer_cases())
@pytest.mark.parametrize("needs_dgrad", [True, False])
def test_plain_conv_value_and_grads_match_jax(x_shape, w_shape, stride,
                                              needs_dgrad):
    x, w, dy = _inputs(x_shape, w_shape, stride)

    def jgrad(conv):
        y, vjp = jax.vjp(conv, jnp.asarray(x), jnp.asarray(w))
        return (y,) + vjp(jnp.asarray(dy))

    want = jgrad(lambda a, b: jlc.lowering_conv_xla(
        a, b, stride=stride, needs_dgrad=needs_dgrad))
    xt, wt = _t(x).requires_grad_(True), _t(w).requires_grad_(True)
    y = ops.lowering_conv_torch(xt, wt, stride=stride, needs_dgrad=needs_dgrad)
    dx, dw = torch.autograd.grad(y, (xt, wt), _t(dy))
    for got, ref, name in ((y, want[0], "y"), (dx, want[1], "dx"),
                           (dw, want[2], "dw")):
        assert got.shape == ref.shape, name
        assert _rel(got.detach(), ref) <= TOL, name
    if not needs_dgrad:
        assert float(dx.abs().max()) == 0.0
    # the same algorithm, three ways, on the port's side
    assert _rel(y.detach(), conv_ref(_t(x), _t(w), stride)) <= TOL
    y2 = ops.lowering_conv_autodiff(xt, wt, stride=stride)
    dx2, dw2 = torch.autograd.grad(y2, (xt, wt), _t(dy))
    assert _rel(dw2, dw) <= TOL
    if needs_dgrad:
        assert _rel(dx2, dx) <= TOL


@pytest.mark.parametrize("needs_dgrad", [True, False])
def test_plain_conv_matches_jax_pallas_interpret(needs_dgrad):
    """The kernels' arm in JAX (Pallas, interpret mode) on one small
    stride-2 case: value and both gradients."""
    x, w, dy = _inputs((2, 13, 13, 3), (3, 3, 3, 8), 2, seed=1)
    y, vjp = jax.vjp(lambda a, b: jlc.lowering_conv(
        a, b, stride=2, bp=2, rb=3, interpret=True, needs_dgrad=needs_dgrad),
        jnp.asarray(x), jnp.asarray(w))
    jdx, jdw = vjp(jnp.asarray(dy))
    xt, wt = _t(x).requires_grad_(True), _t(w).requires_grad_(True)
    yt = ops.lowering_conv_torch(xt, wt, stride=2, needs_dgrad=needs_dgrad)
    dx, dw = torch.autograd.grad(yt, (xt, wt), _t(dy))
    assert _rel(yt.detach(), y) <= TOL
    assert _rel(dw, jdw) <= TOL
    assert _rel(dx, jdx) <= TOL if needs_dgrad else float(
        jnp.abs(jdx).max()) == float(dx.abs().max()) == 0.0


@pytest.mark.parametrize("stride", [1, 2])
def test_bwd_plain_forms_match_jax_xla_forms(stride):
    x, w, dy = _inputs((3, 11, 11, 4), (3, 3, 4, 5), stride, seed=2)
    low = lower(_t(x), 3, 3, stride)
    jlow = j_lower(jnp.asarray(x), 3, 3, stride)
    assert _rel(low, jlow) == 0.0
    assert _rel(bwd.wgrad_ref(low, _t(dy), w.shape),
                jbwd.wgrad_xla(jlow, jnp.asarray(dy), w.shape)) <= TOL
    assert _rel(bwd.dgrad_ref(_t(dy), _t(w), x.shape, stride),
                jbwd.dgrad_xla(jnp.asarray(dy), jnp.asarray(w), x.shape,
                               stride)) <= TOL
    dcols = np.random.default_rng(3).standard_normal(
        tuple(low.shape)).astype(np.float32)
    np.testing.assert_allclose(
        bwd.col2im_ref(_t(dcols), x.shape, 3, 3, stride).numpy(),
        np.asarray(jbwd.col2im_xla(jnp.asarray(dcols), x.shape, 3, 3,
                                   stride)), rtol=1e-6, atol=1e-6)


def test_kernel_wrappers_on_cpu_take_the_plain_versions():
    x, w, dy = _inputs((2, 9, 9, 3), (3, 3, 3, 4), 2, seed=4)
    counts = (lowering_conv_cuda.launches, bwd.wgrad_cuda.launches,
              bwd.dgrad_cuda.launches)
    y, low = lowering_conv_cuda(_t(x), _t(w), stride=2, return_lowered=True)
    assert low.shape == (2, 4, 4, 27)
    torch.testing.assert_close(y, conv_ref(_t(x), _t(w), 2), rtol=1e-5,
                               atol=1e-5)
    torch.testing.assert_close(bwd.wgrad_cuda(low, _t(dy), w.shape),
                               bwd.wgrad_ref(low, _t(dy), w.shape))
    torch.testing.assert_close(bwd.dgrad_cuda(_t(dy), _t(w), x.shape,
                                              stride=2),
                               bwd.dgrad_ref(_t(dy), _t(w), x.shape, 2))
    assert (lowering_conv_cuda.launches, bwd.wgrad_cuda.launches,
            bwd.dgrad_cuda.launches) == counts
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        ops.lowering_conv(_t(x), _t(w), stride=2)
    with pytest.raises(ValueError, match="does not fit"):
        lowering_conv_cuda(_t(x)[:, :2], _t(w))


def test_tiles_and_wgrad_slices():
    assert choose_tiles(64, 55, 8, 8) == (8, 5)
    for m, k, n, bn in ((193600, 363, 96, 96), (33856, 2400, 256, 64),
                        (1600, 3456, 256, 64), (5, 27, 4, 64)):
        rows, s = bwd.wgrad_slices(m, k, n)
        assert rows % bwd.WGRAD_STAGE_ROWS == 0
        assert rows <= bwd.WGRAD_MAX_SLICE_ROWS
        assert (s - 1) * rows < m <= s * rows
        assert bwd.dgrad_block_n(n) == bn     # the tile pads Cout least
        # wgrad's own default width: the fewest tiles of Cout
        tiles = (math.ceil(k / bwd.WGRAD_TILE_K)
                 * math.ceil(n / bwd.out_block_n(n)))
        # enough blocks to fill the card, unless every slice is one stage
        assert s * tiles >= bwd.WGRAD_TARGET_BLOCKS or rows == 32


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

def _model_case(arch, seed=0, batch=6):
    jcfg = JC.get_cnn_smoke_config(arch)
    jparams = jax.device_get(JC.init_params(jax.random.PRNGKey(seed), jcfg))
    rng = np.random.default_rng(seed)
    # non-zero biases, so the bias path carries signal
    jparams = jax.tree.map(
        lambda a: (a + 0.05 * rng.standard_normal(a.shape)).astype(a.dtype)
        if a.ndim == 1 else a, jparams)
    images = rng.standard_normal((batch, jcfg.image_size, jcfg.image_size,
                                  jcfg.in_channels)).astype(np.float32)
    labels = rng.integers(jcfg.num_classes, size=batch).astype(np.int32)
    return jcfg, jparams, images, labels


@pytest.mark.parametrize("arch", ["lenet", "cifarnet", "caffenet"])
@pytest.mark.parametrize("impl,jimpl", [("torch", "xla"),
                                        ("lowering", "lowering")])
def test_cnn_logits_and_grads_match_jax(arch, impl, jimpl):
    jcfg, jparams, images, labels = _model_case(arch)
    jcfg = dataclasses.replace(jcfg, conv_impl=jimpl)
    cfg = dataclasses.replace(C.get_cnn_smoke_config(arch), conv_impl=impl)
    jp = jax.tree.map(jnp.asarray, jparams)
    jbatch = {"images": jnp.asarray(images), "labels": jnp.asarray(labels)}
    jlogits, (jloss, jgrads) = jax.jit(lambda p: (
        JC.forward(p, jbatch["images"], jcfg),
        jax.value_and_grad(lambda q: JC.loss_fn(q, jbatch, jcfg))(p)))(jp)

    params = params_from_jax(jparams)
    flat = [p.requires_grad_(True) for p in T.leaves(params)]
    batch = {"images": _t(images), "labels": _t(labels)}
    logits = C.forward(params, batch["images"], cfg)
    loss = C.loss_fn(params, batch, cfg)
    grads = torch.autograd.grad(loss, flat)
    assert _rel(logits.detach(), jlogits) <= TOL
    assert abs(loss.item() - float(jloss)) <= TOL * abs(float(jloss))
    jflat = jax.tree.leaves(jgrads)
    assert len(jflat) == len(grads) == 2 * (len(cfg.convs) + len(cfg.fc_dims)
                                            + 1)
    for g, jg in zip(grads, jflat):
        assert g.shape == jg.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=TOL,
                                   atol=TOL * float(np.abs(jg).max()))


def test_cnn_configs_match_jax():
    for name in ("lenet", "cifarnet", "caffenet"):
        for get, jget in ((C.get_cnn_config, JC.get_cnn_config),
                          (C.get_cnn_smoke_config, JC.get_cnn_smoke_config)):
            a, b = get(name), jget(name)
            assert (a.name, a.image_size, a.in_channels, a.num_classes,
                    a.fc_dims, a.source) == (b.name, b.image_size,
                                             b.in_channels, b.num_classes,
                                             b.fc_dims, b.source)
            assert [dataclasses.astuple(s) for s in a.convs] == [
                dataclasses.astuple(s) for s in b.convs]
            assert C.conv_layer_shapes(a, 4) == JC.conv_layer_shapes(b, 4)
    assert C.CAFFENET.conv_impl == "lowering_cuda"
    gen = torch.Generator().manual_seed(0)
    p = C.init_params(gen, C.get_cnn_smoke_config("caffenet"))
    jp = JC.init_params(jax.random.PRNGKey(0),
                        JC.get_cnn_smoke_config("caffenet"))
    assert [tuple(x.shape) for x in T.leaves(p)] == [
        tuple(x.shape) for x in jax.tree.leaves(jp)]
    heads = [path for path, _ in T.leaves_with_path(p) if C.head_filter(path)]
    assert heads == [("fc", 0, "b"), ("fc", 0, "w"), ("fc", 1, "b"),
                     ("fc", 1, "w")]


def test_maxpool_splits_gradient_among_ties_as_jax():
    x = np.zeros((1, 4, 4, 1), np.float32)
    x[0, 0, 0, 0] = 1.0                          # one window with a max,
    jg = jax.grad(lambda a: JC._maxpool(a, 2).sum())(jnp.asarray(x))
    xt = _t(x).requires_grad_(True)
    (g,) = torch.autograd.grad(C._maxpool(xt, 2).sum(), (xt,))
    np.testing.assert_array_equal(g.numpy(), np.asarray(jg))
    assert float(g[0, 2, 2, 0]) == 0.25          # three tied all-zero ones
