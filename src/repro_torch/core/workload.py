"""Small trainable workloads + a Runner factory for the optimizer
experiments (stand-ins for the paper's MNIST/CIFAR/ImageNet-8; the JAX
package's ``core/workload.py`` in PyTorch).

- ``quadratic``: noisy strongly-convex quadratic — Theorem 1 is exact here.
- ``mlp_classify``: 2-layer MLP on a synthetic Gaussian-cluster task.
- ``cnn_classify``: the paper's CNN family (LeNet-ish) on synthetic images,
  with the conv/FC phase split (merged-FC head_filter applies), through
  ``models/cnn.py``: on the card its conv runs the lowering-conv and wgrad
  kernels (``conv_impl="lowering_cuda"``, the config default).
- ``rnn_classify``: a single-layer LSTM (paper App. F-F).

``init(generator)`` draws the parameters and ``sample_batches(generator,
steps, batch_size)`` the stacked batches (leaves (steps, batch, ...)) from
the ``torch.Generator`` they are given, on that generator's device. The
numbers differ from the JAX package's (``jax.random`` is not reproduced):
parity tests hand both packages the same numpy parameters and batches.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.models import cnn as cnn_mod


@dataclasses.dataclass
class Workload:
    name: str
    init: Callable                      # generator -> params
    loss_fn: Callable                   # (params, batch) -> scalar
    sample_batches: Callable            # (generator, steps, batch_size) -> stacked batches
    batch_size: int = 32
    head_filter: Optional[Callable] = None


def _nll(logits, labels):
    logp = torch.log_softmax(logits, dim=-1)
    return -torch.gather(logp, -1, labels.long()[:, None]).mean()


def quadratic(dim: int = 32, cond: float = 10.0, noise: float = 0.1) -> Workload:
    eig_host = torch.from_numpy(
        (np.linspace(1.0, cond, dim) / cond).astype(np.float32))

    def init(gen):
        return {"w": torch.randn((dim,), generator=gen, device=gen.device)}

    def loss_fn(params, batch):
        w = params["w"]
        eig = eig_host.to(w.device)
        return 0.5 * torch.sum(eig * w * w) + torch.dot(batch["xi"], w)

    def sample(gen, steps, batch_size):
        return {"xi": noise * torch.randn((steps, dim), generator=gen,
                                          device=gen.device)}
    return Workload("quadratic", init, loss_fn, sample, batch_size=1)


def mlp_classify(dim: int = 16, classes: int = 4, hidden: int = 32,
                 batch_size: int = 32) -> Workload:
    centers = torch.randn((classes, dim),
                          generator=torch.Generator().manual_seed(99)) * 2.0

    def init(gen):
        dev = gen.device
        return {"w1": torch.randn((dim, hidden), generator=gen, device=dev)
                * dim ** -0.5,
                "b1": torch.zeros((hidden,), device=dev),
                "w2": torch.randn((hidden, classes), generator=gen,
                                  device=dev) * hidden ** -0.5,
                "b2": torch.zeros((classes,), device=dev)}

    def loss_fn(params, batch):
        h = torch.relu(batch["x"] @ params["w1"] + params["b1"])
        return _nll(h @ params["w2"] + params["b2"], batch["y"])

    def sample(gen, steps, bsz):
        dev = gen.device
        y = torch.randint(0, classes, (steps, bsz), generator=gen,
                          device=dev, dtype=torch.int32)
        x = centers.to(dev)[y.long()] + torch.randn(
            (steps, bsz, dim), generator=gen, device=dev)
        return {"x": x, "y": y}
    return Workload("mlp", init, loss_fn, sample, batch_size=batch_size)


def cnn_config(conv_impl: Optional[str] = None) -> cnn_mod.CNNConfig:
    """``cnn_classify``'s network: LeNet's family at 12x12x1, one 3x3 conv
    of 8 features pooled by 2, an FC of 16, 4 classes."""
    cfg = dataclasses.replace(cnn_mod.LENET, image_size=12, num_classes=4,
                              convs=(cnn_mod.ConvSpec(8, 3, pool=2),),
                              fc_dims=(16,))
    if conv_impl is not None:
        cfg = dataclasses.replace(cfg, conv_impl=conv_impl)
    return cfg


def cnn_classify(batch_size: int = 16,
                 conv_impl: Optional[str] = None) -> Workload:
    """``conv_impl``: the model's conv arm (default: the config's,
    ``"lowering_cuda"``, which needs the card; ``"lowering"`` is its plain
    twin on the CPU)."""
    cfg = cnn_config(conv_impl)
    proto = torch.randn((4, cfg.image_size, cfg.image_size, 1),
                        generator=torch.Generator().manual_seed(5))

    def init(gen):
        return cnn_mod.init_params(gen, cfg)

    def loss_fn(params, batch):
        return cnn_mod.loss_fn(params, batch, cfg)

    def sample(gen, steps, bsz):
        dev = gen.device
        y = torch.randint(0, 4, (steps, bsz), generator=gen, device=dev,
                          dtype=torch.int32)
        x = proto.to(dev)[y.long()] + 0.5 * torch.randn(
            (steps, bsz, cfg.image_size, cfg.image_size, 1), generator=gen,
            device=dev)
        return {"images": x, "labels": y}
    return Workload("cnn", init, loss_fn, sample, batch_size=batch_size,
                    head_filter=cnn_mod.head_filter)


def rnn_classify(dim: int = 8, hidden: int = 24, seq: int = 16,
                 classes: int = 2, batch_size: int = 16) -> Workload:
    """Paper App. F-F (Fig. 32): the compute-group tradeoff on RNN/LSTM
    models. Single-layer LSTM over synthetic AR(1) sequences whose decay
    rate determines the class."""
    decays = torch.linspace(0.35, 0.9, classes)

    def init(gen):
        dev = gen.device
        return {
            "wx": torch.randn((dim, 4 * hidden), generator=gen, device=dev)
            * dim ** -0.5,
            "wh": torch.randn((hidden, 4 * hidden), generator=gen,
                              device=dev) * hidden ** -0.5,
            "b": torch.zeros((4 * hidden,), device=dev),
            "w_out": torch.randn((hidden, classes), generator=gen,
                                 device=dev) * hidden ** -0.5,
        }

    def lstm(params, xs):
        b = xs.shape[0]
        h = torch.zeros((b, hidden), dtype=xs.dtype, device=xs.device)
        c = torch.zeros_like(h)
        for s in range(xs.shape[1]):
            z = xs[:, s] @ params["wx"] + h @ params["wh"] + params["b"]
            i, f, g, o = torch.split(z, hidden, dim=-1)
            c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
            h = torch.sigmoid(o) * torch.tanh(c)
        return h @ params["w_out"]

    def loss_fn(params, batch):
        return _nll(lstm(params, batch["x"]), batch["y"])

    def sample(gen, steps, bsz):
        dev = gen.device
        y = torch.randint(0, classes, (steps, bsz), generator=gen,
                          device=dev, dtype=torch.int32)
        noise = torch.randn((steps, bsz, seq, dim), generator=gen,
                            device=dev)
        d = decays.to(dev)[y.long()][..., None]
        xs, prev = [], torch.zeros((steps, bsz, dim), device=dev)
        for s in range(seq):
            prev = prev * d + noise[:, :, s]
            xs.append(prev)
        return {"x": torch.stack(xs, dim=2), "y": y}

    return Workload("lstm", init, loss_fn, sample, batch_size=batch_size)


def make_runner(workload: Workload, *, seed: int = 0,
                weight_decay: float = 0.0, strategy: str = "delayed",
                device="cuda", update_impl: str = "cuda"):
    """Runner for Algorithm 1: an ``Engine`` configured from the workload
    (the engine *is* the Runner). The default ``strategy="delayed"`` is
    exact delayed SGD at staleness g-1, state = (params, step_counter),
    probe runs restarting from the same checkpoint without moving the
    batch stream (paper App E). ``strategy="grouped-fused"`` /
    ``"grouped-scan"`` run the same protocol on the deployable grouped
    step (its update through ``update_impl``: ``"cuda"`` the fused-update
    kernel, ``"torch"`` the plain version, which the CPU needs)."""
    from repro_torch.engine import Engine   # deferred: engine imports core
    return Engine(workload.loss_fn, strategy=strategy,
                  weight_decay=weight_decay, head_filter=workload.head_filter,
                  sample_batches=workload.sample_batches,
                  batch_size=workload.batch_size, seed=seed, device=device,
                  update_impl=update_impl)


def init_state(workload: Workload, seed: int = 0, device="cuda"):
    """``(params, 0)``: the workload's parameters drawn on ``device`` from
    a generator seeded with ``seed``."""
    from repro_torch.device import resolve
    gen = torch.Generator(device=resolve(device)).manual_seed(seed)
    return (workload.init(gen), 0)
