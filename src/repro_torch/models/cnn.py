"""The paper's own CNN workloads (CaffeNet/AlexNet-family, LeNet) with the
conv-phase / FC-phase split made explicit (paper §II-C, Fig. 1) — the split
drives the merged-FC ("sync head") update. The JAX package's
``models/cnn.py`` in PyTorch: NHWC activations, HWIO weights, VALID
padding, ``{"conv": [{"w", "b"}...], "fc": [...]}`` parameter trees.

``conv_impl`` (the port's names; ``device.py`` maps them onto the JAX
package's):

  "lowering_cuda"       the lowering-conv, wgrad and dgrad CUDA kernels
                        (the configs' default: the training path on the
                        card; the JAX "lowering_interpret")
  "lowering"            lowering + matmul with the custom backward, the
                        kernels' plain twin (the CPU training path)
  "lowering_autodiff"   the same algorithm under plain autograd (baseline)
  "torch"               F.conv2d (the JAX "xla" native conv)

The first conv layer is fed by data, so its input gradient is skipped
(``needs_dgrad=False`` — Caffe's ``propagate_down=false``).

On the ``lowering_cuda`` arm each conv runs the tiles the autotuner cached
for its geometry (``autotune_conv_tiles``, which the launcher calls before
the engine starts; ``kernels/lowering_conv/autotune.py``), or the fixed
rule for a layer never probed.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels.lowering_conv import autotune
from repro_torch.kernels.lowering_conv import ops as lc_ops


@dataclasses.dataclass(frozen=True)
class ConvSpec:
    features: int
    kernel: int
    stride: int = 1
    pool: int = 1          # max-pool window/stride after the conv (1 = none)


@dataclasses.dataclass(frozen=True)
class CNNConfig:
    name: str
    image_size: int
    in_channels: int
    num_classes: int
    convs: Tuple[ConvSpec, ...]
    fc_dims: Tuple[int, ...]
    # lowering_cuda | lowering | lowering_autodiff | torch (module doc)
    conv_impl: str = "lowering_cuda"
    source: str = ""


LENET = CNNConfig(
    name="lenet", image_size=28, in_channels=1, num_classes=10,
    convs=(ConvSpec(20, 5, pool=2), ConvSpec(50, 5, pool=2)),
    fc_dims=(500,),
    source="LeCun 1998 / Caffe MNIST tutorial (paper Fig. 8)")

# CaffeNet geometry (paper's main workload), scaled-down option for CPU runs.
CAFFENET = CNNConfig(
    name="caffenet", image_size=227, in_channels=3, num_classes=1000,
    convs=(ConvSpec(96, 11, stride=4, pool=2), ConvSpec(256, 5, pool=2),
           ConvSpec(384, 3), ConvSpec(384, 3), ConvSpec(256, 3, pool=2)),
    fc_dims=(4096, 4096),
    source="Krizhevsky 2012 / BVLC reference CaffeNet (paper §VI-A)")

CIFAR_NET = CNNConfig(
    name="cifarnet", image_size=32, in_channels=3, num_classes=10,
    convs=(ConvSpec(32, 5, pool=2), ConvSpec(32, 5, pool=2),
           ConvSpec(64, 5, pool=2)),
    fc_dims=(64,),
    source="Caffe CIFAR-10 tutorial (paper Fig. 8)")

CNN_CONFIGS = {c.name: c for c in (LENET, CAFFENET, CIFAR_NET)}


def get_cnn_config(name: str) -> CNNConfig:
    try:
        return CNN_CONFIGS[name]
    except KeyError:
        raise KeyError(f"unknown CNN arch {name!r}; "
                       f"known: {sorted(CNN_CONFIGS)}") from None


# Per-arch smoke geometry: shrink image/channels/classes but KEEP each
# family's defining structure — caffenet's strided big-kernel conv1,
# cifarnet's three pooled convs — so the smoke runs exercise stride > 1
# and pooling the way the full archs do.
_SMOKE_GEOMETRY = {
    "lenet": dict(image_size=16, convs=(ConvSpec(8, 5, pool=2),
                                        ConvSpec(16, 3)), fc_dims=(32,)),
    "caffenet": dict(image_size=33, convs=(ConvSpec(16, 7, stride=2, pool=2),
                                           ConvSpec(32, 3)), fc_dims=(64,)),
    "cifarnet": dict(image_size=20, convs=(ConvSpec(8, 5, pool=2),
                                           ConvSpec(16, 3, pool=2)),
                     fc_dims=(16,)),
}


def get_cnn_smoke_config(name: str) -> CNNConfig:
    """CPU-runnable reduced same-family config: shrink the image but keep
    the conv/FC phase split AND the family's conv structure
    (strides/pools)."""
    base = get_cnn_config(name)
    return dataclasses.replace(
        base, name=f"{base.name}-smoke", num_classes=4,
        **_SMOKE_GEOMETRY[base.name])


def _conv(x, w, b, stride, impl, needs_dgrad=True):
    if impl == "lowering_cuda":
        y = lc_ops.lowering_conv(
            x, w, stride=stride, needs_dgrad=needs_dgrad,
            tiles=autotune.cached_tiles(x.shape, w.shape, stride, x.device))
    elif impl == "lowering":
        y = lc_ops.lowering_conv_torch(x, w, stride=stride,
                                       needs_dgrad=needs_dgrad)
    elif impl == "lowering_autodiff":
        y = lc_ops.lowering_conv_autodiff(x, w, stride=stride)
    elif impl == "torch":
        y = F.conv2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1),
                     stride=stride).permute(0, 2, 3, 1)
    else:
        raise ValueError(f"unknown conv_impl {impl!r}")
    return y + b


def _maxpool(x, k):
    """Non-overlapping max pool as reshape + ``amax`` (VALID: trailing rows
    and columns that don't fill a window are dropped). ``amax`` splits the
    gradient evenly among tied maxima, as JAX's reduce-max VJP does (ReLU
    zeros tie often); ``max(dim)`` would send it all to one."""
    if k == 1:
        return x
    b, h, w, c = x.shape
    x = x[:, :h // k * k, :w // k * k, :]
    return x.reshape(b, h // k, k, w // k, k, c).amax(dim=(2, 4))


def init_params(generator: torch.Generator, cfg: CNNConfig, device=None):
    """Returns {"conv": [...], "fc": [...]} — the paper's two phases, with
    the JAX ``init_params``' distributions drawn from ``generator`` (the
    numbers differ from JAX's: tests hand both the same numpy params)."""
    device = generator.device if device is None else torch.device(device)

    def normal(shape, scale):
        return torch.randn(shape, generator=generator,
                           device=device) * scale

    conv_params = []
    c_in = cfg.in_channels
    size = cfg.image_size
    for spec in cfg.convs:
        w = normal((spec.kernel, spec.kernel, c_in, spec.features), 0.01)
        conv_params.append({"w": w, "b": torch.zeros(spec.features,
                                                     device=device)})
        size = (size - spec.kernel) // spec.stride + 1
        size = size // spec.pool if spec.pool > 1 else size
        c_in = spec.features
    flat = size * size * c_in
    fc_params = []
    dims = (flat,) + tuple(cfg.fc_dims) + (cfg.num_classes,)
    for j in range(len(dims) - 1):
        w = normal((dims[j], dims[j + 1]), dims[j] ** -0.5)
        fc_params.append({"w": w, "b": torch.zeros(dims[j + 1],
                                                   device=device)})
    return {"conv": conv_params, "fc": fc_params}


def forward(params, images, cfg: CNNConfig):
    """images: (B,H,W,C) -> logits (B,num_classes)."""
    x = images
    for i, (spec, p) in enumerate(zip(cfg.convs, params["conv"])):
        # layer 0 is fed by data: no input gradient (see module docstring)
        x = torch.relu(_conv(x, p["w"], p["b"], spec.stride, cfg.conv_impl,
                             needs_dgrad=i > 0))
        x = _maxpool(x, spec.pool)
    x = x.reshape(x.shape[0], -1)
    for i, p in enumerate(params["fc"]):
        x = x @ p["w"] + p["b"]
        if i < len(params["fc"]) - 1:
            x = torch.relu(x)
    return x


def loss_fn(params, batch, cfg: CNNConfig):
    logits = forward(params, batch["images"], cfg)
    logp = torch.log_softmax(logits, dim=-1)
    labels = batch["labels"].long()[:, None]
    return -torch.gather(logp, -1, labels).mean()


def conv_layer_shapes(cfg: CNNConfig, batch_size: int):
    """[(x_shape, w_shape, stride), ...] for each conv layer — the shapes
    the tile autotuner and the conv kernels' checks iterate."""
    out = []
    c_in, size = cfg.in_channels, cfg.image_size
    for spec in cfg.convs:
        out.append(((batch_size, size, size, c_in),
                    (spec.kernel, spec.kernel, c_in, spec.features),
                    spec.stride))
        size = (size - spec.kernel) // spec.stride + 1
        size = size // spec.pool if spec.pool > 1 else size
        c_in = spec.features
    return out


def autotune_conv_tiles(cfg: CNNConfig, batch_size: int, **kw):
    """Probe and cache the three kernels' tiles for every conv layer of
    ``cfg`` (only the ``lowering_cuda`` arm reads the cache; layer 0 is fed
    by data and probes no dgrad). ``kw`` goes to
    ``autotune.autotune_tiles``. Returns {layer_index: ConvTiles}."""
    return {i: autotune.autotune_tiles(x_shape, w_shape, stride,
                                       needs_dgrad=i > 0, **kw)
            for i, (x_shape, w_shape, stride) in enumerate(
                conv_layer_shapes(cfg, batch_size))}


def head_filter(path) -> bool:
    """True for FC-phase params (a path of dict keys and list indices,
    ``core.tree``) — the paper's merged-FC servers update these
    synchronously (zero staleness)."""
    return "fc" in path
