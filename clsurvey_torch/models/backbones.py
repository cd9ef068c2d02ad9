"""PyTorch backbones: the custom VGG family, with optional batch-norm and
dropout, and AlexNet.

Counterpart of ``clsurvey_tpu/models/backbones.py``:

- the public layout is NHWC, as in the JAX package; inside, the convs run
  in ``torch.channels_last``, whose memory is NHWC, so the preprocess and
  pool kernels read and write the convs' native layout with no transposes
  (``x.permute(0, 3, 1, 2)`` of an NHWC tensor is a channels_last view);
- every ``'M'`` is the port's 2x2 max-pool (``ops/pool.py``): kernels B1 and
  B2 on the card;
- ReLU masks its gradient on its output, which ``torch.relu``'s backward
  already does (``backbones.py:53-76`` of the JAX package);
- the flatten before the trunk is NHWC, channels fastest, so a JAX
  checkpoint's ``fc_0`` rows line up unchanged;
- ``dtype`` mirrors flax's ``dtype=``: parameters stay float32 and are cast,
  with the layer input, to ``dtype`` at each conv and dense layer; the
  returned features are float32;
- batch-norm sits between conv and ReLU and computes in float32 whatever
  ``dtype`` is (flax ``BatchNorm(dtype=float32)``). The module holds only
  ``scale`` and ``bias``; the running statistics are an argument, a flat
  dict ``{'features.bn_<i>.mean' | '.var': (C,)}``, and a train-mode call
  returns the new ones, as flax's ``mutable=['batch_stats']`` does. The
  running update is flax's, written out by hand: ``ra = 0.9*ra +
  0.1*batch`` with the *biased* batch variance (``nn.BatchNorm2d`` would
  feed the unbiased one). The batch variance is ``torch.var_mean``'s
  two-pass value, flax's is ``mean(x^2) - mean(x)^2``: float32 rounding
  apart, about 1e-6 relative at the activations' scale;
- dropout (rate 0.5) follows each trunk ReLU. Its keep-masks come from the
  caller, one (B, d_j) tensor per trunk layer, as the flip masks of the
  preprocess do: the engine draws them from the epoch's generator, a test
  hands in the JAX run's. A kept unit is scaled by 2, as flax does.

Parameter names are the JAX package's (``features.conv_<cfg index>``,
``features.bn_<cfg index>``, ``trunk.fc_<j>``; AlexNet's flat ``conv_<i>`` /
``fc_<j>``), so ``models/convert.py`` maps them one to one. Each backbone's
``drop_dims`` are the widths of its dropout keep-masks, which the engine
draws.
Weight init mirrors torchvision's VGG ``_initialize_weights``:
kaiming-normal (fan_out, relu) for convs, N(0, 0.01) for linears (kaiming
for tiny_CNN's trunk, like the JAX package), zero biases."""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from clsurvey_torch.ops.conv import conv2d
from clsurvey_torch.ops.pool import pool2x2

# Feature-extractor configs, numbers-as-data from the reference table
# (ref:src/models/VGGSlim.py:13-24). 'M' = 2x2 stride-2 max-pool.
VGG_CFG: dict[str, tuple] = {
    "19normal": (64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M",
                 512, 512, 512, 512, "M", 512, 512, 512, 512, "M"),
    "16normal": (64, 64, "M", 128, 128, "M", 256, 256, 256, "M",
                 512, 512, 512, "M", 512, 512, 512, "M"),
    "11normal": (64, "M", 128, "M", 256, 256, "M", 512, 512, "M", 512, 512, "M"),
    "small_VGG9": (64, "M", 64, "M", 64, 64, "M", 128, 128, "M"),
    "base_VGG9": (64, "M", 64, "M", 128, 128, "M", 256, 256, "M"),
    "wide_VGG9": (64, "M", 128, "M", 256, 256, "M", 512, 512, "M"),
    "deep_VGG22": (64, "M", 64, 64, 64, 64, 64, 64, "M",
                   128, 128, 128, 128, 128, 128, "M",
                   256, 256, 256, 256, 256, 256, "M"),
    # minimal net for fast CPU tests of the engine/methods (not a
    # reference model)
    "tiny_CNN": (8, "M", 16, "M"),
}


BN_MOMENTUM = 0.9  # flax's: the share of the old running value kept
BN_EPS = 1e-5
DROPOUT_RATE = 0.5


def _cast(t: torch.Tensor | None, dtype) -> torch.Tensor | None:
    return t if t is None or t.dtype == dtype else t.to(dtype)


class _ScaleBias(nn.Module):
    """A batch-norm layer's learnt ``scale`` and ``bias`` (flax's names);
    the statistics live outside the module."""

    def __init__(self, channels: int):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))


def bn_stat_names(i: int) -> tuple[str, str]:
    return f"features.bn_{i}.mean", f"features.bn_{i}.var"


class VGGBackbone(nn.Module):
    """features -> NHWC flatten -> trunk -> float32 feature vector (the
    task head is applied outside, from the stacked head bank)."""

    def __init__(self, cfg_name: str, classifier_dims: Sequence[int],
                 input_size: Sequence[int], dtype=torch.float32,
                 batch_norm: bool = False, dropout: bool = False):
        super().__init__()
        self.cfg_name = cfg_name
        self.dtype = dtype
        self.batch_norm = batch_norm
        self.dropout = dropout
        self.cfg = VGG_CFG[cfg_name]
        self.features = nn.ModuleDict()
        cin, (h, w) = 3, input_size
        for i, v in enumerate(self.cfg):
            if v == "M":
                h, w = h // 2, w // 2
                continue
            self.features[f"conv_{i}"] = nn.Conv2d(cin, int(v), 3, padding=1)
            if batch_norm:
                self.features[f"bn_{i}"] = _ScaleBias(int(v))
            cin = int(v)
        self.trunk = nn.ModuleDict()
        fan_in = cin * h * w
        for j, d in enumerate(classifier_dims):
            self.trunk[f"fc_{j}"] = nn.Linear(fan_in, int(d))
            fan_in = int(d)
        self.feature_dim = int(classifier_dims[-1])
        # dropout follows each trunk layer: masks of the layers' widths
        self.drop_dims = tuple(int(d) for d in classifier_dims)
        self.reset_parameters()

    def reset_parameters(self, generator: torch.Generator | None = None):
        dense_kaiming = self.cfg_name == "tiny_CNN"
        with torch.no_grad():
            for name, layer in self.features.items():
                layer.bias.zero_()
                if name.startswith("bn_"):
                    layer.scale.fill_(1.0)
                    continue
                fan_out = layer.out_channels * 9
                layer.weight.normal_(0.0, (2.0 / fan_out) ** 0.5,
                                     generator=generator)
            for fc in self.trunk.values():
                std = (2.0 / fc.out_features) ** 0.5 if dense_kaiming \
                    else 0.01
                fc.weight.normal_(0.0, std, generator=generator)
                fc.bias.zero_()

    def init_batch_stats(self) -> dict[str, torch.Tensor]:
        """Running mean 0 and variance 1 for every batch-norm layer (empty
        without batch-norm), on the parameters' device."""
        stats = {}
        for name, layer in self.features.items():
            if name.startswith("bn_"):
                mean, var = bn_stat_names(int(name[3:]))
                stats[mean] = torch.zeros_like(layer.scale)
                stats[var] = torch.ones_like(layer.scale)
        return stats

    def _bn(self, x, i: int, batch_stats, train: bool, new_stats: dict):
        layer = self.features[f"bn_{i}"]
        mean_name, var_name = bn_stat_names(i)
        x = _cast(x, torch.float32)
        if not train:
            # flax's formula, elementwise: (x - mean) * (rsqrt(var + eps)
            # * scale) + bias. Safe under torch.func.vmap(grad).
            mul = torch.rsqrt(batch_stats[var_name] + BN_EPS) * layer.scale
            return ((x - batch_stats[mean_name].view(1, -1, 1, 1))
                    * mul.view(1, -1, 1, 1) + layer.bias.view(1, -1, 1, 1))
        with torch.no_grad():
            var, mean = torch.var_mean(x, dim=(0, 2, 3), correction=0)
            for name, batch in ((mean_name, mean), (var_name, var)):
                new_stats[name] = (BN_MOMENTUM * batch_stats[name]
                                   + (1.0 - BN_MOMENTUM) * batch)
        return F.batch_norm(x, None, None, layer.scale, layer.bias,
                            training=True, eps=BN_EPS)

    def forward(self, x: torch.Tensor, batch_stats: dict | None = None,
                train: bool = False, dropout_masks=None,
                part: str = "all"):
        """``train=False``: the float32 features, batch-norm on the running
        statistics, no dropout. ``train=True``: ``(features, new
        batch_stats)``, batch-norm on the batch's statistics, dropout under
        ``dropout_masks``.

        ``part="features"`` stops after the conv extractor and returns its
        NHWC-flattened float32 output (EBLL's autoencoder space) in place of
        the features; ``part="trunk"`` takes such a flat tensor as ``x``
        and runs only the trunk."""
        new_stats: dict = {}
        if part != "trunk":
            x = self._features(x, batch_stats, train, new_stats)
        if part != "features":
            x = self._trunk(x, train, dropout_masks)
        x = x.to(torch.float32)
        if not train:
            return x
        return x, ({**batch_stats, **new_stats} if new_stats
                   else batch_stats)

    def _features(self, x_nhwc, batch_stats, train, new_stats):
        dt = self.dtype
        x = x_nhwc.permute(0, 3, 1, 2)  # NCHW, channels_last
        for i, v in enumerate(self.cfg):
            if v == "M":
                y = pool2x2(x.permute(0, 2, 3, 1).contiguous())
                x = y.permute(0, 3, 1, 2)
                continue
            conv = self.features[f"conv_{i}"]
            x = conv2d(_cast(x, dt), _cast(conv.weight, dt),
                       _cast(conv.bias, dt), padding=1)
            if self.batch_norm:
                x = self._bn(x, i, batch_stats, train, new_stats)
            x = torch.relu(x)
        return x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)  # NHWC flatten

    def _trunk(self, x, train, dropout_masks):
        dt = self.dtype
        drop = train and self.dropout
        if drop and (dropout_masks is None
                     or len(dropout_masks) != len(self.trunk)):
            raise ValueError(
                "a train-mode forward of a dropout model needs one keep-mask "
                "per trunk layer from the caller (Engine.train_epoch draws "
                "them from the epoch's generator)")
        for j, fc in enumerate(self.trunk.values()):
            x = torch.relu(F.linear(_cast(x, dt), _cast(fc.weight, dt),
                                    _cast(fc.bias, dt)))
            if drop:
                x = x * (dropout_masks[j].to(x.dtype)
                         * (1.0 / (1.0 - DROPOUT_RATE)))
        return x


# AlexNet (ref:src/models/net.py:96-125 wraps torchvision's): (out, kernel,
# stride, padding) per conv, a 3x3/2 max-pool after convs 0, 1 and 4
ALEX_CONVS = ((64, 11, 4, 2), (192, 5, 1, 2), (384, 3, 1, 1),
              (256, 3, 1, 1), (256, 3, 1, 1))
ALEX_POOL_AFTER = (0, 1, 4)
ALEX_FC = 4096


def alexnet_smid(px: int) -> int:
    """Spatial extent after AlexNet's conv / pool stack (6 at 224 px, 2 at
    96); an input below 63 px leaves nothing to pool and raises."""
    n = int(px)
    for i, (_, k, st, p) in enumerate(ALEX_CONVS):
        n = (n + 2 * p - k) // st + 1
        if i in ALEX_POOL_AFTER:
            n = (n - 3) // 2 + 1
    if n < 1:
        raise ValueError(f"AlexNet needs inputs of at least 63 px, not {px}")
    return n


class AlexNetBackbone(nn.Module):
    """Counterpart of ``clsurvey_tpu/models/backbones.py:AlexNetBackbone``:
    five convs, each with ReLU, ``F.max_pool2d(3, 2)`` after convs 0, 1 and
    4 (the JAX package pools AlexNet with flax's ``max_pool``, not with its
    Pallas kernel, so no pool kernel runs here), the NHWC flatten (6*6*256
    at 224 px), then per FC layer dropout *before* the dense layer, then
    ReLU (AlexNet's order, not the VGG trunk's). The two keep-masks are
    handed in, of the FC layers' input widths (``drop_dims``). Parameters
    are top-level ``conv_<i>`` / ``fc_<j>``, as in the JAX package's flat
    tree. The same ``forward`` interface as :class:`VGGBackbone`; no
    batch-norm, so ``batch_stats`` is passed through."""

    dropout = True

    def __init__(self, input_size: Sequence[int], dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        cin = 3
        for i, (f, k, st, p) in enumerate(ALEX_CONVS):
            setattr(self, f"conv_{i}", nn.Conv2d(cin, f, k, stride=st,
                                                 padding=p))
            cin = f
        h, w = (alexnet_smid(int(n)) for n in input_size)
        self.flat_dim = cin * h * w
        self.fc_0 = nn.Linear(self.flat_dim, ALEX_FC)
        self.fc_1 = nn.Linear(ALEX_FC, ALEX_FC)
        self.feature_dim = ALEX_FC
        self.drop_dims = (self.flat_dim, ALEX_FC)
        self.reset_parameters()

    def reset_parameters(self, generator: torch.Generator | None = None):
        """The JAX package's ``conv_init`` (kaiming-normal, fan_out) and
        ``dense_init`` (N(0, 0.01)), zero biases."""
        with torch.no_grad():
            for i in range(len(ALEX_CONVS)):
                conv = getattr(self, f"conv_{i}")
                fan_out = conv.out_channels * conv.kernel_size[0] \
                    * conv.kernel_size[1]
                conv.weight.normal_(0.0, (2.0 / fan_out) ** 0.5,
                                    generator=generator)
                conv.bias.zero_()
            for fc in (self.fc_0, self.fc_1):
                fc.weight.normal_(0.0, 0.01, generator=generator)
                fc.bias.zero_()

    def init_batch_stats(self) -> dict[str, torch.Tensor]:
        return {}

    def forward(self, x: torch.Tensor, batch_stats: dict | None = None,
                train: bool = False, dropout_masks=None,
                part: str = "all"):
        """As :meth:`VGGBackbone.forward`: ``part="features"`` returns the
        NHWC-flattened float32 conv output (EBLL's autoencoder space),
        ``part="trunk"`` runs the FC layers on such a tensor."""
        if part != "trunk":
            x = self._features(x)
        if part != "features":
            x = self._trunk(x, train, dropout_masks)
        x = x.to(torch.float32)
        return (x, batch_stats) if train else x

    def _features(self, x_nhwc):
        dt = self.dtype
        x = x_nhwc.permute(0, 3, 1, 2)  # NCHW, channels_last
        for i, (_, _, st, p) in enumerate(ALEX_CONVS):
            conv = getattr(self, f"conv_{i}")
            x = torch.relu(conv2d(_cast(x, dt), _cast(conv.weight, dt),
                                  _cast(conv.bias, dt), stride=st,
                                  padding=p))
            if i in ALEX_POOL_AFTER:
                x = F.max_pool2d(x, 3, 2)
        return x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)  # NHWC flatten

    def _trunk(self, x, train, dropout_masks):
        dt = self.dtype
        if train and (dropout_masks is None or len(dropout_masks) != 2):
            raise ValueError(
                "a train-mode forward of AlexNet needs one keep-mask per FC "
                "layer from the caller (Engine.train_epoch draws them from "
                "the epoch's generator)")
        for j, fc in enumerate((self.fc_0, self.fc_1)):
            if train:
                x = x * (dropout_masks[j].to(x.dtype)
                         * (1.0 / (1.0 - DROPOUT_RATE)))
            x = torch.relu(F.linear(_cast(x, dt), _cast(fc.weight, dt),
                                    _cast(fc.bias, dt)))
        return x
