"""PyTorch backbones: the custom VGG family (no batch-norm, no dropout yet).

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
  returned features are float32.

Parameter names are the JAX package's (``features.conv_<cfg index>``,
``trunk.fc_<j>``), so ``models/convert.py`` maps them one to one.
Weight init mirrors torchvision's VGG ``_initialize_weights``:
kaiming-normal (fan_out, relu) for convs, N(0, 0.01) for linears (kaiming
for tiny_CNN's trunk, like the JAX package), zero biases."""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

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


def _cast(t: torch.Tensor | None, dtype) -> torch.Tensor | None:
    return t if t is None or t.dtype == dtype else t.to(dtype)


class VGGBackbone(nn.Module):
    """features -> NHWC flatten -> trunk -> float32 feature vector (the
    task head is applied outside, from the stacked head bank)."""

    def __init__(self, cfg_name: str, classifier_dims: Sequence[int],
                 input_size: Sequence[int], dtype=torch.float32):
        super().__init__()
        self.cfg_name = cfg_name
        self.dtype = dtype
        self.cfg = VGG_CFG[cfg_name]
        self.features = nn.ModuleDict()
        cin, (h, w) = 3, input_size
        for i, v in enumerate(self.cfg):
            if v == "M":
                h, w = h // 2, w // 2
                continue
            self.features[f"conv_{i}"] = nn.Conv2d(cin, int(v), 3, padding=1)
            cin = int(v)
        self.trunk = nn.ModuleDict()
        fan_in = cin * h * w
        for j, d in enumerate(classifier_dims):
            self.trunk[f"fc_{j}"] = nn.Linear(fan_in, int(d))
            fan_in = int(d)
        self.feature_dim = int(classifier_dims[-1])
        self.reset_parameters()

    def reset_parameters(self, generator: torch.Generator | None = None):
        dense_kaiming = self.cfg_name == "tiny_CNN"
        with torch.no_grad():
            for conv in self.features.values():
                fan_out = conv.out_channels * 9
                conv.weight.normal_(0.0, (2.0 / fan_out) ** 0.5,
                                    generator=generator)
                conv.bias.zero_()
            for fc in self.trunk.values():
                std = (2.0 / fc.out_features) ** 0.5 if dense_kaiming \
                    else 0.01
                fc.weight.normal_(0.0, std, generator=generator)
                fc.bias.zero_()

    def forward(self, x_nhwc: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        x = _cast(x_nhwc, dt).permute(0, 3, 1, 2)  # NCHW, channels_last
        for i, v in enumerate(self.cfg):
            if v == "M":
                y = pool2x2(x.permute(0, 2, 3, 1).contiguous())
                x = y.permute(0, 3, 1, 2)
            else:
                conv = self.features[f"conv_{i}"]
                x = torch.relu(F.conv2d(x, _cast(conv.weight, dt),
                                        _cast(conv.bias, dt), padding=1))
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)  # NHWC flatten
        for fc in self.trunk.values():
            x = torch.relu(F.linear(x, _cast(fc.weight, dt),
                                    _cast(fc.bias, dt)))
        return x.to(torch.float32)

