"""Weights from the seed, made on the device in one call.

The program's initialisation, drawn by the benchmark: each conv weight
kaiming-normal on its fan-out (std sqrt(2 / (out k k))), each dense weight
N(0, 0.01), every bias 0, the head bank's kernel 0.01 N(0, 1) and its bias
0 (``clsurvey_torch/models/backbones.py:reset_parameters``,
``models/heads.py:init_head_bank``). One ``torch.randn`` on the device
fills every drawn leaf, which is then scaled; the result is float32 in the
parameters' logical layout (OIHW, (out, in)). The harness hands these to
the program and the plain reference makes them again from the same seed.
Plain PyTorch."""

from __future__ import annotations

import math

import torch

from clbench import seeds
from clbench.reference import net


def _std(cfg: dict) -> dict[str, float]:
    """{parameter name: the std of its draw}; a leaf not named is 0."""
    std = {"heads.kernel": 0.01}
    for layer, _, dst in net.shapes(cfg):
        if layer["op"] == "conv":
            std[layer["name"] + ".weight"] = math.sqrt(
                2.0 / (dst[0] * layer["k"] * layer["k"]))
        elif layer["op"] == "fc":
            std[layer["name"] + ".weight"] = 0.01
    return std


def make(cfg: dict, seed: int, stream: int, device) -> dict[str, torch.Tensor]:
    """{parameter name: float32 tensor on ``device``}, the backbone's
    parameters then ``heads.kernel`` and ``heads.bias``."""
    shapes = net.param_shapes(cfg)
    std = _std(cfg)
    drawn = [n for n in shapes if n in std]
    total = sum(math.prod(shapes[n]) for n in drawn)
    flat = torch.randn(total, generator=seeds.generator(
        seed, stream, device=device), device=device, dtype=torch.float32)
    out, at = {}, 0
    for name, shape in shapes.items():
        if name in std:
            size = math.prod(shape)
            out[name] = flat[at:at + size].view(shape) * std[name]
            at += size
        else:
            out[name] = torch.zeros(shape, device=device)
    return out
