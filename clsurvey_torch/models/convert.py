"""Backbone weights between the JAX package's layout and the port's.

Checkpoints on disk keep the JAX package's pytree
``{'features': {'conv_<i>': {'kernel': HWIO, 'bias'}}, 'trunk': {'fc_<j>':
{'kernel': (in, out), 'bias'}}}`` of numpy arrays, so a model written by
either package loads in the other. In the port the same weights are a flat
``{'features.conv_<i>.weight': OIHW, ..., 'trunk.fc_<j>.weight': (out, in),
...}`` dict of tensors, the backbone module's parameter names. ``fc_0``'s
rows need no permutation: both packages flatten NHWC, channels fastest.
Conv weights are made channels_last, the layout the convs run in. A
batch-norm layer's ``bn_<i>/{scale,bias}`` become ``features.bn_<i>.scale``
and ``.bias``, and its running statistics, flax's separate ``batch_stats``
collection ``{'features': {'bn_<i>': {'mean', 'var'}}}``, become the flat
``{'features.bn_<i>.mean', 'features.bn_<i>.var'}`` dict the backbone takes.

Both functions take any tree shaped like the backbone's weights: a method's
importance trees (``omega``, ``theta_star``, SI's ``w``) and PackNet's uint8
ownership masks (with their 0-d sentinels for biases and batch-norm leaves)
travel inside a model's ``method_aux`` through them, in the same layouts as
the weights. ``params_from_jax`` casts to float32 unless it is told to keep
the dtype (``dtype=None``); ``params_to_jax`` keeps every dtype numpy has
(bfloat16 becomes float32)."""

from __future__ import annotations

import numpy as np
import torch
import torch.nn as nn

_SUFFIX = {"kernel": "weight", "bias": "bias", "scale": "scale"}


def params_from_jax(tree: dict, device=None,
                    dtype=np.float32) -> dict[str, torch.Tensor]:
    """JAX-layout numpy pytree -> ``{torch parameter name: tensor}``, cast
    to ``dtype`` (None keeps each leaf's)."""
    out = {}
    for group, layers in tree.items():
        for layer, leaves in layers.items():
            for leaf, value in leaves.items():
                a = np.asarray(value, dtype=dtype)
                if leaf == "kernel" and a.ndim > 1:
                    a = a.transpose(3, 2, 0, 1) if a.ndim == 4 else a.T
                t = torch.tensor(a, device=device)  # a copy, never an alias
                if t.dim() == 4:
                    t = t.contiguous(memory_format=torch.channels_last)
                out[f"{group}.{layer}.{_SUFFIX[leaf]}"] = t
    return out


def params_to_jax(params: dict[str, torch.Tensor] | nn.Module) -> dict:
    """``{torch parameter name: tensor}`` (or a backbone module) -> the
    JAX-layout numpy pytree."""
    if isinstance(params, nn.Module):
        params = dict(params.named_parameters())
    inverse = {v: k for k, v in _SUFFIX.items()}
    tree: dict = {}
    for name, t in params.items():
        group, layer, suffix = name.split(".")
        a = t.detach().cpu()
        a = (a.float() if a.dtype == torch.bfloat16 else a).numpy()
        if suffix == "weight":
            a = a.transpose(2, 3, 1, 0) if a.ndim == 4 else a.T
        tree.setdefault(group, {}).setdefault(layer, {})[inverse[suffix]] = \
            np.ascontiguousarray(a) if a.ndim else a  # keeps a 0-d leaf
    return tree


def batch_stats_from_jax(tree: dict | None,
                         device=None) -> dict[str, torch.Tensor]:
    """flax ``batch_stats`` numpy pytree -> ``{'features.bn_<i>.mean' |
    '.var': tensor}`` (empty for a model without batch-norm)."""
    return {f"{group}.{layer}.{leaf}":
            torch.tensor(np.asarray(value, dtype=np.float32), device=device)
            for group, layers in (tree or {}).items()
            for layer, leaves in layers.items()
            for leaf, value in leaves.items()}


def batch_stats_to_jax(stats: dict[str, torch.Tensor]) -> dict:
    """The inverse: the flax ``batch_stats`` numpy pytree."""
    tree: dict = {}
    for name, t in stats.items():
        group, layer, leaf = name.split(".")
        tree.setdefault(group, {}).setdefault(layer, {})[leaf] = \
            t.detach().float().cpu().numpy()
    return tree
