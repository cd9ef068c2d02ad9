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
AlexNet's JAX tree is flat, ``{'conv_<i>' | 'fc_<j>': {'kernel', 'bias'}}``
with no ``features`` / ``trunk`` level, and its port names are
``conv_<i>.weight`` and so on; the same two functions map it, and ``fc_0``'s
rows line up unchanged there too (both packages flatten NHWC).

Both functions take any tree shaped like the backbone's weights: a method's
importance trees (``omega``, ``theta_star``, SI's ``w``) and PackNet's uint8
ownership masks (with their 0-d sentinels for biases and batch-norm leaves)
travel inside a model's ``method_aux`` through them, in the same layouts as
the weights. ``params_from_jax`` casts to float32 unless it is told to keep
the dtype (``dtype=None``); ``params_to_jax`` keeps every dtype numpy has
(bfloat16 becomes float32).

HAT and PathNet keep flat trees of their own, with the same leaves:

- HAT: ``conv_<i>/{kernel,bias}`` (``i`` counts the convs, not the cfg
  entries), ``fc_<j>/{kernel,bias}`` and the bare ``(n_tasks, C)`` arrays
  ``emb_conv_<i>`` / ``emb_fc_<j>``; in the port ``conv_<i>.weight``
  (OIHW, channels_last), ``conv_<i>.bias``, ..., ``emb_conv_<i>``. The
  same pair carries HAT's ``mask_back`` tree and its momentum.
- PathNet: ``conv_<i>_kernel`` ``(M, kh, kw, in, out)``, ``conv_<i>_bias``
  ``(M, out)``, ``fc_<j>_kernel`` ``(M, in, out)``, ``fc_<j>_bias``; in the
  port ``conv_<i>.weight`` ``(M, out, in, kh, kw)`` and ``fc_<j>.weight``
  ``(M, out, in)``, so that the rows of the selected modules are one
  conv's or one linear layer's weight."""

from __future__ import annotations

import numpy as np
import torch
import torch.nn as nn

_SUFFIX = {"kernel": "weight", "bias": "bias", "scale": "scale"}
_INVERSE = {v: k for k, v in _SUFFIX.items()}


def _leaf_from_jax(value, leaf: str, device, dtype) -> torch.Tensor:
    """One leaf of a conv / dense layer: HWIO -> OIHW (channels_last),
    (in, out) -> (out, in); a copy, never an alias."""
    a = np.asarray(value, dtype=dtype)
    if leaf == "kernel" and a.ndim > 1:
        a = a.transpose(3, 2, 0, 1) if a.ndim == 4 else a.T
    t = torch.tensor(a, device=device)
    if t.dim() == 4:
        t = t.contiguous(memory_format=torch.channels_last)
    return t


def _leaf_to_jax(t: torch.Tensor, suffix: str) -> np.ndarray:
    a = t.detach().cpu()
    a = (a.float() if a.dtype == torch.bfloat16 else a).numpy()
    if suffix == "weight":
        a = a.transpose(2, 3, 1, 0) if a.ndim == 4 else a.T
    return np.ascontiguousarray(a) if a.ndim else a  # keeps a 0-d leaf


def params_from_jax(tree: dict, device=None,
                    dtype=np.float32) -> dict[str, torch.Tensor]:
    """JAX-layout numpy pytree -> ``{torch parameter name: tensor}``, cast
    to ``dtype`` (None keeps each leaf's). The tree may nest at any depth:
    the VGG family's ``features`` / ``trunk`` level, or AlexNet's flat
    ``conv_<i>`` / ``fc_<j>``; the name is the path, dot-joined, with the
    leaf's torch name last."""
    out: dict[str, torch.Tensor] = {}

    def walk(node: dict, prefix: str) -> None:
        for key, value in node.items():
            if isinstance(value, dict):
                walk(value, f"{prefix}{key}.")
            else:
                out[prefix + _SUFFIX[key]] = _leaf_from_jax(
                    value, key, device, dtype)

    walk(tree, "")
    return out


def params_to_jax(params: dict[str, torch.Tensor] | nn.Module) -> dict:
    """``{torch parameter name: tensor}`` (or a backbone module) -> the
    JAX-layout numpy pytree."""
    if isinstance(params, nn.Module):
        params = dict(params.named_parameters())
    tree: dict = {}
    for name, t in params.items():
        *path, suffix = name.split(".")
        node = tree
        for key in path:
            node = node.setdefault(key, {})
        node[_INVERSE[suffix]] = _leaf_to_jax(t, suffix)
    return tree


def port_layout(tree: dict) -> bool:
    """True for a flat ``{torch parameter name: leaf}`` tree (the port's
    own layout, which epoch files of earlier port versions hold), False for
    a JAX-layout pytree: only the port's names hold a dot."""
    return any("." in name for name in tree)


def hat_params_from_jax(tree: dict, device=None) -> dict[str, torch.Tensor]:
    """HAT's flat JAX-layout tree -> ``{name: float32 tensor}``."""
    out = {}
    for name, value in tree.items():
        if isinstance(value, dict):
            for leaf, v in value.items():
                out[f"{name}.{_SUFFIX[leaf]}"] = _leaf_from_jax(
                    v, leaf, device, np.float32)
        else:
            out[name] = _leaf_from_jax(value, "emb", device, np.float32)
    return out


def hat_params_to_jax(params: dict[str, torch.Tensor]) -> dict:
    """The inverse of :func:`hat_params_from_jax`."""
    tree: dict = {}
    for name, t in params.items():
        if "." in name:
            layer, suffix = name.split(".")
            tree.setdefault(layer, {})[_INVERSE[suffix]] = \
                _leaf_to_jax(t, suffix)
        else:
            tree[name] = _leaf_to_jax(t, "emb")
    return tree


# PathNet: module-stacked kernels, (M, kh, kw, in, out) <-> (M, out, in,
# kh, kw) and (M, in, out) <-> (M, out, in)
_PATHNET_FROM = {5: (0, 4, 3, 1, 2), 3: (0, 2, 1)}
_PATHNET_TO = {5: (0, 3, 4, 2, 1), 3: (0, 2, 1)}


def pathnet_params_from_jax(tree: dict,
                            device=None) -> dict[str, torch.Tensor]:
    """PathNet's flat JAX-layout tree -> ``{name: float32 tensor}``."""
    out = {}
    for name, value in tree.items():
        layer, leaf = name.rsplit("_", 1)
        a = np.asarray(value, dtype=np.float32)
        if leaf == "kernel":
            a = a.transpose(_PATHNET_FROM[a.ndim])
        out[f"{layer}.{_SUFFIX[leaf]}"] = torch.tensor(
            np.ascontiguousarray(a), device=device)
    return out


def pathnet_params_to_jax(params: dict[str, torch.Tensor]) -> dict:
    """The inverse of :func:`pathnet_params_from_jax`."""
    tree = {}
    for name, t in params.items():
        layer, suffix = name.split(".")
        a = t.detach().float().cpu().numpy()
        if suffix == "weight":
            a = a.transpose(_PATHNET_TO[a.ndim])
        tree[f"{layer}_{_INVERSE[suffix]}"] = np.ascontiguousarray(a)
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
