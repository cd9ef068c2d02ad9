"""The plain network of a configuration, read from its layer list.

A configuration (``clbench/configs/<name>.json``) lists its layers as data:
``conv`` (``out``, ``k``, ``stride``, ``pad``, and the program's parameter
``name``), ``relu``, ``maxpool`` (``k``, ``stride``), ``flatten`` (NHWC
order, channels fastest, as the program flattens), ``dropout`` (``p``, the
keep-mask handed in) and ``fc`` (``out``, ``name``). The task head is the
stacked bank ``heads.kernel`` (max_tasks, features, classes) and
``heads.bias`` (max_tasks, classes).

This file is plain PyTorch: it imports nothing of the program, and the
harness uses it for the shapes its counts of operations and bytes need."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def shapes(cfg: dict) -> list[tuple[dict, tuple, tuple]]:
    """(layer, input shape, output shape) of every layer, per image: (C, H,
    W) before the flatten, (D,) after it."""
    shape: tuple = (3, cfg["input_px"], cfg["input_px"])
    out = []
    for layer in cfg["layers"]:
        op = layer["op"]
        if op == "conv":
            c, h, w = shape
            k, s, p = layer["k"], layer["stride"], layer["pad"]
            new = (layer["out"], (h + 2 * p - k) // s + 1,
                   (w + 2 * p - k) // s + 1)
        elif op == "maxpool":
            c, h, w = shape
            k, s = layer["k"], layer["stride"]
            new = (c, (h - k) // s + 1, (w - k) // s + 1)
        elif op == "flatten":
            new = (shape[0] * shape[1] * shape[2],)
        elif op == "fc":
            new = (layer["out"],)
        elif op in ("relu", "dropout"):
            new = shape
        else:
            raise ValueError(f"unknown layer op {op!r}")
        out.append((layer, shape, new))
        shape = new
    return out


def feature_dim(cfg: dict) -> int:
    return int(shapes(cfg)[-1][2][0])


def param_shapes(cfg: dict) -> dict[str, tuple]:
    """{program parameter name: shape}, backbone then head bank, in the
    order of the layer list."""
    out: dict[str, tuple] = {}
    for layer, src, dst in shapes(cfg):
        if layer["op"] == "conv":
            k = layer["k"]
            out[layer["name"] + ".weight"] = (dst[0], src[0], k, k)
            out[layer["name"] + ".bias"] = (dst[0],)
        elif layer["op"] == "fc":
            out[layer["name"] + ".weight"] = (dst[0], src[0])
            out[layer["name"] + ".bias"] = (dst[0],)
    tasks, classes = cfg["max_tasks"], cfg["classes_per_task"]
    out["heads.kernel"] = (tasks, feature_dim(cfg), classes)
    out["heads.bias"] = (tasks, classes)
    return out


def dropout_widths(cfg: dict) -> list[int]:
    """The width of each dropout layer's keep-mask, in order."""
    return [int(src[0]) for layer, src, _ in shapes(cfg)
            if layer["op"] == "dropout"]


def features(cfg: dict, params: dict, x_nhwc: torch.Tensor,
             masks=None) -> torch.Tensor:
    """The feature vector of each row of the normalised NHWC batch
    ``x_nhwc``. ``masks`` (one uint8 keep-mask per dropout layer) makes it
    a training forward; without them dropout passes its input."""
    x = x_nhwc.permute(0, 3, 1, 2)
    drops = iter(masks or ())
    for layer in cfg["layers"]:
        op = layer["op"]
        if op == "conv":
            x = F.conv2d(x, params[layer["name"] + ".weight"],
                         params[layer["name"] + ".bias"],
                         stride=layer["stride"], padding=layer["pad"])
        elif op == "relu":
            x = torch.relu(x)
        elif op == "maxpool":
            x = F.max_pool2d(x, layer["k"], layer["stride"])
        elif op == "flatten":
            x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
        elif op == "dropout":
            if masks is not None:
                x = x * (next(drops).to(x.dtype) / (1.0 - layer["p"]))
        elif op == "fc":
            x = F.linear(x, params[layer["name"] + ".weight"],
                         params[layer["name"] + ".bias"])
    return x


def head_logits(params: dict, feats: torch.Tensor, task: int) -> torch.Tensor:
    """One task's logits (every class of the configuration is valid)."""
    return feats @ params["heads.kernel"][task] + params["heads.bias"][task]


def all_head_logits(params: dict, feats: torch.Tensor,
                    n: int) -> torch.Tensor:
    """Heads 0..n-1 at once: (B, n, classes)."""
    return (torch.einsum("bf,tfc->btc", feats, params["heads.kernel"][:n])
            + params["heads.bias"][:n][None])
