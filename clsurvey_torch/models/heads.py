"""Stacked multi-head bank.

Counterpart of ``clsurvey_tpu/models/heads.py``. The reference mutates
``model.classifier._modules[last_idx]`` to swap per-task heads
(ref:src/methods/method.py:230-235). Here heads are one parameter bank

    kernel: (max_tasks, feat_dim, classes_per_task_max)
    bias:   (max_tasks, classes_per_task_max)

so selecting a head is an index, running *all* heads (LwF distillation,
shared-head replay eval) is one einsum, and unequal per-task class counts
are handled by masking logits to ``NEG_INF`` (ref:src/methods/rehearsal/
model/gem.py:199-204, adopted globally)."""

from __future__ import annotations

import functools
import os

import numpy as np
import torch

NEG_INF = -1e10

# Per-task head init scheme (CLSURVEY_HEAD_INIT), as in the JAX package:
#   "legacy" — 0.01*N(0,1) weights, zero bias (the default);
#   "torch_default" — nn.Linear's default U(+-sqrt(1/fan_in)) weight and
#     bias, the reference's replaced-head init;
#   "torch_pinned:<base>" — task t's head is the torch_default draw from a
#     private torch.Generator(base + t + 1), weight then bias: bit-identical
#     to the JAX package's draw (which is made with torch too).
# "legacy" and "torch_default" draw from the caller's torch.Generator, so
# they match the JAX package's distribution, not its bits.
HEAD_INIT_SCHEME = os.environ.get("CLSURVEY_HEAD_INIT", "legacy")


def _pinned_draw(base: int, task: int, feat_dim: int, num_classes: int):
    """torch_default-distribution head draw for 0-based ``task``, drawn
    from Generator(base + task + 1) — weight then bias, the exact call
    order of ``nn.Linear.reset_parameters``. Returns (kernel (feat, C),
    bias (C,))."""
    g = torch.Generator().manual_seed(base + task + 1)
    bound = float(np.sqrt(1.0 / feat_dim))
    w = torch.empty(num_classes, feat_dim).uniform_(
        -bound, bound, generator=g)
    b = torch.empty(num_classes).uniform_(-bound, bound, generator=g)
    return w.T.contiguous(), b


def _pinned_base(scheme: str) -> int:
    return int(scheme.split(":", 1)[1])


def _draw(generator: torch.Generator, shape_k, shape_b, feat_dim: int,
          scheme: str):
    if scheme == "torch_default":
        bound = float(np.sqrt(1.0 / feat_dim))
        kernel = torch.empty(shape_k).uniform_(-bound, bound,
                                               generator=generator)
        bias = torch.empty(shape_b).uniform_(-bound, bound,
                                             generator=generator)
        return kernel, bias
    kernel = 0.01 * torch.randn(shape_k, generator=generator)
    return kernel, torch.zeros(shape_b)


def init_head_bank(generator: torch.Generator, max_tasks: int,
                   feat_dim: int, num_classes: int, class_counts=None,
                   scheme: str | None = None) -> dict:
    """Create the bank on the CPU. ``class_counts[t]`` = real #classes of
    task t (defaults to all = num_classes)."""
    scheme = scheme or HEAD_INIT_SCHEME
    if scheme.startswith("torch_pinned:"):
        base = _pinned_base(scheme)
        draws = [_pinned_draw(base, t, feat_dim, num_classes)
                 for t in range(max_tasks)]
        kernel = torch.stack([d[0] for d in draws])
        bias = torch.stack([d[1] for d in draws])
    else:
        kernel, bias = _draw(generator, (max_tasks, feat_dim, num_classes),
                             (max_tasks, num_classes), feat_dim, scheme)
    if class_counts is None:
        class_counts = [num_classes] * max_tasks
    return {
        "kernel": kernel,
        "bias": bias,
        # static metadata (numpy)
        "class_counts": np.asarray(class_counts, dtype=np.int32),
    }


def reinit_head(bank: dict, task: int, generator: torch.Generator,
                scheme: str | None = None) -> dict:
    """Fresh-init one task's head (a new task starts with a new random
    head, the reference's replace-last-classifier-layer semantics,
    ref:src/methods/Finetune/main_SGD.py:50-70). Returns a new bank; the
    slot's draw is made on the CPU and copied to the bank's device."""
    scheme = scheme or HEAD_INIT_SCHEME
    feat_dim, num_classes = bank["kernel"].shape[1:]
    if scheme.startswith("torch_pinned:"):
        k, b = _pinned_draw(_pinned_base(scheme), task, feat_dim,
                            num_classes)
    else:
        k, b = _draw(generator, (feat_dim, num_classes), (num_classes,),
                     feat_dim, scheme)
    kernel, bias = bank["kernel"].clone(), bank["bias"].clone()
    kernel[task] = k.to(kernel.device)
    bias[task] = b.to(bias.device)
    return {**bank, "kernel": kernel, "bias": bias}


def head_params(bank: dict) -> dict:
    """The trainable leaves of the bank (metadata excluded)."""
    return {"kernel": bank["kernel"], "bias": bank["bias"]}


def forward(bank: dict, feats: torch.Tensor, task: int) -> torch.Tensor:
    """Logits of one task's head, invalid class slots masked to NEG_INF."""
    logits = feats @ bank["kernel"][task] + bank["bias"][task]
    n_valid = int(bank["class_counts"][task])
    if n_valid < logits.shape[-1]:
        invalid = torch.arange(logits.shape[-1],
                               device=logits.device) >= n_valid
        logits = logits.masked_fill(invalid, NEG_INF)
    return logits


@functools.lru_cache(maxsize=64)
def _counts_on(counts: tuple, device: torch.device) -> torch.Tensor:
    return torch.tensor(counts, dtype=torch.long, device=device)


def class_counts_on(class_counts, device) -> torch.Tensor:
    """The bank's class counts as a long tensor on ``device``, made once
    per device and counts: a train step never copies them from the host (a
    copy from pageable memory waits for the device's queue to drain)."""
    return _counts_on(tuple(int(c) for c in class_counts),
                      torch.device(device))


def forward_all(bank: dict, feats: torch.Tensor,
                n_tasks: int) -> torch.Tensor:
    """All heads at once: (B, n_tasks, C) via a single einsum
    (ref:src/methods/LwF/AlexNet_LwF.py:14-38 loops over head modules)."""
    kernel = bank["kernel"][:n_tasks]
    bias = bank["bias"][:n_tasks]
    logits = torch.einsum("bf,tfc->btc", feats, kernel) + bias[None]
    counts = class_counts_on(bank["class_counts"][:n_tasks], logits.device)
    valid = torch.arange(logits.shape[-1],
                         device=logits.device)[None, :] < counts[:, None]
    return logits.masked_fill(~valid[None], NEG_INF)


def shared_logits(bank: dict, feats: torch.Tensor,
                  n_tasks: int) -> torch.Tensor:
    """Flatten all heads into one extended shared head (B, n_tasks*C);
    invalid slots already NEG_INF-masked."""
    return forward_all(bank, feats, n_tasks).reshape(feats.shape[0], -1)
