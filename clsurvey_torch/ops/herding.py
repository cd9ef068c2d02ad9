"""iCaRL exemplar herding.

Counterpart of ``clsurvey_tpu/ops/herding.py``. The reference greedily
picks, per class, the sample minimizing
``|| class_mean - (feat(x) + sum(feats of already-picked)) / (k+1) ||_2``
with an O(exemplars x dataset) python loop of forward passes
(ref:src/methods/rehearsal/model/icarl.py:314-480). The model is frozen
while it herds, so every candidate's features are computed once; the
greedy selection is then k masked argmins over the feature matrix, a
Python loop of device ops whose winners stay on the device until the
caller reads the whole order back."""

from __future__ import annotations

import torch


def herd(features: torch.Tensor, valid: torch.Tensor, k: int) -> torch.Tensor:
    """Greedy herding order.

    features: (n, d) candidate features (frozen model).
    valid:    (n,) 1.0 for real candidates, 0.0 for padding.
    k:        number of exemplars to select.

    Returns (k,) int64 indices in selection order, on the features'
    device. If fewer than k valid candidates exist, later slots repeat the
    masked argmin of an all-inf cost (callers truncate by valid count)."""
    n, d = features.shape
    mean = ((features * valid[:, None]).sum(0)
            / valid.sum().clamp_min(1.0))
    blocked = valid < 0.5
    prev_sum = torch.zeros(d, dtype=features.dtype, device=features.device)
    order = []
    for ex in range(k):
        # cost_i = || mean - (feat_i + prev_sum)/(ex+1) ||
        cand = (features + prev_sum[None, :]) / (ex + 1.0)
        cost = torch.linalg.vector_norm(mean[None, :] - cand, dim=1)
        win = cost.masked_fill(blocked, float("inf")).argmin().view(1)
        blocked = blocked.index_fill(0, win, True)
        prev_sum = prev_sum + features.index_select(0, win)[0]
        order.append(win)
    if not order:
        return torch.zeros(0, dtype=torch.long, device=features.device)
    return torch.cat(order)


def class_means(features: torch.Tensor, labels: torch.Tensor,
                n_classes: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-class mean features: (n_classes, d) and counts (n_classes,)."""
    one_hot = torch.nn.functional.one_hot(labels.long(), n_classes).to(
        features.dtype)
    counts = one_hot.sum(0)
    return (one_hot.T @ features) / counts[:, None].clamp_min(1.0), counts
