"""PackNet ownership-mask operations (ref:src/methods/packnet/prune.py).

Counterpart of ``clsurvey_tpu/ops/masks.py``, over the port's flat
parameter dicts (``features.conv_<i>.weight``, ``trunk.fc_<j>.weight``,
...). A mask is a uint8 tensor shaped like its conv or dense weight (the
reference's SparsePruner tracks nn.Conv2d/nn.Linear ``.weight`` only):
value = 1-based task id owning the weight, 0 = free or pruned. A bias or
batch-norm leaf carries a 0-d uint8 sentinel of 255, so a mask dict has
the same keys as the params. On disk masks travel in the JAX package's
layout through ``models/convert.py`` with their dtype kept (HWIO conv
masks, (in, out) dense masks, the 0-d sentinels)."""

from __future__ import annotations

import numpy as np
import torch

SENTINEL = 255  # 0-d marker: leaf is not maskable (bias / BN param)


def _maskable(m: torch.Tensor) -> bool:
    return m.dim() > 0


def is_kernel_name(name: str) -> bool:
    """Mask only conv/dense weights (not biases, not BN scales)."""
    return name.endswith(".weight")


def _is_bn_name(name: str) -> bool:
    return name.split(".")[1].startswith("bn_")


def init_masks(params: dict, owner: int = 0) -> dict:
    """Fresh masks over weight leaves; every other leaf gets a sentinel."""
    return {k: (torch.full(p.shape, owner, dtype=torch.uint8,
                           device=p.device).contiguous(
                               memory_format=_format(p))
                if is_kernel_name(k) and p.dim() > 1 else
                torch.tensor(SENTINEL, dtype=torch.uint8, device=p.device))
            for k, p in params.items()}


def _format(t: torch.Tensor):
    return (torch.channels_last if t.dim() == 4 and t.is_contiguous(
        memory_format=torch.channels_last) else torch.contiguous_format)


def claim_free(masks: dict, task_id: int) -> dict:
    """make_finetuning_mask (ref:prune.py:141-155): free (0) weights become
    the current task's."""
    return {k: m.masked_fill(m == 0, task_id) if _maskable(m) else m
            for k, m in masks.items()}


def _remove_mask(w: torch.Tensor, m: torch.Tensor, task_id: int,
                 prune_perc) -> torch.Tensor:
    """Among the task's weights, the lowest-|w| ``prune_perc`` fraction
    (ties at the cutoff included). k = round(prune_perc * n_owned) is
    computed in float32 with round-half-to-even, as the JAX package does:
    a float64 product flips k where a decayed percentage lands on .5."""
    owned = m == task_id
    n_owned = owned.sum()
    absw = w.abs()
    order = torch.where(owned, absw, torch.inf).reshape(-1).sort().values
    perc = torch.tensor(np.float32(prune_perc), device=w.device)
    k = torch.round(perc * n_owned.to(torch.float32)).long()
    k = k.clamp(1, order.numel()) - 1
    cutoff = order.gather(0, k.view(1))
    return owned & (absw <= cutoff) & (n_owned > 0)


def prune_masks(params: dict, masks: dict, task_id: int,
                prune_perc) -> tuple[dict, dict]:
    """pruning_mask (ref:prune.py:24-73): per layer, among the current
    task's weights, zero the mask of the lowest-|w| ``prune_perc`` fraction
    and zero those weights. Returns (new_params, new_masks)."""
    new_params, new_masks = {}, {}
    for k, w in params.items():
        m = masks[k]
        if not _maskable(m):
            new_params[k], new_masks[k] = w, m
            continue
        remove = _remove_mask(w, m, task_id, prune_perc)
        new_params[k] = w.masked_fill(remove, 0.0)
        new_masks[k] = m.masked_fill(remove, 0)
    return new_params, new_masks


def mask_grads(grads: dict, masks: dict, task_id: int,
               train_bn: bool = False) -> dict:
    """make_grads_zero (ref:prune.py:73-99): only the current task's
    weights train; biases are always frozen; batch-norm scale/bias grads
    flow when ``train_bn`` (the reference sets train_bn=True whenever the
    model has batchnorm, ref:src/methods/method.py:538, prune.py:93-97)."""
    out = {}
    for k, g in grads.items():
        m = masks[k]
        if _maskable(m):
            out[k] = g.masked_fill(m != task_id, 0.0)
        else:
            out[k] = g if train_bn and _is_bn_name(k) else torch.zeros_like(g)
    return out


def apply_eval_mask(params: dict, masks: dict, dataset_idx: int) -> dict:
    """apply_mask (ref:prune.py:106-123): zero weights that are free (0) or
    were trained after ``dataset_idx`` (1-based)."""
    return {k: w.masked_fill((masks[k] == 0) | (masks[k] > dataset_idx), 0.0)
            if _maskable(masks[k]) else w for k, w in params.items()}


def zero_pruned(params: dict, masks: dict) -> dict:
    """make_pruned_zero (ref:prune.py:101-105)."""
    return {k: w.masked_fill(masks[k] == 0, 0.0)
            if _maskable(masks[k]) else w for k, w in params.items()}


def capacity_report(masks: dict, n_tasks: int) -> dict:
    """mask_summary analog: fraction of weights owned per task id."""
    maskable = [m for m in masks.values() if _maskable(m)]
    n_all = sum(m.numel() for m in maskable)
    return {t: sum(int((m == t).sum()) for m in maskable) / max(n_all, 1)
            for t in range(n_tasks + 1)}
