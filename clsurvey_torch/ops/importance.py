"""Importance-weight estimation (EWC Fisher, MAS, mode-IMM Fisher).

Counterpart of ``clsurvey_tpu/ops/importance.py``, resident path:

- EWC: empirical diagonal Fisher over the previous task's train split,
  reproducing the reference's exact estimator — the *batch-summed* CE
  gradient squared, scaled by 1/N (ref:src/methods/EWC/main_EWC.py:138-157:
  ``omega += p.grad.data ** 2 / data_len`` where p.grad came from a
  sum-reduced NLL over the batch). It is NOT the mean of per-sample
  squares.
- MAS: mean absolute per-sample gradient of the squared L2 norm of the
  output (ref:src/methods/MAS/train_MAS.py:505-567 with batch size 1,
  ``b1=True`` online mode in ref:src/methods/MAS/main_MAS.py:56-60),
  as ``torch.func.vmap(torch.func.grad(...))`` over chunks of samples
  instead of N single-sample backward passes. The backbone's pools take
  part through the ``vmap`` rule of ``ops/pool.py``: one launch of kernel
  B1 or B2 per pool and chunk.
- mode-IMM: the precision of one task's model over its train and val
  splits, with labels sampled from the model's own softmax
  (ref:src/methods/IMM/merge.py:155-185).

All run on backbone params only (the reference's reg dict loses the
replaced head) and return a dict like ``params``. The uint8 rows stay on
the device; each batch is gathered there and normalized by kernel A with
no flip; a plain Python loop over batches replaces the JAX package's
``lax.scan``. EWC's and MAS's ragged tail batch is padded with repeats of
row 0, weighted 0; mode-IMM uses whole batches only. ``batch_stats`` is the
backbone's flat dict of running statistics (``models/convert.py``); every
pass runs the backbone with ``train=False``, so batch-norm uses those and
``torch.func.vmap(grad)`` sees no batch statistics. Splits above the device
data budget are not streamed yet: they raise."""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from clsurvey_torch.models import heads as heads_lib
from clsurvey_torch.ops import preprocess as pp


def _resident_u8(images_u8, device) -> torch.Tensor:
    """The split as a uint8 tensor on ``device``; a host split above the
    device data budget would have to stream in chunks."""
    from clsurvey_torch.engine.train import data_budget_bytes

    if isinstance(images_u8, np.ndarray):
        if images_u8.nbytes > data_budget_bytes():
            raise NotImplementedError(
                f"importance over a split of {images_u8.nbytes / 2**20:.0f} "
                f"MiB, above the device data budget of "
                f"{data_budget_bytes() / 2**20:.0f} MiB: streamed passes "
                f"are not ported to clsurvey_torch yet (ROADMAP.md, queue "
                f"1, item 3: streaming)")
        images_u8 = torch.from_numpy(np.ascontiguousarray(images_u8))
    return images_u8.to(device)


def _batched_indices(n: int, batch_size: int, device):
    """(n_batches, batch_size) row indices and weights: every batch is
    whole; the tail is padded with repeats of row 0 at weight 0."""
    n_batches = -(-n // batch_size)
    pad = n_batches * batch_size - n
    idx = torch.cat([torch.arange(n), torch.zeros(pad, dtype=torch.long)])
    w = torch.cat([torch.ones(n), torch.zeros(pad)])
    return (idx.view(n_batches, batch_size).to(device),
            w.view(n_batches, batch_size).to(device))


def _bank_on(heads_bank: dict, device) -> dict:
    """A model dict's head bank (numpy or tensors) as tensors on
    ``device``; the class counts stay numpy."""
    def leaf(x):
        if isinstance(x, torch.Tensor):
            return x.detach().to(device)
        return torch.tensor(np.asarray(x, np.float32), device=device)

    return {"kernel": leaf(heads_bank["kernel"]),
            "bias": leaf(heads_bank["bias"]),
            "class_counts": np.asarray(heads_bank["class_counts"])}


def ewc_fisher(ctx, params, batch_stats, heads_bank, task: int,
               images_u8, labels, batch_size: int) -> dict:
    """Diagonal Fisher over a dataset; returns a dict like ``params``.

    Exactly mirrors the reference estimator: per batch, grad of the
    sum-reduced NLL wrt params, squared, accumulated /N."""
    images = _resident_u8(images_u8, ctx.device)
    labels = torch.as_tensor(np.asarray(labels) if not isinstance(
        labels, torch.Tensor) else labels).to(ctx.device).long()
    idx, w = _batched_indices(int(images.shape[0]), batch_size, ctx.device)
    n_total = float(images.shape[0])
    bank = _bank_on(heads_bank, ctx.device)
    names = list(params)
    leaves = [params[k].detach().requires_grad_() for k in names]
    p = dict(zip(names, leaves))
    omega = [torch.zeros_like(t) for t in leaves]
    for bidx, bw in zip(idx, w):
        x = pp.preprocess(images.index_select(0, bidx), ctx.mean, ctx.std)
        y = labels.index_select(0, bidx)
        feats, _ = ctx.forward_feats(p, batch_stats, x, False)
        logits = heads_lib.forward(bank, feats, task)
        loss = (F.cross_entropy(logits, y, reduction="none") * bw).sum()
        grads = torch.autograd.grad(loss, leaves)
        sq = torch._foreach_mul(grads, grads)  # omega += g*g / N
        torch._foreach_div_(sq, n_total)
        torch._foreach_add_(omega, sq)
    return dict(zip(names, omega))


def mas_importance(ctx, params, batch_stats, heads_bank, task: int,
                   images_u8, chunk: int = 16) -> dict:
    """MAS omega: mean of |per-sample grad of ||f(x)||_2^2|.

    The reference runs batch-size-1 backward passes over the whole previous
    dataset; here a vmapped grad computes ``chunk`` per-sample gradients at
    once (the math is identical: mean of per-sample |g|)."""
    from torch.func import grad, vmap

    images = _resident_u8(images_u8, ctx.device)
    idx, w = _batched_indices(int(images.shape[0]), chunk, ctx.device)
    n_total = float(images.shape[0])
    bank = _bank_on(heads_bank, ctx.device)
    # masked head slots are a huge negative constant; the squared norm runs
    # over the first n_valid outputs only (the reference model has exactly
    # n_valid outputs)
    n_valid = int(bank["class_counts"][task])
    p = {k: v.detach() for k, v in params.items()}

    def sq_norm(p_, x1):
        feats, _ = ctx.forward_feats(p_, batch_stats, x1[None], False)
        logits = heads_lib.forward(bank, feats, task)
        return (logits[:, :n_valid] ** 2).sum()

    per_sample_grads = vmap(grad(sq_norm), in_dims=(None, 0))
    omega = {k: torch.zeros_like(v) for k, v in p.items()}
    for cidx, cw in zip(idx, w):
        x = pp.preprocess(images.index_select(0, cidx), ctx.mean, ctx.std)
        g = per_sample_grads(p, x)
        for k, gk in g.items():
            # omega += sum_v w_v |g_v| / N
            omega[k] += torch.tensordot(cw, gk.abs(), dims=1) / n_total
    return omega


def imm_mode_fisher(ctx, params, batch_stats, heads_bank, task: int,
                    splits, batch_size: int,
                    generator: torch.Generator | None = None,
                    sampled_labels=None) -> dict:
    """mode-IMM precision matrix (ref:src/methods/IMM/merge.py:155-185):
    initialized at 1e-8; for each split (train AND val), per whole batch
    the model samples labels from its softmax, takes the *mean*-reduced NLL
    gradient, and accumulates ``grad^2 / n_batches_of_split``. Returns a
    dict like ``params``.

    ``splits``: list of uint8 image arrays. The labels are drawn with
    ``torch.multinomial`` from ``generator`` (on ``ctx.device``); the JAX
    package's ``random.categorical`` stream cannot be reproduced, so
    ``sampled_labels``, one integer array of the split's usable rows per
    split, replaces the draw when given."""
    bank = _bank_on(heads_bank, ctx.device)
    names = list(params)
    leaves = [params[k].detach().requires_grad_() for k in names]
    p = dict(zip(names, leaves))
    omega = [torch.full_like(t, 1e-8) for t in leaves]
    for s, images_u8 in enumerate(splits):
        n_batches = int(images_u8.shape[0]) // batch_size
        if n_batches == 0:
            continue
        images = _resident_u8(images_u8[: n_batches * batch_size],
                              ctx.device)
        given = None
        if sampled_labels is not None:
            given = torch.as_tensor(np.asarray(sampled_labels[s])).to(
                ctx.device).long().view(n_batches, batch_size)
        for b in range(n_batches):
            x = pp.preprocess(images[b * batch_size: (b + 1) * batch_size],
                              ctx.mean, ctx.std)
            feats, _ = ctx.forward_feats(p, batch_stats, x, False)
            logits = heads_lib.forward(bank, feats, task)
            if given is not None:
                y = given[b]
            else:
                with torch.no_grad():
                    y = torch.multinomial(torch.softmax(logits, -1), 1,
                                          generator=generator).squeeze(1)
            grads = torch.autograd.grad(F.cross_entropy(logits, y), leaves)
            sq = torch._foreach_mul(grads, grads)  # omega += g*g / batches
            torch._foreach_div_(sq, float(n_batches))
            torch._foreach_add_(omega, sq)
    return dict(zip(names, omega))
