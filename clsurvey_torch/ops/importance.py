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
  B1 or B2 per pool and chunk; on the card its float32 convs through
  ``ops/conv.py``'s exact weight gradient (``Conv2dBackward``'s ``vmap``
  rule: the samples folded into the batch, one batched GEMM per conv and
  chunk).
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
``torch.func.vmap(grad)`` sees no batch statistics. A host split above the
device data budget streams through chunks of whole batches
(:func:`_accumulate_chunked`), each chunk's estimate rescaled to its share
of the split, as in the JAX package.

Data parallel (``parallel/mesh.py``): each rank runs its rows of every
batch (``ctx.mesh.shard``). MAS's estimate is a sum over samples, so each
rank sums its own and the tree is all-reduced once, at the end of the pass.
EWC and mode-IMM square a BATCH gradient, which is not a sum over the
ranks' rows: their gradient is all-reduced per batch (one flat buffer)
before it is squared, as GSPMD reduces it inside the JAX package's step.
mode-IMM draws its labels from the global batch's softmax: the ranks'
probabilities are summed into one (b, C) buffer (each rank fills its rows)
and every rank draws from it, as one device does."""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from clsurvey_torch.engine.train import (data_budget_bytes, place,
                                         stream_chunk_rows)
from clsurvey_torch.models import heads as heads_lib
from clsurvey_torch.ops import preprocess as pp
from clsurvey_torch.parallel import mesh as mesh_lib


def _budget_chunk_rows(images_np, batch_size: int) -> int | None:
    """Rows a host chunk for a split over the device data budget, whole
    batches of ``batch_size``; None where the split fits on the device
    (``clsurvey_tpu/ops/importance.py:_budget_chunk_rows``). A split that
    streams in training streams through its importance pass too."""
    if images_np.nbytes <= data_budget_bytes():
        return None
    rows = stream_chunk_rows(images_np.nbytes // max(len(images_np), 1))
    return max(rows // batch_size * batch_size, batch_size)


def _accumulate_chunked(estimate_chunk, images_np, labels_np, rows: int):
    """The split's estimate from host chunks of ``rows`` rows: each
    chunk's estimate (a mean over the chunk) rescaled by its share of the
    rows and summed (``clsurvey_tpu/ops/importance.py:
    _accumulate_chunked``)."""
    total = float(len(images_np))
    omega = None
    for lo in range(0, len(images_np), rows):
        hi = min(lo + rows, len(images_np))
        part = estimate_chunk(images_np[lo:hi], None if labels_np is None
                              else np.asarray(labels_np)[lo:hi])
        scale = (hi - lo) / total
        part = {k: v * scale for k, v in part.items()}
        omega = part if omega is None else {
            k: omega[k] + part[k] for k in omega}
    return omega


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
    sum-reduced NLL wrt params, squared, accumulated /N. A host split over
    the device data budget streams through chunks."""
    if isinstance(images_u8, np.ndarray):
        rows = _budget_chunk_rows(images_u8, batch_size)
        if rows is not None:
            return _accumulate_chunked(
                lambda xs, ys: ewc_fisher(
                    ctx, params, batch_stats, heads_bank, task,
                    torch.from_numpy(np.ascontiguousarray(xs)), ys,
                    batch_size), images_u8, labels, rows)
    images = place(images_u8, ctx.device)
    labels = torch.as_tensor(np.asarray(labels) if not isinstance(
        labels, torch.Tensor) else labels).to(ctx.device).long()
    idx, w = _batched_indices(int(images.shape[0]), batch_size, ctx.device)
    n_total = float(images.shape[0])
    bank = _bank_on(heads_bank, ctx.device)
    names = list(params)
    leaves = [params[k].detach().requires_grad_() for k in names]
    p = dict(zip(names, leaves))
    omega = [torch.zeros_like(t) for t in leaves]
    sh = ctx.mesh.shard(batch_size)
    for bidx, bw in zip(idx[:, sh.lo:sh.hi], w[:, sh.lo:sh.hi]):
        x = pp.preprocess(images.index_select(0, bidx), ctx.mean, ctx.std)
        y = labels.index_select(0, bidx)
        feats, _ = ctx.forward_feats(p, batch_stats, x, False)
        logits = heads_lib.forward(bank, feats, task)
        loss = mesh_lib.share(
            (F.cross_entropy(logits, y, reduction="none") * bw).sum(),
            sh.sum_scale)
        grads = mesh_lib.global_grads(loss, leaves, ctx.mesh)
        sq = torch._foreach_mul(grads, grads)  # omega += g*g / N
        torch._foreach_div_(sq, n_total)
        torch._foreach_add_(omega, sq)
    return dict(zip(names, omega))


def mas_importance(ctx, params, batch_stats, heads_bank, task: int,
                   images_u8, chunk: int = 16) -> dict:
    """MAS omega: mean of |per-sample grad of ||f(x)||_2^2|.

    The reference runs batch-size-1 backward passes over the whole previous
    dataset; here a vmapped grad computes ``chunk`` per-sample gradients at
    once (the math is identical: mean of per-sample |g|). A host split
    over the device data budget streams through chunks. Each rank sums its
    rows; the tree is all-reduced once, at the end of the pass."""
    if isinstance(images_u8, np.ndarray):
        rows = _budget_chunk_rows(images_u8, chunk)
        if rows is not None:
            omega = _accumulate_chunked(
                lambda xs, _: _mas_local(
                    ctx, params, batch_stats, heads_bank, task,
                    torch.from_numpy(np.ascontiguousarray(xs)), chunk),
                images_u8, None, rows)
            mesh_lib.all_reduce_sum(list(omega.values()), ctx.mesh)
            return omega
    omega = _mas_local(ctx, params, batch_stats, heads_bank, task,
                       images_u8, chunk)
    mesh_lib.all_reduce_sum(list(omega.values()), ctx.mesh)
    return omega


def _mas_local(ctx, params, batch_stats, heads_bank, task: int, images_u8,
               chunk: int) -> dict:
    """MAS omega over this rank's rows of every chunk, before the
    all-reduce."""
    from torch.func import grad, vmap

    images = place(images_u8, ctx.device)
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
    sh = ctx.mesh.shard(chunk)
    for cidx, cw in zip(idx[:, sh.lo:sh.hi],
                        mesh_lib.share(w[:, sh.lo:sh.hi], sh.sum_scale)):
        x = pp.preprocess(images.index_select(0, cidx), ctx.mean, ctx.std)
        g = per_sample_grads(p, x)
        for k, gk in g.items():
            # omega += sum_v w_v |g_v| / N
            omega[k] += torch.tensordot(cw.to(gk.dtype), gk.abs(),
                                        dims=1) / n_total
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

    def split_fisher(images_u8, given) -> dict:
        """sum of grad^2 over the whole batches of ``images_u8``, over
        their number; ``given``: the batches' labels, or None to draw."""
        n_batches = int(images_u8.shape[0]) // batch_size
        images = place(images_u8, ctx.device)
        if given is not None:
            given = torch.as_tensor(np.asarray(given)).to(
                ctx.device).long().view(n_batches, batch_size)
        acc = [torch.zeros_like(t) for t in leaves]
        sh = ctx.mesh.shard(batch_size)
        for b in range(n_batches):
            x = pp.preprocess(images[b * batch_size + sh.lo:
                                     b * batch_size + sh.hi],
                              ctx.mean, ctx.std)
            feats, _ = ctx.forward_feats(p, batch_stats, x, False)
            logits = heads_lib.forward(bank, feats, task)
            if given is not None:
                y = given[b][sh.lo:sh.hi]
            else:
                with torch.no_grad():
                    y = torch.multinomial(
                        _global_rows(torch.softmax(logits, -1), sh,
                                     batch_size, ctx.mesh), 1,
                        generator=generator).squeeze(1)[sh.lo:sh.hi]
            grads = mesh_lib.global_grads(
                mesh_lib.share(F.cross_entropy(logits, y), sh.mean_scale),
                leaves, ctx.mesh)
            sq = torch._foreach_mul(grads, grads)  # acc += g*g / batches
            torch._foreach_div_(sq, float(n_batches))
            torch._foreach_add_(acc, sq)
        return dict(zip(names, acc))

    omega = {k: torch.full_like(t, 1e-8) for k, t in zip(names, leaves)}
    for s, images_u8 in enumerate(splits):
        usable = int(images_u8.shape[0]) // batch_size * batch_size
        if usable == 0:
            continue
        images_u8 = images_u8[:usable]
        given = None if sampled_labels is None else \
            np.asarray(sampled_labels[s])
        rows = (_budget_chunk_rows(images_u8, batch_size)
                if isinstance(images_u8, np.ndarray) else None)
        if rows is None:
            contrib = split_fisher(images_u8, given)
        else:
            # a chunk's Fisher is over its own batches: rescale each by
            # chunk_batches / split_batches (the split's mean exactly)
            contrib = _accumulate_chunked(split_fisher, images_u8, given,
                                          rows)
        omega = {k: omega[k] + contrib[k] for k in names}
    return omega


def _global_rows(rows: torch.Tensor, sh, b: int, mesh) -> torch.Tensor:
    """The (b, ...) global batch of per-row values whose rows ``[sh.lo,
    sh.hi)`` this rank holds: each rank writes its rows into a zero buffer
    and the buffers are all-reduced. ``rows`` itself where every rank
    holds every row (one device, or fewer rows than ranks)."""
    if not mesh.distributed or sh.sum_scale != 1.0:
        return rows
    full = rows.new_zeros((b,) + tuple(rows.shape[1:]))
    full[sh.lo:sh.hi] = rows
    return mesh_lib.all_reduce_sum([full], mesh)[0]
