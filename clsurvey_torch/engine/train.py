"""The training engine: ONE train step for every CL method.

Counterpart of ``clsurvey_tpu/engine/train.py`` (resident path). The
reference implements eleven separate epoch loops with custom SGD subclasses
that inject each method's regularizer into ``optimizer.step``
(ref:SURVEY §2.3). Here there is a single engine:

- the epoch is a Python loop over batches; the task's uint8 dataset, the
  weights, momentum and method state stay on the device for the whole task,
  and per-batch metrics are read back once per epoch;
- each batch is gathered on the device, then normalized and flipped by
  ``ops/preprocess.py`` (kernel A on the card);
- a batch-norm model's running statistics travel in the train state
  (``batch_stats``, ``models/backbones.py``'s flat dict) and every train
  step returns the new ones; a dropout model's keep-masks are drawn per
  step from the epoch's generator on the device, next to the flip masks;
- method mechanics plug in via ``UpdateRule`` hooks (``methods/base.py``)
  evaluated inside the same step, in the reference's "regularizer inside
  optimizer.step" order: CE-grads (+ extra loss terms) -> + penalty grads ->
  transform -> + weight decay -> freeze -> momentum -> masked update
  (ref:src/methods/EWC/train_EWC.py:23-86);
- the SGD hyper-behavior matches the reference's shared protocol: momentum
  0.9, lr x0.1 after 5 non-improving val epochs, early stop after 10
  (ref:src/methods/Finetune/train_SGD.py:10-30), best-val model checkpointing
  and epoch-granular resume (ref:src/methods/Finetune/train_SGD.py:41-189).

The train state is a value, as in the JAX package: ``trainable`` holds the
backbone's parameters by their module names (torch layout) plus the head
bank, and the backbone module is run on them with
``torch.func.functional_call``. Checkpoints are written in the JAX
package's layout (``models/convert.py``). The momentum buffers are updated
in place (the step returns the same tensors), which saves one copy of the
weights per step; the weights themselves are replaced, so ``post_step``
still sees the pre-step values.

A split above the device data budget (``data_budget_bytes``) streams from
the host instead (``Engine.train_epoch_chunked`` / ``evaluate_chunked``,
``train_task`` decides per split): a thread gathers each chunk of the
epoch's permutation into a pinned buffer (``utils/rowgather.py``) and copies
it to the card on a side stream while the card trains on the chunk before
(``ChunkFeed``).

Data parallel (``parallel/mesh.py``, the context's ``mesh``): every rank
runs this program on the whole split. Each step draws the global batch's
flips and dropout masks, and the rule its own draws, exactly as one device
does; the step then keeps its rank's rows of the batch and of the draws.
CE and accuracy are local sums over the global count, and the gradient is
all-reduced in one flat buffer right after the base loss (inside
:meth:`Engine._base_loss_and_grads`, so GEM projects the global one),
before the penalty, transform, weight decay, freeze, momentum and update
hooks, which act on replicated state once. ``post_step`` gets the global
gradient and the global batch's raw rows. The epoch's metric sums are
all-reduced once an epoch, eval's per-class counters once an evaluation.
Train batches round down to a multiple of the ranks, eval batches up with
padded rows of weight 0. ``train_task`` broadcasts the state at its start,
takes every decision from all-reduced numbers, and writes and logs from
the writer alone. Without a process group none of this runs."""

from __future__ import annotations

import functools
import json
import os
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Any, Callable

import numpy as np
import torch
import torch.nn.functional as F
from torch.func import functional_call

from clsurvey_torch.methods.base import UpdateRule
from clsurvey_torch.models import heads as heads_lib
from clsurvey_torch.models.convert import (
    batch_stats_from_jax, batch_stats_to_jax, params_from_jax, params_to_jax)
from clsurvey_torch.models.registry import ModelSpec
from clsurvey_torch.ops import preprocess as pp
from clsurvey_torch.parallel import mesh as mesh_lib
from clsurvey_torch.utils import device as device_lib
from clsurvey_torch.utils import io, orbax_io, rng as rng_lib, timing
from clsurvey_torch.utils.paths import (
    BEST_MODEL_FILENAME, EPOCH_CKPT_FILENAME)
from clsurvey_torch.utils.rowgather import gather_rows

# Epochs ending above this train loss are treated as divergence (like NaN):
# healthy losses are O(ln n_classes + reg terms), while a finite-but-
# exploded epoch is the step before the NaN and must never be recorded as a
# best model. CLSURVEY_DIVERGENCE_BOUND=inf restores a NaN-only abort.
DIVERGENCE_LOSS_BOUND = float(
    os.environ.get("CLSURVEY_DIVERGENCE_BOUND", "1e6"))


# ---------------------------------------------------------------------------
# trees: nested dicts (and lists) of tensors
# ---------------------------------------------------------------------------

def tree_map(fn: Callable, *trees):
    if isinstance(trees[0], dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in trees[0]}
    if isinstance(trees[0], (list, tuple)):
        return [tree_map(fn, *items) for items in zip(*trees)]
    return fn(*trees)


def tree_leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def tree_unflatten(like, leaves: list):
    it = iter(leaves)
    return tree_map(lambda _: next(it), like)


def tree_zeros_like(a):
    return tree_map(torch.zeros_like, a)


def tree_to_device(tree, device):
    """Array leaves -> tensors on ``device``, numpy arrays copied (a rule
    may write its state in place; a loaded array may be read-only); a
    Python int (a ring position or fill count the rules keep on the host)
    stays an int."""
    def leaf(x):
        if isinstance(x, int):
            return x
        if isinstance(x, np.ndarray):
            return torch.tensor(x, device=device)
        return torch.as_tensor(x).to(device)
    return tree_map(leaf, tree)


# ---------------------------------------------------------------------------
# state and context
# ---------------------------------------------------------------------------

@dataclass
class TrainState:
    trainable: Any      # {'params': {name: tensor}, 'heads': {'kernel','bias'}}
    batch_stats: Any
    momentum: Any       # like trainable
    mstate: Any         # method state (hyper scalars + importance tensors...)


@dataclass
class EngineContext:
    """Static description of one task-training problem."""

    spec: ModelSpec
    backbone: torch.nn.Module
    task: int                     # 0-based head index of the current task
    n_tasks: int                  # heads active (incl. current)
    class_counts: np.ndarray      # (max_tasks,) real class counts
    mean: tuple
    std: tuple
    update_rule: UpdateRule
    device: torch.device
    augment: bool = True
    momentum: float = 0.9
    weight_decay: float = 0.0
    freeze_backbone: bool = False  # head-only training (LwF warmup,
    # ref:src/methods/Finetune/main_SGD.py:72 freeze_mode)
    # L1 weight decay: decay term wd*sign(theta) instead of wd*theta
    # (MAS extra, ref:src/methods/MAS/train_MAS.py:72-76 L1_decay flag)
    l1_decay: bool = False
    mesh: mesh_lib.Mesh = field(default_factory=mesh_lib.Mesh)

    def bank(self, trainable: Any) -> dict:
        return {"kernel": trainable["heads"]["kernel"],
                "bias": trainable["heads"]["bias"],
                "class_counts": self.class_counts}

    def forward_feats(self, params, batch_stats, x, train: bool,
                      dropout_masks=None):
        """-> (features, batch_stats). ``train=True`` normalizes with the
        statistics of the global batch over the context's mesh and returns
        the updated running ones, and drops units under ``dropout_masks``;
        ``train=False`` (eval, teachers, importance passes) uses the
        running statistics and no dropout."""
        if train:
            return functional_call(
                self.backbone, params, (x,),
                {"batch_stats": batch_stats, "train": True,
                 "dropout_masks": dropout_masks, "mesh": self.mesh})
        return functional_call(self.backbone, params, (x,),
                               {"batch_stats": batch_stats}), batch_stats

    def draw_dropout_masks(self, batch_size: int, gen):
        """One (B, d) uint8 keep-mask per dropout layer, p(keep) = 0.5,
        drawn on the device from ``gen``; None for a model without
        dropout. The widths are the backbone's ``drop_dims``: the trunk
        layers' outputs for a VGG, the FC layers' inputs for AlexNet
        (9,216 and 4,096 at 224 px)."""
        if not self.spec.uses_dropout:
            return None
        return [torch.randint(0, 2, (batch_size, int(d)), dtype=torch.uint8,
                              device=self.device, generator=gen)
                for d in self.backbone.drop_dims]

    def task_logits(self, trainable, feats):
        return heads_lib.forward(self.bank(trainable), feats, self.task)

    def all_logits(self, trainable, feats):
        return heads_lib.forward_all(self.bank(trainable), feats,
                                     self.n_tasks)

    def shared_logits(self, trainable, feats):
        return heads_lib.shared_logits(self.bank(trainable), feats,
                                       self.n_tasks)

    def preprocess(self, images_u8, flip_mask=None):
        """Train-time preprocess in the compute dtype; ``flip_mask`` is
        ignored unless the context augments."""
        return pp.preprocess(images_u8, self.mean, self.std,
                             flip_mask if self.augment else None,
                             dtype=self.spec.compute_dtype)


def make_context(spec: ModelSpec, task: int, n_tasks: int,
                 class_counts, mean, std, update_rule: UpdateRule,
                 device="cuda", mesh: mesh_lib.Mesh | None = None,
                 **kwargs) -> EngineContext:
    """``mesh`` defaults to the installed one (``get_mesh()``), as the
    JAX package's does."""
    device = device_lib.resolve(device)
    mesh = mesh if mesh is not None else mesh_lib.get_mesh(device)
    backbone = spec.make_backbone().to(device)
    return EngineContext(
        spec=spec, backbone=backbone, task=task,
        n_tasks=n_tasks, class_counts=np.asarray(class_counts, np.int32),
        mean=tuple(mean), std=tuple(std), update_rule=update_rule,
        device=device, mesh=mesh, **kwargs)


# ---------------------------------------------------------------------------
# Engine
# ---------------------------------------------------------------------------

class Engine:
    """Train step, epoch and eval for one EngineContext. Reusable across
    attempts: hyperparameters live in the method state."""

    def __init__(self, ctx: EngineContext):
        self.ctx = ctx

    def _base_loss_and_grads(self, trainable, batch_stats, batch, mstate,
                             dropout_masks=None, gen=None):
        """Loss, gradient, new batch statistics and metrics of the rank's
        rows ``batch``: CE and accuracy as the rank's share of the global
        batch's means, the rule's extra term as its own share, and the
        gradient all-reduced (the global batch's)."""
        ctx = self.ctx
        x, y = batch
        scale = ctx.mesh.batch_scale
        feats, new_bs = ctx.forward_feats(trainable["params"], batch_stats,
                                          x, True, dropout_masks)
        logits = ctx.task_logits(trainable, feats)
        ce = mesh_lib.share(F.cross_entropy(logits, y), scale)
        extra = ctx.update_rule.extra_loss(ctx, trainable, feats, batch,
                                           mstate, batch_stats=batch_stats,
                                           gen=gen)
        loss = ce + extra
        grads = mesh_lib.global_grads(loss, tree_leaves(trainable),
                                      ctx.mesh)
        with torch.no_grad():
            acc = mesh_lib.share(
                (logits.argmax(-1) == y).to(torch.float32).mean(), scale)
        return (loss.detach(), tree_unflatten(trainable, grads),
                new_bs, {"loss": ce.detach(), "acc": acc})

    def _train_step(self, state: TrainState, x_u8, y, lr: float,
                    flip_mask=None, dropout_masks=None, gen=None):
        """One step on the global batch ``x_u8``, ``y`` with its global
        ``flip_mask`` and ``dropout_masks``, of which the rank keeps its
        rows. ``gen`` is the epoch's device generator: the rule's hooks
        draw their own randomness from it (rehearsal: exemplar rows, flip
        and dropout masks of the replayed rows), after the step's flip and
        dropout masks."""
        ctx = self.ctx
        rule = ctx.update_rule
        rows = functools.partial(mesh_lib.constrain_batch, mesh=ctx.mesh)
        x = ctx.preprocess(rows(x_u8), rows(flip_mask))
        dropout_masks = rows(dropout_masks)
        batch = (x, rows(y))

        # a rule may take over the gradient computation (GEM's projection
        # needs per-memory gradients); it is handed the base computation
        base = functools.partial(self._base_loss_and_grads,
                                 dropout_masks=dropout_masks, gen=gen)
        if hasattr(rule, "compute_grads"):
            loss, grads, new_bs, metrics = rule.compute_grads(
                ctx, state.trainable, state.batch_stats, batch,
                state.mstate, base, gen=gen)
        else:
            loss, grads, new_bs, metrics = base(
                state.trainable, state.batch_stats, batch, state.mstate)

        with torch.no_grad():
            raw_grads = grads
            penalty = rule.penalty_grads(state.trainable, state.mstate)
            if penalty is not None:
                grads = tree_map(torch.add, grads, penalty)
            grads = rule.transform_grads(ctx, grads, state.trainable,
                                         state.mstate)
            wd = ctx.weight_decay
            if wd:
                if ctx.l1_decay:
                    grads = tree_map(lambda g, p: g + wd * torch.sign(p),
                                     grads, state.trainable)
                else:
                    grads = tree_map(lambda g, p: g + wd * p, grads,
                                     state.trainable)
            # freeze AFTER weight decay: the reference's freeze_mode
            # optimizes only the classifier (ref:main_SGD.py:69-72), so
            # frozen backbone weights must not decay either
            if ctx.freeze_backbone:
                grads = {**grads,
                         "params": tree_zeros_like(grads["params"])}
            # torch-SGD momentum, in place: buf = m*buf + d_p ; update = buf
            # (multi-tensor ops: a few launches for all leaves, not a few
            # per leaf)
            bufs = tree_leaves(state.momentum)
            torch._foreach_mul_(bufs, ctx.momentum)
            torch._foreach_add_(bufs, tree_leaves(grads))
            new_momentum = state.momentum
            updates = tree_leaves(rule.mask_updates(ctx, new_momentum,
                                                    state.mstate))
            new_leaves = torch._foreach_sub(
                tree_leaves(state.trainable), torch._foreach_mul(updates, lr))
            for leaf in new_leaves:
                leaf.requires_grad_()
            new_trainable = tree_unflatten(state.trainable, new_leaves)
            new_mstate = rule.post_step(ctx, state.mstate, state.trainable,
                                        new_trainable, raw_grads, batch,
                                        raw_images=x_u8, raw_labels=y)
        return TrainState(new_trainable, new_bs, new_momentum,
                          new_mstate), metrics

    def train_epoch(self, state: TrainState, images, labels, perm,
                    gen: torch.Generator | None, lr: float,
                    batch_size: int):
        """One epoch over ``perm`` (truncated to whole batches). ``gen``
        draws the per-sample flip masks on the device (unused without
        augmentation) and, for a dropout model, each step's keep-masks
        (a dropout model therefore needs ``gen``); the rule's hooks draw
        from it too. Metrics are means over the batches of the per-batch
        CE, accuracy and whatever else the rule reports (GEM: the share of
        projected steps). The batch rounds down to a multiple of the
        ranks."""
        ctx = self.ctx
        n = int(perm.shape[0])
        batch_size = mesh_lib.round_batch(batch_size, n, ctx.mesh.size)
        steps = n // batch_size
        if steps == 0:
            raise ValueError("an empty permutation cannot fill one batch")
        perm = torch.as_tensor(perm)[: steps * batch_size].to(ctx.device)
        batches = ((images.index_select(0, idx), labels.index_select(0, idx))
                   for idx in perm.view(steps, batch_size))
        per_step: dict = {}
        state = self._train_batches(state, batches, gen, lr, per_step)
        return state, self._epoch_metrics(per_step)

    def _epoch_metrics(self, per_step: dict) -> dict:
        """Means over the steps; CE and accuracy (the ranks' shares) summed
        over the ranks in one all-reduce. A rule's own metrics are equal on
        every rank (GEM's projected share) and stay as they are."""
        out = {k: torch.stack(v).mean() for k, v in per_step.items()}
        mesh_lib.all_reduce_sum([out["loss"], out["acc"]], self.ctx.mesh)
        return out

    def _train_batches(self, state: TrainState, batches, gen, lr: float,
                       per_step: dict) -> TrainState:
        """One step on each (uint8 images, labels) of ``batches``, in
        order; each step draws its flip mask (augmenting contexts only),
        then a dropout model's keep-masks, from ``gen`` on the device, and
        the rule draws after them. Appends each step's metrics (tensors,
        not read back) to ``per_step``."""
        ctx = self.ctx
        for x, y in batches:
            b = int(x.shape[0])
            flip = (torch.randint(0, 2, (b,), dtype=torch.uint8,
                                  device=ctx.device, generator=gen)
                    if ctx.augment else None)
            state, metrics = self._train_step(
                state, x, y, lr, flip, ctx.draw_dropout_masks(b, gen),
                gen=gen)
            for k, v in metrics.items():
                per_step.setdefault(k, []).append(v)
        return state

    def train_epoch_chunked(self, state: TrainState, images_np, labels_np,
                            perm, gen: torch.Generator | None, lr: float,
                            batch_size: int, chunk_rows: int,
                            feed: "ChunkFeed"):
        """One epoch over a host-resident split too large for the device
        (``clsurvey_tpu/engine/train.py:train_epoch_chunked``): the
        permutation, wrap-padded to whole chunks of ``chunk_rows`` rows
        (rounded down to whole batches, at most the batch-rounded split),
        is gathered on the host chunk by chunk and copied to the device
        while the chunk before trains. The steps, their draws from ``gen``
        and the metrics (means over every step) are those of
        :meth:`train_epoch` over the padded permutation, which this epoch
        therefore equals. ``feed`` holds the chunk buffers, made once for
        the split with the rows :func:`chunk_plan` gives."""
        perm = np.asarray(perm, np.int64)
        batch_size, chunk_rows = chunk_plan(len(perm), batch_size,
                                            chunk_rows, self.ctx.mesh.size)
        n_chunks = -(-len(perm) // chunk_rows)
        use = n_chunks * chunk_rows
        if use > len(perm):  # every chunk of one shape, every row seen
            perm = np.concatenate([perm, perm[: use - len(perm)]])
        if feed.chunk_rows != chunk_rows:
            raise ValueError(f"a feed of {feed.chunk_rows}-row chunks for an "
                             f"epoch of {chunk_rows}-row ones")
        labels = torch.from_numpy(np.asarray(labels_np)[perm]).to(
            self.ctx.device).long()
        per_step: dict = {}
        state = self._train_batches(
            state, _streamed_batches(feed, images_np, labels, perm,
                                     batch_size, n_chunks),
            gen, lr, per_step)
        return state, self._epoch_metrics(per_step)

    def evaluate(self, trainable, batch_stats, images, labels,
                 batch_size: int, predict: str | Callable = "task",
                 target_labels=None, n_counter_classes: int | None = None):
        """Accuracy + per-class counters (ref:src/framework/inference.py:
        8-87 test_model semantics). Eval preprocess is float32 with no
        flip, whatever the compute dtype.

        ``predict``: "task" (current-task head), "shared" (extended shared
        head over all tasks, rehearsal eval), or a callable
        ``(ctx, trainable, feats) -> logits``.
        ``target_labels``: override labels (e.g. offset labels for shared
        eval). ``n_counter_classes``: length of the per-class counters
        (default: the head width, times ``n_tasks`` for "shared").
        Under a group the batch rounds up to a multiple of the ranks, each
        rank counts its rows of each batch (padded rows weigh 0), and the
        counters are all-reduced once."""
        ctx = self.ctx
        n = int(images.shape[0])
        batch_size = mesh_lib.round_eval_batch(batch_size, n, ctx.mesh.size)
        y_all = torch.as_tensor(labels if target_labels is None
                                else target_labels).to(ctx.device).long()
        if n_counter_classes is None:
            kernel_c = int(np.max(ctx.class_counts))
            n_counter_classes = (kernel_c * ctx.n_tasks
                                 if predict == "shared" else kernel_c)
        if callable(predict):
            logits_of = lambda feats: predict(ctx, trainable, feats)
        elif predict == "task":
            logits_of = lambda feats: ctx.task_logits(trainable, feats)
        elif predict == "shared":
            logits_of = lambda feats: ctx.shared_logits(trainable, feats)
        else:
            raise ValueError(predict)

        def logits_u8(x_u8):
            x = pp.preprocess(x_u8, ctx.mean, ctx.std)
            feats, _ = ctx.forward_feats(trainable["params"], batch_stats,
                                         x, False)
            return logits_of(feats)

        pcc, pct = mesh_lib.count_hits(images, y_all, batch_size, logits_u8,
                                       n_counter_classes, ctx.mesh)
        per_class_c, per_class_t = pcc.cpu().numpy(), pct.cpu().numpy()
        acc = float(per_class_c.sum()) / max(float(per_class_t.sum()), 1.0)
        return acc, per_class_c, per_class_t

    def evaluate_chunked(self, trainable, batch_stats, images_np,
                         labels_np, batch_size: int, chunk_rows: int,
                         **kwargs):
        """:meth:`evaluate` over a host-resident split too large for the
        device (``clsurvey_tpu/engine/train.py:evaluate_chunked``): one
        chunk of at least ``batch_size`` rows at a time, in order (the last
        may be short), with the per-class counters summed over the chunks
        and the accuracy computed from the sums."""
        n = int(images_np.shape[0])
        chunk_rows = max(int(chunk_rows), int(batch_size))
        total_c = total_t = 0.0
        for lo in range(0, n, chunk_rows):
            _, pcc, pct = self.evaluate(
                trainable, batch_stats,
                place(images_np[lo: lo + chunk_rows], self.ctx.device),
                np.asarray(labels_np[lo: lo + chunk_rows]), batch_size,
                **kwargs)
            total_c, total_t = total_c + pcc, total_t + pct
        acc = float(np.sum(total_c)) / max(float(np.sum(total_t)), 1.0)
        return acc, total_c, total_t


def _streamed_batches(feed: "ChunkFeed", images_np, labels: torch.Tensor,
                      perm: np.ndarray, batch_size: int, n_chunks: int):
    """The (uint8 images, labels) batches of a streamed epoch, in order: a
    gather thread loads chunk ``c + 1`` while the caller steps through
    chunk ``c``. One generator for the whole epoch, so that no state of a
    chunk's start stays alive through the chunk's steps."""
    rows = feed.chunk_rows
    with ThreadPoolExecutor(1) as pool:
        pending = pool.submit(feed.load, images_np, perm[:rows], 0)
        for c in range(n_chunks):
            pending.result()
            if c + 1 < n_chunks:  # gather and copy the next chunk now
                pending = pool.submit(
                    feed.load, images_np,
                    perm[(c + 1) * rows: (c + 2) * rows], c + 1)
            x, y = feed.chunk(c), labels[c * rows: (c + 1) * rows]
            for i in range(0, rows, batch_size):
                yield x[i: i + batch_size], y[i: i + batch_size]
            feed.consumed(c)  # the chunk's steps are all dispatched


def chunk_plan(n: int, batch_size: int, chunk_rows: int,
               nd: int = 1) -> tuple[int, int]:
    """(batch size, rows a chunk) of a streamed epoch over ``n`` rows: the
    batch at most ``n`` and rounded down to a multiple of the ``nd``
    ranks, the chunk rounded down to whole batches (at least one) and at
    most the batch-rounded split, as the JAX package rounds them
    (``clsurvey_tpu/engine/train.py:338-346``)."""
    batch_size = mesh_lib.round_batch(batch_size, n, nd)
    if batch_size <= 0:
        raise ValueError("an empty permutation cannot fill one batch")
    chunk_rows = max(int(chunk_rows) // batch_size * batch_size, batch_size)
    return batch_size, min(chunk_rows, n // batch_size * batch_size)


class ChunkFeed:
    """The buffers of a streamed epoch: two host chunks of ``chunk_rows``
    rows (pinned on the card) and, on the card, two device chunks, made
    once and reused for every chunk (pinning a gigabyte costs more than
    copying it). Chunk ``c`` lives in buffer ``c % 2``. :meth:`load`, run
    on a gather thread, fills the host buffer and, on the card, copies it
    to the device buffer on a side stream; :meth:`chunk` makes the compute
    stream wait for that copy; :meth:`consumed`, called once the chunk's
    steps are dispatched, keeps the next copy into that buffer from
    starting before they have read it. On the CPU the host buffers are the
    chunks and the compute is done when its call returns."""

    def __init__(self, row_shape, chunk_rows: int, device):
        self.chunk_rows = int(chunk_rows)
        self.device = torch.device(device)
        cuda = self.device.type == "cuda"
        shape = (self.chunk_rows,) + tuple(row_shape)
        self.host = [torch.empty(shape, dtype=torch.uint8, pin_memory=cuda)
                     for _ in range(2)]
        self.dev = ([torch.empty(shape, dtype=torch.uint8,
                                 device=self.device) for _ in range(2)]
                    if cuda else self.host)
        self.stream = torch.cuda.Stream(self.device) if cuda else None
        self._copied = [None, None]    # copy stream: the buffer's last copy
        self._consumed = [None, None]  # compute stream: its last reader

    def load(self, images_np, rows, c: int) -> None:
        """Gather ``images_np[rows]`` into buffer ``c % 2`` and, on the
        card, start its copy to the device."""
        b = c % 2
        if self._copied[b] is not None:
            self._copied[b].synchronize()  # the pinned rows were copied
        gather_rows(images_np, rows, out=self.host[b])
        if self.stream is None:
            return
        with torch.cuda.device(self.device), torch.cuda.stream(self.stream):
            if self._consumed[b] is not None:
                self.stream.wait_event(self._consumed[b])
            self.dev[b].copy_(self.host[b], non_blocking=True)
            self._copied[b] = torch.cuda.Event()
            self._copied[b].record(self.stream)

    def chunk(self, c: int) -> torch.Tensor:
        b = c % 2
        if self.stream is not None:
            torch.cuda.current_stream(self.device).wait_event(
                self._copied[b])
        return self.dev[b]

    def consumed(self, c: int) -> None:
        if self.stream is not None:
            self._consumed[c % 2] = torch.cuda.Event()
            self._consumed[c % 2].record(
                torch.cuda.current_stream(self.device))


# ---------------------------------------------------------------------------
# Host-side task-training controller
# ---------------------------------------------------------------------------

@dataclass
class TrainJob:
    exp_dir: str
    num_epochs: int = 70
    batch_size: int = 200
    lr: float = 5e-3
    saving_freq: int = 5            # ref:train_SGD.py saving_freq
    decay_threshold: int = 5        # lr x0.1 when count == 5
    early_stop_threshold: int = 10  # stop when count > 10
    resume: bool = True
    save_models_mode: bool = True
    seed: int = 7
    eval_batch_size: int = 0        # 0 -> use batch_size

    def __post_init__(self):
        if self.eval_batch_size == 0:
            self.eval_batch_size = self.batch_size


def trainable_to_host(trainable: dict, convert=params_to_jax) -> dict:
    """Trainable tree (or a tree shaped like it, e.g. momentum) -> the JAX
    package's layout, numpy. ``convert`` maps the backbone's weights (HAT
    and PathNet pass their own, ``models/convert.py``)."""
    return {"params": convert(trainable["params"]),
            "heads": io.to_host(trainable["heads"])}


def trainable_from_host(tree: dict, device, requires_grad: bool,
                        convert=params_from_jax) -> dict:
    """JAX-layout trainable tree -> tensors on ``device``."""
    out = {"params": convert(tree["params"], device),
           "heads": {k: torch.tensor(np.asarray(tree["heads"][k],
                                                np.float32), device=device)
                     for k in ("kernel", "bias")}}
    if requires_grad:
        for t in tree_leaves(out):
            t.requires_grad_()
    return out


def model_state_dict(ctx: EngineContext, state: TrainState,
                     meta: dict | None = None,
                     include_aux: bool = True) -> dict:
    """The canonical on-disk model format ({'params','batch_stats','heads',
    'meta'[,'method_aux']}) in the JAX package's layout — the inter-task /
    eval interchange artifact, replacing the reference's whole-module
    pickles (which carry ``model.reg_params`` along, hence ``method_aux``).
    ``include_aux=False`` skips the method-aux export (the aux-heavy
    rehearsal rules attach it once per attempt instead)."""
    host = trainable_to_host(state.trainable)
    out = {
        "params": host["params"],
        "batch_stats": batch_stats_to_jax(state.batch_stats),
        "heads": {**host["heads"],
                  "class_counts": np.asarray(ctx.class_counts)},
        "meta": dict(meta or {}),
    }
    if include_aux:
        aux = ctx.update_rule.export_aux(state.mstate)
        if aux is not None:
            out["method_aux"] = io.to_host(aux)
    return out


def state_from_model(model: dict, mstate: Any, device) -> TrainState:
    """Build a fresh TrainState (zero momentum) on ``device`` from a
    model-state dict."""
    trainable = trainable_from_host(model, device, requires_grad=True)
    batch_stats = batch_stats_from_jax(model.get("batch_stats"), device)
    return TrainState(trainable, batch_stats, tree_zeros_like(trainable),
                      mstate)


def data_budget_bytes() -> int:
    """Device budget for resident split data (CLSURVEY_DATA_BUDGET_MB,
    default 2048). A split above it streams through chunks of half the
    budget (:func:`stream_chunk_rows`), one in compute and one in
    flight."""
    return int(os.environ.get("CLSURVEY_DATA_BUDGET_MB", "2048")) * 2 ** 20


def stream_chunk_rows(row_bytes: int) -> int:
    """Rows of a streamed chunk: half the data budget."""
    return max(data_budget_bytes() // 2 // max(int(row_bytes), 1), 1)


def place(array, device) -> torch.Tensor:
    """Rows (a host array or a tensor) as a tensor on ``device``, whatever
    their size."""
    if not isinstance(array, torch.Tensor):
        array = torch.from_numpy(np.ascontiguousarray(array))
    return array.to(device)


def _load_resume(ckpt_path: str, device, rule: UpdateRule | None = None):
    """(the epoch checkpoint's dict, its TrainState on ``device``). The
    JAX engine, where orbax is importable, keeps the trees in an Orbax
    directory and only a pointer to it in the pickle; the pointer is
    followed as written, as the JAX engine follows it. Without orbax it
    writes the trees into the pickle itself. Either way the method state is
    in the JAX layout: the base rule's (its hyperparameters) is the same in
    both packages, every other rule converts it through its own
    ``mstate_from_jax``. A rule without one is refused, Orbax or pickle,
    rather than handed a state it would mis-read."""
    ck = io.load(ckpt_path)
    rule = rule or UpdateRule()
    if type(rule) is not UpdateRule and \
            type(rule).mstate_from_jax is UpdateRule.mstate_from_jax:
        raise RuntimeError(
            f"{ckpt_path} is an epoch checkpoint whose method state "
            f"{type(rule).__name__} has no conversion for (no "
            f"mstate_from_jax of its own); clsurvey_torch refuses it rather "
            f"than resume a mis-laid state. Delete it to restart the task.")
    trees = orbax_io.load(ck["orbax_state"]) if ck.get("orbax_state") \
        else ck
    state = TrainState(
        trainable_from_host(trees["trainable"], device, requires_grad=True),
        batch_stats_from_jax(trees["batch_stats"], device),
        trainable_from_host(trees["momentum"], device, requires_grad=False),
        tree_to_device(rule.mstate_from_jax(trees["mstate"]), device))
    return ck, state


def train_task(engine: Engine, job: TrainJob, state: TrainState,
               task_data, log: Callable = print,
               perms: Callable[[int], Any] | None = None):
    """Epoch loop with best-val tracking / lr decay / early stop / resume —
    behavior of ref:src/methods/Finetune/train_SGD.py:41-189 shared by every
    method. Returns (best_model_dict, best_val_acc, final_state).

    ``perms(epoch)``, when given, supplies the epoch's permutation of the
    train split (tests hand in the JAX package's); otherwise it comes from
    a generator seeded with (job.seed, epoch).

    Under a process group every rank runs this loop on the whole split:
    the state is broadcast from rank 0 at the start (the JAX package's
    replicated ``device_put``), every decision comes from all-reduced
    numbers, and the writer alone writes the files and the log lines."""
    ctx = engine.ctx
    log = mesh_lib.writer_log(log, ctx.mesh)
    os.makedirs(job.exp_dir, exist_ok=True)
    ckpt_path = os.path.join(job.exp_dir, EPOCH_CKPT_FILENAME)
    best_path = os.path.join(job.exp_dir, BEST_MODEL_FILENAME)

    # each split streams from the host if it is above the budget, in
    # chunks sized by the train split's rows (as the JAX package sizes them)
    budget = data_budget_bytes()
    train_np = np.asarray(task_data.train.images)
    train_labels_np = np.asarray(task_data.train.labels)
    val_np = np.asarray(task_data.val.images)
    val_labels_np = np.asarray(task_data.val.labels)
    n_train = int(train_np.shape[0])
    stream_train = train_np.nbytes > budget
    stream_val = val_np.nbytes > budget
    chunk_rows = stream_chunk_rows(train_np.nbytes // max(n_train, 1))
    feed = None
    if stream_train:
        log(f"streaming train split ({train_np.nbytes / 2**20:.0f} MiB > "
            f"budget {budget / 2**20:.0f} MiB): "
            f"{chunk_rows}-row chunks")
        feed = ChunkFeed(train_np.shape[1:], chunk_plan(
            n_train, job.batch_size, chunk_rows, ctx.mesh.size)[1],
            ctx.device)
    else:
        train_images = place(train_np, ctx.device)
        train_labels = place(train_labels_np, ctx.device).long()
    if not stream_val:
        val_images = place(val_np, ctx.device)
        val_labels = place(val_labels_np, ctx.device).long()

    start_epoch, lr = 0, job.lr
    best_acc, val_beat_counts = 0.0, 0
    best_model = None
    error_history: list = []  # per-epoch val error %, dumped as JSON
    rule_history: dict = {}   # per-epoch means of the rule's own metrics
    history_path = os.path.join(job.exp_dir, "error_history.json")

    if job.resume and io.exists(ckpt_path):
        ck, state = _load_resume(ckpt_path, ctx.device, ctx.update_rule)
        start_epoch = ck["epoch"] + 1
        lr = ck["lr"]
        best_acc = ck["best_acc"]
        val_beat_counts = ck["val_beat_counts"]
        if io.exists(best_path):
            best_model = io.load(best_path)
        if io.exists(history_path):
            with open(history_path) as f:
                history = json.load(f)
            # the history file is written every epoch but the state ckpt
            # only every saving_freq: truncate so re-run epochs don't
            # append duplicate entries (index == epoch must hold)
            error_history = history.get("error_history", [])[:start_epoch]
            rule_history = {k: v[:start_epoch] for k, v in
                            history.get("rule_metrics", {}).items()}
        log(f"=> resumed epoch {start_epoch} lr={lr:g} best={best_acc:.4f}")
    mesh_lib.replicated([state.trainable, state.batch_stats, state.momentum,
                         state.mstate], ctx.mesh)

    # host snapshot of the task-start model: the fallback for runs that
    # never improve (a NaN-aborted final state must not chain into the next
    # task). aux_heavy rules (rehearsal family) defer their large method-aux
    # export to one attach per attempt.
    aux_heavy = bool(getattr(ctx.update_rule, "aux_heavy", False))
    init_model = model_state_dict(
        ctx, state, meta={"task": ctx.task, "n_tasks": ctx.n_tasks,
                          "failed_attempt": True},
        include_aux=not aux_heavy)

    # large method states stretch the resume-checkpoint period 4x
    mstate_bytes = sum(t.numel() * t.element_size()
                       for t in tree_leaves(state.mstate)
                       if isinstance(t, torch.Tensor))
    ckpt_freq = job.saving_freq * (4 if mstate_bytes > (32 << 20) else 1)
    ran_epochs = False

    for epoch in range(start_epoch, job.num_epochs):
        # early stop (ref:train_SGD.py:19-21: count > threshold)
        if val_beat_counts > job.early_stop_threshold:
            log("training terminated")
            break
        # decay (ref:train_SGD.py:24-29: count == threshold)
        if val_beat_counts == job.decay_threshold:
            lr = lr * 0.1
            log(f"lr is set to {lr:g}")

        if perms is not None:
            perm = torch.tensor(np.asarray(perms(epoch)), dtype=torch.long)
        else:
            perm = torch.randperm(n_train,
                                  generator=rng_lib.generator(job.seed,
                                                              epoch))
        flip_gen = rng_lib.generator(job.seed, epoch, 1, device=ctx.device)
        ran_epochs = True
        if stream_train:
            state, metrics = engine.train_epoch_chunked(
                state, train_np, train_labels_np, perm.numpy(), flip_gen,
                lr, job.batch_size, chunk_rows, feed)
        else:
            state, metrics = engine.train_epoch(
                state, train_images, train_labels, perm, flip_gen, lr,
                job.batch_size)
        train_loss = float(metrics.pop("loss"))
        train_acc = float(metrics.pop("acc"))
        # the rule's own per-epoch means (GEM's projected share)
        rule_metrics = {k: float(v) for k, v in metrics.items()}

        if stream_val:
            val_acc, _, _ = engine.evaluate_chunked(
                state.trainable, state.batch_stats, val_np, val_labels_np,
                job.eval_batch_size, chunk_rows)
        else:
            val_acc, _, _ = engine.evaluate(
                state.trainable, state.batch_stats, val_images, val_labels,
                job.eval_batch_size)
        log(f"epoch {epoch}: loss={train_loss:.4f} "
            f"train_acc={train_acc:.4f} val_acc={val_acc:.4f} lr={lr:g}"
            + "".join(f" {k}={v:.4f}" for k, v in rule_metrics.items()))

        # per-epoch error history JSON next to the checkpoint
        # (ref:src/methods/packnet/main.py:287-291 dumps error_history)
        error_history.append(100.0 * (1.0 - val_acc))
        for k, v in rule_metrics.items():
            rule_history.setdefault(k, []).append(v)
        if job.save_models_mode:
            io.save_json({"error_history": error_history, "lr": lr,
                          "train_loss": train_loss,
                          "rule_metrics": rule_history}, history_path)

        if not np.isfinite(train_loss) or train_loss > DIVERGENCE_LOSS_BOUND:
            # NaN guard aborts training (ref:src/methods/SI/train_SI.py:242);
            # a finite-but-exploded loss is the same failure one epoch
            # earlier and must not be recorded as the best model
            log(f"diverged (loss={train_loss:.4g}) — aborting training")
            break

        if val_acc > best_acc:
            best_acc = val_acc
            val_beat_counts = 0
            best_model = model_state_dict(
                ctx, state, meta={"task": ctx.task, "n_tasks": ctx.n_tasks,
                                  "epoch": epoch, "val_acc": val_acc},
                include_aux=not aux_heavy)
            if job.save_models_mode:
                io.save(best_model, best_path)
                # memory telemetry next to every best model
                # (ref:src/methods/Finetune/train_SGD.py:142-144)
                timing.save_mem_req(job.exp_dir)
        else:
            val_beat_counts += 1

        if job.save_models_mode and (epoch % ckpt_freq == 0
                                     or epoch == job.num_epochs - 1):
            meta = {"epoch": epoch, "lr": lr, "best_acc": best_acc,
                    "val_beat_counts": val_beat_counts}
            trees = {"trainable": trainable_to_host(state.trainable),
                     "batch_stats": batch_stats_to_jax(state.batch_stats),
                     "momentum": trainable_to_host(state.momentum),
                     "mstate": io.to_host(
                         ctx.update_rule.mstate_to_jax(state.mstate))}
            io.save({**meta, **trees}, ckpt_path)

    need_save = False
    if best_model is None:  # zero-epoch or fully-failed (e.g. NaN) runs
        best_model = init_model
        # downstream phases chain through best_model.pth.tar on disk;
        # a retained-but-never-improved attempt must still leave one
        need_save = True
    # aux_heavy: attach the method aux ONCE per attempt (see
    # model_state_dict), so every best model a SUCCESS flag vouches for
    # carries its aux
    aux = (ctx.update_rule.export_aux(state.mstate) if aux_heavy else None)
    if aux is not None and (ran_epochs or "method_aux" not in best_model):
        best_model["method_aux"] = io.to_host(aux)
        need_save = True
    if need_save and job.save_models_mode:
        io.save(best_model, best_path)
    return best_model, best_acc, state
