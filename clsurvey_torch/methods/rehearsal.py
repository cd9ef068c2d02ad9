"""Rehearsal-based methods: GEM, iCaRL, and the replay baselines.

Counterpart of ``clsurvey_tpu/methods/rehearsal.py``. The reference keeps
episodic memories as image paths and rebuilds DataLoaders from disk every
batch (ref:src/methods/rehearsal/model/common.py:14-118,
gem.py:233-255). Here every memory is a tensor bundle on the engine's
device inside the method state:

    mem_images (n_tasks, M, H, W, 3) uint8 · mem_labels (n_tasks, M) int32
    mem_count (n_tasks,) int32 · mem_cnt (ring position, a host int)

The ring position depends only on batch sizes, never on data, so it is
kept on the host and the per-step buffer write is a slice assignment with
no read-back. On disk a memory (and iCaRL's exemplar store) is the JAX
package's numpy dict, ``mem_cnt`` an int32 scalar, so either package
continues from the other's files.

- **GEM** (ref:gem.py): per step, the CE gradient of the MEAN over every
  past task's full buffer, in ``mem_batch`` chunks whose partial sums
  divide by the global valid count (the JAX package's chunk-size-invariant
  deviation from the reference's sum of per-batch means); if any
  ``<g, g_mem> < 0`` the dual bound-QP (``ops/qp.py``) projects g, on the
  device. The ring buffer is filled from each batch's raw images. Task 1
  only wraps the shared SI model and fills the buffer.
- **iCaRL** (ref:icarl.py): CE on the new-task part of the batch plus
  lambda times the T=2 ``batchmean`` KL distillation of sampled exemplars
  against their stored outputs; ``poststep`` herds exemplars per class
  (``ops/herding.py``) and stores distillation targets; eval is the
  nearest class mean over exemplar features, as a synthesized head.
- **Baselines** (ref:baseline_rehearsal_*.py): the batch is new samples
  plus guaranteed exemplars of every past task; loss = CE_new + mean of
  per-task exemplar CE. full-mem divides the total capacity over the tasks
  seen.

Randomness: each rule's draws (exemplar rows, the remainder rows' source
task, flip masks of replayed rows, dropout masks of the memory forwards)
come from the epoch's device generator the engine hands its hooks, through
one ``draw`` method per rule, which a test replaces with the JAX run's
draws. The JAX package's documented deviations from the reference carry
over (remainder rows drawn per batch, exemplars drawn with replacement,
per-element dropout masks).

Data parallel (``parallel/mesh.py``): every rule draws for its GLOBAL rows
(a memory chunk, the replayed exemplars) and then keeps its rank's rows of
them and of the draws (``ctx.mesh.shard``). GEM's memory losses are sums
over the global valid count, so each rank's chunk rows give its share, and
the (t, p) memory gradients are all-reduced once a step before the QP,
which then runs on every rank on equal inputs. The replay and iCaRL terms
are means over their rows: the rank's mean times the shard's
``mean_scale``. The ring writes the global batch's rows (``post_step``'s
``raw_images`` / ``raw_labels``), so every rank's memory stays equal."""

from __future__ import annotations

import warnings
from collections import OrderedDict
from dataclasses import dataclass, field

import numpy as np
import torch
import torch.nn.functional as F

from clsurvey_torch.engine.train import make_context, tree_leaves, \
    tree_unflatten
from clsurvey_torch.framework import lr_grid
from clsurvey_torch.framework.evaluate import default_inference_eval
from clsurvey_torch.methods import common
from clsurvey_torch.methods.base import Category, Method, UpdateRule
from clsurvey_torch.methods.finetune import finetune_grid_train
from clsurvey_torch.models import heads as heads_lib
from clsurvey_torch.models.convert import batch_stats_from_jax, params_from_jax
from clsurvey_torch.ops import herding as herd_lib
from clsurvey_torch.ops import preprocess as pp
from clsurvey_torch.ops.distill import icarl_distill
from clsurvey_torch.ops.qp import gem_project_if_violating
from clsurvey_torch.parallel import mesh as mesh_lib
from clsurvey_torch.utils import io

NEG_INF = heads_lib.NEG_INF


# ---------------------------------------------------------------------------
# shared memory helpers
# ---------------------------------------------------------------------------

def _on(x, device, dtype=None) -> torch.Tensor:
    """A fresh copy of ``x`` (numpy or tensor) on ``device``: the rules
    write into their memories in place, so they never alias a caller's
    arrays."""
    return torch.tensor(np.asarray(io.to_host(x)), dtype=dtype,
                        device=device)


def _host(t: torch.Tensor) -> np.ndarray:
    return t.detach().to("cpu", copy=True).numpy()


def fresh_task_memory(n_tasks: int, n_memories: int, input_size,
                      device=None) -> dict:
    h, w = input_size
    return {
        "mem_images": torch.zeros((n_tasks, n_memories, h, w, 3),
                                  dtype=torch.uint8, device=device),
        "mem_labels": torch.zeros((n_tasks, n_memories), dtype=torch.int32,
                                  device=device),
        "mem_count": torch.zeros(n_tasks, dtype=torch.int32, device=device),
        "mem_cnt": 0,
    }


def memory_on(mem: dict, device) -> dict:
    """A memory (numpy from disk, or tensors) as fresh tensors on
    ``device``, its ring position as a host int."""
    return {"mem_images": _on(mem["mem_images"], device, torch.uint8),
            "mem_labels": _on(mem["mem_labels"], device, torch.int32),
            "mem_count": _on(mem["mem_count"], device, torch.int32),
            "mem_cnt": int(mem["mem_cnt"])}


def memory_to_host(mem: dict) -> dict:
    """The on-disk form: numpy copies, ``mem_cnt`` a 0-d int32 array (the
    JAX package's)."""
    return {**{k: _host(mem[k]) for k in ("mem_images", "mem_labels",
                                          "mem_count")},
            "mem_cnt": np.array(int(mem["mem_cnt"]), np.int32)}


def ring_buffer_update(mem: dict, task: int, x_u8: torch.Tensor,
                       y: torch.Tensor) -> dict:
    """ref:gem.py:323-345 fill_buffer: store the batch prefix that fits,
    wrap the counter when the buffer fills. Writes the tensors in place
    and returns the memory with its new ring position."""
    n_mem = mem["mem_images"].shape[1]
    cnt = int(mem["mem_cnt"])
    n_fit = min(int(x_u8.shape[0]), n_mem - cnt)
    new_cnt = cnt + n_fit
    mem["mem_images"][task, cnt:new_cnt] = x_u8[:n_fit].to(torch.uint8)
    mem["mem_labels"][task, cnt:new_cnt] = y[:n_fit].to(torch.int32)
    mem["mem_count"][task: task + 1].clamp_(min=new_cnt)
    return {**mem, "mem_cnt": 0 if new_cnt >= n_mem else new_cnt}


def fill_buffer_from_data(mem: dict, task: int, images_u8: np.ndarray,
                          labels: np.ndarray, seed: int = 7) -> dict:
    """GEM task-1 postprocess: fill the buffer with the first n_memories
    shuffled samples (ref:gem.py:347-374 manage_memory), the same numpy
    permutation as the JAX package's."""
    n_mem = int(mem["mem_images"].shape[1])
    perm = np.random.default_rng(seed).permutation(len(labels))[:n_mem]
    n = len(perm)
    dev = mem["mem_images"].device
    mem["mem_images"][task, :n] = torch.from_numpy(images_u8[perm]).to(dev)
    mem["mem_labels"][task, :n] = torch.from_numpy(
        np.asarray(labels[perm], np.int32)).to(dev)
    mem["mem_count"][task] = n
    return mem


def _uniform_index(u: torch.Tensor, limit: torch.Tensor) -> torch.Tensor:
    """floor(u * limit) for u in [0, 1), kept below ``limit`` (float32
    rounding can reach it)."""
    return torch.minimum((u * limit).floor().long(), limit.long() - 1)


def _limits(mem: dict, t: int, per_task_mem) -> torch.Tensor:
    limit = mem["mem_count"][:t].clamp_min(1)
    return limit if per_task_mem is None else limit.clamp_max(per_task_mem)


def _sample_remainder_rows(gen, mem: dict, t: int, rem: int, per_task_mem):
    """``rem`` exemplar rows whose source task is drawn uniformly from the
    ``t`` past tasks (per call, i.e. per batch) and whose slot index is
    uniform within that task's valid count. Returns (tasks, slots)."""
    dev = mem["mem_images"].device
    tt_dyn = torch.randint(0, t, (rem,), generator=gen, device=dev)
    u = torch.rand(rem, generator=gen, device=dev)
    return tt_dyn, _uniform_index(u, _limits(mem, t, per_task_mem)[tt_dyn])


def _exemplar_split(n_append: int, n_parts: int) -> tuple:
    """(equal floor share per past task, remainder). The remainder is
    replayed from per-batch uniformly-sampled tasks (matching the
    reference's random remainder assignment in expectation,
    ref:baseline_rehearsal_partial_mem.py:195-200)."""
    return n_append // n_parts, n_append % n_parts


def replay_masks(ctx, n: int, gen):
    """(flip mask, dropout keep-masks) for a train-mode forward of ``n``
    replayed rows: None where the context does not augment / the model has
    no dropout."""
    flip = (torch.randint(0, 2, (n,), dtype=torch.uint8, device=ctx.device,
                          generator=gen) if ctx.augment else None)
    return flip, ctx.draw_dropout_masks(n, gen)


def _flat(tree) -> torch.Tensor:
    return torch.cat([g.reshape(-1) for g in tree_leaves(tree)])


def _unflat(like, flat: torch.Tensor):
    """``flat`` cut back into ``like``'s leaves, each with its leaf's
    strides (channels_last convs stay so)."""
    out, i = [], 0
    for g in tree_leaves(like):
        n = g.numel()
        out.append(torch.empty_like(g).copy_(flat[i:i + n].view(g.shape)))
        i += n
    return tree_unflatten(like, out)


class _MemoryRule(UpdateRule):
    """A rule with a per-task memory that each step's raw batch fills."""

    aux_heavy = True  # uint8 exemplar memory: attach once per attempt

    def init_state(self, trainable, hyperparams, ctx, memory=None):
        state = super().init_state(trainable, hyperparams, ctx)
        state["memory"] = (memory_on(memory, ctx.device) if memory is not None
                           else fresh_task_memory(len(ctx.class_counts),
                                                  self.n_memories,
                                                  ctx.spec.input_size,
                                                  ctx.device))
        return state

    def post_step(self, ctx, mstate, old_trainable, new_trainable,
                  raw_grads, batch, raw_images=None, raw_labels=None):
        """The ring takes the global batch's rows: every rank's memory
        stays equal."""
        memory = ring_buffer_update(
            mstate["memory"], ctx.task, raw_images,
            batch[1] if raw_labels is None else raw_labels)
        return {**mstate, "memory": memory}

    def export_aux(self, mstate):
        return {"memory": memory_to_host(mstate["memory"])}

    def mstate_from_jax(self, tree):
        # a JAX-written file and one of an earlier port version differ only
        # in the ring position's type (a 0-d array there, an int here)
        mem = tree["memory"]
        return {**tree, "memory": {**mem, "mem_cnt": int(mem["mem_cnt"])}}


# ---------------------------------------------------------------------------
# GEM
# ---------------------------------------------------------------------------

GEM_BN_CHUNK = 128  # the JAX package's chunk: batch-norm statistics per chunk
GEM_MAX_CHUNK = 1024  # caps one backward's activations whatever the memory


def gem_chunk_rows(n_memories: int, batch_norm: bool) -> int:
    """Rows of one GEM memory chunk. The memory gradient is the exact
    full-buffer mean whatever the chunk. With batch-norm the train-mode
    forwards normalize with the chunk's statistics, so the chunk is the
    JAX package's 128 rows. Without it the chunk changes only the order of
    a sum: one pass of up to ``GEM_MAX_CHUNK`` rows replaces 8 host-bound
    passes of 128 (PERF.md, section 5), and the cap bounds the activation
    memory of one backward for any ``mem_per_task``."""
    return min(n_memories, GEM_BN_CHUNK if batch_norm else GEM_MAX_CHUNK)


class GEMRule(_MemoryRule):
    def __init__(self, n_memories: int, mem_batch: int = 256):
        self.n_memories = int(n_memories)
        self.mem_batch = int(mem_batch)

    def draw(self, ctx, gen, n: int):
        """The masks of one memory chunk's forward."""
        return replay_masks(ctx, n, gen)

    def memory_grads(self, ctx, trainable, batch_stats, mstate,
                     gen=None) -> torch.Tensor:
        """(t, p): per past task, the gradient of the MEAN CE over its full
        buffer, flattened like ``torch.cat`` of the trainable's leaves. The
        tasks replay one after another, each in ``mem_batch`` chunks: the
        last chunk re-slices from M - mb with the overlap masked out, and
        every chunk divides by the task's valid count, so the result does
        not depend on the chunk size. The forwards run in train mode
        (batch-norm on each chunk's statistics, which are dropped). Under a
        process group each rank runs its rows of every chunk and the
        result is all-reduced: the global memory gradients."""
        mem = mstate["memory"]
        M = mem["mem_images"].shape[1]
        mb = min(M, self.mem_batch)
        nb = -(-M // mb)  # ceil: include the remainder chunk
        leaves = tree_leaves(trainable)
        bank = ctx.bank(trainable)
        rows = []
        for tt in range(ctx.task):
            n_valid = mem["mem_count"][tt]
            acc = None
            for i in range(nb):
                start = min(i * mb, M - mb)
                sh = ctx.mesh.shard(mb)
                lo, hi = start + sh.lo, start + sh.hi
                idxs = start + torch.arange(mb, device=ctx.device)
                idxs = idxs[sh.lo:sh.hi]
                w = ((idxs >= i * mb) & (idxs < n_valid)).to(torch.float32)
                flip, drop = (mesh_lib.constrain_batch(m, ctx.mesh)
                              for m in self.draw(ctx, gen, mb))
                x = ctx.preprocess(mem["mem_images"][tt, lo:hi], flip)
                feats, _ = ctx.forward_feats(trainable["params"], batch_stats,
                                             x, True, drop)
                ce = F.cross_entropy(
                    heads_lib.forward(bank, feats, tt),
                    mem["mem_labels"][tt, lo:hi].long(),
                    reduction="none")
                loss = mesh_lib.share((ce * w).sum() / n_valid.clamp_min(1),
                                      sh.sum_scale)
                g = _flat(mesh_lib.grads_of(loss, leaves))
                acc = g if acc is None else acc + g
            rows.append(acc)
        return mesh_lib.all_reduce_sum([torch.stack(rows)], ctx.mesh)[0]

    def compute_grads(self, ctx, trainable, batch_stats, batch, mstate,
                      base_fn, gen=None):
        loss, grads, new_bs, metrics = base_fn(trainable, batch_stats,
                                               batch, mstate)
        if ctx.task == 0:
            return loss, grads, new_bs, metrics
        G = self.memory_grads(ctx, trainable, batch_stats, mstate, gen)
        with torch.no_grad():
            projected, violated = gem_project_if_violating(
                _flat(grads), G, mstate["hyper"]["margin"])
        return loss, _unflat(grads, projected), new_bs, {
            **metrics, "projected": violated.to(torch.float32)}


# ---------------------------------------------------------------------------
# replay baselines
# ---------------------------------------------------------------------------

class ReplayRule(_MemoryRule):
    """FT + guaranteed exemplar replay (ref:baseline_rehearsal_partial_mem
    ``observe_FT``). ``n_append`` exemplars per batch split over past tasks;
    loss adds the mean of per-task exemplar CE means."""

    def __init__(self, n_memories: int, n_append: int,
                 per_task_mem: int | None = None):
        self.n_memories = int(n_memories)       # buffer capacity per task
        self.n_append = int(n_append)
        self.per_task_mem = per_task_mem        # full-mem: truncated size

    def draw(self, ctx, mstate, gen, base: int, rem: int) -> dict:
        """This step's draws: ``idx[tt]`` (base,) slots of past task tt,
        ``rem_task`` / ``rem_idx`` the remainder rows' tasks and slots, and
        ``masks`` the (flip, dropout) pair of each replayed forward, the
        per-task ones first."""
        mem, t = mstate["memory"], ctx.task
        out = {"idx": [], "masks": []}
        if base:
            limit = _limits(mem, t, self.per_task_mem)
            for tt in range(t):
                u = torch.rand(base, generator=gen, device=ctx.device)
                out["idx"].append(_uniform_index(u, limit[tt]))
                out["masks"].append(replay_masks(ctx, base, gen))
        if rem:
            out["rem_task"], out["rem_idx"] = _sample_remainder_rows(
                gen, mem, t, rem, self.per_task_mem)
            out["masks"].append(replay_masks(ctx, rem, gen))
        return out

    def _ce(self, ctx, trainable, batch_stats, x_u8, y, masks, head):
        """This rank's share of the mean CE of replayed rows under
        ``head``: a task index, or per-row tasks (the remainder rows pick
        their head from the bank). The rows, their masks and their heads
        are the global draw's; the rank keeps its shard of them."""
        sh = ctx.mesh.shard(int(x_u8.shape[0]))
        x_u8, y = x_u8[sh.lo:sh.hi], y[sh.lo:sh.hi]
        flip, drop = (mesh_lib.constrain_batch(m, ctx.mesh) for m in masks)
        if not isinstance(head, int):
            head = head[sh.lo:sh.hi]
        feats, _ = ctx.forward_feats(trainable["params"], batch_stats,
                                     ctx.preprocess(x_u8, flip), True, drop)
        bank = ctx.bank(trainable)
        if isinstance(head, int):
            logits = heads_lib.forward(bank, feats, head)
        else:
            logits = heads_lib.forward_all(bank, feats, ctx.task)[
                torch.arange(len(head), device=feats.device), head]
        return mesh_lib.share(F.cross_entropy(logits, y.long()),
                              sh.mean_scale)

    def extra_loss(self, ctx, trainable, feats, batch, mstate,
                   batch_stats=None, gen=None):
        t = ctx.task
        if t == 0 or self.n_append <= 0:
            return 0.0
        mem = mstate["memory"]
        base, rem = _exemplar_split(self.n_append, t)
        d = self.draw(ctx, mstate, gen, base, rem)
        losses = [self._ce(ctx, trainable, batch_stats,
                           mem["mem_images"][tt].index_select(0, idx),
                           mem["mem_labels"][tt].index_select(0, idx),
                           masks, tt)
                  for tt, (idx, masks) in enumerate(zip(d["idx"],
                                                        d["masks"]))]
        if rem:
            tasks, slots = d["rem_task"], d["rem_idx"]
            losses.append(self._ce(ctx, trainable, batch_stats,
                                   mem["mem_images"][tasks, slots],
                                   mem["mem_labels"][tasks, slots],
                                   d["masks"][-1], tasks))
        return torch.stack(losses).mean()


# ---------------------------------------------------------------------------
# iCaRL
# ---------------------------------------------------------------------------

def exemplars_on(ex: dict, device) -> dict:
    """An exemplar store (numpy from disk, or tensors) as fresh tensors on
    ``device``, its fill count as a host int."""
    return {"images": _on(ex["images"], device, torch.uint8),
            "targets": _on(ex["targets"], device, torch.float32),
            "labels": _on(ex["labels"], device, torch.int32),
            "task_ids": _on(ex["task_ids"], device, torch.int32),
            "count": int(ex["count"])}


def exemplars_to_host(ex: dict) -> dict:
    """The on-disk form: numpy copies, ``count`` a 0-d int32 array (the
    JAX package's)."""
    return {**{k: _host(ex[k])
               for k in ("images", "targets", "labels", "task_ids")},
            "count": np.array(int(ex["count"]), np.int32)}


class ICarlRule(UpdateRule):
    """CE on new data + lambda * distillation of sampled exemplars against
    stored pre-update outputs (ref:icarl.py:482-598), T=2."""

    T = 2.0
    aux_heavy = True  # uint8 exemplar store: attach once per attempt

    def __init__(self, n_append: int):
        self.n_append = int(n_append)

    def init_state(self, trainable, hyperparams, ctx, exemplars=None):
        state = super().init_state(trainable, hyperparams, ctx)
        assert exemplars is not None, "iCaRL needs the exemplar store"
        state["exemplars"] = exemplars_on(exemplars, ctx.device)
        return state

    def draw(self, ctx, mstate, gen) -> dict:
        """``idx`` (n_append,) store slots, drawn with replacement, and the
        (flip, dropout) ``masks`` of their forward."""
        n_valid = max(int(mstate["exemplars"]["count"]), 1)
        return {"idx": torch.randint(0, n_valid, (self.n_append,),
                                     generator=gen, device=ctx.device),
                "masks": replay_masks(ctx, self.n_append, gen)}

    def extra_loss(self, ctx, trainable, feats, batch, mstate,
                   batch_stats=None, gen=None):
        if ctx.task == 0 or self.n_append <= 0:
            return 0.0
        ex = mstate["exemplars"]
        d = self.draw(ctx, mstate, gen)
        # the global draw; this rank distills its shard of it
        sh = ctx.mesh.shard(self.n_append)
        idx = d["idx"][sh.lo:sh.hi]
        flip, drop = (mesh_lib.constrain_batch(m, ctx.mesh)
                      for m in d["masks"])
        x = ctx.preprocess(ex["images"].index_select(0, idx), flip)
        feats_m, _ = ctx.forward_feats(trainable["params"], batch_stats, x,
                                       True, drop)
        bank = ctx.bank(trainable)
        logits = heads_lib.shared_logits(bank, feats_m, ctx.n_tasks)
        # stored targets span the full task horizon; slice to active width
        targets = ex["targets"].index_select(0, idx)[:, :logits.shape[-1]]
        # mask each sample to its own task's class region
        tasks = ex["task_ids"].index_select(0, idx).long()
        kernel_c = bank["kernel"].shape[-1]
        col = torch.arange(logits.shape[-1], device=logits.device)[None, :]
        lo = (tasks * kernel_c)[:, None]
        counts = heads_lib.class_counts_on(ctx.class_counts,
                                           logits.device)[tasks][:, None]
        outside = (col < lo) | (col >= lo + counts)
        # KLDivLoss(reduction='batchmean') semantics, T=2
        # (ref:icarl.py:64 'batchmean', applied at :582)
        dist = icarl_distill(logits.masked_fill(outside, NEG_INF),
                             targets.masked_fill(outside, NEG_INF), self.T)
        dist = dist.clamp_min(0.0)  # numerical guard (ref:icarl.py:586)
        return mstate["hyper"]["lambda"] * mesh_lib.share(dist,
                                                          sh.mean_scale)

    def export_aux(self, mstate):
        return {"exemplars": exemplars_to_host(mstate["exemplars"])}

    def mstate_from_jax(self, tree):
        ex = tree["exemplars"]
        return {**tree, "exemplars": {**ex, "count": int(ex["count"])}}


# ---------------------------------------------------------------------------
# host lifecycle
# ---------------------------------------------------------------------------

def _warn_missing_aux(manager, what: str) -> None:
    """From task 2 on, the previous model is one this method trained
    itself, and its ``method_aux`` should hold the ``what`` it replays. A
    best model written mid-attempt by an aux_heavy rule carries none (in
    both packages), and the method would then start afresh and replay
    nothing of the earlier tasks: say so loudly, naming the file. Task 1's
    previous model (the shared base model or a fresh init) has none by
    design."""
    if manager.task_counter <= 1:
        return
    msg = (f"WARNING: {manager.previous_task_model_path} carries no "
           f"method_aux['{what}']; starting an empty {what}, so nothing of "
           f"tasks 1-{manager.task_counter - 1} is replayed")
    manager.log(msg)
    warnings.warn(msg, RuntimeWarning, stacklevel=3)


def _load_memory(manager, model: dict, fallback_fn) -> dict:
    aux = model.get("method_aux")
    if aux and "memory" in aux:
        return aux["memory"]
    _warn_missing_aux(manager, "memory")
    return fallback_fn()


def _task_engine(manager, slot: str, make_rule):
    """The method's engine for this task, built with ``make_rule()`` the
    first time; Phase-2 attempts and grid runs of one task reuse it."""
    engine = common.get_task_engine(manager, slot)
    if engine is None:
        engine = common.build_engine(manager, make_rule(),
                                     manager.task_counter)
    return engine


def _with_batch(args, batch_size: int, run):
    """``run()`` with ``args.batch_size`` temporarily set: the new-data
    part of a replay batch shrinks by the exemplar rows appended to it, so
    an epoch takes more steps."""
    saved = args.batch_size
    args.batch_size = batch_size
    try:
        return run()
    finally:
        args.batch_size = saved


def _n_append(batch_size: int, n_mem: int, train_size: int) -> int:
    """Exemplar rows per batch (ref:main_rehearsal.py:186-207)."""
    ratio = n_mem / (train_size + n_mem)
    return min(int(np.ceil(batch_size * ratio)), batch_size - 1)


@dataclass
class GEM(Method):
    name: str = "GEM"
    category: Category = Category.REHEARSAL_BASED
    wrap_first_task_model: bool = True
    extra_hyperparams_count: int = 1
    hyperparams: "OrderedDict[str, float]" = field(
        default_factory=lambda: OrderedDict({"margin": 1}))
    static_hyperparams: "OrderedDict[str, float]" = field(
        default_factory=lambda: OrderedDict({"mem_per_task": 1024}))

    def _mem(self):
        return int(self.static_hyperparams["mem_per_task"])

    def grid_train(self, args, manager, lr):
        """Phase 1: plain FT (memory_strength=0, finetune mode,
        ref:method.py:321-325)."""
        return finetune_grid_train(args, manager, lr)

    def train(self, args, manager, hyperparams):
        prev_model = io.load(manager.previous_task_model_path)
        engine = _task_engine(manager, "gem_engine", lambda: GEMRule(
            self._mem(), mem_batch=gem_chunk_rows(
                self._mem(), manager.model_spec.batch_norm)))
        rule = engine.ctx.update_rule
        memory = _load_memory(manager, prev_model, lambda: fresh_task_memory(
            manager.dataset.task_count, self._mem(),
            manager.dataset.input_size))
        mstate = rule.init_state(None, dict(hyperparams), engine.ctx,
                                 memory=memory)
        best_model, best_acc, _, engine = common.run_training(
            manager, rule, lr=manager.extras["lr"],
            hyperparams=dict(hyperparams),
            exp_dir=manager.extras["heuristic_exp_dir"],
            start_model=prev_model, seed=args.seed, mstate=mstate,
            engine=engine, reinit_head=False)
        common.set_task_engine(manager, "gem_engine", engine)
        return best_model, best_acc

    def poststep(self, args, manager):
        """Task 1 only: wrap the SI model + fill the buffer with task-1
        samples (ref:method.py:301-320)."""
        if manager.task_counter > 1:
            return
        save_path = manager.best_model_path(1)
        if io.exists(save_path):
            manager.extras["best_model_path"] = save_path
            return
        model = dict(io.load(manager.previous_task_model_path))
        memory = fresh_task_memory(manager.dataset.task_count, self._mem(),
                                   manager.dataset.input_size)
        td = manager.dataset.get_task_dataset(1)
        memory = fill_buffer_from_data(memory, 0, td.train.images,
                                       td.train.labels, seed=args.seed)
        model["method_aux"] = {"memory": memory_to_host(memory)}
        io.save(model, save_path)
        manager.extras["best_model_path"] = save_path
        manager.previous_task_model_path = save_path


@dataclass
class FinetuneRehearsalPartialMem(Method):
    name: str = "finetuning_rehearsal_partial_mem"
    category: Category = Category.BASELINE
    start_scratch: bool = True
    no_framework: bool = True
    static_hyperparams: "OrderedDict[str, float]" = field(
        default_factory=lambda: OrderedDict({"mem_per_task": 1024}))
    full_mem: bool = False

    def _make_rule(self, args, manager):
        mem = int(self.static_hyperparams["mem_per_task"])
        t = manager.task_counter - 1  # past tasks
        n_tasks_total = manager.dataset.task_count
        per_task_mem = None
        if self.full_mem:
            per_task_mem = mem * n_tasks_total // manager.task_counter
            n_mem_samples = mem * n_tasks_total
        else:
            n_mem_samples = mem * t
        n_append = _n_append(args.batch_size, n_mem_samples,
                             manager.current_task_dataset.train.size) \
            if t > 0 else 0
        return ReplayRule(mem, n_append, per_task_mem), n_append

    def grid_train(self, args, manager, lr):
        rule, n_append = self._make_rule(args, manager)
        # the framework always seeds previous_task_model_path before the
        # task loop (framework/main.py get_init_model_path)
        assert manager.previous_task_model_path, \
            "replay baseline needs a previous/init model path"
        prev_model = io.load(manager.previous_task_model_path)
        memory = _load_memory(manager, prev_model, lambda: fresh_task_memory(
            manager.dataset.task_count,
            int(self.static_hyperparams["mem_per_task"]),
            manager.dataset.input_size))
        # reference baselines reset the ring cursor at every task switch
        # (ref:baseline_rehearsal_partial_mem.py:150 "Reset counter!!");
        # a carried mid-ring cursor would make mem_count cover the
        # never-written prefix [0, cnt) — zero images labeled class 0
        memory = {**memory, "mem_cnt": 0}
        engine = _task_engine(manager, "replay_engine", lambda: rule)
        mstate = engine.ctx.update_rule.init_state(None, {}, engine.ctx,
                                                   memory=memory)
        best_model, best_acc, _, engine = _with_batch(
            args, max(args.batch_size - n_append, 1),
            lambda: common.run_training(
                manager, engine.ctx.update_rule, lr=lr, hyperparams={},
                exp_dir=manager.extras["gridsearch_exp_dir"],
                start_model=prev_model,
                seed=manager.extras.get("grid_seed", 0), mstate=mstate,
                engine=engine))
        common.set_task_engine(manager, "replay_engine", engine)
        return best_model, best_acc

    def grid_poststep(self, args, manager):
        lr_grid.grid_poststep_symlink(args, manager)


@dataclass
class FinetuneRehearsalFullMem(FinetuneRehearsalPartialMem):
    name: str = "finetuning_rehearsal_full_mem"
    full_mem: bool = True


@dataclass
class ICARL(Method):
    name: str = "ICARL"
    category: Category = Category.REHEARSAL_BASED
    wrap_first_task_model: bool = True
    extra_hyperparams_count: int = 1
    hyperparams: "OrderedDict[str, float]" = field(
        default_factory=lambda: OrderedDict({"lambda": 10}))
    static_hyperparams: "OrderedDict[str, float]" = field(
        default_factory=lambda: OrderedDict({"mem_per_task": 1024}))

    def _total_mem(self, manager):
        return (int(self.static_hyperparams["mem_per_task"])
                * manager.dataset.task_count)

    def _fresh_exemplars(self, manager, kernel_c) -> dict:
        K = self._total_mem(manager)
        h, w = manager.dataset.input_size
        n_out = kernel_c * manager.dataset.task_count
        return {
            "images": np.zeros((K, h, w, 3), np.uint8),
            "targets": np.full((K, n_out), NEG_INF, np.float32),
            "labels": np.zeros((K,), np.int32),     # shared class idx
            "task_ids": np.zeros((K,), np.int32),
            "count": np.int32(0),
        }

    def train(self, args, manager, hyperparams):
        prev_model = io.load(manager.previous_task_model_path)
        kernel_c = int(np.asarray(prev_model["heads"]["kernel"]).shape[-1])
        exemplars = (prev_model.get("method_aux") or {}).get("exemplars")
        if exemplars is None:
            _warn_missing_aux(manager, "exemplars")
            exemplars = self._fresh_exemplars(manager, kernel_c)
        # exemplar batch ratio like the baselines (ref:main_rehearsal.py)
        n_append = _n_append(args.batch_size, self._total_mem(manager),
                             manager.current_task_dataset.train.size)
        # engine reused across Phase-2 decay attempts (same shapes and
        # rule; only the hyper scalars in mstate change)
        engine = _task_engine(manager, "icarl_engine",
                              lambda: ICarlRule(n_append))
        rule = engine.ctx.update_rule
        mstate = rule.init_state(None, dict(hyperparams), engine.ctx,
                                 exemplars=exemplars)
        best_model, best_acc, _, engine = _with_batch(
            args, max(args.batch_size - n_append, 1),
            lambda: common.run_training(
                manager, rule, lr=manager.extras["lr"],
                hyperparams=dict(hyperparams),
                exp_dir=manager.extras["heuristic_exp_dir"],
                start_model=prev_model, seed=args.seed, mstate=mstate,
                engine=engine, reinit_head=False))
        common.set_task_engine(manager, "icarl_engine", engine)
        return best_model, best_acc

    def grid_train(self, args, manager, lr):
        return finetune_grid_train(args, manager, lr)

    # ---- herding poststep (every task, ref:method.py:352-379) -------------
    def poststep(self, args, manager):
        t = manager.task_counter
        if t == 1:
            save_path = manager.best_model_path(1)
            src_path = manager.previous_task_model_path
        else:
            save_path = manager.extras["best_model_path"].replace(
                "best_model.pth.tar", "best_model_postprocessed.pth.tar")
            src_path = manager.extras["best_model_path"]
        if not io.exists(save_path):
            model = dict(io.load(src_path))
            model["method_aux"] = {
                "exemplars": self._herd(args, manager, model)}
            io.save(model, save_path)
        manager.extras["best_model_path"] = save_path
        manager.previous_task_model_path = save_path

    def _feature_net(self, args, manager, model: dict, task: int):
        """(ctx, features of uint8 images, shared logits of uint8 images)
        under ``model`` in eval mode on the run's device. Both passes run
        in the run's batch size: eval-mode features do not depend on the
        batch, and the kernels then see the training's shapes."""
        ctx = make_context(
            spec=manager.model_spec, task=task - 1, n_tasks=task,
            class_counts=np.asarray(model["heads"]["class_counts"]),
            mean=manager.dataset.mean, std=manager.dataset.std,
            update_rule=UpdateRule(), device=args.device, augment=False)
        params = params_from_jax(model["params"], ctx.device)
        stats = batch_stats_from_jax(model.get("batch_stats"), ctx.device)
        bank = {k: torch.tensor(np.asarray(model["heads"][k], np.float32),
                                device=ctx.device) for k in ("kernel", "bias")}
        bank["class_counts"] = np.asarray(model["heads"]["class_counts"])
        bs = int(args.batch_size)

        def feats_of(images_u8: np.ndarray) -> torch.Tensor:
            images = torch.from_numpy(np.ascontiguousarray(images_u8)).to(
                ctx.device)
            with torch.no_grad():
                return torch.cat([
                    ctx.forward_feats(params, stats, pp.preprocess(
                        images[i:i + bs], ctx.mean, ctx.std), False)[0]
                    for i in range(0, len(images), bs)])

        def logits_of(images_u8: np.ndarray) -> np.ndarray:
            return heads_lib.shared_logits(bank, feats_of(images_u8),
                                           task).cpu().numpy()

        return ctx, feats_of, logits_of

    def _herd(self, args, manager, model) -> dict:
        """Rebuild the full exemplar store: truncate old classes to the new
        per-class budget (keep selection order), herd the new task's
        classes, store distillation targets (ref:icarl.py:314-480).
        Returns the numpy store."""
        t = manager.task_counter
        counts = manager.dataset.class_count_list()
        kernel_c = int(np.asarray(model["heads"]["kernel"]).shape[-1])
        per_class = max(self._total_mem(manager) // sum(counts[:t]), 1)
        _, feats_of, logits_of = self._feature_net(args, manager, model, t)

        # previous store, truncated per class (order = priority)
        old = (model.get("method_aux") or {}).get("exemplars")
        per_class_imgs: dict[int, np.ndarray] = {}
        per_class_targets: dict[int, np.ndarray] = {}
        if old is not None:
            n_old = int(old["count"])
            labels = np.asarray(old["labels"])[:n_old]
            imgs = np.asarray(old["images"])[:n_old]
            tgts = np.asarray(old["targets"])[:n_old]
            for c in np.unique(labels):
                sel = np.where(labels == c)[0][:per_class]
                per_class_imgs[int(c)] = imgs[sel]
                per_class_targets[int(c)] = tgts[sel]

        # herd the new task's classes
        td = manager.dataset.get_task_dataset(t)
        offset = (t - 1) * kernel_c
        for local_c in range(counts[t - 1]):
            sel = np.where(td.train.labels == local_c)[0]
            if len(sel) == 0:
                continue
            imgs_c = td.train.images[sel]
            feats = feats_of(imgs_c)
            order = herd_lib.herd(
                feats, torch.ones(len(sel), device=feats.device),
                min(per_class, len(sel))).cpu().numpy()
            chosen = imgs_c[order]
            # distillation targets: masked shared logits of the exemplars
            per_class_imgs[offset + local_c] = chosen
            per_class_targets[offset + local_c] = logits_of(chosen)

        # pack into the flat static store
        store = self._fresh_exemplars(manager, kernel_c)
        capacity, width = store["images"].shape[0], store["targets"].shape[1]
        pos = 0
        for c in sorted(per_class_imgs):
            # per_class is clamped to >= 1, so with more seen classes than
            # total capacity K the picks can exceed the store: trim
            if pos >= capacity:
                break
            n = min(per_class, len(per_class_imgs[c]), capacity - pos)
            tg = per_class_targets[c][:n, :width]
            store["images"][pos:pos + n] = per_class_imgs[c][:n]
            store["targets"][pos:pos + n, :tg.shape[1]] = tg  # padded
            store["labels"][pos:pos + n] = c
            store["task_ids"][pos:pos + n] = c // kernel_c
            pos += n
        store["count"] = np.int32(pos)
        return store

    # ---- NCM inference (ref:icarl.py:130-186) ------------------------------
    def inference_eval(self, manager, model_path, ref_task, trained_idx):
        """Nearest-class-mean over exemplar features, expressed as a linear
        head:  argmin_c ||f - mu_c||  ==  argmax_c (2 f.mu_c - ||mu_c||^2),
        so the NCM classifier is a synthesized (kernel=2mu, bias=-|mu|^2)
        task head on the standard eval path. The means are numpy float32
        means of the features, as in the JAX package; under a process
        group each rank computes them whole and takes rank 0's."""
        model = io.load(model_path) if isinstance(model_path, str) \
            else model_path
        ex = (model.get("method_aux") or {}).get("exemplars")
        n_cls = manager.dataset.class_count_list()[ref_task - 1]
        kernel_c = int(np.asarray(model["heads"]["kernel"]).shape[-1])
        offset = (ref_task - 1) * kernel_c
        labels = np.asarray(ex["labels"])[:int(ex["count"])]
        imgs = np.asarray(ex["images"])[:int(ex["count"])]
        _, feats_of, _ = self._feature_net(manager.args, manager, model,
                                           ref_task)
        feat_dim = int(np.asarray(model["heads"]["kernel"]).shape[1])
        means = np.zeros((kernel_c, feat_dim), np.float32)
        present = np.zeros((kernel_c,), bool)
        for local_c in range(n_cls):
            sel = np.where(labels == offset + local_c)[0]
            if len(sel) == 0:
                continue
            means[local_c] = feats_of(imgs[sel]).cpu().numpy().mean(0)
            present[local_c] = True
        # computed whole on every rank; rank 0's on all of them
        means = mesh_lib.replicated(torch.from_numpy(means)).numpy()

        kern = np.array(model["heads"]["kernel"], copy=True)
        bias = np.array(model["heads"]["bias"], copy=True)
        kern[ref_task - 1] = (2.0 * means).T
        bias[ref_task - 1] = np.where(
            present, -np.sum(means * means, axis=1), NEG_INF)
        ncm_model = {**model, "heads": {**model["heads"], "kernel": kern,
                                        "bias": bias}}
        return default_inference_eval(manager, ncm_model, ref_task)
