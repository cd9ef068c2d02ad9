"""Shared host-side plumbing between Method lifecycle hooks and the Engine.

Counterpart of ``clsurvey_tpu/methods/common.py``: the reference's
per-method ``main_*.py`` setup (load previous model, replace last
classifier layer, build optimizer, call the train loop — e.g.
ref:src/methods/Finetune/main_SGD.py:13-82), factored once."""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from clsurvey_torch.engine.train import (
    Engine, TrainJob, TrainState, make_context, train_task, tree_map,
    tree_zeros_like, trainable_from_host)
from clsurvey_torch.methods.base import UpdateRule
from clsurvey_torch.models import heads as heads_lib
from clsurvey_torch.models.convert import (
    batch_stats_from_jax, params_from_jax)
from clsurvey_torch.utils import io, rng as rng_lib


def load_model(path_or_dict) -> dict:
    if isinstance(path_or_dict, dict):
        return path_or_dict
    return io.load(path_or_dict)


def prepare_trainable(model: dict, task: int, device, head_gen=None,
                      reinit_head: bool = True,
                      convert=params_from_jax) -> dict:
    """Model dict -> trainable tensors on ``device`` (fresh copies, never
    aliasing the caller's arrays), with the current task's head freshly
    initialised (the reference's replace-last-classifier-layer,
    ref:src/methods/Finetune/main_SGD.py:50-70). ``convert`` maps the
    weights (HAT's and PathNet's layouts, ``models/convert.py``)."""
    trainable = trainable_from_host(model, device, requires_grad=False,
                                    convert=convert)
    if reinit_head:
        gen = head_gen if head_gen is not None else rng_lib.generator(0)
        trainable["heads"] = heads_lib.head_params(heads_lib.reinit_head(
            trainable["heads"], task, gen))
    for leaf in (*trainable["params"].values(),
                 *trainable["heads"].values()):
        leaf.requires_grad_()
    return trainable


def rebuild_head_bank(old_bank: dict, head_gen, n_tasks: int,
                      class_counts: np.ndarray) -> dict:
    """Rebuild the stacked head bank at a new width/task count, preserving
    every already-trained slot (the bank carries ALL tasks' heads, so a
    mid-sequence width change must never wipe the other tasks' trained
    heads). The current task's slot is freshly initialised by
    ``prepare_trainable`` afterwards regardless. Returns numpy arrays."""
    kern = np.asarray(old_bank["kernel"])
    old_bias = np.asarray(old_bank["bias"])
    needed_width = int(np.max(class_counts))
    bank = io.to_host(heads_lib.init_head_bank(
        head_gen, max(n_tasks, kern.shape[0]), kern.shape[1],
        needed_width, class_counts))
    w = min(kern.shape[-1], needed_width)
    nt = min(kern.shape[0], bank["kernel"].shape[0])
    bank["kernel"][:nt, :, :w] = kern[:nt, :, :w]
    bank["bias"][:nt, :w] = old_bias[:nt, :w]
    return bank


def build_engine(manager, update_rule: UpdateRule, task_counter: int,
                 augment: bool = True, freeze_backbone: bool = False,
                 class_counts=None, n_tasks: int | None = None,
                 l1_decay: bool = False) -> Engine:
    """EngineContext from framework state. ``task_counter`` is 1-based."""
    # global --no_augment gate (parity runs); method-level augment=False
    # (eval, Fisher sweeps) always wins
    augment = augment and getattr(manager.args, "augment", True)
    seq = manager.dataset
    counts = class_counts
    if counts is None:
        counts = np.zeros(manager.max_tasks, np.int32)
        for t in range(1, seq.task_count + 1):
            counts[t - 1] = seq.classes_per_task[seq.get_taskname(t)]
    ctx = make_context(
        spec=manager.model_spec,
        task=task_counter - 1,
        n_tasks=n_tasks if n_tasks is not None else task_counter,
        class_counts=counts,
        mean=seq.mean, std=seq.std,
        update_rule=update_rule,
        device=manager.args.device,
        augment=augment,
        weight_decay=manager.args.weight_decay,
        freeze_backbone=freeze_backbone,
        l1_decay=l1_decay,
    )
    return Engine(ctx)


def run_training(manager, update_rule: UpdateRule, lr: float,
                 hyperparams: dict, exp_dir: str, start_model,
                 num_epochs: int | None = None, seed: int = 7,
                 reinit_head: bool = True, task_data=None,
                 mstate: Any = None, freeze_backbone: bool = False,
                 class_counts=None, n_tasks: int | None = None,
                 engine: Engine | None = None, l1_decay: bool = False):
    """One full task training: the engine-driven equivalent of each
    reference method-main. ``mstate`` is a ready method state (else the
    rule builds one); ``engine`` is reused if given; ``num_epochs``
    overrides the run's, ``reinit_head=False`` keeps the start model's head
    for the current task and ``freeze_backbone`` trains the heads alone
    (LwF's head warm-up uses all three). Returns
    (best_model_dict, best_val_acc, final_state, engine)."""
    args = manager.args
    model = load_model(start_model)
    if engine is None:
        engine = build_engine(manager, update_rule, manager.task_counter,
                              freeze_backbone=freeze_backbone,
                              class_counts=class_counts, n_tasks=n_tasks,
                              l1_decay=l1_decay)
    ctx = engine.ctx
    head_gen = rng_lib.generator(seed, 17)
    # If the needed head width differs from the stored bank (e.g. Joint's
    # merged label space), rebuild the bank — the analog of the reference's
    # replace_last_classifier_layer with len(dset_classes) outputs
    # (ref:src/methods/Finetune/main_SGD.py:50-70).
    needed_width = int(np.max(ctx.class_counts))
    kern = np.asarray(model["heads"]["kernel"])
    if kern.shape[-1] != needed_width or kern.shape[0] < ctx.n_tasks:
        model = dict(model)
        model["heads"] = rebuild_head_bank(
            model["heads"], head_gen, ctx.n_tasks,
            np.asarray(ctx.class_counts))
    trainable = prepare_trainable(model, ctx.task, ctx.device, head_gen,
                                  reinit_head=reinit_head)
    if mstate is None:
        mstate = update_rule.init_state(trainable, hyperparams, ctx)
    batch_stats = batch_stats_from_jax(model.get("batch_stats"), ctx.device)
    state = TrainState(trainable, batch_stats, tree_zeros_like(trainable),
                       mstate)
    job = TrainJob(
        exp_dir=exp_dir,
        num_epochs=num_epochs if num_epochs is not None else args.num_epochs,
        batch_size=args.batch_size,
        lr=lr, seed=seed,
        saving_freq=args.saving_freq,
        save_models_mode=args.save_models_mode,
    )
    data = task_data if task_data is not None else \
        manager.current_task_dataset
    best_model, best_acc, final_state = train_task(
        engine, job, state, data, log=manager.log)
    return best_model, best_acc, final_state, engine


def current_task_head_grads(tree, task: int):
    """Zero every head-bank slot's gradient except the current task's
    (the shared 'only the current task's head trains' rule)."""
    def per_leaf(h):
        out = torch.zeros_like(h)
        out[task] = h[task]
        return out

    return tree_map(per_leaf, tree)


def get_task_engine(manager, slot: str):
    """Single engine slot per method, overwritten across tasks, so a
    finished task's engine (its backbone module) is not kept alive."""
    if manager.extras.get(slot + "_task") == manager.task_counter:
        return manager.extras.get(slot)
    return None


def set_task_engine(manager, slot: str, engine) -> None:
    manager.extras[slot] = engine
    manager.extras[slot + "_task"] = manager.task_counter
