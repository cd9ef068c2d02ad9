"""Finetune + Joint baselines (ref:src/methods/method.py:994-1087,1185-1235).

Counterpart of ``clsurvey_tpu/methods/finetune.py``."""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from clsurvey_torch.data.registry import merge_tasks
from clsurvey_torch.framework import lr_grid
from clsurvey_torch.methods.base import Category, Method, UpdateRule
from clsurvey_torch.methods import common


def finetune_grid_train(args, manager, lr):
    """Shared Phase-1 trainer: plain finetuning from the previous task model
    (ref:src/methods/method.py:1007-1025 + Finetune/main_SGD.py)."""
    best_model, best_acc, _, _ = common.run_training(
        manager, UpdateRule(), lr=lr, hyperparams={},
        exp_dir=manager.extras["gridsearch_exp_dir"],
        start_model=manager.previous_task_model_path,
        seed=manager.extras.get("grid_seed", 0))
    return best_model, best_acc


@dataclass
class Finetune(Method):
    """Plain per-task finetuning (ref:src/methods/method.py:994-1087).

    Phase-1 only: the reference's Finetune defines no Phase-2 ``train`` hook —
    its grid_poststep links TASK_TRAINING to the winning lr run and carries
    that model to the next task."""

    name: str = "finetuning"
    category: Category = Category.BASELINE
    start_scratch: bool = True
    no_framework: bool = True

    def grid_train(self, args, manager, lr):
        return finetune_grid_train(args, manager, lr)

    def grid_poststep(self, args, manager):
        lr_grid.grid_poststep_symlink(args, manager)
        print("SINGLE_MODEL MODE: previous model =",
              manager.previous_task_model_path)


@dataclass
class Joint(Method):
    """Joint training over all tasks seen so far, single run
    (ref:src/methods/method.py:1185-1235): ``train_args_overwrite`` collapses
    the sequence to 1 task and ``grid_datafetch`` merges every task's data
    with dynamic label offsets; eval masks the shared output per task."""

    name: str = "joint"
    category: Category = Category.BASELINE
    start_scratch: bool = True
    no_framework: bool = True

    def train_args_overwrite(self, args):
        args.max_task_count = 1  # ref:method.py:1227-1231
        args.starting_task_count = 1

    def grid_datafetch(self, args, dataset):
        max_task = dataset.task_count
        return merge_tasks(dataset, range(1, max_task + 1))

    def grid_train(self, args, manager, lr):
        merged = self.grid_datafetch(args, manager.dataset)
        # single head over all classes: use a 1-task context whose head is
        # wide enough for the merged label space
        n_classes = int(merged.train.labels.max()) + 1
        manager.extras["joint_n_classes"] = n_classes
        counts = np.zeros(manager.max_tasks, np.int32)
        counts[0] = n_classes
        exp_dir = manager.extras["gridsearch_exp_dir"]
        seed = manager.extras.get("grid_seed", 0)
        best_model, best_acc, _, _ = common.run_training(
            manager, UpdateRule(), lr=lr, hyperparams={},
            exp_dir=exp_dir, start_model=manager.previous_task_model_path,
            seed=seed, task_data=merged, class_counts=counts, n_tasks=1)
        return best_model, best_acc

    def grid_poststep(self, args, manager):
        lr_grid.grid_poststep_symlink(args, manager)
