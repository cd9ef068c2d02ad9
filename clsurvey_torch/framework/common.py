"""Framework state holders: RunArgs (the CLI flag surface,
ref:src/framework/main.py:17-74) and Manager (the per-run holder object,
ref:src/framework/main.py:181-221). Counterpart of
``clsurvey_tpu/framework/common.py``, plus ``device``."""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Any

from clsurvey_torch.data.registry import TaskData, TaskSequence
from clsurvey_torch.models.registry import ModelSpec
from clsurvey_torch.utils import paths as paths_lib


@dataclass
class RunArgs:
    """Argparse-equivalent knobs (defaults = Tiny-ImageNet protocol,
    ref:src/main_tinyimagenet.sh:16-25, ref:src/framework/main.py:52-67)."""

    model_name: str = "small_VGG9_cl_128_128"
    ds_name: str = "tiny"
    method_name: str = "finetuning"  # = the CLI default
    num_epochs: int = 70
    batch_size: int = 200
    lr_grid: tuple = (1e-2, 5e-3, 1e-3, 5e-4, 1e-4)
    boot_lr_grid: tuple | None = None   # first-task grid (1e-1..1e-4)
    weight_decay: float = 0.0
    drop_margin: float = 0.2
    decaying_factor: float = 0.5
    max_attempts_per_task: int = 10
    finetune_iterations: int = 1
    seed: int = 7
    starting_task_count: int = 1
    max_task_count: int | None = None
    saving_freq: int = 5
    save_models_mode: bool = True
    gridsearch_name: str = "demo"
    exp_name: str | None = None
    runmode: str = "default"  # default | first_task_basemodel_dump | debug
    test: bool = False
    test_overwrite_mode: bool = False
    # eval range/split control (ref:src/framework/main.py:71-74)
    test_set: str = "test"  # test | val | train
    test_starting_task_count: int = 1
    test_max_task_count: int | None = None
    # method hyperparams as the reference's string DSL
    hyperparams: str | None = None
    static_hyperparams: str | None = None
    # storage policy for the LR grid (ref:src/framework/lr_grid_train.py)
    grid_storage_policy: str = "only_keep_best"
    # force policy 'all' for the framework's Phase-1 FT grid
    # (ref:src/framework/main.py:39-40)
    save_models_FT_heuristic: bool = False
    # train-time p=0.5 horizontal flip. Default ON (a recorded deviation:
    # the reference's framework path trains on the NON-flip dataset
    # variant — set_dataset(rnd_transform=False), ref:src/framework/
    # main.py:163,197 — reserving the flip pickle for Joint,
    # ref:src/methods/method.py:1204). --no_augment gives exact parity.
    augment: bool = True
    debug: bool = False
    # torch.profiler trace of the first task (framework/main.py)
    profile: bool = False
    # remove the experiment tree before training (ref:src/framework/
    # main.py:142-147 --cleanup_exp; refused when evaluating)
    cleanup_exp: bool = False
    # where the entry points run: "cuda" (the default; raises without a
    # card) or "cpu"
    device: str = "cuda"

    def apply_runmode(self):
        """debug collapses the protocol (ref:src/framework/main.py:269-277);
        timing_mode fixes the measurement protocol: 4 tasks, single
        lr=5e-3, bs=200, 10 epochs, no model saves
        (ref:src/framework/main.py:289-300)."""
        if self.runmode == "debug" or self.debug:
            self.num_epochs = 2
            self.lr_grid = (self.lr_grid[0],)
            if self.boot_lr_grid:  # task 1 uses the boot grid — collapse
                self.boot_lr_grid = (self.boot_lr_grid[0],)
            self.finetune_iterations = 1
        elif self.runmode == "timing_mode":
            self.max_task_count = 4
            self.lr_grid = (5e-3,)
            self.boot_lr_grid = (5e-3,)
            self.batch_size = 200
            self.num_epochs = 10
            self.finetune_iterations = 1
            # minimal IO: best models still written (tasks chain through
            # disk) but epoch checkpoints are disabled
            self.saving_freq = 10 ** 9


@dataclass
class Manager:
    """Holder threaded through every hook (ref:src/framework/main.py:181-221).
    """

    args: RunArgs
    dataset: TaskSequence
    method: Any
    model_spec: ModelSpec
    previous_task_model_path: str | None = None
    task_counter: int = 1
    gridsearch_name: str = "demo"
    exp_name: str = "default"
    current_task_dataset: TaskData | None = None
    # per-method scratch the hooks may stash things in (like the reference's
    # loosely-typed manager attributes)
    extras: dict = field(default_factory=dict)

    @property
    def max_tasks(self) -> int:
        limit = self.args.max_task_count or self.dataset.task_count
        return max(limit, self.dataset.task_count)

    def log(self, *msg) -> None:
        print(f"[task {self.task_counter}]", *msg)

    # --- path scheme --------------------------------------------------------
    def task_dir(self, task_counter: int | None = None,
                 method_name: str | None = None,
                 create: bool = True) -> str:
        return paths_lib.get_train_results_path(
            self.dataset.name,
            method_name or self.method.name,
            self.model_spec.name,
            self.gridsearch_name,
            self.exp_name,
            task_counter=task_counter or self.task_counter,
            create=create,
        )

    def task_training_dir(self, task_counter: int | None = None,
                          create: bool = True) -> str:
        return paths_lib.get_task_training_dir(
            self.task_dir(task_counter, create=create), create=create)

    def best_model_path(self, task_counter: int | None = None,
                        create: bool = True) -> str:
        """``create=False`` for existence probes — a query must not
        litter empty task_N/TASK_TRAINING trees for untrained tasks."""
        return os.path.join(
            self.task_training_dir(task_counter, create=create),
            paths_lib.BEST_MODEL_FILENAME)

    def set_dataset(self, task_counter: int) -> None:
        """ref:src/framework/main.py:197-202."""
        self.task_counter = task_counter
        self.current_task_dataset = self.dataset.get_task_dataset(
            task_counter)
