"""Experiment path scheme, drop-in compatible with the reference.

Reference layout (ref:src/utilities/utils.py:130-232):

- train: ``<tr_root>/<ds>/<method>/<model>/gridsearch/<grid_name>/<exp_name>/
  task_<N>/{FT_LR_GRIDSEARCH/lr=<lr>/, TASK_TRAINING/}``
- test:  ``<test_root>/results/<ds>/<eval_name>/<model>/<grid_name>/<exp_name>``
- the per-experiment name is auto-built from the (init) hyperparameter dict.
"""

from __future__ import annotations

import os
from collections import OrderedDict

from clsurvey_torch.parallel import mesh as mesh_lib
from clsurvey_torch.utils import io
from clsurvey_torch.utils.config import load_config

TASK_TRAINING_DIRNAME = "TASK_TRAINING"
LR_GRID_DIRNAME = "FT_LR_GRIDSEARCH"
SUCCESS_FLAG = "SUCCESS.FLAG"
BEST_MODEL_FILENAME = "best_model.pth.tar"
# iCaRL/GEM write an aux-carrying twin next to the best model
# (ref:src/framework/main.py uses best_model.pth.tar; our rehearsal
# poststeps append the exemplar/memory aux under this name)
BEST_MODEL_POSTPROCESSED_FILENAME = "best_model_postprocessed.pth.tar"
EPOCH_CKPT_FILENAME = "epoch.pth.tar"
GRID_CKPT_FILENAME = "grid_checkpoint.pth"
HYPERPARAMS_CKPT_FILENAME = "hyperparams.pth.tar"


def get_exp_name(hyperparams: "OrderedDict[str, object]", extra: str = "") -> str:
    """Auto-build an experiment dirname from hyperparams.

    Mirrors the reference's convention of joining ``key=value`` pairs
    (ref:src/utilities/utils.py:130-146)."""
    parts = []
    for key, value in hyperparams.items():
        if isinstance(value, float):
            value = f"{value:g}"
        parts.append(f"{key}={value}")
    if extra:
        parts.append(extra)
    return "_".join(parts) if parts else "default"


def get_train_results_path(
    ds_name: str,
    method_name: str,
    model_name: str,
    grid_name: str,
    exp_name: str,
    task_counter: int | None = None,
    subdir: str | None = None,
    create: bool = True,
) -> str:
    """ref:src/utilities/utils.py:166-199 path shape."""
    cfg = load_config()
    path = os.path.join(
        cfg.tr_results_root_path, ds_name, method_name, model_name,
        "gridsearch", grid_name, exp_name,
    )
    if task_counter is not None:
        path = os.path.join(path, f"task_{task_counter}")
    if subdir is not None:
        path = os.path.join(path, subdir)
    if create:
        os.makedirs(path, exist_ok=True)
    return path


def lr_dirname(lr: float) -> str:
    """The grid's per-lr directory name — 1-significant-digit scientific,
    the reference's float_to_scientific_str(lr) format
    (ref:src/framework/lr_grid_train.py:65, utils.py:357-367)."""
    return f"lr={lr:.1e}"


def get_task_training_dir(task_dir: str, create: bool = True) -> str:
    path = os.path.join(task_dir, TASK_TRAINING_DIRNAME)
    if create:
        os.makedirs(path, exist_ok=True)
    return path


def get_test_results_path(
    ds_name: str,
    eval_name: str,
    model_name: str,
    grid_name: str,
    exp_name: str,
    create: bool = True,
    subset: str = "test",
) -> str:
    """ref:src/utilities/utils.py:166-183 path shape; evaluating a
    non-test split suffixes the experiment dir (ref:utils.py:178-179)."""
    cfg = load_config()
    if subset != "test":
        exp_name = f"{exp_name}_{subset}"
    path = os.path.join(
        cfg.test_results_root_path, "results", ds_name, eval_name, model_name,
        grid_name, exp_name,
    )
    if create:
        os.makedirs(path, exist_ok=True)
    return path


def get_starting_model_path(
    ds_name: str, model_name: str, init_model_name: str,
    basemethod_name: str = "SI",
    grid_name: str = "first_task_basemodel",
) -> str:
    """Shared first-task base model path (ref:src/utilities/utils.py:146-163).

    All regularisation/replay methods start their task-2+ sequence from the SI
    first-task model trained once via ``--runmode first_task_basemodel_dump``."""
    task_dir = get_train_results_path(
        ds_name, basemethod_name, model_name, grid_name, init_model_name,
        task_counter=1, create=False,
    )
    return os.path.join(task_dir, TASK_TRAINING_DIRNAME, BEST_MODEL_FILENAME)


def success_flag_path(dirname: str) -> str:
    return os.path.join(dirname, SUCCESS_FLAG)


def set_success(dirname: str) -> None:
    """Collective under a process group: the writer writes the flag."""
    def write():
        os.makedirs(dirname, exist_ok=True)
        with open(success_flag_path(dirname), "w") as f:
            f.write("done\n")

    mesh_lib.writer_does(write)


def has_success(dirname: str) -> bool:
    return io.exists(success_flag_path(dirname))
