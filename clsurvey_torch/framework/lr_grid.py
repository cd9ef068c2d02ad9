"""Phase 1 — maximal-plasticity LR grid search.

Behavior of ref:src/framework/lr_grid_train.py:9-176: for each lr in the grid
x ``finetune_iterations``: reseed per iteration, call ``method.grid_train``,
track the best iteration-average accuracy, checkpoint processed lrs for
resume, apply the storage policy (all / only_keep_best / keep_none), then
``method.grid_poststep`` links TASK_TRAINING to the winning run.
Counterpart of ``clsurvey_tpu/framework/lr_grid.py``. Under a process
group the writer alone appends to the log file and removes or links
directories, and every rank waits for it (``parallel/mesh.py``)."""

from __future__ import annotations

import os
import shutil
import time

from clsurvey_torch.parallel import mesh as mesh_lib
from clsurvey_torch.utils import io, paths as paths_lib, rng as rng_lib
from clsurvey_torch.utils.paths import (
    GRID_CKPT_FILENAME, LR_GRID_DIRNAME, TASK_TRAINING_DIRNAME,
    BEST_MODEL_FILENAME)


class StoragePolicy:
    """ref:src/framework/lr_grid_train.py:162-176."""

    def __init__(self, save_models_mode: str):
        if save_models_mode not in ("all", "keep_none", "only_keep_best"):
            raise ValueError(f"Invalid save_models_mode {save_models_mode}")
        self.keep_none = save_models_mode == "keep_none"
        self.only_keep_best = save_models_mode == "only_keep_best"


def lr_grid_single_task(args, manager, save_models_mode: str = "keep_none"):
    """Returns (best_lr, best_acc)."""
    store_policy = StoragePolicy(save_models_mode)
    task_dir = manager.task_dir()
    ft_parent_dir = os.path.join(task_dir, LR_GRID_DIRNAME)
    os.makedirs(ft_parent_dir, exist_ok=True)
    manager.extras["ft_parent_exp_dir"] = ft_parent_dir

    # logfile (ref:lr_grid_train.py:23-27)
    log_dir = os.path.join(ft_parent_dir, "log")
    os.makedirs(log_dir, exist_ok=True)
    logfile = os.path.join(log_dir, "finetune_grid.log")

    def log_line(msg):
        if not mesh_lib.is_writer():
            return
        print(msg)
        with open(logfile, "a") as f:
            f.write(msg + "\n")

    def remove(dirs):
        def rmtree_all():
            for d in dirs:
                shutil.rmtree(d, ignore_errors=True)

        mesh_lib.writer_does(rmtree_all)

    # resume (ref:lr_grid_train.py:30-37)
    processed = {}
    ckpt_file = os.path.join(ft_parent_dir, GRID_CKPT_FILENAME)
    if io.exists(ckpt_file):
        processed = io.load(ckpt_file)["processed_lrs"]
        log_line(f"STARTING FROM CHECKPOINT: {processed}")

    if hasattr(manager.method, "grid_prestep"):
        manager.method.grid_prestep(args, manager)

    lrs = (args.boot_lr_grid if (manager.task_counter == 1
                                 and args.boot_lr_grid) else args.lr_grid)

    # -1 so the first candidate wins even at 0.0 accuracy — a degenerate
    # grid must still select an lr (the reference's >0.0 tracking leaves
    # best_lr None there and crashes in Phase 2, framework_train.py:76)
    best_acc, best_lr = -1.0, None
    best_dir = None
    best_batch_dirs: list[str] = []
    # the 1-sig-digit dirnames (reference format) collide for lrs closer
    # than their rounding — fail loudly instead of silently sharing a dir
    names = [paths_lib.lr_dirname(lr) for lr in lrs]
    assert len(set(names)) == len(names), \
        f"lr grid values collide in the reference's lr=X.Xe-YY dir " \
        f"naming: {sorted(zip(names, lrs))}"
    for lr in lrs:
        accum_acc = 0.0
        best_it_acc, best_it_dir = -1.0, None
        iteration_dirs = []
        if lr not in processed:
            processed[lr] = {"acc": []}
        for it in range(args.finetune_iterations):
            dirname = paths_lib.lr_dirname(lr)
            if args.finetune_iterations > 1:
                dirname += f"_it{it}"
            grid_exp_dir = os.path.join(ft_parent_dir, dirname)
            iteration_dirs.append(grid_exp_dir)
            manager.extras["gridsearch_exp_dir"] = grid_exp_dir

            if it < len(processed[lr]["acc"]):
                acc = processed[lr]["acc"][it]
                rng_lib.set_random(it)
                log_line(f"RESTORED lr={lr:g} it={it} acc={acc:.4f}")
            else:
                rng_lib.set_random(it)  # per-iteration seed
                os.makedirs(grid_exp_dir, exist_ok=True)
                start = time.time()
                manager.extras["grid_seed"] = it
                _, acc = manager.method.grid_train(args, manager, lr)
                processed[lr]["acc"].append(acc)
                log_line(f"LR = {lr:g}, FT Iteration {it + 1}/"
                         f"{args.finetune_iterations}, Acc = {acc:.4f} "
                         f"({time.time() - start:.1f}s)")
                io.save({"processed_lrs": processed}, ckpt_file)

            if acc > best_it_acc:
                best_it_acc, best_it_dir = acc, grid_exp_dir
            accum_acc += acc

        avg_acc = accum_acc / args.finetune_iterations
        if avg_acc > best_acc:
            best_lr, best_acc = lr, avg_acc
            if store_policy.only_keep_best:
                remove(best_batch_dirs)
            best_batch_dirs = iteration_dirs
            best_dir = best_it_dir
            log_line(f"UPDATE best lr = {best_lr:g} acc = {best_acc:.4f}")
        elif store_policy.only_keep_best:
            remove(iteration_dirs)
        if store_policy.keep_none:
            remove(iteration_dirs)

    manager.extras["best_exp_grid_node_dirname"] = best_dir
    log_line(f"FINETUNE DONE: best_lr={best_lr}, best_acc={best_acc:.4f}")
    if best_lr is None:  # unreachable safety net: never hand Phase 2 None
        raise RuntimeError(
            f"LR grid selected no lr for task {manager.task_counter}")

    if hasattr(manager.method, "grid_poststep"):
        manager.method.grid_poststep(args, manager)

    return best_lr, best_acc


def grid_poststep_symlink(args, manager):
    """TASK_TRAINING -> best grid dir (ref:src/methods/method.py:1033-1040)."""
    exp_dir = os.path.join(manager.task_dir(), TASK_TRAINING_DIRNAME)
    best = manager.extras.get("best_exp_grid_node_dirname")
    if best is None:
        return

    def link():
        if os.path.islink(exp_dir):
            os.unlink(exp_dir)
        elif os.path.isdir(exp_dir):
            shutil.rmtree(exp_dir)
        os.symlink(os.path.join(LR_GRID_DIRNAME, os.path.basename(best)),
                   exp_dir)

    mesh_lib.writer_does(link)
    manager.previous_task_model_path = os.path.join(
        best, BEST_MODEL_FILENAME)
