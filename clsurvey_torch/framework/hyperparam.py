"""The Continual Hyperparameter Framework (Phase 1 + Phase 2).

Counterpart of ``clsurvey_tpu/framework/hyperparam.py``; behavioral port of
ref:src/framework/framework_train.py:14-292:

- Phase 1 ``maximalPlasticitySearch``: coarse finetuning LR grid.
- Phase 2 ``stabilityDecay``: train with the method's stability
  hyperparameters at the Phase-1 lr; if val acc falls below
  ``finetune_acc * (1 - drop_margin)``, decay the hyperparameters and retry,
  up to ``max_attempts_per_task`` (last attempt retained). The multi-
  hyperparameter decay alternates decaying each one individually (restoring
  the others) before decaying all together
  (ref:src/framework/framework_train.py:168-216).
- Checkpoint/resume of the decay state + SUCCESS tokens, in the
  reference's formats.
"""

from __future__ import annotations

import copy
import operator
import os
import shutil
import time

from clsurvey_torch.utils import io, paths as paths_lib
from clsurvey_torch.utils.paths import (
    BEST_MODEL_FILENAME, HYPERPARAMS_CKPT_FILENAME, TASK_TRAINING_DIRNAME)


class HyperparameterFramework:
    def __init__(self, method):
        self.method = method
        self.hyperparams = method.hyperparams  # shared dict object, like ref
        self.hyperparams_backup = copy.deepcopy(self.hyperparams)
        self.hyperparam_idx = 0
        self.attempts = 0

    # --- state (ref:framework_train.py:29-64) -------------------------------
    def _get_state(self):
        return {"hyperparams": dict(self.hyperparams),
                "hyperparams_backup": dict(self.hyperparams_backup),
                "hyperparam_idx": self.hyperparam_idx,
                "attempts": self.attempts}

    def _restore_state(self, state):
        for hkey in self.hyperparams.keys():
            self.hyperparams[hkey] = state["hyperparams"][hkey]
            self.hyperparams_backup[hkey] = state["hyperparams_backup"][hkey]
        self.hyperparam_idx = state["hyperparam_idx"]
        self.attempts = state["attempts"]

    def _save_chkpt(self, exp_dir, threshold, val_acc):
        # torch.save format: the reference's postprocessing reads this
        # file with torch.load (main_postprocessing.py:322-330)
        io.save_compat({"acc_threshold": threshold, "val_acc": val_acc,
                        "state": self._get_state()},
                       os.path.join(exp_dir, HYPERPARAMS_CKPT_FILENAME))

    def _load_chkpt(self, exp_dir) -> bool:
        path = os.path.join(exp_dir, HYPERPARAMS_CKPT_FILENAME)
        if not io.exists(path):
            return False
        try:
            self._restore_state(io.load(path)["state"])
            print(f"Restored framework chkpt: {path}")
            return True
        except Exception as e:  # corrupted/renamed keys -> start fresh
            print(f"CHECKPOINT LOAD FAILED ({e}); starting fresh")
            return False

    # --- Phase 1 -------------------------------------------------------------
    @staticmethod
    def maximalPlasticitySearch(args, manager):
        from clsurvey_torch.framework import lr_grid

        start = time.time()
        # ref:src/framework/framework_train.py:229-235: the flag forces
        # keeping every grid model; PackNet must keep its Phase-1 winner
        # (Phase 2 prunes that model — keep_none would delete it)
        if getattr(args, "save_models_FT_heuristic", False):
            save_mode = "all"
        elif manager.method is not None and manager.method.name == "packnet":
            save_mode = "only_keep_best"
        else:
            save_mode = args.grid_storage_policy
        ft_lr, ft_acc = lr_grid.lr_grid_single_task(
            args, manager, save_models_mode=save_mode)
        manager.extras["phase1_elapsed_time"] = time.time() - start
        return ft_lr, ft_acc

    # --- Phase 2 -------------------------------------------------------------
    def stabilityDecay(self, args, manager, finetune_lr, finetune_acc):
        manager.extras["lr"] = finetune_lr
        exp_dir = os.path.join(manager.task_dir(), TASK_TRAINING_DIRNAME)
        if os.path.islink(exp_dir):  # leftover Phase-1 symlink from baselines
            os.unlink(exp_dir)
        os.makedirs(exp_dir, exist_ok=True)
        manager.extras["heuristic_exp_dir"] = exp_dir

        if hasattr(self.method, "train_init"):
            self.method.train_init(args, manager)

        if not self._load_chkpt(exp_dir):
            self.attempts = 0
            self.hyperparams_backup = copy.deepcopy(self.hyperparams)

        if paths_lib.has_success(exp_dir):  # skip completed phase
            print("Already successful run. Skipping phase 2.")
            manager.extras["best_model_path"] = os.path.join(
                exp_dir, BEST_MODEL_FILENAME)
            return

        prestep_start = time.time()
        if hasattr(self.method, "prestep"):
            self.method.prestep(args, manager)
        manager.extras["presteps_elapsed_time"] = time.time() - prestep_start

        threshold = finetune_acc * (1 - args.drop_margin)
        max_attempts = args.max_attempts_per_task
        converged = False
        while not converged and self.attempts < max_attempts:
            print(f" => ATTEMPT {self.attempts}/{max_attempts - 1}: "
                  f"Hyperparams {dict(self.hyperparams)}")
            start = time.time()
            self.method.hyperparams = self.hyperparams
            model, val_acc = self.method.train(args, manager,
                                               self.hyperparams)
            if val_acc >= threshold:
                print(f"CONVERGED, acc={val_acc:.4f} >= "
                      f"threshold={threshold:.4f}")
                converged = True
                manager.extras["convergence_iteration_elapsed_time"] = (
                    time.time() - start)
            else:
                print(f"DECAY HYPERPARAMS, acc={val_acc:.4f} < "
                      f"threshold={threshold:.4f}")
                self.hyperparamDecay(args, manager)
                self.attempts += 1
                if self.attempts < max_attempts:
                    # remove failed attempt's artifacts, keep the dir
                    for fn in os.listdir(exp_dir):
                        if fn != HYPERPARAMS_CKPT_FILENAME:
                            path = os.path.join(exp_dir, fn)
                            (os.unlink if os.path.isfile(path)
                             else shutil.rmtree)(path)
                else:
                    # NOTE the retained model trained with the PRE-decay
                    # hyperparams, but the decayed values are what gets
                    # checkpointed and carried into the next task — this
                    # matches the reference exactly (decay runs before
                    # the retain branch and mutates the dict the method
                    # aliases, ref:framework_train.py:127-137)
                    print("RETAINING LAST ATTEMPT MODEL")
                    converged = True
            self._save_chkpt(exp_dir, threshold, val_acc)

        manager.extras["best_model_path"] = os.path.join(
            exp_dir, BEST_MODEL_FILENAME)
        paths_lib.set_success(exp_dir)

    # --- decay (ref:framework_train.py:168-216) ------------------------------
    def hyperparamDecay(self, args, manager):
        op = (self.method.decay_operator
              if hasattr(self.method, "decay_operator") else operator.mul)
        if len(self.hyperparams) == 1:
            hkey = next(iter(self.hyperparams))
            self.hyperparams[hkey] = op(self.hyperparams[hkey],
                                        args.decaying_factor)
        elif len(self.hyperparams) > 1:
            if self.hyperparam_idx == len(self.hyperparams):
                # decay all from backup; backup moves forward
                self.hyperparam_idx = 0
                for hkey, hval in self.hyperparams_backup.items():
                    self.hyperparams[hkey] = op(hval, args.decaying_factor)
                self.hyperparams_backup = copy.deepcopy(self.hyperparams)
            else:
                hlist = list(self.hyperparams.keys())
                hkey = hlist[self.hyperparam_idx]
                self.hyperparams[hkey] = op(
                    self.hyperparams_backup[hkey], args.decaying_factor)
                for other in hlist:
                    if other != hkey:
                        self.hyperparams[other] = self.hyperparams_backup[
                            other]
                self.hyperparam_idx += 1


PHASE_TIMING_FILENAME = "phase_timing.pth.tar"


def report_phase_timing(phase_times: dict, task_dir: str | None):
    """Print + pickle per-task phase wall-clock (ref:src/framework/
    framework_train.py:286-292). ``task_dir=None`` prints only."""
    for name, secs in phase_times.items():
        print(f"{name} elapsed_time = {secs:.2f}s")
    if phase_times and task_dir is not None:
        io.save(phase_times, os.path.join(task_dir, PHASE_TIMING_FILENAME))


def framework_single_task(args, manager):
    """Per-task dispatch (ref:src/framework/framework_train.py:219-292)."""
    method = manager.method
    if (manager.task_counter == 1 and not method.start_scratch
            and not method.wrap_first_task_model):
        print("USING SI AS MODEL FOR FIRST TASK:",
              manager.previous_task_model_path)
        return

    skip_to_post = method.wrap_first_task_model and manager.task_counter == 1
    hf = HyperparameterFramework(method)

    if not skip_to_post:
        print(f"\nPHASE 1 (TASK {manager.task_counter})")
        ft_lr, ft_acc = hf.maximalPlasticitySearch(args, manager)
        print(f"\nPHASE 2 (TASK {manager.task_counter}) — FT LR {ft_lr}")
        hf.stabilityDecay(args, manager, ft_lr, ft_acc)

    post_start = time.time()
    if hasattr(method, "poststep"):
        method.poststep(args, manager)
    manager.extras["postprocess_elapsed_time"] = time.time() - post_start

    # per-task phase timing report + pickle, ref:src/framework/
    # framework_train.py:237-240,286-292 (printed via utils.print_timing)
    phase_times = {
        k: manager.extras.pop(f"{k}_elapsed_time")
        for k in ("phase1", "presteps", "convergence_iteration",
                  "postprocess")
        if manager.extras.get(f"{k}_elapsed_time") is not None
    }
    report_phase_timing(phase_times,
                        None if skip_to_post else manager.task_dir())

    if hasattr(method, "init_next_task"):
        method.init_next_task(manager)
    else:
        manager.previous_task_model_path = manager.extras.get(
            "best_model_path", manager.previous_task_model_path)
