"""IMM — Incremental Moment Matching, mean and mode variants
(ref:src/methods/method.py:760-819, ref:src/methods/IMM/).

Counterpart of ``clsurvey_tpu/methods/imm.py``. Training is per-task
L2-transfer: the quadratic penalty with omega == 1 anchored at the previous
task's params (ref:src/methods/IMM/train_L2transfer.py:20-100). IMM is a
``no_framework`` outlier: the LR grid runs the *regularized* training
directly (Phase 1 only).

Merging happens at eval time (``eval_model_preprocessing``):
- mean-IMM: equal-weight parameter average of models 1..k, heads excluded
  (ref:src/methods/IMM/merge.py:188-242);
- mode-IMM: weights F_t / sum(F) from per-task diagonal Fishers with labels
  sampled from the softmax over train+val (ref:src/methods/IMM/merge.py:
  57-120,155-185), cached to disk like the reference.

The merges run on the host over the models' numpy trees, in float64 with a
float32 result, in the JAX package's order of additions, so both packages
merge the same files to the same bits; the Fisher runs on the run's device
(``ops/importance.py``). Files on disk are in the JAX package's layout."""

from __future__ import annotations

import os
import time
from collections import OrderedDict
from dataclasses import dataclass, field

import numpy as np
import torch

from clsurvey_torch.engine.train import make_context, tree_map
from clsurvey_torch.framework import lr_grid
from clsurvey_torch.methods import common
from clsurvey_torch.methods.base import Category, Method, UpdateRule
from clsurvey_torch.methods.reg_based import QuadRegRule, tree_copy
from clsurvey_torch.models.convert import (
    batch_stats_from_jax, params_from_jax, params_to_jax)
from clsurvey_torch.ops import importance as imp_lib
from clsurvey_torch.parallel import mesh as mesh_lib
from clsurvey_torch.utils import device as device_lib
from clsurvey_torch.utils import io, rng as rng_lib, timing

MODES = ("mean", "mode")
PRECISION_FILENAME = "precision_mode_IMM.pth.tar"


@dataclass
class IMM(Method):
    name: str = "IMM"
    mode: str = "mean"
    category: Category = Category.MODEL_BASED
    no_framework: bool = True
    hyperparams: "OrderedDict[str, float]" = field(
        default_factory=lambda: OrderedDict({"lambda": 0.01}))

    def __post_init__(self):
        assert self.mode in MODES, self.mode
        self.eval_name = f"{self.mode}_IMM"
        super().__post_init__()

    def make_update_rule(self) -> UpdateRule:
        return QuadRegRule()

    def grid_train(self, args, manager, lr):
        """L2-transfer training inside the grid (no Phase 2)."""
        prev_model = io.load(manager.previous_task_model_path)
        rule = self.make_update_rule()
        prev_params = params_from_jax(prev_model["params"],
                                      device_lib.resolve(args.device))
        mstate = rule.init_state(
            {"params": prev_params, "heads": None}, dict(self.hyperparams),
            None, omega=tree_map(torch.ones_like, prev_params),
            theta_star=tree_copy(prev_params))
        best_model, best_acc, _, _ = common.run_training(
            manager, rule, lr=lr, hyperparams=dict(self.hyperparams),
            exp_dir=manager.extras["gridsearch_exp_dir"],
            start_model=prev_model,
            seed=manager.extras.get("grid_seed", 0), mstate=mstate)
        return best_model, best_acc

    def grid_poststep(self, args, manager):
        lr_grid.grid_poststep_symlink(args, manager)

    # ---- eval-time merging --------------------------------------------------
    def eval_model_preprocessing(self, args, manager, model_paths):
        """Create + save merged models for every prefix 1..k; returns their
        paths (first model passes through unmerged)."""
        t0 = time.perf_counter()
        models = [io.load(p) if isinstance(p, str) else p
                  for p in model_paths]
        merged_paths = [model_paths[0]]
        merge_name = f"best_model_{self.mode}_IMM_merge.pth.tar"

        # a merge of prefix 1..k depends on ALL k models: a cached file is
        # only valid if no prefix model changed since it was written (the
        # reference sidesteps this by always overwriting, merge.py
        # overwrite=True)
        def prefix_mtime(k):
            return max((os.path.getmtime(p) for p in model_paths[:k]
                        if isinstance(p, str) and os.path.exists(p)),
                       default=0.0)

        did_work = False
        precisions = None
        if self.mode == "mode":
            precisions = self._precisions(args, manager, model_paths, models)

        for k in range(2, len(models) + 1):
            out_path = os.path.join(
                os.path.dirname(model_paths[k - 1]), merge_name)
            # the writer's look at the files, on every rank
            redo = mesh_lib.agree(mesh_lib.is_writer() and (
                not os.path.isfile(out_path)
                or os.path.getmtime(out_path) < prefix_mtime(k)
                or args.test_overwrite_mode))
            if redo:
                if self.mode == "mean":
                    merged = merge_mean(models[:k])
                else:
                    merged = merge_mode(models[:k], precisions[:k])
                io.save(merged, out_path)
                did_work = True
            merged_paths.append(out_path)
        # merge/Fisher preprocessing time per exp
        # (ref:src/utilities/utils.py:100-105); only when work actually
        # happened — a fully-cached re-eval must not overwrite the real
        # measurement with ~0s
        if len(models) > 1 and did_work:
            timing.save_preprocessing_time(
                os.path.dirname(model_paths[-1]),
                time.perf_counter() - t0)
        return merged_paths

    def _precisions(self, args, manager, model_paths, models):
        """Per-task Fisher precision matrices, cached to disk next to each
        model (ref:src/methods/IMM/merge.py:57-120)."""
        precisions = []
        for t, (path, model) in enumerate(zip(model_paths, models), start=1):
            cache = None
            if isinstance(path, str):
                cache = os.path.join(os.path.dirname(path),
                                     PRECISION_FILENAME)
                fresh = mesh_lib.agree(mesh_lib.is_writer() and (
                    os.path.isfile(cache)
                    and (not os.path.exists(path)
                         or os.path.getmtime(cache)
                         >= os.path.getmtime(path))))
                if fresh and not args.test_overwrite_mode:
                    precisions.append(io.load(cache))
                    continue
            td = manager.dataset.get_task_dataset(t)
            ctx = make_context(
                spec=manager.model_spec, task=t - 1, n_tasks=t,
                class_counts=np.asarray(model["heads"]["class_counts"]),
                mean=manager.dataset.mean, std=manager.dataset.std,
                update_rule=UpdateRule(), device=args.device, augment=False)
            prec = params_to_jax(imp_lib.imm_mode_fisher(
                ctx, params_from_jax(model["params"], ctx.device),
                batch_stats_from_jax(model.get("batch_stats"), ctx.device),
                model["heads"], t - 1, [td.train.images, td.val.images],
                args.batch_size,
                generator=rng_lib.generator(args.seed + t,
                                            device=ctx.device)))
            if cache is not None:
                io.save(prec, cache)
            precisions.append(prec)
        return precisions


def _f64(x) -> np.ndarray:
    return np.asarray(x, dtype=np.float64)


def _f32(x) -> np.ndarray:
    return np.asarray(x, dtype=np.float32)


def merge_mean(models: list) -> dict:
    """Equal-alpha backbone average; heads + batch_stats from the last
    model (heads are per-task and excluded from merging)."""
    k = len(models)
    avg = tree_map(lambda *leaves: sum(_f64(l) for l in leaves) / k,
                   *[m["params"] for m in models])
    out = dict(models[-1])
    out["params"] = tree_map(_f32, avg)
    return out


def merge_mode(models: list, precisions: list) -> dict:
    """theta = sum_t (F_t / sum(F)) * theta_t, heads excluded."""
    sum_prec = tree_map(lambda *ps: sum(_f64(p) for p in ps), *precisions)
    merged = None
    for model, prec in zip(models, precisions):
        contrib = tree_map(lambda th, p, sp: (_f64(p) / sp) * _f64(th),
                           model["params"], prec, sum_prec)
        merged = contrib if merged is None else tree_map(np.add, merged,
                                                         contrib)
    out = dict(models[-1])
    out["params"] = tree_map(_f32, merged)
    return out
