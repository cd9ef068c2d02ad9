"""LwF — Learning without Forgetting (ref:src/methods/LwF/main_LWF.py,
ref:src/methods/method.py:940-989).

Counterpart of ``clsurvey_tpu/methods/lwf.py``. Training = CE on the new
task + ``lambda * sum_over_prev_heads`` of the temperature-2 distillation
loss between the current model's old-head outputs and the frozen previous
model's outputs on the same batch. All heads (old + new) are trainable; the
teacher is frozen.

The teacher lives in the method state on the engine's device and runs one
extra backbone forward per step, under ``torch.no_grad()`` with
``train=False``; all previous heads distill with a single (B, n_prev, C)
einsum via the stacked head bank — the reference loops python lists of head
modules (ref:src/methods/LwF/AlexNet_LwF.py:14-38)."""

from __future__ import annotations

from collections import OrderedDict
from dataclasses import dataclass, field

import numpy as np
import torch

from clsurvey_torch.methods import common
from clsurvey_torch.methods.base import Category, Method, UpdateRule
from clsurvey_torch.methods.finetune import finetune_grid_train
from clsurvey_torch.models import heads as heads_lib
from clsurvey_torch.models.convert import (
    batch_stats_from_jax, batch_stats_to_jax, params_from_jax, params_to_jax,
    port_layout)
from clsurvey_torch.ops.distill import lwf_distill_multi
from clsurvey_torch.parallel import mesh as mesh_lib
from clsurvey_torch.utils import io

TEMPERATURE = 2.0


class LwFRule(UpdateRule):
    """extra_loss = lambda * distillation over all previous heads."""

    def init_state(self, trainable, hyperparams, ctx, prev_model=None):
        """``prev_model`` is a model dict in the on-disk layout; the frozen
        teacher is put on the context's device."""
        assert prev_model is not None
        device = ctx.device
        state = {"hyper": {k: torch.tensor(v, dtype=torch.float32,
                                           device=device)
                           for k, v in hyperparams.items()}}
        head = lambda k: torch.tensor(
            np.asarray(prev_model["heads"][k], np.float32), device=device)
        state["teacher"] = {
            "params": params_from_jax(prev_model["params"], device),
            "batch_stats": batch_stats_from_jax(
                prev_model.get("batch_stats"), device),
            "kernel": head("kernel"),
            "bias": head("bias"),
        }
        return state

    def mstate_to_jax(self, mstate):
        """The teacher's weights and statistics in the JAX layout, as the
        JAX rule's ``init_state`` builds them."""
        t = mstate["teacher"]
        return {**mstate, "teacher": {
            **t, "params": params_to_jax(t["params"]),
            "batch_stats": batch_stats_to_jax(t["batch_stats"])}}

    def mstate_from_jax(self, tree):
        # epoch files of earlier port versions hold the teacher in the
        # port's own flat layout: passed through as they are
        t = tree["teacher"]
        if port_layout(t["params"]):
            return tree
        return {**tree, "teacher": {
            **t, "params": params_from_jax(t["params"]),
            "batch_stats": batch_stats_from_jax(t.get("batch_stats"))}}

    # hyperparam key holding the distillation strength (EBLL reuses this
    # whole term under its own key)
    LAMBDA_KEY = "lambda"

    def teacher_feats(self, ctx, batch, mstate):
        teacher = mstate["teacher"]
        with torch.no_grad():
            feats, _ = ctx.forward_feats(teacher["params"],
                                         teacher["batch_stats"], batch[0],
                                         False)
        return feats

    def distill_term(self, ctx, trainable, feats, batch, mstate,
                     t_feats=None):
        """lambda * sum of temperature-softened distillation losses over
        all previous heads (ref:main_LWF.py:177-201). ``t_feats``: the
        teacher's features, when the caller already has them."""
        n_prev = ctx.n_tasks - 1
        teacher = mstate["teacher"]
        if t_feats is None:
            t_feats = self.teacher_feats(ctx, batch, mstate)
        t_bank = {"kernel": teacher["kernel"], "bias": teacher["bias"],
                  "class_counts": ctx.class_counts}
        with torch.no_grad():
            t_logits = heads_lib.forward_all(t_bank, t_feats, n_prev)
        s_logits = heads_lib.forward_all(ctx.bank(trainable), feats, n_prev)
        dist = lwf_distill_multi(s_logits, t_logits, TEMPERATURE)
        return mstate["hyper"][self.LAMBDA_KEY] * dist

    def extra_loss(self, ctx, trainable, feats, batch, mstate,
                   batch_stats=None, gen=None):
        """The JAX rule hands its ``rng`` only to the teacher's forward;
        that forward runs with ``train=False`` and draws nothing, so this
        rule draws nothing from ``gen`` either. The distillation is a mean
        over the batch: the rank's share is its rows' mean times
        ``ctx.mesh.batch_scale``."""
        if ctx.n_tasks - 1 == 0:
            return 0.0
        return mesh_lib.share(
            self.distill_term(ctx, trainable, feats, batch, mstate),
            ctx.mesh.batch_scale)


@dataclass
class LWF(Method):
    name: str = "LWF"
    category: Category = Category.DATA_BASED
    hyperparams: "OrderedDict[str, float]" = field(
        default_factory=lambda: OrderedDict({"lambda": 10}))
    static_hyperparams: "OrderedDict[str, float]" = field(
        default_factory=lambda: OrderedDict({"head_warmup_epochs": 0}))

    def make_update_rule(self) -> UpdateRule:
        return LwFRule()

    def grid_train(self, args, manager, lr):
        return finetune_grid_train(args, manager, lr)

    def train(self, args, manager, hyperparams):
        prev_model = io.load(manager.previous_task_model_path)
        # optional head-only warmup before the distillation training
        # (ref:src/methods/LwF/main_LWF.py:322-362 fine_tune_freeze)
        warmup = int(self.static_hyperparams.get("head_warmup_epochs", 0))
        if warmup > 0:
            warm_dir = manager.extras["heuristic_exp_dir"] + "_head_warmup"
            prev_model, _, _, _ = common.run_training(
                manager, UpdateRule(), lr=manager.extras["lr"],
                hyperparams={}, exp_dir=warm_dir, start_model=prev_model,
                seed=args.seed, num_epochs=warmup, freeze_backbone=True)
        rule = self.make_update_rule()
        engine = common.get_task_engine(manager, "lwf_engine")
        if engine is None:
            engine = common.build_engine(manager, rule, manager.task_counter)
        mstate = rule.init_state(None, dict(hyperparams), engine.ctx,
                                 prev_model=prev_model)
        best_model, best_acc, _, engine = common.run_training(
            manager, rule, lr=manager.extras["lr"],
            hyperparams=dict(hyperparams),
            exp_dir=manager.extras["heuristic_exp_dir"],
            start_model=prev_model, seed=args.seed, mstate=mstate,
            engine=engine,
            reinit_head=(warmup == 0))  # keep the warmed-up head
        common.set_task_engine(manager, "lwf_engine", engine)
        return best_model, best_acc

