"""Importance-weight regularization methods: EWC, MAS, SI.

Counterpart of ``clsurvey_tpu/methods/reg_based.py``. Shared mechanism (the
reference's signature "regularizer inside optimizer.step" design,
ref:src/methods/EWC/train_EWC.py:23-86, ref:src/methods/SI/train_SI.py:
40-126): the step adds ``2*lambda*omega*(theta - theta_star)`` to the raw
CE gradients *before* weight decay and momentum, on backbone params only
(each task's replaced head drops out of the reg set in the reference).

Per-method importance:

- **EWC**  omega accumulates the empirical diagonal Fisher of each finished
  task, estimated on that task's train split with the model that finished it
  (ref:src/methods/EWC/main_EWC.py:79-157,177-232).
- **MAS**  omega accumulates the mean |per-sample grad of ||f(x)||^2|
  over the previous task's data, batch-size-1 online mode
  (ref:src/methods/MAS/main_MAS.py:34-153, train_MAS.py:128-181,505-567).
- **SI**   omega is built *during* training from the path integral
  ``w += -delta_theta * g_unreg`` updated every optimizer step
  (ref:src/methods/SI/train_SI.py:98-126), consolidated at the next task's
  start as ``omega += max(w / ((theta - theta_init)^2 + xi), 0)``, xi=1e-3
  (ref:src/methods/SI/train_SI.py:301-364, main_SI.py:73-94).

omega / theta_star / w live in the method state as dicts shaped like the
engine's ``trainable['params']`` (torch parameter names and layouts, on the
engine's device). On disk, inside a best model's ``method_aux``, they are in
the JAX package's layout (``models/convert.py``), so a model written by
either package continues in the other. The rules never update a state
tensor in place: the engine's ``post_step`` returns new tensors, and every
decay attempt starts from its own copies."""

from __future__ import annotations

import time
from collections import OrderedDict
from dataclasses import dataclass, field

import numpy as np
import torch

from clsurvey_torch.engine.train import tree_zeros_like
from clsurvey_torch.methods import common
from clsurvey_torch.methods.base import Category, Method, UpdateRule
from clsurvey_torch.methods.finetune import finetune_grid_train
from clsurvey_torch.models.convert import (
    batch_stats_from_jax, params_from_jax, params_to_jax, port_layout)
from clsurvey_torch.ops import importance as imp_lib
from clsurvey_torch.utils import io, timing

SI_XI = 1e-3  # slack (ref:src/methods/SI/train_SI.py:302 slak=1e-3)


def tree_copy(tree: dict) -> dict:
    return {k: v.detach().clone() for k, v in tree.items()}


class QuadRegRule(UpdateRule):
    """penalty = 2*lambda*omega*(theta - theta_star) on backbone params."""

    # the state's trees shaped like ``params``: JAX layout on disk
    PARAM_TREES = ("omega", "theta_star")

    def init_state(self, trainable, hyperparams, ctx, omega=None,
                   theta_star=None):
        params = trainable["params"]
        device = next(iter(params.values())).device  # ctx may be None
        return {
            "hyper": {k: torch.tensor(v, dtype=torch.float32, device=device)
                      for k, v in hyperparams.items()},
            "omega": (omega if omega is not None
                      else tree_zeros_like(tree_copy(params))),
            "theta_star": (theta_star if theta_star is not None
                           else tree_copy(params)),
        }

    def penalty_grads(self, trainable, mstate):
        names = list(trainable["params"])
        theta = [trainable["params"][k] for k in names]
        # (2*lambda*omega) * (theta - theta_star), in three multi-tensor ops
        pen = torch._foreach_mul([mstate["omega"][k] for k in names],
                                 2.0 * mstate["hyper"]["lambda"])
        torch._foreach_mul_(pen, torch._foreach_sub(
            theta, [mstate["theta_star"][k] for k in names]))
        return {"params": dict(zip(names, pen)),
                "heads": tree_zeros_like(trainable["heads"])}

    def export_aux(self, mstate):
        return {k: params_to_jax(mstate[k]) for k in self.PARAM_TREES}

    def mstate_from_jax(self, tree):
        # epoch files of earlier port versions hold the port's own flat
        # layout ("features.conv_0.weight"): passed through as they are
        return {**tree, **{k: tree[k] if port_layout(tree[k])
                           else params_from_jax(tree[k])
                           for k in self.PARAM_TREES}}


class SIRule(QuadRegRule):
    """Adds the per-step path integral w += -(theta_new-theta_old)*g_raw."""

    PARAM_TREES = QuadRegRule.PARAM_TREES + ("w",)

    def init_state(self, trainable, hyperparams, ctx, omega=None,
                   theta_star=None, w=None):
        state = super().init_state(trainable, hyperparams, ctx, omega,
                                   theta_star)
        state["w"] = (w if w is not None else tree_zeros_like(
            tree_copy(trainable["params"])))
        return state

    def post_step(self, ctx, mstate, old_trainable, new_trainable,
                  raw_grads, batch, raw_images=None):
        names = list(mstate["w"])
        delta = torch._foreach_sub(
            [new_trainable["params"][k] for k in names],
            [old_trainable["params"][k] for k in names])
        torch._foreach_mul_(delta, [raw_grads["params"][k] for k in names])
        w = torch._foreach_sub([mstate["w"][k] for k in names], delta)
        return {**mstate, "w": dict(zip(names, w))}


def si_consolidate(prev_params: dict, aux: dict) -> dict:
    """omega += max(w / ((theta_end - theta_init)^2 + xi), 0); reset w;
    theta_star moves to the finished task's params
    (ref:src/methods/SI/train_SI.py:301-364). ``prev_params`` and the
    trees of ``aux`` are dicts shaped like ``params``, on one device.

    Non-finite contributions are dropped: the reference's NaN guard kills
    the whole process instead (train_SI.py:242-244 exit(-1)); the decay
    framework retries with smaller lambda, which only helps if the carried
    omega stays finite."""
    omega = {}
    for k, th_end in prev_params.items():
        this = aux["w"][k] / ((th_end - aux["theta_star"][k]) ** 2 + SI_XI)
        this = torch.where(torch.isfinite(this), this, 0.0)
        om = aux["omega"][k]
        om = torch.where(torch.isfinite(om), om, 0.0)  # carried state too
        omega[k] = om + torch.clamp(this, min=0.0)
    return omega


def orth_reg_grad(weight: torch.Tensor, beta: float,
                  orth_lambda: float = 10.0,
                  eps: float = 1e-10) -> torch.Tensor:
    """Orthogonality-regularization gradient for a conv weight — the MAS
    extra hook (ref:src/methods/MAS/train_MAS.py:100-125 orth_org_hook;
    beta = weight_decay like the reference's caller at :79-80). The weight
    is (out,in,kh,kw) as in the reference, so its filters are its rows."""
    out_c = weight.shape[0]
    filters = weight.reshape(out_c, -1)
    norms = torch.linalg.norm(filters, dim=1, keepdim=True)
    f = filters / (norms + eps)
    g = torch.exp((f @ f.T) * orth_lambda)
    g = (g * orth_lambda) / (g + float(np.exp(np.float32(orth_lambda))))
    g = g * (1.0 - torch.eye(out_c, dtype=g.dtype, device=g.device))
    return ((g @ f) * beta).reshape(weight.shape)


class MASRule(QuadRegRule):
    """QuadReg + the optional orth-reg hook on conv weights
    (ref:src/methods/MAS/train_MAS.py:79-80: ``if self.orth_reg:
    d_p.add_(orth_org_hook(p, {'beta': weight_decay}))``, applied after
    decay, before momentum; off by default like the reference — no caller
    ever passes orth_reg=True)."""

    def __init__(self, orth_reg: bool = False):
        self.orth_reg = orth_reg

    def transform_grads(self, ctx, grads, trainable, mstate):
        if not self.orth_reg:
            return grads
        beta = ctx.weight_decay  # reference passes beta=weight_decay
        return {**grads, "params": {
            k: (g + orth_reg_grad(trainable["params"][k], beta)
                if g.dim() == 4 else g)  # conv weights only
            for k, g in grads["params"].items()}}


@dataclass
class _RegMethodBase(Method):
    """Shared host lifecycle of the three reg methods."""

    category: Category = Category.MODEL_BASED

    def make_update_rule(self) -> UpdateRule:
        return QuadRegRule()

    def _l1_decay(self) -> bool:
        return False

    def grid_train(self, args, manager, lr):
        """Phase 1 is plain finetuning (maximal plasticity)."""
        return finetune_grid_train(args, manager, lr)

    # -- importance preparation, once per task (cached across attempts) -----
    def _prepare(self, args, manager):
        """-> (omega, theta_star, extra) as device trees."""
        raise NotImplementedError

    def _accumulated(self, prev_model: dict, omega_new: dict,
                     device) -> dict:
        """``omega_new`` added onto the omega carried in the previous
        model's aux, if it carries one."""
        aux = prev_model.get("method_aux")
        if not (aux and "omega" in aux):
            return omega_new
        carried = params_from_jax(aux["omega"], device)
        return {k: carried[k] + v for k, v in omega_new.items()}

    def train(self, args, manager, hyperparams):
        cache_key = ("reg_prep", self.name, manager.task_counter)
        if cache_key not in manager.extras:
            t0 = time.perf_counter()
            manager.extras[cache_key] = self._prepare(args, manager)
            manager.extras[(cache_key, "secs")] = time.perf_counter() - t0
        exp_dir = manager.extras["heuristic_exp_dir"]
        # telemetry per exp (ref:src/utilities/utils.py:100-105, caller
        # main_EWC.py:43-46) — (re)written every attempt: the failed-
        # attempt cleanup wipes the exp dir between decay retries
        timing.save_preprocessing_time(
            exp_dir, manager.extras.get((cache_key, "secs"), 0.0))
        omega, theta_star, extra = manager.extras[cache_key]
        rule = self.make_update_rule()
        # one engine slot, overwritten per task
        engine = common.get_task_engine(manager, "reg_engine")
        prev_model = io.load(manager.previous_task_model_path)

        # the method state is built from copies of the cached importance
        # trees, so decay attempts never share (or inherit) a tensor
        init_kwargs = {"omega": tree_copy(omega),
                       "theta_star": tree_copy(theta_star)}
        if isinstance(rule, SIRule):
            init_kwargs["w"] = tree_copy(extra["w"])
        mstate = rule.init_state({"params": theta_star, "heads": None},
                                 dict(hyperparams), None, **init_kwargs)

        best_model, best_acc, _, engine = common.run_training(
            manager, rule, lr=manager.extras["lr"],
            hyperparams=dict(hyperparams), exp_dir=exp_dir,
            start_model=prev_model, seed=args.seed, mstate=mstate,
            engine=engine, l1_decay=self._l1_decay())
        common.set_task_engine(manager, "reg_engine", engine)
        return best_model, best_acc

    # -- shared by EWC and MAS ----------------------------------------------
    def _prev_task_inputs(self, args, manager):
        """The previous task's model (dict; params and batch-norm
        statistics on the device) and train split, and an augment-free
        engine context to run it in."""
        prev_model = io.load(manager.previous_task_model_path)
        engine = common.build_engine(manager, UpdateRule(),
                                     manager.task_counter, augment=False)
        device = engine.ctx.device
        prev_params = params_from_jax(prev_model["params"], device)
        prev_stats = batch_stats_from_jax(prev_model.get("batch_stats"),
                                          device)
        prev_task = manager.task_counter - 1
        prev_data = manager.dataset.get_task_dataset(prev_task)
        return (prev_model, prev_params, prev_stats, prev_task, prev_data,
                engine.ctx)


@dataclass
class EWC(_RegMethodBase):
    name: str = "EWC"
    hyperparams: "OrderedDict[str, float]" = field(
        default_factory=lambda: OrderedDict({"lambda": 400}))

    def _prepare(self, args, manager):
        """Fisher of the finished (previous) task, accumulated onto the
        omega carried in the prev model's aux."""
        prev_model, prev_params, prev_stats, prev_task, prev_data, ctx = \
            self._prev_task_inputs(args, manager)
        fisher = imp_lib.ewc_fisher(
            ctx, prev_params, prev_stats, prev_model["heads"], prev_task - 1,
            np.asarray(prev_data.train.images),
            np.asarray(prev_data.train.labels), args.batch_size)
        return (self._accumulated(prev_model, fisher, ctx.device),
                prev_params, {})


@dataclass
class MAS(_RegMethodBase):
    """MAS b1 online mode. The reference's auxiliary knobs ride as static
    hyperparams, both off by default exactly like the reference
    (ref:src/methods/MAS/main_MAS.py:36 L1_decay=False;
    train_MAS.py:23 orth_reg=False, no caller enables it):
    ``--static_hyperparams "l1;orth"`` with 0/1 values."""

    name: str = "MAS"
    hyperparams: "OrderedDict[str, float]" = field(
        default_factory=lambda: OrderedDict({"lambda": 3}))
    static_hyperparams: "OrderedDict[str, float]" = field(
        default_factory=lambda: OrderedDict(
            {"l1_decay": 0, "orth_reg": 0}))

    def make_update_rule(self) -> UpdateRule:
        return MASRule(orth_reg=bool(self.static_hyperparams["orth_reg"]))

    def _l1_decay(self) -> bool:
        return bool(self.static_hyperparams["l1_decay"])

    def _prepare(self, args, manager):
        prev_model, prev_params, prev_stats, prev_task, prev_data, ctx = \
            self._prev_task_inputs(args, manager)
        omega_new = imp_lib.mas_importance(
            ctx, prev_params, prev_stats, prev_model["heads"], prev_task - 1,
            np.asarray(prev_data.train.images))
        return (self._accumulated(prev_model, omega_new, ctx.device),
                prev_params, {})


@dataclass
class SI(_RegMethodBase):
    """SI trains with the path integral live in the update rule; at each new
    task start, the previous model's (omega, w, theta_star) consolidate.
    SI is also the method that produces the shared first-task base model
    (ref:src/framework/main.py first_task_basemodel_dump)."""

    name: str = "SI"
    hyperparams: "OrderedDict[str, float]" = field(
        default_factory=lambda: OrderedDict({"lambda": 400}))

    def make_update_rule(self) -> UpdateRule:
        return SIRule()

    def _prepare(self, args, manager):
        from clsurvey_torch.utils import device as device_lib

        device = device_lib.resolve(args.device)
        prev_model = io.load(manager.previous_task_model_path)
        prev_params = params_from_jax(prev_model["params"], device)
        aux = prev_model.get("method_aux")
        if aux and "w" in aux:
            omega = si_consolidate(prev_params, {
                k: params_from_jax(aux[k], device)
                for k in ("omega", "w", "theta_star")})
        else:  # task 1 (basemodel dump): start from zeros
            omega = tree_zeros_like(prev_params)
        return omega, prev_params, {"w": tree_zeros_like(prev_params)}
