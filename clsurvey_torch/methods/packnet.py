"""PackNet — iterative pruning with per-weight task ownership masks
(ref:src/methods/packnet/{main,prune,networks,packnetSGD}.py,
wrapper ref:src/methods/method.py:417-556).

Counterpart of ``clsurvey_tpu/methods/packnet.py``; the lifecycle maps
onto the framework like the reference's:

- Phase 1 (``grid_train``, the reference's *finetune* mode): free weights
  are claimed for the current task (``make_finetuning_mask``) and only the
  current task's conv/dense weights receive updates; biases are frozen,
  batch-norm trains when the model has it.
- Phase 2 (``train``, the reference's *prune* mode): starting from the
  Phase-1 winner, prune ``prune_perc_per_layer`` of the current task's
  weights per layer (kth-|w| cutoff), then retrain the survivors at
  ``lr * 0.1`` for ``post_prune_epochs`` (ref:method.py:509-536). Each
  decay attempt re-prunes the same Phase-1 model at the decayed
  percentage.
- Eval: weights not yet trained at the evaluated task (mask == 0 or
  mask > task) are zeroed before the forward (``apply_mask``).

The masks (``ops/masks.py``) are uint8 tensors in the method state, keyed
like the backbone's parameters. Gradient masking and the exact-zero
guarantee (the reference's PacknetSGD masks weight decay,
ref:packnetSGD.py:39-43) are both enforced by masking the final update
direction after momentum, so frozen and pruned weights move exactly 0. On
disk the masks ride in ``method_aux`` in the JAX package's layout, uint8
(``models/convert.py``), so either package continues from the other's
models."""

from __future__ import annotations

from collections import OrderedDict
from dataclasses import dataclass, field

from clsurvey_torch.framework.evaluate import default_inference_eval
from clsurvey_torch.methods import common
from clsurvey_torch.methods.base import Category, Method, UpdateRule
from clsurvey_torch.models.convert import (
    params_from_jax, params_to_jax, port_layout)
from clsurvey_torch.ops import masks as masks_lib
from clsurvey_torch.utils import io
from clsurvey_torch.utils.paths import BEST_MODEL_FILENAME


class PackNetRule(UpdateRule):
    """Grad + update masking for one task's training run. ``masks`` is
    fixed for the run (pruning happens on the host between runs)."""

    def __init__(self, task_id: int, train_bn: bool = False):
        self.task_id = int(task_id)  # 1-based ownership id
        # ref trains BN params whenever the model has batchnorm
        # (ref:src/methods/method.py:538, prune.py:93-97)
        self.train_bn = bool(train_bn)

    def init_state(self, trainable, hyperparams, ctx, masks=None):
        state = super().init_state(trainable, hyperparams, ctx)
        assert masks is not None
        state["masks"] = masks
        return state

    def _mask_tree(self, tree, mstate):
        params = masks_lib.mask_grads(tree["params"], mstate["masks"],
                                      self.task_id, train_bn=self.train_bn)
        # only the current task's head trains
        heads = common.current_task_head_grads(tree["heads"],
                                               self.task_id - 1)
        return {"params": params, "heads": heads}

    def transform_grads(self, ctx, grads, trainable, mstate):
        return self._mask_tree(grads, mstate)

    def mask_updates(self, ctx, updates, mstate):
        # post-momentum: frozen + pruned weights move exactly 0
        return self._mask_tree(updates, mstate)

    def export_aux(self, mstate):
        return {"masks": params_to_jax(mstate["masks"])}

    def mstate_from_jax(self, tree):
        # the uint8 masks keep their dtype and 0-d sentinels; epoch files of
        # earlier port versions hold the port's flat layout, passed through
        if port_layout(tree["masks"]):
            return tree
        return {**tree, "masks": params_from_jax(tree["masks"], dtype=None)}


def load_with_masks(path_or_model, device) -> tuple[dict, dict]:
    """(model dict, its masks as uint8 tensors on ``device``, in the port's
    layout); a model without masks (the first task's) has every weight
    free."""
    model = io.load(path_or_model) if isinstance(path_or_model, str) \
        else path_or_model
    aux = model.get("method_aux") or {}
    if "masks" in aux:
        return model, params_from_jax(aux["masks"], device, dtype=None)
    return model, masks_lib.init_masks(
        params_from_jax(model["params"], device), owner=0)


@dataclass
class PackNet(Method):
    name: str = "packnet"
    category: Category = Category.MASK_BASED
    start_scratch: bool = True
    hyperparams: "OrderedDict[str, float]" = field(
        default_factory=lambda: OrderedDict(
            {"prune_perc_per_layer": 0.9}))
    static_hyperparams: "OrderedDict[str, float]" = field(
        default_factory=lambda: OrderedDict({"post_prune_epochs": 10}))

    def _engine(self, manager):
        t = manager.task_counter
        return common.build_engine(
            manager, PackNetRule(t, train_bn=manager.model_spec.batch_norm),
            t)

    # ---- Phase 1: finetune mode ----------------------------------------------
    def grid_train(self, args, manager, lr):
        engine = self._engine(manager)
        prev_model, masks = load_with_masks(manager.previous_task_model_path,
                                            engine.ctx.device)
        masks = masks_lib.claim_free(masks, manager.task_counter)
        rule = engine.ctx.update_rule
        mstate = rule.init_state(None, {}, engine.ctx, masks=masks)
        best_model, best_acc, _, _ = common.run_training(
            manager, rule, lr=lr, hyperparams={},
            exp_dir=manager.extras["gridsearch_exp_dir"],
            start_model=prev_model, seed=manager.extras.get("grid_seed", 0),
            mstate=mstate, engine=engine)
        return best_model, best_acc

    def grid_poststep(self, args, manager):
        best_dir = manager.extras.get("best_exp_grid_node_dirname")
        manager.extras["packnet_ft_model_path"] = (
            f"{best_dir}/{BEST_MODEL_FILENAME}" if best_dir else None)

    # ---- Phase 2: prune + retrain at lr*0.1 ----------------------------------
    def train(self, args, manager, hyperparams):
        t = manager.task_counter
        ft_path = manager.extras.get("packnet_ft_model_path")
        if not ft_path or not io.exists(ft_path):
            # a silent fallback to the previous task's model would train
            # only the head (its masks hold no task-t claims)
            raise FileNotFoundError(
                f"PackNet Phase-1 model missing: {ft_path!r} — Phase 1 "
                "must run first and its grid storage must keep the best "
                "model (policy only_keep_best/all)")
        engine = self._engine(manager)
        model, masks = load_with_masks(ft_path, engine.ctx.device)
        pruned, masks = masks_lib.prune_masks(
            params_from_jax(model["params"], engine.ctx.device), masks, t,
            hyperparams["prune_perc_per_layer"])
        model = {**model, "params": params_to_jax(pruned)}
        rule = engine.ctx.update_rule
        mstate = rule.init_state(None, dict(hyperparams), engine.ctx,
                                 masks=masks)
        best_model, best_acc, _, _ = common.run_training(
            manager, rule, lr=manager.extras["lr"] * 0.1,
            hyperparams=dict(hyperparams),
            exp_dir=manager.extras["heuristic_exp_dir"],
            num_epochs=int(self.static_hyperparams["post_prune_epochs"]),
            start_model=model, seed=args.seed, mstate=mstate, engine=engine,
            reinit_head=False)  # keep the Phase-1 trained head
        return best_model, best_acc

    # ---- eval: apply the task's subnetwork -----------------------------------
    def inference_eval(self, manager, model_path, ref_task, trained_idx):
        model, masks = load_with_masks(model_path, "cpu")
        params = masks_lib.apply_eval_mask(
            params_from_jax(model["params"], "cpu"), masks, ref_task)
        return default_inference_eval(
            manager, {**model, "params": params_to_jax(params)}, ref_task)
