"""Method plugin API (counterpart of ``clsurvey_tpu/methods/base.py``).

Two-level design replacing the reference's ``methods/method.py`` ABC + eleven
hand-written training engines (ref:src/methods/method.py:81-224):

1. ``UpdateRule`` — the train-step surface. Functions on tensors that plug
   into the engine's single train step: extra loss terms (LwF/EBLL
   distillation), penalty gradients injected before momentum (EWC/MAS/SI/IMM
   — the reference's "regularizer inside optimizer.step" pattern,
   ref:src/methods/EWC/train_EWC.py:23-86), gradient transforms (PackNet/HAT
   masking, GEM projection), and per-step state updates (SI path integral).
   All state lives in a ``method_state`` dict of device tensors;
   hyperparameters that the Continual Hyperparameter Framework decays are
   scalar tensors inside it.

2. ``Method`` — the *host* lifecycle, hook-compatible with the reference's
   framework probes (grid_prestep / grid_train / grid_poststep / prestep /
   train / poststep / init_next_task / get_output / inference_eval,
   ref:src/methods/method.py:128-224), driven by framework/ orchestration.

Data parallel (``parallel/mesh.py``): under a process group each rank's
hooks see its own rows of the step's batch, and the loss they return is
the rank's SHARE of the global loss, which the ranks' gradients then sum:

- a term that is a mean over the batch is a local sum over the global
  count: the local mean times the shard's ``mean_scale``
  (``ctx.mesh.batch_scale`` for the step's own batch, ``ctx.mesh.shard(b)``
  for rows a rule draws itself, which it shards too);
- a term that does not depend on the batch is counted once: scaled by
  ``1/N`` on every rank (or added after the all-reduce), not N times.

``compute_grads`` gets a ``base`` whose gradient is already all-reduced;
``penalty_grads``, ``transform_grads``, ``mask_updates`` and ``post_step``
act on replicated state and the global gradient, and ``post_step`` gets
the global batch's raw rows and labels. A rule's own metrics must be equal
on every rank. Without a group the scales are 1 and every hook computes
what it computed on one device.
"""

from __future__ import annotations

import enum
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Any, Callable

import torch


class Category(enum.Enum):
    """ref:src/methods/method.py:114-123."""

    MODEL_BASED = "model_based"
    DATA_BASED = "data_based"
    MASK_BASED = "mask_based"
    BASELINE = "baseline"
    REHEARSAL_BASED = "rehearsal_based"

    def __eq__(self, other):
        return (self.name == getattr(other, "name", None)
                and self.value == getattr(other, "value", None))

    def __hash__(self):
        return hash((self.name, self.value))


class UpdateRule:
    """Train-step hooks; default = plain finetuning SGD. Trees are nested
    dicts of tensors shaped like the engine's ``trainable``."""

    def init_state(self, trainable: Any, hyperparams: "OrderedDict[str, float]",
                   ctx: Any) -> Any:
        """Build the method_state dict at task start."""
        device = getattr(ctx, "device", None)
        return {"hyper": {k: torch.tensor(v, dtype=torch.float32,
                                          device=device)
                          for k, v in hyperparams.items()}}

    def extra_loss(self, ctx: Any, trainable: Any, feats: torch.Tensor,
                   batch: Any, mstate: Any, batch_stats: Any = None,
                   gen: torch.Generator | None = None
                   ) -> torch.Tensor | float:
        """Differentiated extra loss term (distillation, replay).
        ``batch_stats`` are the current model's BN stats for auxiliary
        forwards (replay/distillation); ``gen`` is the epoch's device
        generator, the source of the rule's own draws (exemplar rows, their
        flip and dropout masks). A rule that draws nothing ignores it, so
        the engine's stream of draws is the same as without it."""
        return 0.0

    # Optional: ``compute_grads(ctx, trainable, batch_stats, batch, mstate,
    # base, gen=None) -> (loss, grads, new_batch_stats, metrics)`` takes
    # over the gradient computation; ``base(trainable, batch_stats, batch,
    # mstate)`` is the engine's own (GEM projects its result).

    def penalty_grads(self, trainable: Any, mstate: Any) -> Any | None:
        """Gradient of the importance penalty, added to CE grads *before*
        weight decay and momentum (ref:src/methods/EWC/train_EWC.py:50-68
        order). Returns a tree matching ``trainable`` or None."""
        return None

    def transform_grads(self, ctx: Any, grads: Any, trainable: Any,
                        mstate: Any) -> Any:
        """Mask/project total grads (PackNet/HAT/GEM)."""
        return grads

    def post_step(self, ctx: Any, mstate: Any, old_trainable: Any,
                  new_trainable: Any, raw_grads: Any, batch: Any,
                  raw_images: Any = None, raw_labels: Any = None) -> Any:
        """Per-step state update with the *unregularized* grads (SI path
        integral), the rank's preprocessed rows ``batch``, and the global
        batch's raw uint8 images and labels (rehearsal ring buffers store
        un-augmented samples, the analog of the reference's path-based
        memory; every rank's memory stays equal)."""
        return mstate

    def mask_updates(self, ctx: Any, updates: Any, mstate: Any) -> Any:
        """Final hook on the (lr-scaled) update direction, applied after
        momentum (PackNet keeps other tasks' weights exactly frozen)."""
        return updates

    def export_aux(self, mstate: Any) -> Any | None:
        """Method state persisted inside the best-model pickle — the analog
        of the reference pickling ``model.reg_params`` with the model
        (importance tensors, SI path integrals, masks, memories)."""
        return None

    def mstate_to_jax(self, mstate: Any) -> Any:
        """The method state as an epoch checkpoint holds it, in the JAX
        package's layout: the state with its ``export_aux`` parts (already
        in that layout) in place of the port's; a rule whose state holds
        more than that converts it itself. ``mstate_from_jax`` is the
        inverse."""
        return {**mstate, **(self.export_aux(mstate) or {})}

    def mstate_from_jax(self, tree: Any) -> Any:
        """An epoch checkpoint's host method state -> the port's layout,
        leaves still on the host (the engine moves them to the device)."""
        return tree


@dataclass
class Method:
    """Host-side lifecycle. Concrete methods subclass this.

    Attribute semantics follow ref:src/methods/method.py:
    - ``hyperparams``: OrderedDict of *decayable* hyperparams (framework
      Phase-2 multiplies them by ``decaying_factor``);
    - ``static_hyperparams``: not decayed;
    - ``start_scratch``: train task 1 itself instead of reusing the shared SI
      first-task model (ref:src/framework/main.py:109-111);
    - ``no_framework``: Phase-1 (LR grid) only — IMM/Joint/rehearsal
      baselines (ref:src/methods/method.py:768,1000,1099);
    - ``wrap_first_task_model``: GEM/iCaRL wrap the shared SI model."""

    name: str = "abstract"
    eval_name: str = ""
    category: Category = Category.BASELINE
    hyperparams: "OrderedDict[str, float]" = field(
        default_factory=OrderedDict)
    static_hyperparams: "OrderedDict[str, float]" = field(
        default_factory=OrderedDict)
    init_hyperparams: "OrderedDict[str, float]" = field(
        default_factory=OrderedDict)
    start_scratch: bool = False
    no_framework: bool = False
    wrap_first_task_model: bool = False
    grid_chkpt: bool = True
    extra_hyperparams_count: int = 0

    def __post_init__(self):
        if not self.eval_name:
            self.eval_name = self.name
        self.init_hyperparams = OrderedDict(self.hyperparams)

    # ---- train-step factory ----------------------------------------------
    def make_update_rule(self) -> UpdateRule:
        return UpdateRule()

    # ---- hyperparameter plumbing (ref:src/methods/method.py:238-274) ------
    def set_hyperparams(self, spec, static: bool = False) -> None:
        """Reference string DSL (ref:src/methods/method.py:238-274):
        ``"0.5,300"`` -> two scalar hyperparams; ``"0.1,0.2;5.2,300"`` ->
        two *list* hyperparams; ``def``/empty leaves the default."""
        if spec is None:
            return
        leave_default = lambda x: x == "def" or x == ""
        if isinstance(spec, str):
            groups = [g.strip() for g in spec.split(";") if len(g) > 0]
            values: list = []
            for g in groups:
                parts = [float(x) for x in g.split(",")
                         if not leave_default(x)]
                parts = parts[0] if len(parts) == 1 else parts
                if len(groups) == 1:
                    values = parts if isinstance(parts, list) else [parts]
                else:
                    values.append(parts)
        elif isinstance(spec, (int, float)):
            values = [float(spec)]
        else:
            values = list(spec)
        target = self.static_hyperparams if static else self.hyperparams
        for key, val in zip(list(target.keys()), values):
            target[key] = val
        if not static:
            self.init_hyperparams = OrderedDict(self.hyperparams)

    def decay_operator(self, value, factor):
        """Default: multiply (PathNet overrides to increment,
        ref:src/methods/method.py:565-593)."""
        return value * factor

    # ---- optional lifecycle hooks (probed via hasattr by the framework,
    #      exactly like the reference ref:src/framework/framework_train.py) --
    #   grid_prestep(args, manager)
    #   grid_train(args, manager, lr) -> (model_state, best_val_acc)
    #   grid_poststep(args, manager)
    #   prestep(args, manager)
    #   train(args, manager, hyperparams) -> (model_state, best_val_acc)
    #   poststep(args, manager)
    #   init_next_task(manager)
    #   eval_model_preprocessing(args) -> model paths
    #   grid_datafetch(args, dataset) -> task data
    #   train_args_overwrite(args)

    # ---- inference --------------------------------------------------------
    def get_output(self, logits_fn: Callable, feats: torch.Tensor,
                   task: int, n_tasks: int) -> torch.Tensor:
        """Default: current-head logits (ref:src/methods/method.py:230-235)."""
        return logits_fn(feats, task)
