"""Reads the program's first train steps and an eval's logits for the
correctness check.

The program's update rule may take over a step's gradient computation
through ``compute_grads(ctx, trainable, batch_stats, batch, mstate, base,
gen)``, whose ``base`` is the engine's own. The probe sets that hook on the
rule object (an attribute of the instance, so the rule's class is left as
it is) for the first steps of the first epoch only: each call runs the
rule's own computation unchanged and reads what the program has at that
point. At step 1, 2 and 3 the total loss the step returns; at step 2 the
momentum, which after one step from zero is the first gradient as the
optimizer got it; at step 4 the parameters it is handed, the state after
three steps as step 4 keeps it. It then removes itself, so every later
step, and the whole window, runs the rule exactly as the program has it.
Readings are copied to the host at once: they take no device memory while
the window runs.

:class:`EvalProbe` reads the task logits of one ``Engine.evaluate`` call
the same way, through the engine context's ``task_logits`` (set on the
instance for that call only), and passes them on unchanged."""

from __future__ import annotations

import torch

STEPS = 3


def named(trainable: dict) -> dict:
    """{name: tensor} of the program's trainable tree (or a tree shaped
    like it, such as the momentum): the backbone's parameter names, then
    ``heads.kernel`` and ``heads.bias``."""
    return {**trainable["params"],
            **{f"heads.{k}": v for k, v in trainable["heads"].items()}}


def host(tree) -> dict:
    return {k: v.detach().to("cpu", copy=True)
            for k, v in named(tree).items()}


class StepProbe:
    def __init__(self, rule, state, steps: int = STEPS):
        self.rule = rule
        self.momentum = state.momentum  # updated in place by every step
        self.steps = steps
        self.calls = 0
        self.losses: list = []
        self.first_grad: dict | None = None
        self.params: dict | None = None
        self._own = rule.__dict__.get("compute_grads")  # an instance's
        self._inner = getattr(rule, "compute_grads", None)
        rule.compute_grads = self

    @property
    def done(self) -> bool:
        return self.params is not None

    def _release(self) -> None:
        if self._own is not None:
            self.rule.compute_grads = self._own
        else:
            del self.rule.compute_grads

    def __call__(self, ctx, trainable, batch_stats, batch, mstate, base,
                 gen=None):
        k = self.calls
        self.calls += 1
        if k == 1:
            self.first_grad = host(self.momentum)
        if k == self.steps:
            self.params = host(trainable)
            self._release()
        if self._inner is None:
            out = base(trainable, batch_stats, batch, mstate)
        else:
            out = self._inner(ctx, trainable, batch_stats, batch, mstate,
                              base, gen=gen)
        if k < self.steps:
            self.losses.append(float(out[0]))
        return out


class EvalProbe:
    def __init__(self, ctx):
        self.ctx = ctx
        self.parts: list = []
        self._own = ctx.__dict__.get("task_logits")  # an instance's
        self._inner = ctx.task_logits
        ctx.task_logits = self

    def release(self) -> torch.Tensor:
        """Removes the probe; the logits read, in the split's order."""
        if self._own is not None:
            self.ctx.task_logits = self._own
        else:
            del self.ctx.task_logits
        return torch.cat(self.parts)

    def __call__(self, trainable, feats):
        out = self._inner(trainable, feats)
        self.parts.append(out.detach().to("cpu", torch.float32, copy=True))
        return out
