"""A run with the timed path broken underneath comes out not correct, once
for each fault a training cell on one card can have: a step that returns
its state unchanged, half of each batch left out (the mean taken over the
rest), one label altered where the step reads it, the conv weights frozen
(their gradient zero), the eval's answers altered where they are
produced, and the eval's images flipped as a train batch's are. The harness's look for a card is skipped
(the CPU runs the tiny cells); the rest of the run is the benchmark's."""

from __future__ import annotations

import functools

import pytest

from clbench import harness
from clbench.tests import tiny


@pytest.fixture(scope="module")
def spec(tmp_path_factory):
    return tiny.make(str(tmp_path_factory.mktemp("clbench")))


def _unchanged_state(orig):
    @functools.wraps(orig)
    def step(self, state, *args, **kwargs):
        _, metrics = orig(self, state, *args, **kwargs)
        return state, metrics
    return step


def _half_batch(orig):
    @functools.wraps(orig)
    def base(self, trainable, batch_stats, batch, mstate,
             dropout_masks=None, gen=None):
        x, y = batch
        h = int(y.shape[0]) // 2
        masks = None if dropout_masks is None else [m[:h] for m in
                                                    dropout_masks]
        return orig(self, trainable, batch_stats, (x[:h], y[:h]), mstate,
                    dropout_masks=masks, gen=gen)
    return base


def _label(orig):
    @functools.wraps(orig)
    def base(self, trainable, batch_stats, batch, mstate, **kwargs):
        x, y = batch
        y = y.clone()
        y[0] = (y[0] + 1) % int(self.ctx.class_counts[self.ctx.task])
        return orig(self, trainable, batch_stats, (x, y), mstate, **kwargs)
    return base


def _frozen_conv(orig):
    @functools.wraps(orig)
    def base(self, *args, **kwargs):
        loss, grads, new_bs, metrics = orig(self, *args, **kwargs)
        grads["params"] = {k: g.zero_() if g.dim() == 4 else g
                           for k, g in grads["params"].items()}
        return loss, grads, new_bs, metrics
    return base


def _eval_flip(orig):
    @functools.wraps(orig)
    def evaluate(self, trainable, batch_stats, images, *args, **kwargs):
        return orig(self, trainable, batch_stats, images.flip(2), *args,
                    **kwargs)
    return evaluate


def _answers(orig):
    @functools.wraps(orig)
    def evaluate(self, *args, **kwargs):
        acc, hits, rows = orig(self, *args, **kwargs)
        hits = hits.copy()
        hits[0] = rows[0] - hits[0]  # class 0's answers turned over
        return acc, hits, rows
    return evaluate


FAULTS = {"unchanged_state": ("_train_step", _unchanged_state),
          "half_batch": ("_base_loss_and_grads", _half_batch),
          "label": ("_base_loss_and_grads", _label),
          "frozen_conv": ("_base_loss_and_grads", _frozen_conv),
          "answers": ("evaluate", _answers),
          "eval_flip": ("evaluate", _eval_flip)}


@pytest.mark.parametrize("cell", ["tiny-vgg-finetune", "tiny-alexnet-stream"])
@pytest.mark.parametrize("fault", list(FAULTS))
def test_a_fault_is_not_correct(spec, monkeypatch, cell, fault):
    from clsurvey_torch.engine.train import Engine

    if "stream" in cell:
        monkeypatch.setenv("CLSURVEY_DATA_BUDGET_MB", tiny.BUDGET_MB)
    name, wrap = FAULTS[fault]
    monkeypatch.setattr(Engine, name, wrap(getattr(Engine, name)))
    result, lines = harness.run(spec, cell, 2 ** 32 + 11, 0.05, False,
                                device="cpu", log=lambda m: None)
    assert result["correct"] is False, lines
    assert any(line.endswith("FAILED") for line in lines)
