"""The plain reference of a training cell: its first steps and its eval.

Plain PyTorch, in the precision the caller asks for (float64 for the
check; the control asks for float32 with TF32 on). It imports nothing of
the program and takes nothing the program made: it draws the weights, the
rows of each step (the epoch's permutation through the chunk plan), the
flips and the dropout masks again from the seed, in the program's order,
and computes each step as the survey's protocol states it: normalise and
flip, the network, the task head, the mean cross-entropy plus the method's
extra term, the gradient, and torch SGD with momentum 0.9 (``buf = 0.9 buf
+ g``, ``p -= lr buf``). The parameters after each step are kept in the
precision the configuration states for them (float32), as the program
keeps them: a step moves a conv weight by a few millionths of itself, so
the change after three steps is only defined to that precision."""

from __future__ import annotations

import contextlib
import importlib
import os
from dataclasses import dataclass, field

import numpy as np
import torch
import torch.nn.functional as F

from clbench import seeds
from clbench.reference import net

# the program's device data budget: a split above it streams, in chunks of
# half of it (``engine/train.py:data_budget_bytes``); the benchmark's runs
# leave it at its default
BUDGET_ENV, BUDGET_MB = "CLSURVEY_DATA_BUDGET_MB", "2048"
MOMENTUM = 0.9
# a val row whose two best logits lie closer than this share of its largest
# |logit| has no decided answer in float32; it may count either way
AMBIGUOUS = 1e-4


@dataclass
class Problem:
    cfg: dict
    workload: dict
    device: torch.device
    teacher: dict | None = None  # float32 weights, as made from the seed
    method: object = field(init=False)

    def __post_init__(self):
        self.method = importlib.import_module(
            f"clbench.reference.methods.{self.workload['method']}")

    @property
    def task(self) -> int:  # 0-based head of the task trained
        return int(self.workload["task"]) - 1

    @property
    def n_tasks(self) -> int:
        return int(self.workload["task"])

    @property
    def batch(self) -> int:
        return min(int(self.workload["batch_size"]),
                   int(self.workload["train_rows"]))


@contextlib.contextmanager
def precision(tf32: bool):
    """TF32 in cuBLAS and cuDNN as asked, cuDNN's algorithm search off."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32, torch.backends.cudnn.benchmark)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    torch.backends.cudnn.benchmark = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32,
         torch.backends.cudnn.benchmark) = saved


def preprocess(u8: torch.Tensor, cfg: dict, flip, dtype) -> torch.Tensor:
    """uint8 NHWC -> ``u8 / (255 std) - mean / std``, flipped along the
    width where ``flip`` is nonzero."""
    std = torch.tensor(cfg["std"], dtype=dtype, device=u8.device)
    mean = torch.tensor(cfg["mean"], dtype=dtype, device=u8.device)
    x = u8.to(dtype) * (1.0 / (255.0 * std)) - mean / std
    if flip is None:
        return x
    return torch.where(flip.bool().view(-1, 1, 1, 1), x.flip(2), x)


def step_rows(p: Problem, seed: int, steps: int) -> torch.Tensor:
    """The train rows of epoch 0's first ``steps`` steps, in order. A
    resident epoch takes the permutation's whole batches; a streamed one
    pads the permutation to whole chunks of half the data budget (rounded
    down to whole batches, at most the batch-rounded split) with its own
    first rows and steps through the chunks in order."""
    n, b = int(p.workload["train_rows"]), p.batch
    perm = seeds.permutation(seed, 0, n)
    px = int(p.cfg["input_px"])
    budget = int(os.environ.get(BUDGET_ENV, BUDGET_MB)) << 20
    if n * px * px * 3 > budget:
        chunk = budget // 2 // (px * px * 3)
        chunk = min(max(chunk // b * b, b), n // b * b)
        use = -(-n // chunk) * chunk
        perm = torch.cat([perm, perm[:use - n]])
    else:
        perm = perm[:n // b * b]
    if steps * b > perm.numel():
        raise ValueError(f"{steps} steps need {steps * b} rows")
    return perm[:steps * b]


def draws(p: Problem, gen: torch.Generator, b: int):
    """One step's flip mask (when the traffic flips) and dropout
    keep-masks, drawn in the program's order."""
    dev = p.device
    flip = (torch.randint(0, 2, (b,), dtype=torch.uint8, device=dev,
                          generator=gen)
            if p.workload.get("augment", True) else None)
    masks = [torch.randint(0, 2, (b, d), dtype=torch.uint8, device=dev,
                           generator=gen)
             for d in net.dropout_widths(p.cfg)]
    return flip, masks


def cast(params: dict, dtype) -> dict:
    return {k: v.detach().to(dtype) for k, v in params.items()}


def loss_of(p: Problem, params: dict, x, y, masks, teacher):
    feats = net.features(p.cfg, params, x, masks)
    ce = F.cross_entropy(net.head_logits(params, feats, p.task), y)
    return ce + p.method.extra_loss(p, params, feats, x, teacher)


def follow(p: Problem, params0: dict, rows_u8: torch.Tensor,
           labels: torch.Tensor, seed: int, dtype, steps: int = 3,
           fault: str | None = None):
    """The first ``steps`` SGD steps from ``params0`` on ``rows_u8`` (the
    steps' rows in order) in ``dtype``. Returns (each step's loss, the
    first step's gradient, the parameters after the last step), the
    gradient and parameters as {name: tensor}.

    ``fault`` plants one of the faults the check has to catch, as a
    program with it would compute: ``half_batch`` (each step on the first
    half of its rows, the mean over those) or ``label`` (one label of each
    step altered)."""
    b, dev = p.batch, p.device
    store = getattr(torch, p.cfg["dtype"])
    gen = seeds.draw_generator(seed, 0, dev)
    params = {k: v.clone().requires_grad_() for k, v in
              cast(params0, dtype).items()}
    teacher = cast(p.teacher, dtype) if p.teacher is not None else None
    buf = {k: torch.zeros_like(v) for k, v in params.items()}
    lr = float(p.workload["lr"])
    losses, first = [], None
    for s in range(steps):
        u8 = rows_u8[s * b:(s + 1) * b].to(dev)
        y = labels[s * b:(s + 1) * b].to(dev).long()
        flip, masks = draws(p, gen, b)
        x = preprocess(u8, p.cfg, flip, dtype)
        if fault == "half_batch":
            h = b // 2
            x, y, masks = x[:h], y[:h], [m[:h] for m in masks]
        elif fault == "label":
            y = y.clone()
            y[0] = (y[0] + 1) % int(p.cfg["classes_per_task"])
        elif fault is not None:
            raise ValueError(f"unknown fault {fault!r}")
        loss = loss_of(p, params, x, y, masks or None, teacher)
        grads = torch.autograd.grad(loss, list(params.values()))
        with torch.no_grad():
            for (k, v), g in zip(list(params.items()), grads):
                buf[k].mul_(MOMENTUM).add_(g)
                # the parameters are kept in the configuration's precision
                params[k] = (v - lr * buf[k]).to(store).to(
                    dtype).requires_grad_()
        losses.append(float(loss.detach()))
        if first is None:
            first = {k: g.detach().clone() for k, g in zip(params, grads)}
    return losses, first, {k: v.detach() for k, v in params.items()}


def eval_counts(p: Problem, params: dict, images: torch.Tensor,
                labels: torch.Tensor, dtype) -> dict:
    """The val split's answers under ``params`` in ``dtype``: by class,
    rows, hits, and the rows without a decided answer (``AMBIGUOUS``)
    that the reference hits and misses; and the task logits of every row,
    on the host."""
    classes = int(p.cfg["classes_per_task"])
    params = cast({k: v.to(p.device) for k, v in params.items()}, dtype)
    out = {k: np.zeros(classes, np.int64)
           for k in ("rows", "hits", "open_hit", "open_miss")}
    parts = []
    b = int(p.workload["batch_size"])
    with torch.no_grad():
        for lo in range(0, int(images.shape[0]), b):
            u8 = images[lo:lo + b].to(p.device)
            y = labels[lo:lo + b].to(p.device).long()
            x = preprocess(u8, p.cfg, None, dtype)
            logits = net.head_logits(params, net.features(p.cfg, params, x),
                                     p.task)
            parts.append(logits.cpu())
            top = logits.topk(2, dim=-1)
            hit = top.indices[:, 0] == y
            open_ = (top.values[:, 0] - top.values[:, 1]
                     <= AMBIGUOUS * logits.abs().max(-1).values)
            for key, mask in (("rows", torch.ones_like(hit)),
                              ("hits", hit), ("open_hit", open_ & hit),
                              ("open_miss", open_ & ~hit)):
                out[key] += torch.bincount(y[mask], minlength=classes
                                           ).cpu().numpy()
    out["logits"] = torch.cat(parts)
    return out
