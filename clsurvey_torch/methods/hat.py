"""HAT — Hard Attention to the Task
(ref:src/methods/HAT/{approaches/hat.py, HAT_utils.py, networks/vgg_hat.py},
wrapper ref:src/methods/method.py:600-627).

Counterpart of ``clsurvey_tpu/methods/hat.py``: :class:`HATVGG` for the VGG
family and :class:`HATAlexNet` for an AlexNet model name
(:func:`make_hat_model`). Per-layer task
embeddings ``e_t`` gate every conv and FC output with ``m = sigmoid(s *
e_t)``; ``s`` anneals from ``1/smax`` to ``smax`` across each epoch's
batches; the loss adds the sparsity term ``c * sum(m * (1 - m_prev)) /
sum(1 - m_prev)``; gradients of weights that earlier tasks use are blocked
by ``mask_back = 1 - a^{<t}``; embedding gradients are cosh-compensated and
clipped, and the embeddings clamped to +-6 after each step. HAT keeps its
own controller (:func:`hat_train_task`: patience 10, lr/3 at half patience,
warm-up at lr 0.01 with lambda 0 on task 1, the min-epoch guard and the
divergence containment), not the engine's x0.1-at-5 schedule.

On the card:

- every ``'M'`` of :class:`HATVGG` is ``ops.pool.pool2x2`` (kernels B1 and
  B2); :class:`HATAlexNet` pools with ``F.max_pool2d(3, 2)``, as the JAX
  package pools it with flax's ``max_pool``; kernel A preprocesses, with
  flips in training and without in eval;
- a step is a Python function over the weights, as in ``engine/train.py``:
  the gradient processing (weight decay, cosh compensation, per-leaf norm
  clipping, ``mask_back``, the head select), momentum, update and clamp are
  multi-tensor ``torch._foreach_*`` calls over the ~26 leaves, and nothing
  is read back inside a step; ``s`` and ``smax / s`` are host floats
  computed in float32 from the step index, as the JAX package computes
  them on the device;
- ``compute_mask_pre`` takes the previous tasks' gates straight from the
  embeddings (the JAX package runs a forward pass on zeros for them: the
  same values).

In ``finetune_mode`` (Phase 1) the gates are all ones, so autograd gives
no gradient for the embeddings; it is taken as zero, as JAX's is, and the
embeddings still go through momentum, update and clamp. Batch-norm is
ignored on ``_BN`` names, as in the JAX package; dropout (``_DROP``) keep
masks are drawn from the epoch's generator, like the flips
(:meth:`HATEngine.draw`, which tests replace with the JAX run's draws).

On disk the weights keep the JAX package's flat HAT layout
(``models/convert.py``), so either package evaluates or continues the
other's models and epoch checkpoints."""

from __future__ import annotations

import os
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Sequence

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.func import functional_call

from clsurvey_torch.engine.train import (
    _resident, tree_leaves, tree_unflatten, tree_zeros_like,
    trainable_from_host, trainable_to_host)
from clsurvey_torch.methods import common
from clsurvey_torch.methods.base import Category, Method
from clsurvey_torch.models import heads as heads_lib
from clsurvey_torch.models.backbones import (
    ALEX_CONVS, ALEX_FC, ALEX_POOL_AFTER, DROPOUT_RATE, VGG_CFG, _cast,
    alexnet_smid)
from clsurvey_torch.models.convert import (
    hat_params_from_jax, hat_params_to_jax)
from clsurvey_torch.ops import preprocess as pp
from clsurvey_torch.ops.conv import conv2d
from clsurvey_torch.ops.pool import pool2x2
from clsurvey_torch.utils import device as device_lib
from clsurvey_torch.utils import io, rng as rng_lib
from clsurvey_torch.utils.paths import BEST_MODEL_FILENAME, EPOCH_CKPT_FILENAME

THRES_COSH = 50.0
THRES_EMB = 6.0
CLIPGRAD = 10000.0


class _Gated(nn.Module):
    """What the gated backbones share: the embedding names in gate order,
    the gate, and the JAX package's init. A subclass sets ``n_conv``,
    ``fc_dims``, ``cfg_name`` and the layers ``conv_<i>`` / ``emb_conv_<i>``
    / ``fc_<j>`` / ``emb_fc_<j>``."""

    @property
    def emb_names(self) -> list[str]:
        """Gate order: conv layers, then the trunk."""
        return ([f"emb_conv_{i}" for i in range(self.n_conv)]
                + [f"emb_fc_{j}" for j in range(len(self.fc_dims))])

    def reset_parameters(self, generator: torch.Generator | None = None):
        """The JAX package's init: kaiming-normal (fan_out) convs, N(0, 0.01)
        linears (kaiming for tiny_CNN), zero biases, and embeddings from
        uniform(0, 2), so every gate starts open (ref:vgg_hat.py:75-80)."""
        with torch.no_grad():
            for i in range(self.n_conv):
                conv = getattr(self, f"conv_{i}")
                fan_out = conv.out_channels * conv.kernel_size[0] \
                    * conv.kernel_size[1]
                conv.weight.normal_(0.0, (2.0 / fan_out) ** 0.5,
                                    generator=generator)
                conv.bias.zero_()
            for j, d in enumerate(self.fc_dims):
                fc = getattr(self, f"fc_{j}")
                std = (2.0 / d) ** 0.5 if self.cfg_name == "tiny_CNN" else 0.01
                fc.weight.normal_(0.0, std, generator=generator)
                fc.bias.zero_()
            for name in self.emb_names:
                getattr(self, name).uniform_(0.0, 2.0, generator=generator)

    def _gate(self, name: str, task: int, s: float, ones: bool):
        gate = torch.sigmoid(s * getattr(self, name)[task])
        return torch.ones_like(gate) if ones else gate


class HATVGG(_Gated):
    """VGG backbone with per-layer task-embedding gates. ``forward``
    returns (float32 features, gates): the gate vectors of the requested
    task, conv layers first, then the trunk's (ref:vgg_hat.py:90-127).
    Conv ``i`` is the ``i``-th conv (not its cfg index), the JAX package's
    HAT naming. Order per layer: conv, ReLU, gate; the next ``'M'`` pools
    the gated activation."""

    def __init__(self, cfg_name: str, classifier_dims: Sequence[int],
                 n_tasks: int, input_size: Sequence[int],
                 dropout: bool = False, dtype=torch.float32):
        super().__init__()
        self.cfg_name = cfg_name
        self.cfg = VGG_CFG[cfg_name]
        self.dtype = dtype
        self.dropout = dropout
        cin, (h, w) = 3, input_size
        self.n_conv = 0
        for v in self.cfg:
            if v == "M":
                h, w = h // 2, w // 2
                continue
            i = self.n_conv
            setattr(self, f"conv_{i}", nn.Conv2d(cin, int(v), 3, padding=1))
            setattr(self, f"emb_conv_{i}",
                    nn.Parameter(torch.empty(n_tasks, int(v))))
            cin, self.n_conv = int(v), i + 1
        self.smid_hw = (h, w)  # spatial dims at the conv->fc boundary
        self.fc_dims = tuple(int(d) for d in classifier_dims)
        fan_in = cin * h * w
        for j, d in enumerate(self.fc_dims):
            setattr(self, f"fc_{j}", nn.Linear(fan_in, d))
            setattr(self, f"emb_fc_{j}", nn.Parameter(torch.empty(n_tasks, d)))
            fan_in = d
        self.feature_dim = self.fc_dims[-1]
        # dropout follows each trunk layer: masks of the layers' widths
        self.drop_dims = self.fc_dims
        self.reset_parameters()

    def forward(self, x: torch.Tensor, task: int, s: float,
                train: bool = False, ones_gates: bool = False,
                dropout_masks=None):
        dt = self.dtype
        gates = []
        x = x.permute(0, 3, 1, 2)  # NCHW view of NHWC: channels_last
        i = 0
        for v in self.cfg:
            if v == "M":
                x = pool2x2(x.permute(0, 2, 3, 1).contiguous()
                            ).permute(0, 3, 1, 2)
                continue
            conv = getattr(self, f"conv_{i}")
            x = torch.relu(conv2d(_cast(x, dt), _cast(conv.weight, dt),
                                  _cast(conv.bias, dt), padding=1))
            gate = self._gate(f"emb_conv_{i}", task, s, ones_gates)
            gates.append(gate)
            x = x * gate.view(1, -1, 1, 1).to(x.dtype)
            i += 1
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)  # NHWC flatten
        drop = train and self.dropout
        if drop and (dropout_masks is None
                     or len(dropout_masks) != len(self.fc_dims)):
            raise ValueError("a train-mode forward of a dropout model needs "
                             "one keep-mask per trunk layer")
        for j in range(len(self.fc_dims)):
            fc = getattr(self, f"fc_{j}")
            x = torch.relu(F.linear(_cast(x, dt), _cast(fc.weight, dt),
                                    _cast(fc.bias, dt)))
            if drop:
                x = x * (dropout_masks[j].to(x.dtype)
                         * (1.0 / (1.0 - DROPOUT_RATE)))
            gate = self._gate(f"emb_fc_{j}", task, s, ones_gates)
            gates.append(gate)
            x = x * gate.to(x.dtype)
        return x.to(torch.float32), gates


class HATAlexNet(_Gated):
    """AlexNet with per-layer task-embedding gates (ref:src/methods/HAT/
    networks/alexnet_hat.py; the JAX package's ``HATAlexNet``). Per conv:
    conv, ReLU, the 3x3/2 pool after convs 0, 1 and 4, then the gate; per
    FC layer: dropout, FC, ReLU, gate (AlexNet's dropout-first order), so
    the keep-masks have the FC layers' input widths (``drop_dims``).
    ``smid_hw`` (``alexnet_smid``) drives ``compute_mask_back``'s NHWC
    tiling of ``fc_0``; the names follow HATVGG's scheme, so the mask
    functions and ``models/convert.py``'s HAT layout apply unchanged."""

    def __init__(self, n_tasks: int, input_size: Sequence[int],
                 dtype=torch.float32):
        super().__init__()
        self.cfg_name = "alexnet"
        self.dtype = dtype
        self.dropout = True
        cin = 3
        for i, (f, k, st, p) in enumerate(ALEX_CONVS):
            setattr(self, f"conv_{i}", nn.Conv2d(cin, f, k, stride=st,
                                                 padding=p))
            setattr(self, f"emb_conv_{i}",
                    nn.Parameter(torch.empty(n_tasks, f)))
            cin = f
        self.n_conv = len(ALEX_CONVS)
        self.smid_hw = tuple(alexnet_smid(int(n)) for n in input_size)
        flat = cin * self.smid_hw[0] * self.smid_hw[1]
        self.fc_dims = (ALEX_FC, ALEX_FC)
        for j, fan_in in enumerate((flat, ALEX_FC)):
            setattr(self, f"fc_{j}", nn.Linear(fan_in, ALEX_FC))
            setattr(self, f"emb_fc_{j}",
                    nn.Parameter(torch.empty(n_tasks, ALEX_FC)))
        self.feature_dim = ALEX_FC
        self.drop_dims = (flat, ALEX_FC)
        self.reset_parameters()

    def forward(self, x: torch.Tensor, task: int, s: float,
                train: bool = False, ones_gates: bool = False,
                dropout_masks=None):
        dt = self.dtype
        gates = []
        x = x.permute(0, 3, 1, 2)  # NCHW view of NHWC: channels_last
        for i, (_, _, st, p) in enumerate(ALEX_CONVS):
            conv = getattr(self, f"conv_{i}")
            x = torch.relu(conv2d(_cast(x, dt), _cast(conv.weight, dt),
                                  _cast(conv.bias, dt), stride=st,
                                  padding=p))
            if i in ALEX_POOL_AFTER:
                x = F.max_pool2d(x, 3, 2)
            gate = self._gate(f"emb_conv_{i}", task, s, ones_gates)
            gates.append(gate)
            x = x * gate.view(1, -1, 1, 1).to(x.dtype)
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)  # NHWC flatten
        if train and (dropout_masks is None or len(dropout_masks) != 2):
            raise ValueError("a train-mode forward of HAT's AlexNet needs "
                             "one keep-mask per FC layer")
        for j in range(2):
            if train:
                x = x * (dropout_masks[j].to(x.dtype)
                         * (1.0 / (1.0 - DROPOUT_RATE)))
            fc = getattr(self, f"fc_{j}")
            x = torch.relu(F.linear(_cast(x, dt), _cast(fc.weight, dt),
                                    _cast(fc.bias, dt)))
            gate = self._gate(f"emb_fc_{j}", task, s, ones_gates)
            gates.append(gate)
            x = x * gate.to(x.dtype)
        return x.to(torch.float32), gates


def make_hat_model(spec, n_tasks: int) -> HATVGG | HATAlexNet:
    """The gated backbone of ``spec``: HATAlexNet for AlexNet, else
    HATVGG."""
    if spec.arch == "alexnet":
        return HATAlexNet(n_tasks, spec.input_size, dtype=spec.compute_dtype)
    return HATVGG(spec.arch, spec.classifier_dims, n_tasks, spec.input_size,
                  dropout=spec.dropout, dtype=spec.compute_dtype)


def compute_mask_pre(params: dict, emb_names: list, task: int,
                     smax: float):
    """a^{<t}: per layer, the elementwise max over the previous tasks of
    ``sigmoid(smax * e_t)`` (ref:hat.py:57-89 ``init_masks``); None at the
    first task."""
    if task == 0:
        return None
    with torch.no_grad():
        return [torch.sigmoid(smax * params[n][:task]).amax(0)
                for n in emb_names]


def compute_mask_back(net: HATVGG, params: dict, mask_pre) -> dict:
    """``1 - get_view_for(a^{<t})`` per weight (ref:vgg_hat.py:258-295):
    conv ``i``'s weight gets ``1 - min(post_i, pre_{i-1})`` (conv 0 ``1 -
    post_0``), its bias ``1 - post_i``; ``fc_0``'s "pre" is the last conv's
    mask tiled over the ``smid_h * smid_w`` positions, channels fastest
    (the NHWC flatten). Embeddings get ones: they are never blocked. All
    ones without previous tasks."""
    with torch.no_grad():
        if mask_pre is None:
            return {n: torch.ones_like(p) for n, p in params.items()}
        conv, fcs = mask_pre[:net.n_conv], mask_pre[net.n_conv:]
        out = {}
        for name, p in params.items():
            if name.startswith("emb_"):
                out[name] = torch.ones_like(p)
                continue
            layer, leaf = name.split(".")
            kind, idx = layer.split("_")
            idx = int(idx)
            post = (conv if kind == "conv" else fcs)[idx]
            if leaf == "bias":
                out[name] = 1.0 - post
                continue
            if kind == "conv":
                pre = conv[idx - 1] if idx else torch.ones_like(p[0, :, 0, 0])
                view = torch.minimum(post.view(-1, 1, 1, 1),
                                     pre.view(1, -1, 1, 1))
                out[name] = (1.0 - view.expand(p.shape)).contiguous(
                    memory_format=torch.channels_last)
            else:
                pre = (conv[-1].repeat(net.smid_hw[0] * net.smid_hw[1])
                       if idx == 0 else fcs[idx - 1])
                out[name] = 1.0 - torch.minimum(post.view(-1, 1),
                                                pre.view(1, -1))
        return out


def capacity_report(params: dict, task: int, smax: float,
                    mask_back: dict | None = None, log=print) -> dict:
    """Per-layer gate and capacity summary (ref:vgg_hat.py:129-256
    premask_summary + backmask_summary): embedding mean and std, saturated
    gates (< 0.1 / > 0.9) of the current task, and with ``mask_back`` the
    % of each layer's weights still trainable. The same keys and numpy
    arithmetic as the JAX package's."""
    report = {}
    log("=" * 70)
    log(f"Task {task}: HAT CAPACITY SUMMARY (smax={smax})")
    for name in sorted(n for n in params if n.startswith("emb_")):
        emb = params[name][task].detach().cpu().numpy()
        gates = 1.0 / (1.0 + np.exp(-smax * emb))
        stats = {"emb_mean": float(emb.mean()), "emb_std": float(emb.std()),
                 "gates_off": int((gates < 0.1).sum()),
                 "gates_on": int((gates > 0.9).sum()), "units": emb.size}
        report[name] = stats
        log(f"  {name}: u={stats['emb_mean']:.4f} std={stats['emb_std']:.4f}"
            f" gates<0.1: {stats['gates_off']}/{stats['units']}"
            f" gates>0.9: {stats['gates_on']}/{stats['units']}")
    if mask_back is not None:
        caps = []
        for name, m in mask_back.items():
            if not name.endswith(".weight"):
                continue
            cap = 100.0 * float(m.double().mean())
            caps.append(cap)
            report[f"capacity_left/{name[:-len('.weight')]}"] = cap
            log(f"  capacity left {name[:-len('.weight')]}: {cap:.1f}%")
        if caps:
            report["capacity_left/avg"] = float(np.mean(caps))
            log(f"  capacity left avg: {np.mean(caps):.1f}%")
    log("=" * 70)
    return report


def sparsity_reg(masks, mask_pre):
    """ref:hat.py:285-299."""
    if mask_pre is None:
        return sum(m.sum() for m in masks) / sum(m.numel() for m in masks)
    num = sum((m * (1 - mp)).sum() for m, mp in zip(masks, mask_pre))
    den = sum((1 - mp).sum() for mp in mask_pre)
    return num / torch.clamp(den, min=1e-8)


def anneal_s(smax: float, step: int, steps: int) -> float:
    """The step's ``s``: ``(smax - 1/smax) * step / max(steps - 1, 1) +
    1/smax`` in float32, as the JAX package computes it (ref:hat.py:
    216-219)."""
    progress = np.float32(step) / np.float32(max(steps - 1, 1))
    return float(np.float32(smax - 1 / smax) * progress
                 + np.float32(1 / smax))


# ---------------------------------------------------------------------------
# HAT engine: its own step, epoch and eval, like the reference's Appr
# ---------------------------------------------------------------------------

class HATEngine:
    def __init__(self, net: HATVGG, spec, task: int, class_counts, mean, std,
                 smax: float, mask_pre, mask_back, momentum: float = 0.9,
                 weight_decay: float = 0.0, finetune_mode: bool = False,
                 augment: bool = True, device="cuda"):
        self.net = net
        self.spec = spec
        self.task = task
        self.class_counts = np.asarray(class_counts, np.int32)
        self.mean, self.std = tuple(mean), tuple(std)
        self.smax = float(smax)
        self.mask_pre = mask_pre
        self.mask_back = mask_back
        self.momentum = momentum
        self.weight_decay = weight_decay
        self.finetune_mode = finetune_mode
        self.augment = augment
        self.device = device_lib.resolve(device)

    def bank(self, trainable) -> dict:
        return {"kernel": trainable["heads"]["kernel"],
                "bias": trainable["heads"]["bias"],
                "class_counts": self.class_counts}

    def draw(self, gen, batch_size: int):
        """(flip mask, dropout keep-masks) of one step, drawn on the device
        from the epoch's generator (None where unused)."""
        flip = (torch.randint(0, 2, (batch_size,), dtype=torch.uint8,
                              device=self.device, generator=gen)
                if self.augment else None)
        drop = ([torch.randint(0, 2, (batch_size, d), dtype=torch.uint8,
                               device=self.device, generator=gen)
                 for d in self.net.drop_dims] if self.spec.uses_dropout
                else None)
        return flip, drop

    def grads(self, trainable, x_u8, y, s: float, lamb: float, flip=None,
              dropout_masks=None):
        """The processed gradient of one batch (ref:hat.py:225-239, order
        of ``clsurvey_tpu``'s step): weight decay on non-embedding leaves;
        outside ``finetune_mode`` the embeddings' cosh compensation
        ``(smax/s) (cosh(clip(s p, +-50)) + 1) / (cosh(p) + 1)`` and every
        params leaf clipped to norm 1e4; ``mask_back`` at task > 0 in both
        modes; only the current task's head. Returns (grads, metrics)."""
        x = pp.preprocess(x_u8, self.mean, self.std,
                          flip if self.augment else None,
                          dtype=self.spec.compute_dtype)
        params = trainable["params"]
        feats, gates = functional_call(
            self.net, params, (x, self.task, s),
            {"train": True, "ones_gates": self.finetune_mode,
             "dropout_masks": dropout_masks})
        logits = heads_lib.forward(self.bank(trainable), feats, self.task)
        ce = F.cross_entropy(logits, y)
        loss = ce if self.finetune_mode else \
            ce + lamb * sparsity_reg(gates, self.mask_pre)
        names = list(params)
        leaves = [params[n] for n in names]
        heads = [trainable["heads"]["kernel"], trainable["heads"]["bias"]]
        raw = torch.autograd.grad(loss, leaves + heads, allow_unused=True)
        with torch.no_grad():
            # unused embeddings (all-ones gates): JAX's gradient is zero
            g = [torch.zeros_like(p) if r is None else r
                 for r, p in zip(raw, leaves + heads)]
            gp, gh = g[:len(names)], g[len(names):]
            emb = [i for i, n in enumerate(names) if n.startswith("emb_")]
            rest = [i for i in range(len(names)) if i not in emb]
            if self.weight_decay:
                decayed = torch._foreach_add(
                    [gp[i] for i in rest],
                    torch._foreach_mul([leaves[i] for i in rest],
                                       self.weight_decay))
                for i, d in zip(rest, decayed):
                    gp[i] = d
            if not self.finetune_mode:
                pe = [leaves[i] for i in emb]
                num = torch._foreach_mul(pe, s)
                torch._foreach_clamp_min_(num, -THRES_COSH)
                torch._foreach_clamp_max_(num, THRES_COSH)
                num = torch._foreach_cosh(num)
                torch._foreach_add_(num, 1.0)
                den = torch._foreach_cosh(pe)
                torch._foreach_add_(den, 1.0)
                ge = torch._foreach_mul([gp[i] for i in emb],
                                        float(np.float32(self.smax)
                                              / np.float32(s)))
                torch._foreach_mul_(ge, num)
                torch._foreach_div_(ge, den)
                for i, e in zip(emb, ge):
                    gp[i] = e
                norms = torch.stack(torch._foreach_norm(gp))
                factor = torch.clamp(
                    CLIPGRAD / torch.clamp(norms, min=1e-12), max=1.0)
                gp = torch._foreach_mul(gp, list(factor.unbind()))
            if self.task > 0 and self.mask_back is not None:
                gp = torch._foreach_mul(gp, [self.mask_back[n] for n in names])
            heads_g = common.current_task_head_grads(
                {"kernel": gh[0], "bias": gh[1]}, self.task)
            acc = (logits.argmax(-1) == y).to(torch.float32).mean()
        return ({"params": dict(zip(names, gp)), "heads": heads_g},
                {"loss": ce.detach(), "acc": acc})

    def train_step(self, state, x_u8, y, lr: float, s: float, lamb: float,
                   flip=None, dropout_masks=None):
        """SGD with momentum over params and heads (``b = m b + g``, ``p -=
        lr b``), then the embeddings clamped to +-6. ``state`` is
        (trainable, momentum); the momentum is updated in place."""
        trainable, momentum = state
        grads, metrics = self.grads(trainable, x_u8, y, s, lamb, flip,
                                    dropout_masks)
        with torch.no_grad():
            # leaves by the trainable's names: a resumed momentum tree may
            # list them in another order
            bufs = _leaves(momentum, trainable)
            torch._foreach_mul_(bufs, self.momentum)
            torch._foreach_add_(bufs, _leaves(grads, trainable))
            new = torch._foreach_sub(tree_leaves(trainable),
                                     torch._foreach_mul(bufs, lr))
            new_tr = tree_unflatten(trainable, new)
            embs = [p for n, p in new_tr["params"].items()
                    if n.startswith("emb_")]
            torch._foreach_clamp_min_(embs, -THRES_EMB)
            torch._foreach_clamp_max_(embs, THRES_EMB)
        for leaf in new:
            leaf.requires_grad_()
        return (new_tr, momentum), metrics

    def train_epoch(self, state, images, labels, perm, gen, lr: float,
                    lamb: float, batch_size: int):
        """One epoch over ``perm`` (truncated to whole batches), ``s``
        annealed across its steps; the metrics are the means of the
        per-step CE and accuracy, left on the device."""
        n = int(perm.shape[0])
        bsz = min(int(batch_size), n)
        steps = n // bsz
        perm = torch.as_tensor(perm)[: steps * bsz].to(self.device)
        per_step: dict = {"loss": [], "acc": []}
        for i in range(steps):
            idx = perm[i * bsz: (i + 1) * bsz]
            flip, drop = self.draw(gen, bsz)
            state, metrics = self.train_step(
                state, images.index_select(0, idx),
                labels.index_select(0, idx), lr,
                anneal_s(self.smax, i, steps), lamb, flip, drop)
            for k, v in metrics.items():
                per_step[k].append(v)
        return state, {k: torch.stack(v).mean() for k, v in per_step.items()}

    def evaluate(self, trainable, images, labels, batch_size: int) -> float:
        """Accuracy at ``s = smax`` (all-ones gates in ``finetune_mode``),
        float32 preprocess without flips; one read-back."""
        n = int(images.shape[0])
        bsz = min(int(batch_size), n)
        labels = torch.as_tensor(labels).to(self.device).long()
        hits = torch.zeros((), device=self.device)
        with torch.no_grad():
            for lo in range(0, n, bsz):
                x = pp.preprocess(images[lo: lo + bsz], self.mean, self.std)
                feats, _ = functional_call(
                    self.net, trainable["params"], (x, self.task, self.smax),
                    {"ones_gates": self.finetune_mode})
                logits = heads_lib.forward(self.bank(trainable), feats,
                                           self.task)
                hits += (logits.argmax(-1) == labels[lo: lo + bsz]).sum()
        return float(hits) / n


def _leaves(tree: dict, like: dict) -> list:
    """``tree``'s leaves in the order of ``like``'s (params, then heads)."""
    return ([tree["params"][n] for n in like["params"]]
            + [tree["heads"][k] for k in like["heads"]])


def hat_to_host(tree: dict) -> dict:
    """A trainable-shaped tree (weights or momentum) in HAT's JAX layout."""
    return trainable_to_host(tree, hat_params_to_jax)


def hat_from_host(tree: dict, device, requires_grad: bool) -> dict:
    return trainable_from_host(tree, device, requires_grad,
                               hat_params_from_jax)


def hat_train_task(engine: HATEngine, exp_dir: str, trainable, task_data,
                   nepochs: int, batch_size: int, lr: float, lamb: float,
                   seed: int = 7, lr_patience: int = 10,
                   lr_factor: float = 3.0, warmup: bool = False,
                   warmup_lr: float = 0.01, warmup_epochs: int = 10,
                   min_epochs: int = 0, save_models: bool = True,
                   log=print):
    """The reference's ``Appr.train`` controller (ref:hat.py:96-199) with
    epoch-checkpoint resume (ref:hat.py:100-121), decision for decision the
    JAX package's: the warm-up exits after epoch ``warmup_epochs`` (so at
    ``warmup_epochs + 1`` epochs); a loss that is not finite or above ``2 *
    best + 2`` restores the best weights (else the task-start ones), zeroes
    the momentum and cuts the lr, which also caps the lr at warm-up exit.
    The epoch's permutation and flips come from generators seeded with
    (seed, epoch). Returns (best model in the JAX layout, best val acc)."""
    os.makedirs(exp_dir, exist_ok=True)
    device = engine.device
    train_images = _resident(task_data.train.images, "train", device)
    train_labels = _resident(task_data.train.labels, "train labels",
                             device).long()
    val_images = _resident(task_data.val.images, "val", device)
    val_labels = _resident(task_data.val.labels, "val labels", device).long()
    n_train = int(train_images.shape[0])
    bsz = min(batch_size, n_train)

    # finite task-start snapshot: the fallback for runs that never improve
    task_start = hat_to_host(trainable)
    state = (trainable, tree_zeros_like(trainable))
    patience = lr_patience
    cur_lr = warmup_lr if warmup else lr
    best_acc, best_model = 0.0, None
    in_warmup = warmup
    start_epoch = 0
    ckpt_path = os.path.join(exp_dir, EPOCH_CKPT_FILENAME)
    if save_models and io.exists(ckpt_path):
        ck = io.load(ckpt_path)
        if (abs(ck.get("smax", engine.smax) - engine.smax) < 1e-6
                and abs(ck.get("lamb", lamb) - lamb) < 1e-6):
            state = (hat_from_host(ck["trainable"], device, True),
                     hat_from_host(ck["momentum"], device, False))
            start_epoch = ck["epoch"] + 1
            cur_lr, patience = ck["lr"], ck["patience"]
            best_acc, in_warmup = ck["best_acc"], ck["warmup"]
            best_path = os.path.join(exp_dir, BEST_MODEL_FILENAME)
            if io.exists(best_path):
                best_model = io.load(best_path)
            log(f"HAT resumed epoch {start_epoch} lr={cur_lr:g}")
    best_loss = float("inf")
    contained_lr_cap = lr  # lowered whenever divergence containment fires
    for e in range(start_epoch, nepochs):
        cur_lamb = 0.0 if in_warmup else lamb
        perm = torch.randperm(n_train, generator=rng_lib.generator(seed, e))
        perm = perm[: (n_train // bsz) * bsz]
        gen = rng_lib.generator(seed, e, 1, device=device)
        state, metrics = engine.train_epoch(
            state, train_images, train_labels, perm, gen, cur_lr, cur_lamb,
            bsz)
        val_acc = engine.evaluate(state[0], val_images, val_labels, bsz)
        train_loss = float(metrics["loss"])
        log(f"HAT epoch {e}: loss={train_loss:.4f} "
            f"val={val_acc:.4f} lr={cur_lr:g} lamb={cur_lamb}")
        diverged = (not np.isfinite(train_loss)
                    or train_loss > 2.0 * best_loss + 2.0)
        if diverged:
            # a diverged state would poison this and every later task (a
            # loss jump slams embeddings to the +-6 clamp, closing gates
            # for good): restore the last good weights, cut the lr
            cur_lr /= lr_factor
            if cur_lr < 1e-5:
                log("diverged below lr floor — stopping")
                break
            contained_lr_cap = cur_lr
            restore = best_model if best_model is not None else task_start
            restored = hat_from_host(restore, device, True)
            state = (restored, tree_zeros_like(restored))
            patience = lr_patience
            log(f"diverged — restored best weights, lr={cur_lr:g}")
        else:
            best_loss = min(best_loss, train_loss)
            if val_acc > best_acc:
                best_acc = val_acc
                best_model = hat_to_host(state[0])
                patience = lr_patience
                if save_models:
                    io.save(best_model, os.path.join(exp_dir,
                                                     BEST_MODEL_FILENAME))
            elif not in_warmup:
                patience -= 1
                if patience == lr_patience // 2:
                    cur_lr /= lr_factor
                elif patience <= 0 and e >= min_epochs:
                    break  # before min_epochs: the first task's guard
        if in_warmup and e >= warmup_epochs:
            # the warm-up exit must not undo a containment cut
            in_warmup = False
            patience = lr_patience
            cur_lr = min(lr, contained_lr_cap)
        if save_models and (e % 5 == 0 or e == nepochs - 1):
            io.save({"epoch": e, "lr": cur_lr, "patience": patience,
                     "best_acc": best_acc, "warmup": in_warmup,
                     "smax": engine.smax, "lamb": lamb,
                     "trainable": hat_to_host(state[0]),
                     "momentum": hat_to_host(state[1])}, ckpt_path)
    if best_model is None:
        best_model = task_start
    return best_model, best_acc


# ---------------------------------------------------------------------------
# Method
# ---------------------------------------------------------------------------

@dataclass
class HAT(Method):
    name: str = "HAT"
    category: Category = Category.MASK_BASED
    start_scratch: bool = True
    hyperparams: "OrderedDict[str, float]" = field(
        default_factory=lambda: OrderedDict({"smax": 800, "c": 2.5}))
    # the reference's Appr hard-codes SGD momentum 0.9 (ref:src/methods/
    # HAT/approaches/hat.py:21, HAT_utils.py:233-245)
    momentum: float = 0.9

    def _net(self, manager) -> HATVGG:
        return make_hat_model(manager.model_spec, manager.max_tasks)

    def _load_or_init(self, manager) -> dict:
        """The previous task's HAT model, or at task 1 a fresh one: weights
        and embeddings from (seed, 0), the head bank from (seed, 5)."""
        path = manager.previous_task_model_path
        prev = io.load(path) if path and io.exists(path) else None
        if prev is not None and prev.get("meta", {}).get("hat"):
            return prev
        seed = manager.args.seed
        net = self._net(manager)
        net.reset_parameters(rng_lib.generator(seed, 0))
        seq = manager.dataset
        counts = np.zeros(manager.max_tasks, np.int32)
        counts[: seq.task_count] = seq.class_count_list()
        bank = heads_lib.init_head_bank(
            rng_lib.generator(seed, 5), manager.max_tasks, net.feature_dim,
            int(counts.max()), counts)
        return {"params": hat_params_to_jax(dict(net.named_parameters())),
                "batch_stats": {},
                "heads": io.to_host({"kernel": bank["kernel"],
                                     "bias": bank["bias"],
                                     "class_counts": counts}),
                "meta": {"hat": True}}

    def _run(self, manager, lr, smax, lamb, exp_dir, finetune_mode, seed,
             num_epochs):
        args = manager.args
        t = manager.task_counter - 1
        device = device_lib.resolve(args.device)
        model = self._load_or_init(manager)
        net = self._net(manager)
        params = hat_params_from_jax(model["params"], device)
        # masks in BOTH modes: the reference's hat_finetune also blocks
        # the previous tasks' weights (HAT_utils.py:220-222)
        mask_pre = compute_mask_pre(params, net.emb_names, t, smax)
        mask_back = compute_mask_back(net, params, mask_pre)
        if not finetune_mode:
            capacity_report(params, t, smax, mask_back, log=manager.log)
        engine = HATEngine(
            net, manager.model_spec, t, model["heads"]["class_counts"],
            manager.dataset.mean, manager.dataset.std, smax, mask_pre,
            mask_back, momentum=self.momentum,
            weight_decay=args.weight_decay, finetune_mode=finetune_mode,
            augment=getattr(args, "augment", True), device=device)
        trainable = common.prepare_trainable(
            model, t, device, rng_lib.generator(seed, 17),
            convert=hat_params_from_jax)
        best_model, best_acc = hat_train_task(
            engine, exp_dir, trainable, manager.current_task_dataset,
            nepochs=num_epochs, batch_size=args.batch_size, lr=lr,
            lamb=lamb, seed=seed, warmup=(t == 0) and not finetune_mode,
            min_epochs=num_epochs // 2 if t == 0 else 0,
            save_models=args.save_models_mode, log=manager.log)
        out = {
            "params": best_model["params"],
            "batch_stats": {},
            "heads": {"kernel": best_model["heads"]["kernel"],
                      "bias": best_model["heads"]["bias"],
                      "class_counts": np.asarray(
                          model["heads"]["class_counts"])},
            "meta": {"hat": True, "smax": smax, "task": t},
        }
        io.save(out, os.path.join(exp_dir, BEST_MODEL_FILENAME))
        return out, best_acc

    def grid_train(self, args, manager, lr):
        """Phase 1: hat_finetune — all-ones gates, full capacity
        (ref:HAT/approaches/hat_finetune.py:26-33)."""
        return self._run(manager, lr, smax=float(self.hyperparams["smax"]),
                         lamb=0.0,
                         exp_dir=manager.extras["gridsearch_exp_dir"],
                         finetune_mode=True,
                         seed=manager.extras.get("grid_seed", 0),
                         num_epochs=args.num_epochs)

    def train(self, args, manager, hyperparams):
        return self._run(manager, manager.extras["lr"],
                         smax=float(hyperparams["smax"]),
                         lamb=float(hyperparams["c"]),
                         exp_dir=manager.extras["heuristic_exp_dir"],
                         finetune_mode=False, seed=args.seed,
                         num_epochs=args.num_epochs)

    def inference_eval(self, manager, model_path, ref_task, trained_idx):
        from clsurvey_torch.framework.evaluate import _eval_split

        model = io.load(model_path) if isinstance(model_path, str) \
            else model_path
        smax = float(model["meta"].get("smax", self.hyperparams["smax"]))
        device = device_lib.resolve(manager.args.device)
        engine = HATEngine(
            self._net(manager), manager.model_spec, ref_task - 1,
            model["heads"]["class_counts"], manager.dataset.mean,
            manager.dataset.std, smax, None, None, augment=False,
            device=device)
        split = _eval_split(manager, manager.dataset.get_task_dataset(
            ref_task))
        return engine.evaluate(
            hat_from_host(model, device, False),
            _resident(split.images, "eval", device), split.labels,
            manager.args.batch_size)
