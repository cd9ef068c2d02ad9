"""PathNet — evolutionary module-path selection
(ref:src/methods/HAT/approaches/pathnet.py, networks/vgg_pathnet.py,
wrapper ref:src/methods/method.py:559-597; exposed as ``pathnet``).

Counterpart of ``clsurvey_tpu/methods/pathnet.py``: :class:`PathNetVGG` for
the VGG family and, on an AlexNet model name, :class:`PathNetAlexNet`, the
reference's 5-layer AlexNet-budget PathNet. Each VGG conv / FC layer is
split into M modules of width ``out // M``; a path picks N modules per
layer and sums their outputs. A binary tournament evolves the path: each
candidate trains for a few epochs, the winner survives, and the loser
becomes a mutation of it (per gene, probability 1/(N L), ``+=
randint(-2, 2) mod M``, ref:pathnet.py:186-199). Modules on earlier tasks'
best paths are frozen; the others are re-initialised at task start from
the stored ``init_params`` (ref:pathnet.py:83-99).

- The N selected modules of a layer run as one conv (or linear layer)
  whose output channels are the modules' channels, module-major: the
  ``(M, out, in, kh, kw)`` bank indexed by the path is the OIHW weight.
  ReLU and the 2x2 max-pool are channelwise, so they run on the stacked
  channels, and the N groups are summed after the pool (max-then-sum is
  not sum-then-max). The bank is indexed by ``index_select``, whose
  backward adds the gradients of a module that the path repeats (N > M
  after the decay operator has grown N).
- The pool is ``F.max_pool2d``: the JAX package pools here with XLA's
  ``reduce_window``, not with its Pallas kernel (which takes 64 or 128
  channels; PathNet's are N * out // M). Kernel A preprocesses.
- The gradient gate is a hard select, ``where(gate > 0, g, 0)``: a NaN
  gradient times a 0-gate is NaN, and would poison the frozen modules.
- The evolution stays on the host in numpy: paths, mutations and winners
  come from ``np.random.default_rng(seed)`` as in the JAX package, so with
  the same accuracies the paths are the same. The epochs' permutations
  and flips come from torch generators seeded from ``seed``.
- Training uses batch 64 whatever ``--batch_size`` says, the tournament
  evaluates at batch 256 and ``inference_eval`` at ``--batch_size``. The
  NaN guard reads the device back once an epoch; the best state stays on
  the device as a clone.

On disk the weights keep the JAX package's flat PathNet layout
(``models/convert.py``), with the ``init_params`` tree beside them and the
best paths in ``method_aux``.

Data parallel (``parallel/mesh.py``, :class:`PathNetFns`' ``mesh``): the
batch of 64 rounds down to a multiple of the ranks (``clsurvey_tpu/
methods/pathnet.py:315-319, 483-487``), each step's draws are the global
batch's and each rank runs its rows; CE is the rank's share of the mean,
and the gradient is all-reduced before the module gate. The tournament's
evaluations round their batch down too, pad the last one to a multiple of
the ranks with rows of weight 0, and all-reduce the hits, so every rank
picks the same winners; the writer writes the files."""

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
    place, tree_leaves, tree_map, tree_unflatten, tree_zeros_like,
    trainable_from_host)
from clsurvey_torch.methods import common
from clsurvey_torch.methods.base import Category, Method
from clsurvey_torch.models import heads as heads_lib
from clsurvey_torch.models.backbones import VGG_CFG, _cast
from clsurvey_torch.models.convert import (
    pathnet_params_from_jax, pathnet_params_to_jax)
from clsurvey_torch.ops import preprocess as pp
from clsurvey_torch.ops.conv import conv2d
from clsurvey_torch.parallel import mesh as mesh_lib
from clsurvey_torch.utils import device as device_lib
from clsurvey_torch.utils import io, rng as rng_lib
from clsurvey_torch.utils.paths import BEST_MODEL_FILENAME

TRAIN_BATCH = 64  # ref:pathnet.py: hard-coded, whatever --batch_size says
TOURNAMENT_EVAL_BATCH = 256


class _ModuleBank(nn.Module):
    """M modules of one layer: ``weight`` (M, out, in[, kh, kw]) and
    ``bias`` (M, out)."""

    def __init__(self, m: int, out_w: int, in_w: int, k: int | None):
        super().__init__()
        shape = (m, out_w, in_w) + ((k, k) if k else ())
        self.weight = nn.Parameter(torch.empty(shape))
        self.bias = nn.Parameter(torch.zeros(m, out_w))


class PathNetVGG(nn.Module):
    """Stacked-module VGG; layer widths divided by M
    (ref:vgg_pathnet.py:36-90). ``forward(x, path)`` takes NHWC input and
    an (L, N) long tensor of module indices per layer."""

    def __init__(self, cfg_name: str, classifier_dims: Sequence[int],
                 input_size: Sequence[int], M: int, dtype=torch.float32):
        super().__init__()
        self.cfg_name = cfg_name
        self.cfg = VGG_CFG[cfg_name]
        self.M = int(M)
        self.dtype = dtype
        cin, (h, w) = 3, input_size
        self.n_convs = 0
        for v in self.cfg:
            if v == "M":
                h, w = h // 2, w // 2
                continue
            out_w = max(int(v) // self.M, 1)
            setattr(self, f"conv_{self.n_convs}",
                    _ModuleBank(self.M, out_w, cin, 3))
            cin, self.n_convs = out_w, self.n_convs + 1
        fan_in = cin * h * w
        self.fc_widths = []
        for j, d in enumerate(classifier_dims):
            out_w = max(int(d) // self.M, 1)
            setattr(self, f"fc_{j}", _ModuleBank(self.M, out_w, fan_in, None))
            self.fc_widths.append(out_w)
            fan_in = out_w
        self.n_layers = self.n_convs + len(self.fc_widths)
        self.feature_dim = self.fc_widths[-1]
        self.reset_parameters()

    def reset_parameters(self, generator: torch.Generator | None = None):
        """Each module initialised as a layer of its own (the fan is the
        module's, not the stack's): kaiming-normal (fan_out) convs, N(0,
        0.01) linears (kaiming for tiny_CNN), zero biases."""
        with torch.no_grad():
            for name, bank in self.named_children():
                out_w = bank.weight.shape[1]
                if name.startswith("conv_"):
                    std = (2.0 / (out_w * 9)) ** 0.5
                else:
                    std = ((2.0 / out_w) ** 0.5
                           if self.cfg_name == "tiny_CNN" else 0.01)
                bank.weight.normal_(0.0, std, generator=generator)
                bank.bias.zero_()

    def forward(self, x: torch.Tensor, path: torch.Tensor,
                train: bool = False, dropout_masks=None) -> torch.Tensor:
        """The VGG PathNet has no dropout: ``train`` and ``dropout_masks``
        are accepted for :class:`PathNetAlexNet`'s interface and unused."""
        x = x.permute(0, 3, 1, 2)  # NCHW view of NHWC: channels_last
        layer = 0
        for ci, v in enumerate(self.cfg):
            if v == "M":
                continue  # the pool of the conv before it
            pool = ci + 1 < len(self.cfg) and self.cfg[ci + 1] == "M"
            bank = getattr(self, f"conv_{layer}")
            x = module_conv(x, bank.weight, bank.bias, path[layer], pool,
                            self.dtype)
            layer += 1
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)  # NHWC flatten
        for j in range(len(self.fc_widths)):
            bank = getattr(self, f"fc_{j}")
            x = module_dense(x, bank.weight, bank.bias,
                             path[self.n_convs + j], self.dtype)
        return x.to(torch.float32)


def _drop(x, keep, rate: float):
    """Inverted dropout under a handed-in keep-mask, as the JAX package's
    ``where(keep, x / (1 - rate), 0)``."""
    return torch.where(keep, x / (1.0 - rate), torch.zeros((), dtype=x.dtype,
                                                           device=x.device))


def module_conv(x, weight, bias, sel, pool: bool, dtype=torch.float32,
                padding: int = 1, keep=None, rate: float = 0.0):
    """The modules ``sel`` of a conv bank as one conv (NCHW in and out; 3x3
    SAME for the VGG, unpadded for AlexNet's), then ReLU, dropout under
    ``keep`` (NHWC, over the stacked channels, as the JAX package draws
    it)[, 2x2 max-pool] and the sum over the N channel groups
    (ref:vgg_pathnet.py forward: ``sum_j maxpool(relu(conv_j(x)))``)."""
    n, out_w = sel.shape[0], weight.shape[1]
    k = weight.index_select(0, sel).reshape(n * out_w, *weight.shape[2:])
    b = bias.index_select(0, sel).reshape(n * out_w)
    x = torch.relu(conv2d(_cast(x, dtype), _cast(k, dtype), _cast(b, dtype),
                          padding=padding))
    if keep is not None:
        x = _drop(x, keep.permute(0, 3, 1, 2), rate)
    if pool:
        x = F.max_pool2d(x, 2, 2)
    return x.unflatten(1, (n, out_w)).sum(1)


def module_dense(x, weight, bias, sel, dtype=torch.float32, keep=None,
                 rate: float = 0.0):
    """The modules ``sel`` of a dense bank as one linear layer, ReLU,
    dropout under ``keep``, and the sum over the N groups."""
    n, out_w = sel.shape[0], weight.shape[1]
    k = weight.index_select(0, sel).reshape(n * out_w, weight.shape[2])
    b = bias.index_select(0, sel).reshape(n * out_w)
    x = torch.relu(F.linear(_cast(x, dtype), _cast(k, dtype), _cast(b, dtype)))
    if keep is not None:
        x = _drop(x, keep, rate)
    return x.unflatten(1, (n, out_w)).sum(1)


class PathNetAlexNet(nn.Module):
    """The reference's standalone 5-layer AlexNet-budget PathNet
    (ref:src/methods/HAT/networks/alexnet_pathnet.py; the JAX package's
    ``PathNetAlexNet``): 3 convs and 2 FC layers of M modules each, module
    widths ``int(0.258 * base)`` (16, 33, 66; 528, 528), unpadded kernels
    of ``px // 8``, ``px // 10`` and 2, a 2x2 max-pool after every conv,
    dropout 0.2, 0.2 and 0.5 on the convs' module outputs (before the pool)
    and 0.5 on the FC layers'. The keep-masks are handed in, one per layer:
    ``(B, H, W, N * width)`` NHWC for a conv, ``(B, N * width)`` for an FC
    layer (:meth:`drop_shapes`)."""

    EXPAND = 0.258
    CONV_DROP = (0.2, 0.2, 0.5)
    FC_DROP = 0.5

    def __init__(self, input_px: int, M: int, dtype=torch.float32):
        super().__init__()
        e, px = self.EXPAND, int(input_px)
        self.M = int(M)
        self.dtype = dtype
        widths = [int(e * 64), int(e * 128), int(e * 256)]
        self.ksizes = (px // 8, px // 10, 2)
        self.conv_hw = []  # each conv's output side, before its pool
        cin, h = 3, px
        for i, (out_w, k) in enumerate(zip(widths, self.ksizes)):
            setattr(self, f"conv_{i}", _ModuleBank(self.M, out_w, cin, k))
            h = h - k + 1
            self.conv_hw.append(h)
            cin, h = out_w, h // 2
        self.n_convs = 3
        fan_in = cin * h * h
        self.fc_widths = [int(e * 2048), int(e * 2048)]
        for j, out_w in enumerate(self.fc_widths):
            setattr(self, f"fc_{j}", _ModuleBank(self.M, out_w, fan_in, None))
            fan_in = out_w
        self.n_layers = 5
        self.feature_dim = self.fc_widths[-1]
        self.reset_parameters()

    def reset_parameters(self, generator: torch.Generator | None = None):
        """Each module as a layer of its own: kaiming-normal (fan_out)
        convs, N(0, 0.01) linears, zero biases."""
        with torch.no_grad():
            for name, bank in self.named_children():
                if name.startswith("conv_"):
                    out_w, k = bank.weight.shape[1], bank.weight.shape[-1]
                    std = (2.0 / (out_w * k * k)) ** 0.5
                else:
                    std = 0.01
                bank.weight.normal_(0.0, std, generator=generator)
                bank.bias.zero_()

    def drop_shapes(self, batch_size: int, n: int) -> list:
        """(shape, rate) of each layer's keep-mask for a path of ``n``
        modules a layer."""
        out = []
        for i, hw in enumerate(self.conv_hw):
            width = getattr(self, f"conv_{i}").weight.shape[1]
            out.append(((batch_size, hw, hw, n * width), self.CONV_DROP[i]))
        for width in self.fc_widths:
            out.append(((batch_size, n * width), self.FC_DROP))
        return out

    def forward(self, x: torch.Tensor, path: torch.Tensor,
                train: bool = False, dropout_masks=None) -> torch.Tensor:
        if train and (dropout_masks is None or len(dropout_masks) != 5):
            raise ValueError("a train-mode forward of the AlexNet PathNet "
                             "needs one keep-mask per layer")
        keep = dropout_masks if train else [None] * 5
        rates = self.CONV_DROP + (self.FC_DROP,) * 2
        x = x.permute(0, 3, 1, 2)  # NCHW view of NHWC: channels_last
        for i in range(self.n_convs):
            bank = getattr(self, f"conv_{i}")
            x = module_conv(x, bank.weight, bank.bias, path[i], True,
                            self.dtype, padding=0, keep=keep[i],
                            rate=rates[i])
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)  # NHWC flatten
        for j in range(len(self.fc_widths)):
            bank = getattr(self, f"fc_{j}")
            x = module_dense(x, bank.weight, bank.bias, path[3 + j],
                             self.dtype, keep=keep[3 + j], rate=rates[3 + j])
        return x.to(torch.float32)


def layer_index(name: str, n_convs: int) -> int:
    """``conv_<i>.*`` are layers 0.., ``fc_<j>.*`` follow, offset by the
    model's own conv count."""
    kind, idx = name.split(".")[0].split("_")
    return int(idx) if kind == "conv" else n_convs + int(idx)


def module_train_mask(params: dict, path: np.ndarray, frozen: np.ndarray,
                      n_convs: int) -> dict:
    """Per leaf, the (M, 1, ...) float gate: 1 for the path's modules that
    no earlier best path froze (ref ``unfreeze_path``)."""
    per_layer = np.zeros_like(frozen, dtype=np.float32)  # (L, M)
    for layer in range(frozen.shape[0]):
        per_layer[layer, path[layer]] = 1.0
    per_layer = per_layer * (1.0 - frozen)
    return {name: torch.tensor(per_layer[layer_index(name, n_convs)],
                               device=leaf.device).view(
                                   (-1,) + (1,) * (leaf.dim() - 1))
            for name, leaf in params.items()}


def frozen_modules(best_paths: list, n_layers: int, M: int) -> np.ndarray:
    """(L, M): 1 where an earlier task's best path uses the module."""
    frozen = np.zeros((n_layers, M), np.float32)
    for bp in best_paths:
        for layer in range(n_layers):
            frozen[layer, bp[layer] % M] = 1.0
    return frozen


def reinit_unfrozen(params: dict, init_params: dict, frozen: np.ndarray,
                    n_convs: int) -> dict:
    """Modules no earlier best path uses start again from ``init_params``
    (ref:pathnet.py:83), with the JAX package's arithmetic."""
    out = {}
    for name, leaf in params.items():
        gate = torch.tensor(frozen[layer_index(name, n_convs)],
                            device=leaf.device).view(
                                (-1,) + (1,) * (leaf.dim() - 1))
        out[name] = leaf * gate + init_params[name] * (1 - gate)
    return out


class PathNetFns:
    """Train epoch and eval of one PathNet module, task and device."""

    def __init__(self, net: PathNetVGG, mean, std, class_counts, task: int,
                 device, augment: bool = True, mesh=None):
        self.net = net
        self.mean, self.std = tuple(mean), tuple(std)
        self.class_counts = np.asarray(class_counts, np.int32)
        self.task = task
        self.device = device
        self.augment = augment
        self.mesh = mesh if mesh is not None else mesh_lib.get_mesh(device)

    def bank(self, trainable) -> dict:
        return {"kernel": trainable["heads"]["kernel"],
                "bias": trainable["heads"]["bias"],
                "class_counts": self.class_counts}

    def draw(self, gen, batch_size: int):
        """One step's flip mask, from the epoch's device generator."""
        if not self.augment:
            return None
        return torch.randint(0, 2, (batch_size,), dtype=torch.uint8,
                             device=self.device, generator=gen)

    def draw_dropout(self, gen, batch_size: int, n: int):
        """One step's keep-masks of the AlexNet PathNet (p(keep) = 1 -
        rate, per element), from the epoch's device generator; None for
        the VGG PathNet, which has no dropout."""
        if not isinstance(self.net, PathNetAlexNet):
            return None
        return [torch.rand(shape, device=self.device, generator=gen) >= rate
                for shape, rate in self.net.drop_shapes(batch_size, n)]

    def train_step(self, trainable, momentum, x_u8, y, path, keep, lr,
                   flip=None, dropout_masks=None):
        """One SGD step (momentum 0.9) with the gradient hard-selected by
        ``keep`` (name -> bool gate) and only the current head trained.
        Returns the new trainable; the momentum is updated in place. The
        batch and the draws are global; the rank runs its rows and the
        gradient is all-reduced before the gate."""
        rows = lambda t: mesh_lib.constrain_batch(t, self.mesh)
        x = pp.preprocess(rows(x_u8), self.mean, self.std, rows(flip),
                          dtype=self.net.dtype)
        feats = functional_call(self.net, trainable["params"], (x, path),
                                {"train": True,
                                 "dropout_masks": rows(dropout_masks)})
        loss = mesh_lib.share(
            F.cross_entropy(heads_lib.forward(self.bank(trainable), feats,
                                              self.task), rows(y)),
            self.mesh.batch_scale)
        names = list(trainable["params"])
        leaves = tree_leaves(trainable)
        g = mesh_lib.global_grads(loss, leaves, self.mesh)
        with torch.no_grad():
            gp = [torch.where(keep[n], gi, 0.0)
                  for n, gi in zip(names, g[:len(names)])]
            gh = common.current_task_head_grads(
                dict(zip(trainable["heads"], g[len(names):])), self.task)
            bufs = [momentum["params"][n] for n in names] + [
                momentum["heads"][k] for k in trainable["heads"]]
            torch._foreach_mul_(bufs, 0.9)
            torch._foreach_add_(bufs, gp + list(gh.values()))
            new = torch._foreach_sub(leaves, torch._foreach_mul(bufs, lr))
        for leaf in new:
            leaf.requires_grad_()
        return tree_unflatten(trainable, new)

    def train_epoch(self, trainable, momentum, images, labels, perm, path,
                    gates, gen, lr: float):
        """One epoch over ``perm`` at batch 64 (the dataset's size if
        smaller, rounded down to a multiple of the ranks), truncated to
        whole batches. Returns (trainable, momentum)."""
        n = int(perm.shape[0])
        bsz = mesh_lib.round_batch(TRAIN_BATCH, n, self.mesh.size)
        perm = torch.as_tensor(perm)[: (n // bsz) * bsz].to(self.device)
        path = torch.as_tensor(np.asarray(path), dtype=torch.long,
                               device=self.device)
        keep = {k: v > 0 for k, v in gates.items()}
        for i in range(n // bsz):
            idx = perm[i * bsz: (i + 1) * bsz]
            trainable = self.train_step(
                trainable, momentum, images.index_select(0, idx),
                labels.index_select(0, idx), path, keep, lr,
                self.draw(gen, bsz),
                self.draw_dropout(gen, bsz, int(path.shape[1])))
        return trainable, momentum

    def eval_acc(self, trainable, images, labels, path,
                 batch_size: int = TOURNAMENT_EVAL_BATCH) -> float:
        """Accuracy of ``path`` on uint8 ``images``; one read-back. Under a
        group the batch rounds down to a multiple of the ranks, the last
        one is padded with rows of weight 0, and the hits are
        all-reduced."""
        n = int(images.shape[0])
        bsz = mesh_lib.round_batch(batch_size, n, self.mesh.size)
        labels = torch.as_tensor(labels).to(self.device).long()
        path = torch.as_tensor(np.asarray(path), dtype=torch.long,
                               device=self.device)

        def logits_u8(x_u8):
            x = pp.preprocess(x_u8, self.mean, self.std)
            feats = functional_call(self.net, trainable["params"], (x, path))
            return heads_lib.forward(self.bank(trainable), feats, self.task)

        hits, _ = mesh_lib.count_hits(images, labels, bsz, logits_u8,
                                      mesh=self.mesh)
        return float(hits) / n


def _finite(trainable) -> bool:
    """The NaN guard: the sum of every leaf's sum is finite (one
    read-back)."""
    return bool(torch.isfinite(sum(leaf.sum()
                                   for leaf in tree_leaves(trainable))))


def _clone(tree, requires_grad: bool = False):
    return tree_map(lambda t: t.detach().clone().requires_grad_(
        requires_grad), tree)


@dataclass
class PathNet(Method):
    name: str = "pathnet"
    category: Category = Category.MASK_BASED
    start_scratch: bool = True
    hyperparams: "OrderedDict[str, float]" = field(
        default_factory=lambda: OrderedDict({"N": 3}))
    static_hyperparams: "OrderedDict[str, float]" = field(
        default_factory=lambda: OrderedDict({"M": 20, "generations": 35}))

    P: int = 2
    lr_patience: int = 10
    lr_factor: float = 3.0

    def decay_operator(self, value, factor):
        """PathNet 'decays' by ADDING a module per layer
        (ref:src/methods/method.py:565-593)."""
        return int(value) + 1

    # ---- model plumbing -----------------------------------------------------
    def _net(self, manager) -> PathNetVGG | PathNetAlexNet:
        spec = manager.model_spec
        if spec.arch == "alexnet":
            return PathNetAlexNet(int(spec.input_size[0]),
                                  M=int(self.static_hyperparams["M"]),
                                  dtype=spec.compute_dtype)
        return PathNetVGG(spec.arch, spec.classifier_dims, spec.input_size,
                          M=int(self.static_hyperparams["M"]),
                          dtype=spec.compute_dtype)

    def _load_or_init(self, manager, net: PathNetVGG) -> dict:
        """The previous task's PathNet model, or at task 1 a fresh one:
        modules from (seed, 0), the head bank from (seed, 5), and a copy of
        the modules as ``init_params``."""
        p = manager.previous_task_model_path
        prev = io.load(p) if p and io.exists(p) else None
        if prev is not None and prev.get("meta", {}).get("pathnet"):
            return prev
        seed = manager.args.seed
        net.reset_parameters(rng_lib.generator(seed, 0))
        params = pathnet_params_to_jax(dict(net.named_parameters()))
        seq = manager.dataset
        counts = np.zeros(manager.max_tasks, np.int32)
        counts[: seq.task_count] = seq.class_count_list()
        bank = heads_lib.init_head_bank(
            rng_lib.generator(seed, 5), manager.max_tasks, net.feature_dim,
            int(counts.max()), counts)
        return {"params": params,
                "init_params": {k: v.copy() for k, v in params.items()},
                "batch_stats": {},
                "heads": io.to_host({"kernel": bank["kernel"],
                                     "bias": bank["bias"],
                                     "class_counts": counts}),
                "meta": {"pathnet": True},
                "method_aux": {"best_paths": []}}  # N may grow per task

    def _make_fns(self, net, mean, std, class_counts, task, device,
                  augment: bool = True) -> PathNetFns:
        return PathNetFns(net, mean, std, class_counts, task, device,
                          augment)

    # ---- evolutionary training (ref:pathnet.py:101-207) ---------------------
    def _evolve(self, args, manager, N, generations, nepochs_per_gen,
                exp_dir, seed, n_candidates: int | None = None):
        P = self.P if n_candidates is None else int(n_candidates)
        t = manager.task_counter - 1
        device = device_lib.resolve(args.device)
        net = self._net(manager)
        state = self._load_or_init(manager, net)
        L, M, n_convs = net.n_layers, net.M, net.n_convs
        aux = state.get("method_aux") or {}
        best_paths = [np.asarray(bp) for bp in aux.get("best_paths", [])]
        frozen = frozen_modules(best_paths, L, M)

        params = pathnet_params_from_jax(state["params"], device)
        if t > 0 and "init_params" in state:
            params = reinit_unfrozen(
                params, pathnet_params_from_jax(state["init_params"], device),
                frozen, n_convs)

        rng = np.random.default_rng(seed)
        N = int(N)
        paths = np.zeros((P, L, N), np.int32)
        for p in range(P):
            for layer in range(L):
                # distinct modules while they fit; repeats once the decay
                # operator has grown N past M
                paths[p, layer] = rng.choice(M, N, replace=N > M)

        trainable = {"params": params, "heads": {
            k: torch.tensor(np.asarray(state["heads"][k], np.float32),
                            device=device) for k in ("kernel", "bias")}}
        for leaf in tree_leaves(trainable):
            leaf.requires_grad_()
        class_counts = np.asarray(state["heads"]["class_counts"])
        td = manager.current_task_dataset
        # whole on the device, whatever the data budget, as in the JAX
        # package
        images = place(td.train.images, device)
        labels = place(td.train.labels, device).long()
        val_images = place(td.val.images, device)
        val_labels = place(td.val.labels, device).long()
        fns = self._make_fns(net, manager.dataset.mean, manager.dataset.std,
                             class_counts, t, device,
                             augment=getattr(args, "augment", True))

        mesh = mesh_lib.get_mesh(device)
        mesh_lib.replicated(trainable, mesh)
        momenta = [tree_zeros_like(trainable) for _ in range(P)]
        lrs = [manager.extras.get("lr", args.lr_grid[0])] * P
        patience = [self.lr_patience] * P
        best_acc_p = [0.0] * P
        best_overall, best_state, winner = 0.0, _clone(trainable), 0
        n_train = int(images.shape[0])
        perm_gen = rng_lib.generator(seed, 3)
        flip_gen = rng_lib.generator(seed, 4, device=device)
        for g in range(generations):
            for p in range(P):
                gates = module_train_mask(trainable["params"], paths[p],
                                          frozen, n_convs)
                for e in range(nepochs_per_gen):
                    bsz = mesh_lib.round_batch(TRAIN_BATCH, n_train,
                                               mesh.size)
                    perm = torch.randperm(n_train, generator=perm_gen)
                    perm = perm[: (n_train // bsz) * bsz]
                    trainable, momenta[p] = fns.train_epoch(
                        trainable, momenta[p], images, labels, perm,
                        paths[p], gates, flip_gen, lrs[p])
                    # NaN guard: a diverged candidate must not poison the
                    # shared weights: restore the last finite snapshot,
                    # drop this candidate's lr, reset its momentum
                    if not _finite(trainable):
                        trainable = _clone(best_state, requires_grad=True)
                        momenta[p] = tree_zeros_like(trainable)
                        lrs[p] /= self.lr_factor
                        continue
                    acc = fns.eval_acc(trainable, val_images, val_labels,
                                       paths[p])
                    if acc > best_overall:
                        best_overall, winner = acc, p
                        best_state = _clone(trainable)
                    if acc > best_acc_p[p]:
                        best_acc_p[p] = acc
                        patience[p] = self.lr_patience
                    else:
                        patience[p] -= 1
                        if patience[p] == self.lr_patience // 2:
                            lrs[p] /= self.lr_factor
            # restore the overall winner, mutate the losers
            # (ref:pathnet.py:186-199)
            trainable = _clone(best_state, requires_grad=True)
            prob = 1.0 / (N * L)
            for p in range(P):
                if p == winner:
                    continue
                best_acc_p[p] = 0.0
                lrs[p] = lrs[winner]
                patience[p] = self.lr_patience
                # a fresh optimizer state for the loser (ref:pathnet.py:
                # 132-134): stale momentum of the old path would keep
                # dragging modules that are off the mutated path
                momenta[p] = tree_zeros_like(trainable)
                for layer in range(L):
                    for k in range(N):
                        paths[p, layer, k] = paths[winner, layer, k]
                        if rng.random() < prob:
                            paths[p, layer, k] = (paths[p, layer, k]
                                                  + rng.integers(-2, 2)) % M

        out = {
            "params": pathnet_params_to_jax(best_state["params"]),
            "init_params": state.get("init_params", state["params"]),
            "batch_stats": {},
            "heads": {**io.to_host(best_state["heads"]),
                      "class_counts": class_counts},
            "meta": {"pathnet": True, "task": t, "N": N},
            "method_aux": {"best_paths": best_paths + [paths[winner]]},
        }
        io.save(out, os.path.join(exp_dir, BEST_MODEL_FILENAME))
        return out, best_overall

    # ---- framework hooks ----------------------------------------------------
    def grid_train(self, args, manager, lr):
        """Phase 1: one candidate, one generation of ``num_epochs``
        epochs."""
        manager.extras["lr"] = lr
        return self._evolve(args, manager, int(self.hyperparams["N"]), 1,
                            args.num_epochs,
                            manager.extras["gridsearch_exp_dir"],
                            manager.extras.get("grid_seed", 0),
                            n_candidates=1)

    def train(self, args, manager, hyperparams):
        gens = int(self.static_hyperparams["generations"])
        return self._evolve(args, manager, int(hyperparams["N"]), gens,
                            max(args.num_epochs // gens, 1),
                            manager.extras["heuristic_exp_dir"], args.seed)

    def inference_eval(self, manager, model_path, ref_task, trained_idx):
        from clsurvey_torch.framework.evaluate import _eval_split

        model = io.load(model_path) if isinstance(model_path, str) \
            else model_path
        path = np.asarray(model["method_aux"]["best_paths"][ref_task - 1])
        device = device_lib.resolve(manager.args.device)
        fns = self._make_fns(self._net(manager), manager.dataset.mean,
                             manager.dataset.std,
                             model["heads"]["class_counts"], ref_task - 1,
                             device, augment=False)
        trainable = trainable_from_host(model, device, False,
                                        pathnet_params_from_jax)
        split = _eval_split(manager, manager.dataset.get_task_dataset(
            ref_task))  # honours --test_set
        return fns.eval_acc(trainable, place(split.images, device),
                            split.labels, path,
                            batch_size=manager.args.batch_size)
