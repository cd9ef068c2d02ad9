"""EBLL — Encoder-Based Lifelong Learning
(ref:src/methods/EBLL/{Finetune_SGD_EBLL,AlexNet_EBLL}.py,
wrapper ref:src/methods/method.py:822-937).

Counterpart of ``clsurvey_tpu/methods/ebll.py``. Extends LwF: besides
distilling previous heads, the conv-feature codes of every previous task's
undercomplete autoencoder are anchored:

- ``prestep`` grid-trains an autoencoder (Linear+Sigmoid encoder / Linear
  decoder over the flattened conv features) on the *previous* task's data
  with Adadelta, loss ``alpha*MSE(recon, feats) + CE(classifier(recon))``
  (ref:Finetune_SGD_EBLL.py:398-447,93-205); grid over
  encoder_dims x encoder_alphas x autoencoder_lr with checkpoint/resume.
- ``train`` = LwF distillation + ``ebll_reg_alpha * sum_t
  MSE(enc_t(conv_feats_cur), enc_t(conv_feats_frozen))``
  (ref:Finetune_SGD_EBLL.py:230-395).

The conv features of the whole previous task are computed once and stay on
the device while the autoencoder trains (the frozen extractor never
reruns). In the train step the teacher's conv pass is shared between the
code anchoring and the LwF term (its trunk runs on the same conv
features); the student's conv features are a second, eval-mode pass, as in
the JAX package, because a batch-norm model's train-mode pass normalizes
with other statistics. An autoencoder is a dict ``{'enc' | 'dec':
{'kernel': (in, out), 'bias'}}``, on disk as numpy in exactly that layout,
so either package loads the other's encoders. On AlexNet, the
architecture the reference's own EBLL runs on, the autoencoder runs on the
flattened conv output (9,216 wide at 224 px): ``conv_feats`` and
``trunk_feats`` call the backbone's ``part="features"`` / ``part="trunk"``,
which both backbones have."""

from __future__ import annotations

import itertools
import os
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Callable

import numpy as np
import torch
import torch.nn.functional as F
from torch.func import functional_call

from clsurvey_torch.methods import common
from clsurvey_torch.methods.base import Category, Method
from clsurvey_torch.methods.finetune import finetune_grid_train
from clsurvey_torch.methods.lwf import LwFRule
from clsurvey_torch.models import heads as heads_lib
from clsurvey_torch.models.convert import batch_stats_from_jax, params_from_jax
from clsurvey_torch.ops import preprocess as pp
from clsurvey_torch.parallel import mesh as mesh_lib
from clsurvey_torch.utils import device as device_lib
from clsurvey_torch.utils import io, rng as rng_lib

ADADELTA_RHO, ADADELTA_EPS = 0.9, 1e-6  # optax.adadelta's defaults


# ---------------------------------------------------------------------------
# autoencoder
# ---------------------------------------------------------------------------

def init_autoencoder(generator: torch.Generator, x_dim: int, h_dim: int,
                     device=None) -> dict:
    """Glorot-uniform kernels, zero biases (drawn on the CPU)."""
    def glorot(fan_in, fan_out):
        bound = (6.0 / (fan_in + fan_out)) ** 0.5
        return torch.empty(fan_in, fan_out).uniform_(
            -bound, bound, generator=generator).to(device)

    return {
        "enc": {"kernel": glorot(x_dim, h_dim),
                "bias": torch.zeros(h_dim, device=device)},
        "dec": {"kernel": glorot(h_dim, x_dim),
                "bias": torch.zeros(x_dim, device=device)},
    }


def autoencoder_on(ae: dict, device) -> dict:
    """An autoencoder (numpy or tensors) as fresh float32 tensors on
    ``device``, never aliasing the caller's arrays."""
    return {part: {k: torch.tensor(np.asarray(io.to_host(ae[part][k]),
                                              np.float32), device=device)
                   for k in ("kernel", "bias")} for part in ("enc", "dec")}


def encode(ae: dict, x: torch.Tensor) -> torch.Tensor:
    return torch.sigmoid(x @ ae["enc"]["kernel"] + ae["enc"]["bias"])


def decode(ae: dict, h: torch.Tensor) -> torch.Tensor:
    return h @ ae["dec"]["kernel"] + ae["dec"]["bias"]


def conv_feats(backbone, params, x, batch_stats=None) -> torch.Tensor:
    """Flattened conv-extractor output — the autoencoder's input space
    (the reference inserts the AE right after ``features``). Eval mode:
    batch-norm on the running statistics."""
    return functional_call(backbone, params, (x,),
                           {"batch_stats": batch_stats, "part": "features"})


def trunk_feats(backbone, params, flat) -> torch.Tensor:
    """The classifier trunk (eval mode) on flat conv features."""
    return functional_call(backbone, params, (flat,), {"part": "trunk"})


def trunk_head_logits(backbone, bank, params, flat, task) -> torch.Tensor:
    """classifier trunk + task head on (possibly reconstructed) conv feats."""
    return heads_lib.forward(bank, trunk_feats(backbone, params, flat), task)


def train_autoencoder(spec, model, task, images_u8, labels, val_images_u8,
                      val_labels, mean, std, h_dim, alpha, lr, epochs,
                      batch_size, seed=7, device="cuda",
                      init_ae: dict | None = None,
                      perms: Callable[[int], np.ndarray] | None = None):
    """Adadelta AE training; returns (ae_params as numpy, best_val_acc)
    where acc is the frozen classifier's accuracy on the reconstruction
    (ref:Finetune_SGD_EBLL.py:93-205).

    ``init_ae`` and ``perms(epoch)`` replace the draws from ``seed`` (the
    JAX package's ``jax.random`` streams cannot be reproduced; a test hands
    in its init and its epoch permutations)."""
    device = device_lib.resolve(device)
    backbone = spec.make_backbone().to(device)
    params = params_from_jax(model["params"], device)
    stats = batch_stats_from_jax(model.get("batch_stats"), device)
    bank = {"kernel": torch.tensor(np.asarray(model["heads"]["kernel"],
                                              np.float32), device=device),
            "bias": torch.tensor(np.asarray(model["heads"]["bias"],
                                            np.float32), device=device),
            "class_counts": np.asarray(model["heads"]["class_counts"])}

    def feats_all(images, bs=int(batch_size)):
        # in the run's own batches: the kernels see the training's shapes
        images = torch.from_numpy(np.ascontiguousarray(images)).to(device)
        with torch.no_grad():
            return torch.cat([
                conv_feats(backbone, params,
                           pp.preprocess(images[i:i + bs], mean, std), stats)
                for i in range(0, len(images), bs)])

    tr_feats, va_feats = feats_all(images_u8), feats_all(val_images_u8)
    tr_labels = torch.as_tensor(np.asarray(labels)).to(device).long()
    va_labels = torch.as_tensor(np.asarray(val_labels)).to(device).long()
    n, x_dim = int(tr_feats.shape[0]), int(tr_feats.shape[-1])

    ae = (autoencoder_on(init_ae, device) if init_ae is not None else
          init_autoencoder(rng_lib.generator(seed), x_dim, h_dim, device))
    leaves = [ae[part][k].requires_grad_() for part in ("enc", "dec")
              for k in ("kernel", "bias")]
    opt = torch.optim.Adadelta(leaves, lr=lr, rho=ADADELTA_RHO,
                               eps=ADADELTA_EPS)
    bsz = min(int(batch_size), n)
    best_acc, best_ae = 0.0, io.to_host(ae)
    for e in range(epochs):
        if perms is not None:
            perm = torch.tensor(np.asarray(perms(e))).long().to(device)
        else:
            perm = torch.randperm(
                n, generator=rng_lib.generator(seed + 1, e)).to(device)
        for i in range(n // bsz):
            idx = perm[i * bsz: (i + 1) * bsz]
            f = tr_feats.index_select(0, idx)
            recon = decode(ae, encode(ae, f))
            logits = trunk_head_logits(backbone, bank, params, recon, task)
            loss = alpha * F.mse_loss(recon, f) + F.cross_entropy(
                logits, tr_labels.index_select(0, idx))
            opt.zero_grad(set_to_none=True)
            loss.backward()
            opt.step()
        with torch.no_grad():
            recon = decode(ae, encode(ae, va_feats))
            logits = trunk_head_logits(backbone, bank, params, recon, task)
            acc = float((logits.argmax(-1) == va_labels).float().mean())
        if acc > best_acc:
            best_acc, best_ae = acc, io.to_host(ae)
    return best_ae, best_acc


# ---------------------------------------------------------------------------
# update rule: LwF distillation + code anchoring
# ---------------------------------------------------------------------------

class EBLLRule(LwFRule):
    LAMBDA_KEY = "reg_lambda"

    def init_state(self, trainable, hyperparams, ctx, prev_model=None,
                   encoders=None):
        state = super().init_state(trainable, hyperparams, ctx,
                                   prev_model=prev_model)
        state["encoders"] = [autoencoder_on(e, ctx.device)
                             for e in (encoders or [])]
        return state

    # the autoencoders have one layout in both packages ({'enc' | 'dec':
    # {'kernel': (in, out), 'bias'}}), so only the teacher converts
    # (LwFRule's mstate_to_jax / mstate_from_jax)

    def extra_loss(self, ctx, trainable, feats, batch, mstate,
                   batch_stats=None, gen=None):
        """Distillation plus the code term: both means over the batch (the
        code term over its rows and code units), so the rank's share is
        its rows' value times ``ctx.mesh.batch_scale``."""
        if ctx.n_tasks - 1 == 0:
            return 0.0
        return mesh_lib.share(
            self._terms(ctx, trainable, feats, batch, mstate, batch_stats),
            ctx.mesh.batch_scale)

    def _terms(self, ctx, trainable, feats, batch, mstate, batch_stats):
        x, _ = batch
        teacher = mstate["teacher"]
        if not mstate["encoders"]:
            return self.distill_term(ctx, trainable, feats, batch, mstate)
        # one teacher conv pass for both terms
        with torch.no_grad():
            frz_conv = conv_feats(ctx.backbone, teacher["params"], x,
                                  teacher["batch_stats"])
            t_feats = trunk_feats(ctx.backbone, teacher["params"], frz_conv)
        # LwF distillation part, shared with LwFRule (its lambda key is
        # EBLL's reg_lambda)
        loss = self.distill_term(ctx, trainable, feats, batch, mstate,
                                 t_feats=t_feats)
        cur_conv = conv_feats(ctx.backbone, trainable["params"], x,
                              batch_stats)
        code_loss = 0.0
        for ae in mstate["encoders"]:
            with torch.no_grad():
                c_frz = encode(ae, frz_conv)
            code_loss = code_loss + F.mse_loss(encode(ae, cur_conv), c_frz)
        return loss + mstate["hyper"]["ebll_reg_alpha"] * code_loss

    def export_aux(self, mstate):
        return {"encoders": mstate["encoders"]}


# ---------------------------------------------------------------------------
# method
# ---------------------------------------------------------------------------

def _as_list(value) -> list:
    return list(value) if isinstance(value, (list, tuple)) else [value]


@dataclass
class EBLL(Method):
    name: str = "EBLL"
    category: Category = Category.DATA_BASED
    extra_hyperparams_count: int = 2
    hyperparams: "OrderedDict[str, float]" = field(
        default_factory=lambda: OrderedDict(
            {"reg_lambda": 10, "ebll_reg_alpha": 1}))
    static_hyperparams: "OrderedDict[str, object]" = field(
        default_factory=lambda: OrderedDict({
            "autoencoder_lr": [0.01], "autoencoder_epochs": 50,
            "encoder_alphas": [1e-1, 1e-2], "encoder_dims": [100, 300]}))

    def grid_train(self, args, manager, lr):
        return finetune_grid_train(args, manager, lr)

    def prestep(self, args, manager):
        """Autoencoder gridsearch on the previous task
        (ref:method.py:835-908)."""
        t_prev = manager.task_counter - 1
        parent = os.path.join(manager.task_dir(t_prev), "ENCODER_TRAINING")
        os.makedirs(parent, exist_ok=True)
        ckpt_file = os.path.join(parent, "grid_checkpoint.pth")
        processed = io.load(ckpt_file) if io.exists(ckpt_file) else {}

        prev_model = io.load(manager.previous_task_model_path)
        td = manager.dataset.get_task_dataset(t_prev)
        sh = self.static_hyperparams
        best_acc, best_ae = -1.0, None
        for dim, alpha, lr in itertools.product(
                _as_list(sh["encoder_dims"]), _as_list(sh["encoder_alphas"]),
                _as_list(sh["autoencoder_lr"])):
            key = (float(dim), float(alpha), float(lr))
            if key in processed:
                acc, ae = processed[key]["acc"], processed[key]["ae"]
            else:
                ae, acc = train_autoencoder(
                    manager.model_spec, prev_model, t_prev - 1,
                    td.train.images, td.train.labels,
                    td.val.images, td.val.labels,
                    manager.dataset.mean, manager.dataset.std,
                    h_dim=int(dim), alpha=float(alpha), lr=float(lr),
                    epochs=int(sh["autoencoder_epochs"]),
                    batch_size=args.batch_size, seed=args.seed,
                    device=args.device)
                processed[key] = {"acc": acc, "ae": ae}
                io.save(processed, ckpt_file)
            manager.log(f"AE dim={dim}_alpha={alpha}_lr={lr}: acc={acc:.4f}")
            if acc > best_acc:
                best_acc, best_ae = acc, ae
        if best_acc < 0.40:
            manager.log(f"[WARNING] AE grid max acc = {best_acc:.3f}")
        best_path = os.path.join(parent, "best_model.pth.tar")
        io.save(best_ae, best_path)
        # the writer's file: under a process group every rank trains the
        # grid whole, and all of them then continue with the writer's pick
        manager.extras["ebll_new_encoder"] = io.load(best_path)

    def train(self, args, manager, hyperparams):
        prev_model = io.load(manager.previous_task_model_path)
        aux = prev_model.get("method_aux") or {}
        encoders = list(aux.get("encoders", []))
        new_enc = manager.extras.get("ebll_new_encoder")
        if new_enc is not None and len(encoders) < manager.task_counter - 1:
            encoders.append(new_enc)
        rule = EBLLRule()
        engine = common.get_task_engine(manager, "ebll_engine")
        if engine is None:
            engine = common.build_engine(manager, rule, manager.task_counter)
        mstate = rule.init_state(None, dict(hyperparams), engine.ctx,
                                 prev_model=prev_model, encoders=encoders)
        best_model, best_acc, _, engine = common.run_training(
            manager, rule, lr=manager.extras["lr"],
            hyperparams=dict(hyperparams),
            exp_dir=manager.extras["heuristic_exp_dir"],
            start_model=prev_model, seed=args.seed, mstate=mstate,
            engine=engine)
        common.set_task_engine(manager, "ebll_engine", engine)
        return best_model, best_acc
