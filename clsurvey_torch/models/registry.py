"""Model-name parsing + init-model dump.

Counterpart of ``clsurvey_tpu/models/registry.py`` (ref:src/models/net.py:
15-36 ``parse_model_name``): the same model-name strings and the same
``models_root_path`` layout. The initial network is created and pickled on
first parse, in the JAX package's layout ``{'params', 'batch_stats',
'heads', 'meta'}`` (numpy), so either package can start from a file the
other wrote; ``models/convert.py`` maps the backbone weights at load and
save. The VGG family is built with its ``_BN`` / ``_DROP`` variants, and
``alexnet`` / ``alexnet_pretrained`` with AlexNet, whose ImageNet weights
``load_pretrained`` reads from ``<models_root>/alexnet_imagenet.npz`` in the
JAX package's flat layout."""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Any

import numpy as np
import torch

from clsurvey_torch.models import heads as heads_lib
from clsurvey_torch.models.backbones import AlexNetBackbone, VGGBackbone
from clsurvey_torch.models.convert import batch_stats_to_jax, params_to_jax
from clsurvey_torch.utils import io, rng as rng_lib


class ModelRegularization:
    vanilla = "vanilla"
    weight_decay = "L2"
    dropout = "DROP"
    batchnorm = "BN"


@dataclass
class ModelSpec:
    """The backbone factory + metadata; ``path`` is where the pickled init
    state lives (ref:src/models/net.py:77-237)."""

    name: str
    arch: str                      # a VGG_CFG name or 'alexnet'
    input_size: tuple              # (H, W)
    classifier_dims: tuple = ()
    batch_norm: bool = False
    dropout: bool = False
    pretrained: bool = False
    models_root_path: str = ""
    compute_dtype: Any = torch.float32
    path: str = field(default="", init=False)

    def __post_init__(self):
        if self.arch == "alexnet":
            parent = os.path.join(self.models_root_path, "alexnet")
        else:
            parent = os.path.join(
                self.models_root_path,
                f"customVGG_input={self.input_size[0]}x{self.input_size[1]}")
        self.path = os.path.join(parent, self.name + ".pth.tar")

    def make_backbone(self) -> VGGBackbone | AlexNetBackbone:
        if self.arch == "alexnet":
            return AlexNetBackbone(self.input_size, dtype=self.compute_dtype)
        return VGGBackbone(self.arch, self.classifier_dims, self.input_size,
                           dtype=self.compute_dtype,
                           batch_norm=self.batch_norm, dropout=self.dropout)

    @property
    def feature_dim(self) -> int:
        if self.arch == "alexnet":
            return 4096
        return int(self.classifier_dims[-1])

    @property
    def has_batch_stats(self) -> bool:
        return self.batch_norm

    @property
    def uses_dropout(self) -> bool:
        return self.dropout or self.arch == "alexnet"


def _parse_classifier_dims(model_name: str) -> tuple:
    """``..._cl_128_128...`` -> (128, 128)."""
    segs = model_name.split("_")
    if "cl" not in segs:
        raise ValueError(f"no classifier spec ('_cl_d1_d2') in {model_name}")
    i = segs.index("cl")
    return (int(segs[i + 1]), int(segs[i + 2]))


def parse_model_name(models_root_path: str, model_name: str,
                     input_size: tuple,
                     compute_dtype=torch.float32) -> ModelSpec:
    """String -> ModelSpec (ref:src/models/net.py:15-36)."""
    segs = model_name.split("_")
    if "alexnet" in model_name:
        return ModelSpec(model_name, "alexnet", input_size,
                         pretrained="pretrained" in model_name,
                         models_root_path=models_root_path,
                         compute_dtype=compute_dtype)
    for cfg in ("small_VGG9", "wide_VGG9", "deep_VGG22", "base_VGG9",
                "tiny_CNN", "19normal", "16normal", "11normal"):
        if cfg in model_name:
            return ModelSpec(
                model_name, cfg, input_size,
                classifier_dims=_parse_classifier_dims(model_name),
                batch_norm=ModelRegularization.batchnorm in segs,
                dropout=ModelRegularization.dropout in segs,
                models_root_path=models_root_path,
                compute_dtype=compute_dtype,
            )
    raise NotImplementedError(f"MODEL NOT IMPLEMENTED YET: {model_name}")


def get_init_modelname(num_epochs, batch_size, lr_grid, weight_decay,
                       model_name) -> str:
    """First-task base-model experiment name (ref:src/models/net.py:39-53)."""
    name = [f"e={num_epochs}", f"bs={batch_size}", f"lr={sorted(lr_grid)}"]
    if weight_decay != 0:
        name.append(f"{ModelRegularization.weight_decay}={weight_decay}")
    if ModelRegularization.batchnorm in model_name:
        name.append(ModelRegularization.batchnorm)
    if ModelRegularization.dropout in model_name:
        name.append(ModelRegularization.dropout)
    return "_".join(name)


def init_model_state(spec: ModelSpec, seed: int, max_tasks: int,
                     classes_per_task: int, class_counts=None) -> dict:
    """Initialise backbone params + head bank from ``seed``. Returns the
    canonical model dict ``{'params', 'batch_stats', 'heads', 'meta'}`` in
    the JAX package's layout (numpy)."""
    backbone = spec.make_backbone()
    backbone.reset_parameters(rng_lib.generator(seed, 0))
    params = params_to_jax(backbone)
    if spec.pretrained:
        params = load_pretrained(spec, params)
    head_bank = heads_lib.init_head_bank(
        rng_lib.generator(seed, 1), max_tasks, spec.feature_dim,
        classes_per_task, class_counts)
    return {
        "params": params,
        "batch_stats": batch_stats_to_jax(backbone.init_batch_stats()),
        "heads": io.to_host(head_bank),
        "meta": {
            "model_name": spec.name,
            "max_tasks": max_tasks,
            "classes_per_task": classes_per_task,
        },
    }


def create_init_model(spec: ModelSpec, seed: int, max_tasks: int,
                      classes_per_task: int, class_counts=None) -> str:
    """Create + pickle the shared init model if missing
    (ref:src/models/net.py:243-262). Idempotent like the reference."""
    if io.exists(spec.path):
        return spec.path
    state = init_model_state(spec, seed, max_tasks, classes_per_task,
                             class_counts)
    io.save(state, spec.path)
    print(f"CREATED INIT MODEL {spec.name} -> {spec.path}")
    return spec.path


def load_pretrained(spec: ModelSpec, params: dict) -> dict:
    """Pretrained backbone weights into the JAX-layout numpy tree
    ``params`` (ref AlexNet uses torchvision's ImageNet weights,
    ref:src/models/net.py:96-125), read from
    ``<models_root>/<arch>_imagenet.npz``: a flat ``{'/'.join(path):
    array}`` dump in the JAX package's layout (``'conv_0/kernel'`` HWIO, ...),
    the file ``clsurvey_tpu`` reads. A leaf the file lacks, or holds in
    another shape, keeps its scratch init with a warning. Without the file
    the scratch init is kept only under
    ``CLSURVEY_ALLOW_SCRATCH_PRETRAINED``; otherwise it raises."""
    path = os.path.join(spec.models_root_path, f"{spec.arch}_imagenet.npz")
    if not os.path.isfile(path):
        if os.environ.get("CLSURVEY_ALLOW_SCRATCH_PRETRAINED"):
            print(f"[WARN] pretrained weights not found at {path}; "
                  f"using scratch init for {spec.name}")
            return params
        raise FileNotFoundError(
            f"'{spec.name}' requests pretrained weights but {path} does "
            f"not exist. Generate it with "
            f"scripts/dump_torchvision_alexnet.py (from torchvision or a "
            f"local torch checkpoint), or set "
            f"CLSURVEY_ALLOW_SCRATCH_PRETRAINED=1 to accept a scratch "
            f"init (results will not match the reference protocol).")
    with np.load(path) as z:
        flat_npz = dict(z)

    def walk(node: dict, prefix: str) -> dict:
        out = {}
        for key, leaf in node.items():
            name = prefix + key
            if isinstance(leaf, dict):
                out[key] = walk(leaf, name + "/")
            elif name in flat_npz and flat_npz[name].shape == leaf.shape:
                out[key] = np.asarray(flat_npz[name], leaf.dtype)
            else:
                print(f"[WARN] pretrained leaf missing/mismatched: {name}")
                out[key] = leaf
        return out

    return walk(params, "")


def _leaf_count(tree) -> int:
    if isinstance(tree, dict):
        return sum(_leaf_count(v) for v in tree.values())
    return int(np.asarray(tree).size)


def count_parameters(state: dict) -> int:
    """ref:src/models/net.py:282-300 param counting."""
    return _leaf_count(state["params"]) + sum(
        np.asarray(state["heads"][k]).size for k in ("kernel", "bias"))
