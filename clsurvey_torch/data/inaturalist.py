"""iNaturalist 10-supercategory task sequence
(ref:src/data/dataset.py:85-202, inaturalist_dataprep.py).

Counterpart of ``clsurvey_tpu/data/inaturalist.py``: the same orderings,
filter, numpy draws and npz layout, so either package reads the bundles
the other's ``prepare`` wrote.

10 tasks = 10 supercategories (Amphibia, Animalia, Arachnida, Aves, Fungi,
Insecta, Mammalia, Mollusca, Plantae, Reptilia), 224x224 inputs, classes
with >= 100 images kept; two task orderings: 'unrel' (maximally unrelated)
and 'rel' (related consecutive) exposed as class attributes like the
reference. Prep consumes an already-downloaded iNaturalist train_val2017
directory layout; it downloads nothing."""

from __future__ import annotations

import os

import numpy as np

from clsurvey_torch.data import imagefolders as imf
from clsurvey_torch.data.registry import (
    SplitData, TaskSequence, register_dataset)
from clsurvey_torch.utils.config import load_config

IMG_SIZE = 224
MIN_IMAGES_PER_CLASS = 100  # ref filter

# ref:src/data/dataset.py:85-164 task orderings
ORDER_UNREL = ["Amphibia", "Mollusca", "Fungi", "Aves", "Arachnida",
               "Mammalia", "Plantae", "Insecta", "Reptilia", "Animalia"]
ORDER_REL = ["Amphibia", "Reptilia", "Aves", "Mammalia", "Animalia",
             "Mollusca", "Arachnida", "Insecta", "Fungi", "Plantae"]


def prepare(raw_root: str, out_root: str, order: str = "unrel",
            seed: int = 7, val_fraction: float = 0.1,
            test_fraction: float = 0.1) -> str:
    """Serialize per-supercategory task npz bundles.

    ``raw_root`` layout: <raw_root>/<supercategory>/<species>/<img>."""
    supercats = ORDER_UNREL if order == "unrel" else ORDER_REL
    out_dir = os.path.join(out_root, f"inaturalist_{order}_10tasks")
    token = os.path.join(out_dir, "PREP.TOKEN")
    if os.path.isfile(token):
        return out_dir
    os.makedirs(out_dir, exist_ok=True)
    rng = np.random.default_rng(seed)
    for task, supercat in enumerate(supercats, start=1):
        root = os.path.join(raw_root, supercat)
        images, labels, classes = imf.load_imagefolder(
            root, (IMG_SIZE, IMG_SIZE), min_images=MIN_IMAGES_PER_CLASS)
        # carve test then val per class
        test_idx, rest_idx = [], []
        for c in np.unique(labels):
            sel = np.where(labels == c)[0]
            perm = rng.permutation(len(sel))
            n_test = max(int(len(sel) * test_fraction), 1)
            test_idx.extend(sel[perm[:n_test]])
            rest_idx.extend(sel[perm[n_test:]])
        test_idx, rest_idx = np.asarray(test_idx), np.asarray(rest_idx)
        train, val = imf.split_train_val(
            images[rest_idx], labels[rest_idx], val_fraction, seed)
        imf.save_task_npz(out_dir, task, train, val,
                          SplitData(images[test_idx], labels[test_idx]),
                          classes)
    with open(token, "w") as f:
        f.write("\n".join(supercats))
    return out_dir


class INaturalistSequence(TaskSequence):
    """``inat`` / ``inat_rel`` (ref:src/data/dataset.py:85-202)."""

    task_count = 10
    input_size = (IMG_SIZE, IMG_SIZE)

    def __init__(self, ds_name: str = "inat", ds_root: str | None = None,
                 **_):
        self.name = ds_name
        # NOTE "unrel".endswith("rel") — check the longer suffix first
        self.order = ("unrel" if ds_name.endswith("unrel")
                      else "rel" if ds_name.endswith("rel") else "unrel")
        self.ordering = (ORDER_REL if self.order == "rel" else ORDER_UNREL)
        self._root = os.path.join(
            ds_root or load_config().ds_root_path,
            f"inaturalist_{self.order}_10tasks")
        self._cache: dict = {}
        self.classes_per_task = {}
        for t in range(1, self.task_count + 1):
            path = os.path.join(self._root, f"task_{t}.npz")
            # keyed by taskname (the supercategory), the reference's
            # convention (ref:src/data/dataset.py:85-164) and what
            # registry.class_count_list looks up
            if os.path.isfile(path):
                self.classes_per_task[self.get_taskname(t)] = int(
                    imf.npz_member_shape(path, "classes")[0])
                # trust the prepared bundles' resolution (tests prepare
                # reduced-size trees); header-read only, no decompression
                self.input_size = tuple(
                    imf.npz_member_shape(path, "train_images")[1:3])
            else:
                self.classes_per_task[self.get_taskname(t)] = 0
        if all(v == 0 for v in self.classes_per_task.values()):
            raise FileNotFoundError(
                f"no task bundles under {self._root} — run clsurvey_torch.data.inaturalist.prepare() first")

    def get_taskname(self, task: int) -> str:
        return self.ordering[task - 1]

    def get_task_dataset(self, task: int):
        if task not in self._cache:
            path = os.path.join(self._root, f"task_{task}.npz")
            if not os.path.isfile(path):
                raise FileNotFoundError(
                    f"{path} missing — run "
                    f"clsurvey_torch.data.inaturalist.prepare() first")
            self._cache[task] = imf.load_task_npz(path)
        return self._cache[task]


register_dataset("inat", INaturalistSequence)
