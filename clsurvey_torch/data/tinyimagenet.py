"""Tiny-ImageNet task-incremental sequence (10 or 40 tasks).

Counterpart of ``clsurvey_tpu/data/tinyimagenet.py``: the same class order
(a byte-identical copy of ``tinyimgnet_classes.txt`` lives beside this
module), the same numpy draws and the same npz layout, so either package
prepares a tree the other reads.

Behavior parity with the reference's dataprep + registry
(ref:src/data/tinyimgnet_dataprep.py:16-257, ref:src/data/dataset.py:205-375):

- 200 classes split into ``task_count`` equal tasks in the **survey's
  fixed class order**: the reference's ``tinyimgnet_classes.txt`` ships in
  this package (config data consumed at
  ref:src/data/tinyimgnet_dataprep.py:216) and is the default, so the
  10-task splits are identical to the paper's; a caller-provided
  ``order_file`` or ``survey_order=False`` (sorted wnids) overrides;
- per task: the official train split is divided 80/20 into train/val; the
  official val split (which has labels) becomes the test set
  (ref:src/data/tinyimgnet_dataprep.py:154-174);
- prep is idempotent via a token file (reference's ``*.TOKEN`` pattern,
  ref:src/data/tinyimgnet_dataprep.py:223-254);
- no download step: prep consumes an
  already-unpacked ``tiny-imagenet-200/`` directory.

Device-resident representation: each task is one ``task_<i>.npz`` of uint8
arrays (not 3 pickled ImageFolders); normalisation + random flip happen on
the device in the train step (kernel A), so there is no CPU transform
pipeline at all."""

from __future__ import annotations

import os

import numpy as np

from clsurvey_torch.data.registry import (
    SplitData, TaskData, TaskSequence, register_dataset)
from clsurvey_torch.utils.config import load_config

IMG_SIZE = 64
N_CLASSES = 200
PREP_TOKEN = "PREP.TOKEN"


def _load_image(path: str) -> np.ndarray:
    from PIL import Image

    with Image.open(path) as im:
        arr = np.asarray(im.convert("RGB"), dtype=np.uint8)
    assert arr.shape == (IMG_SIZE, IMG_SIZE, 3), arr.shape
    return arr


SURVEY_ORDER_FILE = os.path.join(os.path.dirname(__file__),
                                 "tinyimgnet_classes.txt")


def _read_class_order(raw_root: str, order_file: str | None,
                      survey_order: bool = True) -> list[str]:
    if order_file is None and survey_order:
        order_file = SURVEY_ORDER_FILE
    elif order_file and not os.path.isfile(order_file):
        # an explicitly requested ordering must not silently fall back —
        # the wrong task splits would be sealed under the variant's name
        raise FileNotFoundError(f"class order file missing: {order_file}")
    if order_file and os.path.isfile(order_file):
        with open(order_file) as f:
            order = [line.strip() for line in f if line.strip()]
    else:
        with open(os.path.join(raw_root, "wnids.txt")) as f:
            order = sorted(line.strip() for line in f if line.strip())
    assert len(order) == N_CLASSES, len(order)
    return order


def prepare(raw_root: str, out_root: str, task_count: int = 10,
            order_file: str | None = None, seed: int = 7,
            variant: str = "", survey_order: bool = True) -> str:
    """Serialize per-task npz bundles from an unpacked tiny-imagenet-200
    dir. ``variant`` names an alternative class ordering (the reference's
    hard<->easy orderings via symlinked task dirs,
    ref:src/data/dataset.py:314-375) — pass e.g. variant='hardeasy' with
    the matching ``order_file``."""
    suffix = f"_{variant}" if variant else ""
    out_dir = os.path.join(out_root, f"tiny_{task_count}tasks{suffix}")
    token = os.path.join(out_dir, PREP_TOKEN)
    if os.path.isfile(token):
        return out_dir
    os.makedirs(out_dir, exist_ok=True)
    order = _read_class_order(raw_root, order_file, survey_order)
    if N_CLASSES % task_count:
        raise ValueError(
            f"task_count={task_count} does not divide {N_CLASSES} classes"
            " — trailing classes would be silently dropped")
    per_task = N_CLASSES // task_count
    rng = np.random.default_rng(seed)

    # official val annotations: filename -> wnid
    val_ann = {}
    with open(os.path.join(raw_root, "val", "val_annotations.txt")) as f:
        for line in f:
            parts = line.split("\t")
            val_ann[parts[0]] = parts[1]

    for task in range(1, task_count + 1):
        wnids = order[(task - 1) * per_task: task * per_task]
        tr_imgs, tr_lbls, va_imgs, va_lbls, te_imgs, te_lbls = ([] for _ in range(6))
        for local_label, wnid in enumerate(wnids):
            img_dir = os.path.join(raw_root, "train", wnid, "images")
            files = sorted(os.listdir(img_dir))
            imgs = np.stack([_load_image(os.path.join(img_dir, fn))
                             for fn in files])
            # 80/20 train/val split of the official train images
            # (ref:src/data/tinyimgnet_dataprep.py train/val split)
            perm = rng.permutation(len(imgs))
            n_val = len(imgs) // 5
            va_idx, tr_idx = perm[:n_val], perm[n_val:]
            tr_imgs.append(imgs[tr_idx]); tr_lbls.append(
                np.full(len(tr_idx), local_label, np.int32))
            va_imgs.append(imgs[va_idx]); va_lbls.append(
                np.full(len(va_idx), local_label, np.int32))
            # official val images of this class -> test set
            test_files = [fn for fn, w in val_ann.items() if w == wnid]
            timgs = np.stack([_load_image(
                os.path.join(raw_root, "val", "images", fn))
                for fn in sorted(test_files)])
            te_imgs.append(timgs); te_lbls.append(
                np.full(len(timgs), local_label, np.int32))
        np.savez_compressed(
            os.path.join(out_dir, f"task_{task}.npz"),
            train_images=np.concatenate(tr_imgs),
            train_labels=np.concatenate(tr_lbls),
            val_images=np.concatenate(va_imgs),
            val_labels=np.concatenate(va_lbls),
            test_images=np.concatenate(te_imgs),
            test_labels=np.concatenate(te_lbls),
            classes=np.asarray(wnids),
        )
    with open(token, "w") as f:
        f.write("\n".join(order))
    return out_dir


class TinyImagenetSequence(TaskSequence):
    """``tiny`` (10 tasks) / ``tiny40`` etc. (ref:src/data/dataset.py:205-311).

    Reads prepared ``task_<i>.npz`` bundles under
    ``<ds_root>/tiny_<N>tasks/``."""

    def __init__(self, ds_name: str = "tiny", task_count: int | None = None,
                 ds_root: str | None = None, **_):
        self.name = ds_name
        # names: tiny / tiny40 / tiny_hardeasy / tiny10_easyhard ...
        segs = ds_name.split("_")
        variant = "_".join(segs[1:]) if len(segs) > 1 else ""
        if task_count is None:
            digits = "".join(ch for ch in segs[0] if ch.isdigit())
            task_count = int(digits) if digits else 10
        self.task_count = task_count
        self.input_size = (IMG_SIZE, IMG_SIZE)
        if N_CLASSES % task_count:
            raise ValueError(
                f"task_count={task_count} does not divide {N_CLASSES}")
        per_task = N_CLASSES // task_count
        self.classes_per_task = {
            str(t): per_task for t in range(1, task_count + 1)}
        suffix = f"_{variant}" if variant else ""
        self._root = os.path.join(
            ds_root or load_config().ds_root_path,
            f"tiny_{task_count}tasks{suffix}")
        self._cache: dict[int, TaskData] = {}

    def get_task_dataset(self, task: int) -> TaskData:
        if task in self._cache:
            return self._cache[task]
        path = os.path.join(self._root, f"task_{task}.npz")
        if not os.path.isfile(path):
            raise FileNotFoundError(
                f"{path} missing — run clsurvey_torch.data.tinyimagenet.prepare("
                f"raw_root=<tiny-imagenet-200>, out_root=<ds_root>, "
                f"task_count={self.task_count}) first")
        z = np.load(path, allow_pickle=False)
        td = TaskData(
            SplitData(z["train_images"], z["train_labels"]),
            SplitData(z["val_images"], z["val_labels"]),
            SplitData(z["test_images"], z["test_labels"]),
            classes=[str(c) for c in z["classes"]],
        )
        self._cache[task] = td
        return td


register_dataset("tiny", TinyImagenetSequence)
