"""Generic imagefolder -> task-npz serialization.

Counterpart of ``clsurvey_tpu/data/imagefolders.py``: the same PIL reads,
resizes and numpy ``default_rng(seed)`` draws, so both packages write
identical arrays from one raw tree, and each reads the other's npz files.

The reference's dataprep scripts all converge on per-task pickled
ImageFolders (ref:src/data/{inaturalist,recogseq}_dataprep.py). Our common
denominator: a directory of ``<root>/<class>/<image>`` per split is packed
into one ``task_<i>.npz`` of uint8 arrays at a fixed resolution — the
device-resident format every TaskSequence reads."""

from __future__ import annotations

import os

import numpy as np

from clsurvey_torch.data.registry import SplitData, TaskData


def load_imagefolder(root: str, size: tuple, class_filter=None,
                     min_images: int = 0) -> tuple:
    """Read an ImageFolder layout into (images uint8, labels, classes)."""
    from PIL import Image

    classes = sorted(d for d in os.listdir(root)
                     if os.path.isdir(os.path.join(root, d)))
    if class_filter:
        # labels must follow the FILTER's ordering (the train split's
        # label space): a class missing from this split would otherwise
        # shift every later class's label with no error
        present = set(classes)
        classes = list(class_filter)
        missing = [c for c in classes if c not in present]
        if missing:
            raise FileNotFoundError(
                f"classes missing under {root}: {missing[:5]} — "
                "train/test label spaces would diverge")
    images, labels, kept = [], [], []
    for c in classes:
        cdir = os.path.join(root, c)
        files = sorted(
            f for f in os.listdir(cdir)
            if f.lower().endswith((".jpg", ".jpeg", ".png", ".bmp")))
        if len(files) < min_images:
            continue
        kept.append(c)
        label = len(kept) - 1
        for f in files:
            with Image.open(os.path.join(cdir, f)) as im:
                im = im.convert("RGB").resize((size[1], size[0]),
                                              Image.BILINEAR)
                images.append(np.asarray(im, np.uint8))
            labels.append(label)
    if class_filter and kept != list(class_filter):
        raise ValueError(
            f"classes dropped under {root} (below min_images={min_images}):"
            f" {sorted(set(class_filter) - set(kept))[:5]} — labels would"
            " shift against the filter's label space")
    return (np.stack(images) if images else
            np.zeros((0, size[0], size[1], 3), np.uint8),
            np.asarray(labels, np.int32), kept)


def split_train_val(images, labels, val_fraction: float, seed: int = 7):
    """Stratified-ish random split (the reference splits per class)."""
    rng = np.random.default_rng(seed)
    tr_idx, va_idx = [], []
    for c in np.unique(labels):
        sel = np.where(labels == c)[0]
        perm = rng.permutation(len(sel))
        n_val = max(int(len(sel) * val_fraction), 1)
        va_idx.extend(sel[perm[:n_val]])
        tr_idx.extend(sel[perm[n_val:]])
    tr_idx, va_idx = np.asarray(tr_idx), np.asarray(va_idx)
    return (SplitData(images[tr_idx], labels[tr_idx]),
            SplitData(images[va_idx], labels[va_idx]))


def save_task_npz(out_dir: str, task: int, train: SplitData, val: SplitData,
                  test: SplitData, classes) -> str:
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"task_{task}.npz")
    np.savez_compressed(
        path,
        train_images=train.images, train_labels=train.labels,
        val_images=val.images, val_labels=val.labels,
        test_images=test.images, test_labels=test.labels,
        classes=np.asarray(classes))
    return path


def npz_member_shape(path: str, name: str) -> tuple:
    """Shape of one array inside an npz WITHOUT decompressing its data —
    reads just the .npy header from the zip member (dataset __init__ needs
    per-task class counts/resolutions at every CLI start; decompressing
    gigabytes of images for two integers is not acceptable)."""
    import zipfile

    with zipfile.ZipFile(path) as zf:
        with zf.open(name + ".npy") as f:
            version = np.lib.format.read_magic(f)
            reader = (np.lib.format.read_array_header_1_0
                      if version == (1, 0)
                      else np.lib.format.read_array_header_2_0)
            shape, _, _ = reader(f)
    return shape


def load_task_npz(path: str):
    z = np.load(path, allow_pickle=False)
    return TaskData(
        SplitData(z["train_images"], z["train_labels"]),
        SplitData(z["val_images"], z["val_labels"]),
        SplitData(z["test_images"], z["test_labels"]),
        classes=[str(c) for c in z["classes"]])
