"""RecogSeq — the 8-dataset recognition sequence
(ref:src/data/dataset.py:397-476, recogseq_dataprep.py:13-134):

Counterpart of ``clsurvey_tpu/data/recogseq.py`` (the same numpy draws and
npz layout, so either package reads the other's bundles).

flowers -> scenes -> birds -> cars -> aircraft -> actions -> letters -> svhn,
224x224, AlexNet-pretrained protocol, 100 epochs. Val/test = 90/10 split of
each dataset's original test split (ref:recogseq_dataprep.py:13-134).

Prep consumes already-downloaded per-dataset ImageFolder layouts
(``<raw_root>/<dataset>/{train,test}/<class>/<img>``)."""

from __future__ import annotations

import os

import numpy as np

from clsurvey_torch.data import imagefolders as imf
from clsurvey_torch.data.registry import (SplitData, TaskSequence,
                                        register_dataset)
from clsurvey_torch.utils.config import load_config

IMG_SIZE = 224
TASKS = ("flowers", "scenes", "birds", "cars", "aircraft", "actions",
         "letters", "svhn")


def prepare(raw_root: str, out_root: str, seed: int = 7) -> str:
    out_dir = os.path.join(out_root, "recogseq_8tasks")
    token = os.path.join(out_dir, "PREP.TOKEN")
    if os.path.isfile(token):
        return out_dir
    os.makedirs(out_dir, exist_ok=True)
    rng = np.random.default_rng(seed)
    for task, name in enumerate(TASKS, start=1):
        tr_images, tr_labels, classes = imf.load_imagefolder(
            os.path.join(raw_root, name, "train"), (IMG_SIZE, IMG_SIZE))
        te_images, te_labels, _ = imf.load_imagefolder(
            os.path.join(raw_root, name, "test"), (IMG_SIZE, IMG_SIZE),
            class_filter=classes)
        # 90/10 val/test split of the original test list
        # (ref:recogseq_dataprep.py:13-134)
        val_idx, test_idx = [], []
        for c in np.unique(te_labels):
            sel = np.where(te_labels == c)[0]
            perm = rng.permutation(len(sel))
            n_val = max(int(0.9 * len(sel)), 1)
            val_idx.extend(sel[perm[:n_val]])
            test_idx.extend(sel[perm[n_val:]])
        val_idx, test_idx = np.asarray(val_idx), np.asarray(test_idx)
        imf.save_task_npz(
            out_dir, task,
            SplitData(tr_images, tr_labels),
            SplitData(te_images[val_idx], te_labels[val_idx]),
            SplitData(te_images[test_idx], te_labels[test_idx]),
            classes)
    with open(token, "w") as f:
        f.write("\n".join(TASKS))
    return out_dir


class RecogSeqSequence(TaskSequence):
    """``recogseq`` — unequal class counts per task (head widths padded +
    logit-masked by the engine)."""

    task_count = 8
    input_size = (IMG_SIZE, IMG_SIZE)

    def __init__(self, ds_name: str = "recogseq",
                 ds_root: str | None = None, **_):
        self.name = ds_name
        self._root = os.path.join(ds_root or load_config().ds_root_path,
                                  "recogseq_8tasks")
        self._cache: dict = {}
        self.classes_per_task = {}
        for t in range(1, self.task_count + 1):
            path = os.path.join(self._root, f"task_{t}.npz")
            # keyed by taskname (the dataset), the reference's convention
            # and what registry.class_count_list looks up
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
                f"no task bundles under {self._root} — run clsurvey_torch.data.recogseq.prepare() first")

    def get_taskname(self, task: int) -> str:
        return TASKS[task - 1]

    def get_task_dataset(self, task: int):
        if task not in self._cache:
            path = os.path.join(self._root, f"task_{task}.npz")
            if not os.path.isfile(path):
                raise FileNotFoundError(
                    f"{path} missing — run "
                    f"clsurvey_torch.data.recogseq.prepare() first")
            self._cache[task] = imf.load_task_npz(path)
        return self._cache[task]


register_dataset("recogseq", RecogSeqSequence)
