"""Task-sequence dataset registry (counterpart of
``clsurvey_tpu/data/registry.py``; ``synthetic``, ``tiny``, ``inat`` and
``recogseq`` are registered).

Mirrors the reference's registry API (ref:src/data/dataset.py:13-82:
``parse(ds_name)`` + ``CustomDataset`` ABC with ``task_count``,
``classes_per_task``, ``input_size``, ``get_task_dataset_path``,
``get_taskname``), but device-resident in representation: instead of per-task
pickled torch ImageFolders reloaded through DataLoader worker processes,
each task is a static-shape numpy/uint8 array bundle that is moved to the
device once and consumed by the epoch loop. Augmentation (random flip — the
reference's ``rnd_transform`` pickles, ref:src/data/tinyimgnet_dataprep.py:
154-174) happens on the device inside the train step instead of in CPU workers.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Sequence

import numpy as np


@dataclass
class SplitData:
    images: np.ndarray  # (N, H, W, 3) uint8
    labels: np.ndarray  # (N,) int32, task-local label ids

    def __post_init__(self):
        assert self.images.ndim == 4 and self.images.dtype == np.uint8
        self.labels = np.asarray(self.labels, dtype=np.int32)

    @property
    def size(self) -> int:
        return int(self.images.shape[0])


@dataclass
class TaskData:
    """One task's {train, val, test} — the reference's per-task pickled
    ImageFolder dict (ref:src/data/tinyimgnet_dataprep.py:154-174)."""

    train: SplitData
    val: SplitData
    test: SplitData
    classes: Sequence[str] = field(default_factory=list)

    @property
    def num_classes(self) -> int:
        return len(self.classes) if self.classes else int(
            self.train.labels.max()) + 1


class TaskSequence:
    """ABC equivalent of the reference's CustomDataset
    (ref:src/data/dataset.py:43-82). Tasks are 1-based like the reference."""

    name: str = "abstract"
    task_count: int = 0
    classes_per_task: dict = {}
    input_size: tuple = (0, 0)
    # mean/std used for on-device normalisation (ImageNet stats, matching the
    # reference's torchvision transforms, ref:src/data/tinyimgnet_dataprep.py)
    mean: tuple = (0.485, 0.456, 0.406)
    std: tuple = (0.229, 0.224, 0.225)

    def get_task_dataset(self, task: int) -> TaskData:
        raise NotImplementedError

    def get_taskname(self, task: int) -> str:
        """ref:src/data/dataset.py — default = str(task index)."""
        return str(task)

    @property
    def max_classes_per_task(self) -> int:
        return max(int(v) for v in self.classes_per_task.values())

    def class_count_list(self) -> list:
        return [int(self.classes_per_task[self.get_taskname(t)])
                for t in range(1, self.task_count + 1)]


_REGISTRY: dict[str, Callable[..., TaskSequence]] = {}


def register_dataset(name: str, factory: Callable[..., TaskSequence]) -> None:
    _REGISTRY[name] = factory


def parse(ds_name: str, **kwargs) -> TaskSequence:
    """String -> dataset object (ref:src/data/dataset.py:13-40)."""
    # late imports register the built-ins
    from clsurvey_torch.data import (  # noqa: F401
        inaturalist, recogseq, synthetic, tinyimagenet)

    for key, factory in _REGISTRY.items():
        if ds_name == key or ds_name.startswith(key):
            return factory(ds_name=ds_name, **kwargs)
    raise NotImplementedError(f"DATASET NOT IMPLEMENTED: {ds_name}")


def merge_tasks(seq: TaskSequence, tasks: Sequence[int]) -> TaskData:
    """Label-shifted concat of tasks — the Joint baseline's merged dataset
    (ref:src/data/imgfolder.py ``ConcatDatasetDynamicLabels``,
    ref:src/methods/method.py:1185-1235 ``grid_datafetch``)."""
    splits = {}
    offset = 0
    classes: list[str] = []
    acc: dict[str, list] = {"train": [], "val": [], "test": []}
    for t in tasks:
        td = seq.get_task_dataset(t)
        for split_name in ("train", "val", "test"):
            sd: SplitData = getattr(td, split_name)
            acc[split_name].append((sd.images, sd.labels + offset))
        ncls = td.num_classes
        classes.extend([f"task{t}:{c}" for c in (
            td.classes or range(ncls))])
        offset += ncls
    for split_name, parts in acc.items():
        images = np.concatenate([p[0] for p in parts], axis=0)
        labels = np.concatenate([p[1] for p in parts], axis=0)
        splits[split_name] = SplitData(images, labels)
    return TaskData(splits["train"], splits["val"], splits["test"], classes)
