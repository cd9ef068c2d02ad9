"""The one generator of a cell's inputs, read from its traffic file.

A traffic file (``clbench/workloads/<cell>.json``) gives the rows of the
task's train and val splits, where the train split lives (``resident`` on
the card, or ``stream`` from the host: the program decides by its data
budget and the harness checks the two agree), the batch, the learning rate,
whether training flips, the method and its hyperparameters, and the limits
of the correctness check. The images are uniform random uint8 at the
configuration's size, the labels uniform over its classes, all drawn from
the seed on the device in large calls; a streamed split is drawn in blocks
and copied to the host, where a user's split would be. Every seed gives the
same sizes and shapes, so seeds change the values and never the work.
Plain PyTorch."""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from clbench import seeds

# rows of a streamed split drawn on the device a block at a time
HOST_BLOCK_ROWS = 3000


@dataclass
class Split:
    images: object  # (n, px, px, 3) uint8: a device tensor, or numpy
    labels: object  # (n,) int64: a device tensor, or numpy

    @property
    def rows(self) -> int:
        return int(self.images.shape[0])

    @property
    def nbytes(self) -> int:
        return int(np.prod(self.images.shape))


def _draw(n: int, px: int, classes: int, gen, device) -> tuple:
    images = torch.randint(0, 256, (n, px, px, 3), dtype=torch.uint8,
                           device=device, generator=gen)
    labels = torch.randint(0, classes, (n,), device=device, generator=gen)
    return images, labels


def make_split(workload: dict, cfg: dict, seed: int, which: str,
               device) -> Split:
    """The ``train`` or ``val`` split of the cell; a train split that the
    traffic streams is made on the host."""
    n = int(workload[f"{which}_rows"])
    px, classes = int(cfg["input_px"]), int(cfg["classes_per_task"])
    stream = seeds.TRAIN_DATA if which == "train" else seeds.VAL_DATA
    gen = seeds.generator(seed, stream, device=device)
    if which == "val" or workload["residency"] == "resident":
        return Split(*_draw(n, px, classes, gen, device))
    images = np.empty((n, px, px, 3), np.uint8)
    labels = np.empty((n,), np.int64)
    for lo in range(0, n, HOST_BLOCK_ROWS):
        hi = min(lo + HOST_BLOCK_ROWS, n)
        x, y = _draw(hi - lo, px, classes, gen, device)
        images[lo:hi] = x.cpu().numpy()
        labels[lo:hi] = y.cpu().numpy()
    return Split(images, labels)


def rows(split: Split, idx: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(images, labels) of rows ``idx`` of ``split``, copied to the host."""
    if isinstance(split.images, np.ndarray):
        i = idx.numpy()
        return (torch.from_numpy(split.images[i]),
                torch.from_numpy(split.labels[i]))
    dev = split.images.device
    return (split.images.index_select(0, idx.to(dev)).cpu(),
            split.labels.index_select(0, idx.to(dev)).cpu())
