"""The streams of randomness a run draws from its ``--seed``.

Every input of a run (images, labels, weights, the teacher's weights, each
epoch's permutation and the generator of its flip and dropout draws) comes
from one stream, named here, so the harness and the plain reference derive
the same values from the same seed. A seed is any whole number; it is mixed
with the stream's numbers into 63 bits, as ``torch.Generator.manual_seed``
takes them."""

from __future__ import annotations

import torch

TRAIN_DATA, VAL_DATA, WEIGHTS, TEACHER = 1, 2, 3, 4
PERM, DRAWS = 10, 11


def mix(seed: int, *stream: int) -> int:
    mixed = int(seed) % (2 ** 63)
    for s in stream:
        mixed = (mixed * 1_000_003 + int(s)) % (2 ** 63)
    return mixed


def generator(seed: int, *stream: int, device="cpu") -> torch.Generator:
    return torch.Generator(device=device).manual_seed(mix(seed, *stream))


def permutation(seed: int, epoch: int, n: int) -> torch.Tensor:
    """Epoch ``epoch``'s order of the ``n`` train rows, drawn on the host
    as the program's task loop draws its own."""
    return torch.randperm(n, generator=generator(seed, PERM, epoch))


def draw_generator(seed: int, epoch: int, device) -> torch.Generator:
    """The device generator epoch ``epoch`` draws its flips and dropout
    masks from, in the program's order."""
    return generator(seed, DRAWS, epoch, device=device)
