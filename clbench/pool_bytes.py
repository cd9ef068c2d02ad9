"""Bytes the pool kernels B1 and B2 move, from a configuration's 2x2
stride-2 maxpool shapes, beside ``flops.py``'s operations.

B1 (``clsurvey_torch/csrc/pool.cu``) reads its input once and writes the
pooled values and a 1-byte code for each; B2 reads the codes and the
cotangent and writes the input's gradient. A train step pools each maxpool's
input forward and backward. Other pools (AlexNet's 3x3 stride-2) run no B1 or
B2 and count nothing."""

from __future__ import annotations

from clbench.reference import net

ITEMSIZE = {"float32": 4, "bfloat16": 2}


def pool_inputs(cfg: dict) -> list[tuple]:
    """(C, H, W) of the input of each 2x2 stride-2 maxpool, per image."""
    return [src for layer, src, _ in net.shapes(cfg)
            if layer["op"] == "maxpool"
            and (layer["k"], layer["stride"]) == (2, 2)]


def call_bytes(rows: int, shape, itemsize: int) -> int:
    """One call of B1 or B2 on ``rows`` images of input ``shape`` (C, H,
    W): the input (or its gradient), the values (or the cotangent) and the
    codes, each once."""
    c, h, w = shape
    return rows * c * (h * w * itemsize + (h // 2) * (w // 2) * (itemsize + 1))


def train_bytes(cfg: dict, rows: int, dtype: str) -> int:
    """B1 and B2 over every 2x2 pool of a train step on ``rows`` images."""
    return 2 * sum(call_bytes(rows, s, ITEMSIZE[dtype])
                   for s in pool_inputs(cfg))
