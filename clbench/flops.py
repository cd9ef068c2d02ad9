"""Operations and bytes the work needs, from a configuration's shapes, and
the card's peaks.

A forward pass counts 2 H W k^2 C_in C_out for each conv (its output's H
and W) and 2 in out for each dense layer and for the task head; training
counts three forward passes (the forward, the input gradient and the
weight gradient), as ``chip_smoke.py:alexnet_train_flops_per_img`` and
``bench.py:vgg_train_flops_per_img`` count them: 4.261 GFLOP an image for
``alexnet224``, 0.469 for the survey's small_VGG9 at 64 px. A kernel's bytes count each
input byte read once and each output byte written once."""

from __future__ import annotations

from clbench.reference import net

# NVIDIA H100 SXM data sheet, dense, at the 700 W limit: float32 outside
# the tensor cores (the program keeps TF32 off), bfloat16 on them; HBM3
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}
HBM_BYTES_PER_S = 3.35e12


def forward_flops(cfg: dict) -> float:
    """One image's forward through the backbone and one task head."""
    flops = 0.0
    for layer, src, dst in net.shapes(cfg):
        if layer["op"] == "conv":
            flops += (2.0 * dst[1] * dst[2] * layer["k"] ** 2
                      * src[0] * dst[0])
        elif layer["op"] == "fc":
            flops += 2.0 * src[0] * dst[0]
    return flops + 2.0 * net.feature_dim(cfg) * cfg["classes_per_task"]


def train_flops(cfg: dict, extra_forwards: int = 0) -> float:
    """One train image: forward and backward, and the forwards a method
    adds (LwF's teacher)."""
    return (3 + extra_forwards) * forward_flops(cfg)


def preprocess_bytes(rows: int, px: int, flip: bool,
                     out_bytes: int = 4) -> int:
    """Kernel A on ``rows`` images: the uint8 pixels and the flip mask
    read, the normalised pixels written."""
    pixels = rows * px * px * 3
    return pixels + (rows if flip else 0) + pixels * out_bytes

