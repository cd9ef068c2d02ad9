"""The one place that picks the device and the float32 numerics.

Entry points run on ``cuda`` unless the caller asks for the CPU; asking for
``cuda`` without a card raises instead of carrying on on the CPU.

TF32 is switched off for both cuDNN convolutions and cuBLAS matrix
products: the CLI path computes in float32 (``parse_model_name`` defaults
``compute_dtype`` to float32), and TF32 would keep only about three decimal
digits of each product. The bf16 path casts explicitly and is unaffected.
cuDNN's autotuner is on: every training step of a task has the same
shapes, so the one-time search pays for itself.

Under a process group (``parallel/mesh.py``) ``cuda`` without an index is
the rank's card, ``cuda:{LOCAL_RANK % device_count}``."""

from __future__ import annotations

import torch

from clsurvey_torch.parallel import mesh as mesh_lib


def resolve(device: str | torch.device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {dev} requested but torch.cuda.is_available() is "
                f"False; pass --device cpu to run on the CPU")
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.benchmark = True
        mesh = mesh_lib.get_mesh(dev)
        if dev.index is None and mesh.distributed \
                and mesh.device.type == "cuda":
            dev = mesh.device
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev} (cuda or cpu)")
    return dev
