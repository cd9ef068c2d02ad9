"""Device-side image preprocessing: uint8 NHWC -> normalized, flipped.

Counterpart of ``clsurvey_tpu/ops/preprocess.py``. Images stay resident on
the device as uint8; each batch is normalized (``x * 1/(255*std) -
mean/std`` per channel) and, for training, flipped horizontally per sample.
On a CUDA tensor :func:`preprocess` launches kernel A
(``csrc/preprocess.cu``), which does both in one pass; on a CPU tensor it
runs the plain PyTorch version :func:`normalize_flip_plain`. Kernel A is
two kernels behind one C entry point, which picks by shape and alignment:
16-byte output chunks per thread, coalesced across a warp, where the row
width is a multiple of 8 and the pointers are 16-byte aligned, one pixel
per thread otherwise.

The flip mask is an argument, drawn by the caller from a
``torch.Generator``: torch cannot reproduce the JAX package's
``jax.random`` bits, so tests hand the same mask to both."""

from __future__ import annotations

import functools

import torch

from clsurvey_torch.ops import _kernels


def affine(mean, std) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-channel (scale, shift) in float32, computed exactly as the JAX
    package does: ``1/(255*std)`` and ``mean/std`` in float32 arithmetic
    (a float64 result cast down can differ in the last bit)."""
    std_t = torch.tensor(std, dtype=torch.float32)
    mean_t = torch.tensor(mean, dtype=torch.float32)
    return 1.0 / (255.0 * std_t), mean_t / std_t


@functools.lru_cache(maxsize=16)
def _affine_floats(mean: tuple, std: tuple) -> tuple[float, ...]:
    """``affine`` as six Python floats (exact float32 values), cached: the
    kernel takes them by value, and the train step calls it every batch."""
    scale, shift = affine(mean, std)
    return (*scale.tolist(), *shift.tolist())


def normalize(images_u8: torch.Tensor, mean, std,
              dtype=torch.float32) -> torch.Tensor:
    """(B,H,W,3) uint8 -> normalized ``dtype``; fused scale/shift form."""
    scale, shift = affine(mean, std)
    dev = images_u8.device
    out = images_u8.to(torch.float32) * scale.to(dev) - shift.to(dev)
    return out.to(dtype)


def random_flip(images: torch.Tensor, flip_mask: torch.Tensor) -> torch.Tensor:
    """Flip sample b horizontally where ``flip_mask[b]`` is nonzero."""
    flip = flip_mask.to(device=images.device, dtype=torch.bool)
    return torch.where(flip.view(-1, 1, 1, 1), images.flip(2), images)


def normalize_flip_plain(images_u8: torch.Tensor, mean, std,
                         flip_mask: torch.Tensor | None = None,
                         dtype=torch.float32) -> torch.Tensor:
    """Plain PyTorch version of kernel A."""
    x = normalize(images_u8, mean, std, dtype)
    return x if flip_mask is None else random_flip(x, flip_mask)


def _normalize_flip_cuda(images_u8: torch.Tensor, mean, std,
                         flip_mask: torch.Tensor | None,
                         dtype) -> torch.Tensor:
    if images_u8.dtype != torch.uint8 or images_u8.dim() != 4 \
            or images_u8.shape[-1] != 3:
        raise ValueError(f"kernel A takes (B,H,W,3) uint8, got "
                         f"{tuple(images_u8.shape)} {images_u8.dtype}")
    if not images_u8.is_contiguous():
        raise ValueError("kernel A takes a contiguous NHWC tensor")
    if dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"kernel A writes float32 or bfloat16, not {dtype}")
    if images_u8.numel() >= 2 ** 31:
        raise ValueError("kernel A indexes in 32 bits: split the batch")
    b, h, w, _ = images_u8.shape
    flip_ptr = None
    if flip_mask is not None:
        if flip_mask.device != images_u8.device \
                or flip_mask.dtype != torch.uint8 \
                or tuple(flip_mask.shape) != (b,) \
                or not flip_mask.is_contiguous():
            raise ValueError("kernel A's flip mask is a contiguous (B,) "
                             "uint8 tensor on the images' device")
        flip_ptr = flip_mask.data_ptr()
    out = torch.empty(images_u8.shape, dtype=dtype, device=images_u8.device)
    fn = _kernels.lib("preprocess").clsurvey_normalize_flip
    with torch.cuda.device(images_u8.device):
        rc = fn(images_u8.data_ptr(), flip_ptr, out.data_ptr(), b, h, w,
                int(dtype == torch.bfloat16),
                *_affine_floats(tuple(mean), tuple(std)),
                torch.cuda.current_stream(images_u8.device).cuda_stream)
    _kernels.record_launch(rc, "normalize_flip", b)
    return out


def preprocess(images_u8: torch.Tensor, mean, std,
               flip_mask: torch.Tensor | None = None,
               dtype=torch.float32) -> torch.Tensor:
    """Normalize, then flip where ``flip_mask`` says (no flip if None).
    Kernel A on a CUDA tensor, the plain version on a CPU tensor."""
    if images_u8.device.type == "cuda":
        return _normalize_flip_cuda(images_u8, mean, std, flip_mask, dtype)
    if images_u8.device.type != "cpu":
        raise ValueError(f"no preprocess path for {images_u8.device}")
    return normalize_flip_plain(images_u8, mean, std, flip_mask, dtype)
