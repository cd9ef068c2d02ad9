"""Time kernel A's alternatives on the card, beside the adopted kernel.

    python -m clsurvey_torch.ops.tune_preprocess

Needs a CUDA card and ``nvcc``. Builds, into a temporary directory and all
at once, ``csrc/preprocess.cu`` with 2, 3, 4, 6 and 8 chunks in flight per
thread (``-DCLSURVEY_A_UNROLL=n``; the source's default is the adopted
one) and ``csrc/preprocess_group16.cu`` (16 pixels per thread, the form
designed first). Each variant is held against the plain PyTorch version at
the main path's shape, ``(200, 64, 64, 3)`` uint8 with and without a flip
mask, float32 within 1 ulp and bfloat16 bit-equal, and then timed with the
mask: the device time per call (CUPTI, through ``torch.profiler``) over
``ITERS`` calls, three rounds, variants interleaved within a round so that
a drift of the card's clocks falls on all of them. The scalar kernel of
``preprocess.cu`` is timed at the same shape through a pointer that is not
16-byte aligned, and an empty kernel on one warp and on the adopted
kernel's two grids. Prints one JSON line per variant and dtype with the
three rounds and their minimum, then the card's name and power limit."""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys
import tempfile

import torch

from clsurvey_torch.ops import _kernels, preprocess as pp
from clsurvey_torch.utils.devtime import time_ms

SHAPE = (200, 64, 64, 3)
MEAN = (0.485, 0.456, 0.406)
STD = (0.229, 0.224, 0.225)
UNROLLS = (2, 3, 4, 6, 8)
ITERS, ROUNDS = 200, 3
# the adopted kernel's grids at SHAPE: blocks of 128 threads
EMPTY_GRIDS = {"one warp": (1, 32), "bf16 grid": (1200, 128),
               "f32 grid": (2400, 128)}


def build_variants(out_dir: str) -> dict:
    """{variant: loaded library}; one nvcc per variant, started together."""
    jobs = {f"unroll {n}": ("preprocess", (f"-DCLSURVEY_A_UNROLL={n}",))
            for n in UNROLLS}
    jobs["group16"] = ("preprocess_group16", ())
    procs = {}
    for i, (variant, (source, defines)) in enumerate(jobs.items()):
        lib = os.path.join(out_dir, f"variant{i}.so")
        cmd = [_kernels.nvcc_path(), *_kernels.NVCC_FLAGS, *defines, "-o",
               lib, _kernels.source_path(source)]
        procs[variant] = (lib, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    libs = {}
    for variant, (lib, proc) in procs.items():
        out = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {variant}:\n{out}")
        for line in out.splitlines():
            if "registers" in line:
                print(f"[{variant}] {line.strip()}", flush=True)
        handle = ctypes.CDLL(lib)
        sigs = _kernels.SIGNATURES["preprocess"]
        handle.clsurvey_normalize_flip.argtypes = \
            sigs["clsurvey_normalize_flip"]
        handle.clsurvey_normalize_flip.restype = ctypes.c_int
        libs[variant] = handle
    return libs


def device_ms(fn, iters: int = ITERS) -> float:
    """Device time per call of ``fn``'s kernels, as the profiler saw it."""
    return time_ms(fn, iters=iters)[0]


def runner(handle, x, flip, out):
    """A call of ``handle``'s entry point on these tensors, no allocation."""
    args = (x.data_ptr(), None if flip is None else flip.data_ptr(),
            out.data_ptr(), *x.shape[:3], int(out.dtype == torch.bfloat16),
            *pp._affine_floats(MEAN, STD),
            torch.cuda.current_stream().cuda_stream)

    def run():
        rc = handle.clsurvey_normalize_flip(*args)
        if rc != 0:
            raise RuntimeError(f"launch failed: cudaError_t {rc}")
    return run


def agrees(got, want) -> bool:
    if got.dtype == torch.bfloat16:
        return torch.equal(got, want)
    ulp = (torch.nextafter(want, torch.full_like(want, float("inf")))
           - want).abs()
    return bool(((got - want).abs() <= ulp).all())


def main() -> int:
    if not torch.cuda.is_available():
        print("tune_preprocess: no CUDA device", file=sys.stderr)
        return 1
    gen = torch.Generator(device="cuda").manual_seed(0)
    n = 1
    for d in SHAPE:
        n *= d
    flat = torch.randint(0, 256, (n + 16,), dtype=torch.uint8,
                         device="cuda", generator=gen)
    x = flat[:n].view(SHAPE)
    shifted = flat[1:n + 1].view(SHAPE)  # 1 past a 16-byte boundary
    assert x.data_ptr() % 16 == 0 and shifted.data_ptr() % 16 == 1
    flip = torch.randint(0, 2, (SHAPE[0],), dtype=torch.uint8,
                         device="cuda", generator=gen)
    with tempfile.TemporaryDirectory() as tmp:
        libs = build_variants(tmp)
        adopted = _kernels.lib("preprocess")
        for dtype in (torch.float32, torch.bfloat16):
            out = torch.empty(SHAPE, dtype=dtype, device="cuda")
            runs = {}
            for variant, handle in libs.items():
                for mask in (flip, None):
                    out.zero_()
                    runner(handle, x, mask, out)()
                    torch.cuda.synchronize()
                    want = pp.normalize_flip_plain(x, MEAN, STD, mask, dtype)
                    if not agrees(out, want):
                        raise AssertionError(
                            f"{variant} disagrees with the plain version "
                            f"in {dtype} (flip mask: {mask is not None})")
                runs[variant] = runner(handle, x, flip, out)
            runs["scalar"] = runner(adopted, shifted, flip, out)
            times = {variant: [] for variant in runs}
            for _ in range(ROUNDS):
                for variant, run in runs.items():
                    times[variant].append(device_ms(run))
            for variant, ms in times.items():
                print(json.dumps({"kernel A": variant, "dtype": str(dtype),
                                  "shape": list(SHAPE), "device_ms": ms,
                                  "min_ms": min(ms)}), flush=True)
        stream = torch.cuda.current_stream().cuda_stream
        for what, (blocks, threads) in EMPTY_GRIDS.items():
            ms = [device_ms(lambda: adopted.clsurvey_empty_launch(
                blocks, threads, stream)) for _ in range(ROUNDS)]
            print(json.dumps({"empty kernel": what, "blocks": blocks,
                              "threads": threads, "device_ms": ms,
                              "min_ms": min(ms)}), flush=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
