"""Time kernels B1 and B2's routes, and another tree's pool pair, on the
card.

    python -m clsurvey_torch.ops.tune_pool [--baseline OTHER/pool.cu]

Needs a CUDA card and ``nvcc``. Builds ``csrc/pool.cu`` as the port does
and, with ``--baseline``, another tree's ``pool.cu`` (a parent commit's,
unpacked with ``git archive``) into a temporary directory, both compilers
started together; the baseline is called through its
``clsurvey_pool_fwd`` / ``clsurvey_pool_bwd`` entry points, whose
signature this file keeps. At each of the four pool inputs of a
small_VGG9 step at 64 px, batch 200, in float32 and bfloat16, the vec
route, the scalar route and the baseline are held bit-exact against the
plain PyTorch versions, then timed with ``utils/devtime.py`` (the timing
of ``chip_smoke.py``): device time per call over ``ITERS`` calls, warm and
on a cold L2, three rounds with the versions interleaved. Prints one JSON
line per kernel, dtype, shape and version with the rounds, their minimum
and the share of the byte bound (HBM at 3.35 TB/s) the cold minimum
reaches, then the card's name and power limit."""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys
import tempfile

import torch

from clsurvey_torch.ops import _kernels, pool
from clsurvey_torch.utils.devtime import cold_ms, time_ms

SHAPES = ((200, 64, 64, 64), (200, 32, 32, 64), (200, 16, 16, 64),
          (200, 8, 8, 128))
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
FLUSH_BYTES = 128 << 20    # above the 50 MB L2
ITERS, ROUNDS = 50, 3


def build(out_dir: str, baseline: str | None) -> dict:
    """{version: loaded library}: this tree's, and the baseline's where
    one is given; prints each build's ptxas report."""
    proc = None
    if baseline:
        lib = os.path.join(out_dir, "baseline.so")
        proc = subprocess.Popen(
            [_kernels.nvcc_path(), *_kernels.NVCC_FLAGS, "-o", lib,
             baseline], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)
    logs = {"this tree": _kernels.build(["pool"]).get("pool", "cached")}
    libs = {"this tree": _kernels.lib("pool")}
    if proc is not None:
        logs["baseline"] = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {baseline}:\n"
                               f"{logs['baseline']}")
        handle = ctypes.CDLL(lib)
        for fn, argtypes in _kernels.SIGNATURES["pool"].items():
            if not fn.endswith("_route"):
                getattr(handle, fn).argtypes = argtypes
                getattr(handle, fn).restype = ctypes.c_int
        libs["baseline"] = handle
    for version, out in logs.items():
        for line in out.splitlines():
            if "ptxas" in line:
                print(f"[{version}] {line.strip()}", flush=True)
    return libs


def runners(handle, x, g, route: str | None):
    """(B1 call, B2 call) of ``handle`` on ``route`` (None: the entry
    points without a route, a baseline's), no allocation."""
    b, h, w, c = x.shape
    val = torch.empty_like(g)
    code = torch.empty(g.shape, dtype=torch.uint8, device=x.device)
    dx = torch.empty_like(x)
    stream = torch.cuda.current_stream().cuda_stream
    bf16 = int(x.dtype == torch.bfloat16)
    extra = () if route is None else (pool.ROUTE_CODES[route],)
    fwd_fn = handle.clsurvey_pool_fwd if route is None \
        else handle.clsurvey_pool_fwd_route
    bwd_fn = handle.clsurvey_pool_bwd if route is None \
        else handle.clsurvey_pool_bwd_route

    def fwd():
        rc = fwd_fn(x.data_ptr(), val.data_ptr(), code.data_ptr(), b, h, w,
                    c, bf16, *extra, stream)
        if rc != 0:
            raise RuntimeError(f"B1 launch failed: cudaError_t {rc}")

    def bwd():
        rc = bwd_fn(g.data_ptr(), code.data_ptr(), dx.data_ptr(), b, h, w,
                    c, bf16, *extra, stream)
        if rc != 0:
            raise RuntimeError(f"B2 launch failed: cudaError_t {rc}")

    return fwd, bwd, (val, code, dx)


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--baseline", help="another tree's csrc/pool.cu, timed "
                                       "beside this one")
    baseline = ap.parse_args(argv).baseline
    if not torch.cuda.is_available():
        print("tune_pool: no CUDA device", file=sys.stderr)
        return 1
    gen = torch.Generator(device="cuda").manual_seed(0)
    scratch = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    flush = scratch.bitwise_not_
    with tempfile.TemporaryDirectory() as tmp:
        libs = build(tmp, baseline)
        for dtype in (torch.float32, torch.bfloat16):
            for shape in SHAPES:
                x = torch.randint(0, 3, shape, device="cuda",
                                  generator=gen).to(dtype)
                pval, pcode = pool.pool_fwd_plain(x)
                g = torch.randn(pval.shape, device="cuda",
                                generator=gen).to(dtype)
                pdx = pool.pool_bwd_plain(g, pcode, x.shape)
                calls = {}
                for version, handle in libs.items():
                    routes = ("vec", "scalar") if version == "this tree" \
                        else (None,)
                    for route in routes:
                        fwd, bwd, (val, code, dx) = runners(handle, x, g,
                                                            route)
                        fwd()
                        bwd()
                        torch.cuda.synchronize()
                        name = route or version
                        if not (torch.equal(val, pval)
                                and torch.equal(code, pcode)
                                and torch.equal(dx, pdx)):
                            raise AssertionError(
                                f"{name} disagrees with the plain "
                                f"versions at {shape} {dtype}")
                        calls[("B1", name)] = fwd
                        calls[("B2", name)] = bwd
                times = {key: {"warm": [], "cold": []} for key in calls}
                for _ in range(ROUNDS):
                    for key, fn in calls.items():
                        times[key]["warm"].append(
                            time_ms(fn, iters=ITERS)[0])
                        times[key]["cold"].append(
                            cold_ms(fn, flush, iters=ITERS))
                esz = x.element_size()
                nbytes = x.numel() * esz + pval.numel() * (esz + 1)
                bound = nbytes / HBM_BYTES_PER_S * 1e3
                for (kernel, name), t in times.items():
                    print(json.dumps({
                        "kernel": kernel, "version": name,
                        "dtype": str(dtype), "shape": list(shape),
                        "warm_ms": t["warm"], "cold_ms": t["cold"],
                        "warm_min_ms": min(t["warm"]),
                        "cold_min_ms": min(t["cold"]), "bound_ms": bound,
                        "cold_share": bound / min(t["cold"])}), flush=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
