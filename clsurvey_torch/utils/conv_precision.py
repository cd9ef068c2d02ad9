"""Float32 convolutions against float64 on the card: cuDNN's and the
port's.

    python -m clsurvey_torch.utils.conv_precision

For each conv of AlexNet at 224 px and of small_VGG9 at 64 px, at batch
200 and in the port's channels_last layout, under the port's settings
(:func:`clsurvey_torch.utils.device.resolve`: TF32 off, the autotuner on):
the forward, the input gradient and the weight gradient in float32, each
as max |float32 - float64| over the largest float64 entry (float64 on the
card), through ``F.conv2d`` (cuDNN throughout) and through the port's
:func:`clsurvey_torch.ops.conv.conv2d` (cuDNN's forward and input
gradient, the weight gradient kernel C, ``csrc/conv_wgrad.cu``; its plain
twin at small_VGG9's first conv), and the device ms of one
float32 forward + backward of each (CUPTI, through ``utils/devtime.py``).
Inputs are ReLU'd normals, as a conv after ReLU sees; weights are
He-scaled normals; the cotangent is normal.

:func:`measure_per_sample` does the same for MAS's per-sample route
(``ops/importance.py``): ``torch.func.vmap(torch.func.grad)`` over a chunk
of ``CHUNK`` samples of one row each, each sample's input and weight
gradient against float64 (the error the largest over the samples, each
over its own largest entry), through ``F.conv2d`` and through the port's
``conv2d`` (:class:`clsurvey_torch.ops.conv.Conv2dExactWeightGrad` under
its ``vmap`` rules). Prints a JSON line for each of the two,
then the card's name and power limit. Needs a CUDA card; ``chip_smoke.py``
holds the port's errors."""

from __future__ import annotations

import json
import subprocess
import sys

import torch
import torch.nn.functional as F

# name: (C_in, C_out, kernel, stride, padding, input side)
SHAPES = {
    "alexnet.conv_0": (3, 64, 11, 4, 2, 224),
    "alexnet.conv_1": (64, 192, 5, 1, 2, 27),
    "alexnet.conv_2": (192, 384, 3, 1, 1, 13),
    "alexnet.conv_3": (384, 256, 3, 1, 1, 13),
    "alexnet.conv_4": (256, 256, 3, 1, 1, 13),
    "small_VGG9.conv_0": (3, 64, 3, 1, 1, 64),
    "small_VGG9.conv_1": (64, 64, 3, 1, 1, 64),
    "small_VGG9.conv_2": (64, 128, 3, 1, 1, 32),
    "small_VGG9.conv_3": (128, 128, 3, 1, 1, 32),
    "small_VGG9.conv_4": (128, 256, 3, 1, 1, 16),
    "small_VGG9.conv_5": (256, 256, 3, 1, 1, 8),
}
BATCH = 200
CHUNK = 16  # MAS's chunk of samples (ops/importance.py:mas_importance)


def _rel(got: torch.Tensor, want: torch.Tensor) -> float:
    return float((got.double() - want).abs().max() / want.abs().max())


def _inputs(gen, shape, n: int):
    """float64 ReLU'd input, He-scaled weight, on the card."""
    cin, cout, k, _, _, hw = shape
    x = torch.relu(torch.randn(n, cin, hw, hw, generator=gen, device="cuda",
                               dtype=torch.float64))
    w = torch.randn(cout, cin, k, k, generator=gen, device="cuda",
                    dtype=torch.float64) * (2.0 / (cin * k * k)) ** 0.5
    return x, w


def _float32(*ts):
    return [t.detach().float().contiguous(memory_format=torch.channels_last)
            for t in ts]


def measure(routes=("port",), timed: bool = False) -> dict:
    """{route: {conv name: {"fwd", "dgrad", "wgrad": relative error[,
    "ms"]}}} on ``cuda`` under the current settings; a route is "port"
    (:func:`clsurvey_torch.ops.conv.conv2d`) or "cudnn" (``F.conv2d``)."""
    from clsurvey_torch.ops.conv import conv2d
    from clsurvey_torch.utils.devtime import time_ms

    fns = {"port": conv2d, "cudnn": F.conv2d}
    gen = torch.Generator(device="cuda").manual_seed(0)
    out = {route: {} for route in routes}
    for name, (cin, cout, k, st, p, hw) in SHAPES.items():
        x, w = _inputs(gen, SHAPES[name], BATCH)
        x.requires_grad_()
        w.requires_grad_()
        # the float64 reference runs once: no autotuner search for it
        bench, torch.backends.cudnn.benchmark = \
            torch.backends.cudnn.benchmark, False
        try:
            y = F.conv2d(x, w, stride=st, padding=p)
            dy = torch.randn(y.shape, generator=gen, device="cuda",
                             dtype=torch.float64)
            gx, gw = torch.autograd.grad(y, (x, w), dy)
        finally:
            torch.backends.cudnn.benchmark = bench
        x32, w32, dy32 = _float32(x, w, dy)
        x32.requires_grad_()
        w32.requires_grad_()
        for route in routes:
            def step(fn=fns[route]):
                y32 = fn(x32, w32, stride=st, padding=p)
                return (y32,) + torch.autograd.grad(y32, (x32, w32), dy32)

            y32, gx32, gw32 = step()
            row = {"fwd": _rel(y32.detach(), y.detach()),
                   "dgrad": _rel(gx32, gx), "wgrad": _rel(gw32, gw)}
            if timed:
                row["ms"] = time_ms(step, iters=5, warmup=2)[0]
            out[route][name] = row
    return out


def _per_sample_grads(fn, x, w, dy, stride: int, padding: int):
    """(input, weight) gradient of <fn(x_v), dy_v> for each sample v,
    through ``vmap(grad)`` over one row a sample, as MAS's pass runs."""
    def loss(row, weight, cot):
        return (fn(row[None], weight, stride=stride, padding=padding)
                * cot[None]).sum()

    return torch.func.vmap(torch.func.grad(loss, argnums=(0, 1)),
                           in_dims=(0, None, 0))(x, w, dy)


def _rel_per_sample(got: torch.Tensor, want: torch.Tensor) -> float:
    """The largest over the samples of each one's :func:`_rel`."""
    err = (got.double() - want).abs().flatten(1).amax(1)
    return float((err / want.abs().flatten(1).amax(1)).max())


def measure_per_sample(routes=("port",), timed: bool = False,
                       chunk: int = CHUNK) -> dict:
    """{route: {conv name: {"dgrad", "wgrad": relative error[, "ms"]}}}:
    each conv's per-sample input and weight gradients over ``chunk``
    samples, float32 on ``cuda`` against float64, through ``vmap(grad)``;
    a route is "port" or "cudnn", as in :func:`measure`."""
    from clsurvey_torch.ops.conv import conv2d
    from clsurvey_torch.utils.devtime import time_ms

    fns = {"port": conv2d, "cudnn": F.conv2d}
    gen = torch.Generator(device="cuda").manual_seed(1)
    out = {route: {} for route in routes}
    for name, (cin, cout, k, st, p, hw) in SHAPES.items():
        x, w = _inputs(gen, SHAPES[name], chunk)
        oh = (hw + 2 * p - k) // st + 1
        dy = torch.randn(chunk, cout, oh, oh, generator=gen, device="cuda",
                         dtype=torch.float64)
        bench, torch.backends.cudnn.benchmark = \
            torch.backends.cudnn.benchmark, False
        try:
            gx, gw = _per_sample_grads(F.conv2d, x, w, dy, st, p)
        finally:
            torch.backends.cudnn.benchmark = bench
        x32, w32, dy32 = _float32(x, w, dy)
        for route in routes:
            step = lambda fn=fns[route]: _per_sample_grads(
                fn, x32, w32, dy32, st, p)
            gx32, gw32 = step()
            row = {"dgrad": _rel_per_sample(gx32, gx),
                   "wgrad": _rel_per_sample(gw32, gw)}
            if timed:
                row["ms"] = time_ms(step, iters=5, warmup=2)[0]
            out[route][name] = row
    return out


def main() -> int:
    from clsurvey_torch.utils.device import resolve

    resolve("cuda")
    print(json.dumps({"cudnn": torch.backends.cudnn.version(),
                      "torch": torch.__version__,
                      **measure(("cudnn", "port"), timed=True)}), flush=True)
    print(json.dumps({"per_sample": f"vmap(grad), {CHUNK} samples",
                      **measure_per_sample(("cudnn", "port"), timed=True)}),
          flush=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
