"""2-D convolution whose float32 weight gradient on the card is exact to
float32.

cuDNN 9.2, through PyTorch's v8/v9 engine interface (the only one that
runs bf16 convolutions), chose for float32 weight gradients engines far
less exact than float32 on an H100: AlexNet's 5x5 conv at batch 200 came
out 1.7e-2 of the largest entry off float64, small_VGG9's 3x3 convs up to
8.4e-5, while the forward and the input gradient stayed within 2.5e-6
(``python -m clsurvey_torch.utils.conv_precision`` measures both routes).

So :func:`conv2d` keeps cuDNN's forward and input gradient, and computes a
float32 weight gradient on the card with kernel C (``csrc/conv_wgrad.cu``,
:func:`weight_grad_cuda`): one implicit GEMM in float32 FFMAs straight
from the NHWC input and cotangent, its loader gathering the input's
patches into shared memory, split over the output pixels into slices that
a second pass sums in a fixed order (:func:`wgrad_plan` picks the tile and
the split from the call's shapes). Its result is laid out as the port's
channels_last weights are. :func:`weight_grad_plain`, its plain twin, is
the route of everything else (the CPU, float64) and of the card's calls
that :func:`takes_kernel`'s rule on shapes keeps from the kernel: the
input's patches written out a chunk of rows at a time, each chunk's
product added into the gradient by a GEMM. Under ``torch.func.vmap(grad)``
(MAS's per-sample pass, ``ops/importance.py``) the ``vmap`` rules fold the
samples into the batch, as ``ops/pool.py``'s do: one ``F.conv2d``
forward, one input gradient, and the per-sample form of the weight
gradient, each sample's pixels its own slices. bfloat16 and the CPU go to
``F.conv2d`` unchanged. While a profiler records, each of the three parts
is a span with the card's time (``utils/spans.py``): cuDNN's forward
``conv.fwd`` and its input gradient ``conv.dgrad`` in a sampled train step
only (``spans.step_span``), the weight gradient ``conv.wgrad``, each with
the call's rows."""

from __future__ import annotations

import functools
from dataclasses import dataclass

import torch
import torch.nn.functional as F

from clsurvey_torch.ops import _kernels
from clsurvey_torch.utils import spans

# bytes of patches a chunk of rows of the plain twin may write out
CHUNK_BYTES = 256 << 20

# kernel C's tiles (csrc/conv_wgrad.cu): patch columns a block; output
# pixels a stage, by the tile's rows of C_out
WGRAD_BN = 128
WGRAD_BK = {64: 16, 128: 8}
# the fewest stages a slice of the split over pixels holds: each block pays
# its pipeline's fill and its tile's write once
WGRAD_MIN_STEPS = 16
# the split's target: the blocks the card holds at once, times this (two
# to three were fastest at AlexNet's convs, one too few: PERF.md)
WGRAD_WAVES = 2
# a call whose patch rows have fewer columns (C_in k k) keeps the plain
# twin: a tile of 128 columns would be more than half empty (small_VGG9's
# first conv, 27 columns, ran 1.45 times slower through the kernel)
WGRAD_MIN_COLUMNS = 64


@dataclass(frozen=True)
class WgradPlan:
    """One call of kernel C: tile rows ``bm`` (C_out a block), the copies
    of the input (``route``) and of the cotangent (``dy_route``), "vec"
    (16 bytes) or "scalar" (a float), and the split of each group's
    ``pixels`` (all rows' output pixels, or one sample's) into ``slices``
    of ``chunk``; ``ws_floats`` the workspace's floats (0: none)."""
    bm: int
    route: str
    dy_route: str
    groups: int
    pixels: int
    slices: int
    chunk: int
    ws_floats: int


def wgrad_route(channels: int, ptr: int) -> str:
    """How kernel C copies an NHWC tensor of ``channels`` at ``ptr``:
    ``"vec"`` where the channels are a multiple of 4 and the pointer
    16-byte aligned, else ``"scalar"``; ``csrc/conv_wgrad.cu`` refuses a
    vec copy this does not allow."""
    return "scalar" if channels % 4 or ptr % 16 else "vec"


def wgrad_plan(w_shape, out_hw, rows: int, samples: int | None, route: str,
               dy_route: str, sms: int, resident) -> WgradPlan:
    """Kernel C's tile and split for a call: ``bm`` 128 where C_out is a
    multiple of 128, else 64 (C_out 64 and 192 fill their tiles); then the
    slices of each group's pixels that give about ``WGRAD_WAVES`` times the
    blocks that ``sms`` SMs hold at once (``resident(bm, route, dy_route)``
    an SM), each of at least ``WGRAD_MIN_STEPS`` stages, a whole number of
    stages long, none empty, and at most 65,535 in all."""
    cout, cin, kh, kw = w_shape
    groups = samples or 1
    bm = 128 if cout % 128 == 0 else 64
    bk = WGRAD_BK[bm]
    rows_pad = -(-cout // bm) * bm
    cols_pad = -(-(cin * kh * kw) // WGRAD_BN) * WGRAD_BN
    tiles = rows_pad // bm * cols_pad // WGRAD_BN * groups
    pixels = rows // groups * out_hw[0] * out_hw[1]
    steps = -(-pixels // bk)
    want = int(WGRAD_WAVES * sms * resident(bm, route, dy_route) // tiles)
    # the grid's third dimension holds groups * slices blocks
    slices = max(1, min(want, steps // WGRAD_MIN_STEPS, 65535 // groups))
    chunk = -(-steps // slices) * bk
    slices = -(-pixels // chunk)
    # one slice of unpadded tiles: the blocks write dW itself
    direct = slices == 1 and rows_pad == cout and cols_pad == cin * kh * kw
    return WgradPlan(bm, route, dy_route, groups, pixels, slices, chunk,
                     0 if direct else groups * slices * rows_pad * cols_pad)


@functools.cache
def _resident(bm: int, route: str, dy_route: str) -> int:
    """Blocks of kernel C an SM holds at once (the CUDA occupancy API)."""
    n = _kernels.lib("conv_wgrad").clsurvey_conv_wgrad_occupancy(
        bm, int(route == "vec"), int(dy_route == "vec"))
    if n <= 0:
        raise RuntimeError(f"kernel C: no occupancy for tile rows {bm}, "
                           f"copies {route} / {dy_route}")
    return n


def takes_kernel(x: torch.Tensor, dy: torch.Tensor, w_shape) -> bool:
    """Whether :func:`weight_grad` sends a call to kernel C: float32 on the
    card, rows, a square kernel of at least ``WGRAD_MIN_COLUMNS`` patch
    columns (C_in k k), and sizes inside the kernel's 32-bit offsets."""
    n, (_, cin, kh, kw) = x.shape[0], w_shape
    return (x.is_cuda and x.dtype == dy.dtype == torch.float32 and n > 0
            and kh == kw and cin * kh * kw >= WGRAD_MIN_COLUMNS
            and x.numel() // n * (n + 1) < 2 ** 31 and dy.numel() < 2 ** 31)


def weight_grad_cuda(x: torch.Tensor, dy: torch.Tensor, w_shape,
                     stride: int, padding: int,
                     samples: int | None = None) -> torch.Tensor:
    """Kernel C (``csrc/conv_wgrad.cu``): the weight gradient of
    :func:`weight_grad_plain` as one implicit GEMM over the NHWC input
    and cotangent, the patches gathered in the kernel, in the
    channels_last layout of the port's conv weights, on
    :func:`wgrad_plan`'s tile and split for this card."""
    cout, cin, k, _ = w_shape
    n, _, oh, ow = dy.shape
    if not takes_kernel(x, dy, w_shape) or dy.device != x.device \
            or dy.shape[1] != cout:
        raise ValueError(f"kernel C: cotangent {tuple(dy.shape)} "
                         f"{dy.dtype} for input {tuple(x.shape)} {x.dtype}, "
                         f"weight {tuple(w_shape)}")
    x_nhwc = x.permute(0, 2, 3, 1).contiguous()  # free for channels_last
    dy_nhwc = dy.permute(0, 2, 3, 1).contiguous()
    plan = wgrad_plan(w_shape, (oh, ow), n, samples,
                      wgrad_route(cin, x_nhwc.data_ptr()),
                      wgrad_route(cout, dy_nhwc.data_ptr()),
                      torch.cuda.get_device_properties(
                          x.device).multi_processor_count, _resident)
    ws = torch.empty(plan.ws_floats, device=x.device, dtype=torch.float32)
    # (V, C_out, k, k, C_in): the channels_last weight's own layout
    out = torch.empty((plan.groups, cout, k, k, cin), device=x.device,
                      dtype=torch.float32).permute(0, 1, 4, 2, 3)
    fn = _kernels.lib("conv_wgrad").clsurvey_conv_wgrad
    with torch.cuda.device(x.device):
        rc = fn(x_nhwc.data_ptr(), dy_nhwc.data_ptr(),
                ws.data_ptr() if plan.ws_floats else None,
                out.data_ptr(), n, x.shape[2], x.shape[3], cin, oh, ow, cout,
                k, stride, padding, plan.groups, plan.slices, plan.chunk,
                plan.bm, int(plan.route == "vec"),
                int(plan.dy_route == "vec"),
                torch.cuda.current_stream(x.device).cuda_stream)
    _kernels.record_launch(rc, "conv_wgrad", n, plan.route)
    return out if samples else out[0]


def weight_grad(x: torch.Tensor, dy: torch.Tensor, w_shape, stride: int,
                padding: int, samples: int | None = None,
                chunk_bytes: int = CHUNK_BYTES) -> torch.Tensor:
    """d loss / d weight of ``F.conv2d(x, w, stride=, padding=)`` given the
    output cotangent ``dy``, (V, *w_shape) with ``samples`` = V (the rows
    V samples' one after another, each sample's gradient): kernel C where
    :func:`takes_kernel` says so, else :func:`weight_grad_plain`. One
    ``conv.wgrad`` span either way."""
    with spans.span("conv.wgrad", dy.shape[0], device=x.is_cuda):
        if takes_kernel(x, dy, w_shape):
            return weight_grad_cuda(x, dy, w_shape, stride, padding, samples)
        return weight_grad_plain(x, dy, w_shape, stride, padding, samples,
                                 chunk_bytes)


def weight_grad_plain(x: torch.Tensor, dy: torch.Tensor, w_shape,
                      stride: int, padding: int, samples: int | None = None,
                      chunk_bytes: int = CHUNK_BYTES) -> torch.Tensor:
    """Kernel C's plain twin, and the route of every call that is not
    float32 on the card: the sum over rows and output pixels of ``dy``
    times the input patch, ``dy^T @ patches``, a chunk of rows at a time.
    The patches are strided windows of the NHWC input (``Tensor.unfold``),
    written out once as a (pixels, C_in kh kw) matrix for the GEMM. With
    ``samples`` = V the rows are V samples' one after another, and the
    result is each sample's gradient, (V, *w_shape): a chunk of whole
    samples a batched GEMM."""
    cout, cin, kh, kw = w_shape
    n, _, oh, ow = dy.shape
    v = samples or 1
    per = n // v  # rows of one sample
    width = cin * kh * kw
    rows = max(1, chunk_bytes // (oh * ow * width * x.element_size()))
    if samples:
        rows = max(per, rows // per * per)
    x_nhwc = x.permute(0, 2, 3, 1)  # free for channels_last
    dy_rows = dy.permute(0, 2, 3, 1)
    gw = torch.zeros(v, cout, width, device=x.device, dtype=x.dtype)
    for i in range(0, n, rows):
        xp = x_nhwc[i:i + rows]
        if padding:
            xp = F.pad(xp, (0, 0, padding, padding, padding, padding))
        patches = xp.unfold(1, kh, stride).unfold(2, kw, stride)
        k = xp.shape[0] // per  # samples in the chunk
        if samples:
            gw[i // per:i // per + k].baddbmm_(
                dy_rows[i:i + rows].reshape(k, -1, cout).transpose(1, 2),
                patches.reshape(k, -1, width))
        else:  # (b oh ow, C_in kh kw)
            gw[0].addmm_(dy_rows[i:i + rows].reshape(-1, cout).t(),
                         patches.reshape(-1, width))
    return gw.view(v, *w_shape) if samples else gw.view(w_shape)


def _fold(t: torch.Tensor, dim: int | None, v: int) -> torch.Tensor:
    """A vmapped operand ``(.., V at dim, ..)`` -> ``(V*B, C, H, W)``; one
    that is not batched (``dim`` None) is repeated."""
    t = t.unsqueeze(0).expand(v, *t.shape) if dim is None \
        else t.movedim(dim, 0)
    return t.reshape(v * t.shape[1], *t.shape[2:])


def _unbatched(in_dims, what: str) -> None:
    if any(d is not None for d in in_dims):
        raise NotImplementedError(
            f"conv2d under vmap: a batched {what} (only the input and its "
            "cotangent may carry the vmapped dimension)")


class Conv2dBackward(torch.autograd.Function):
    """The backward of :class:`Conv2dExactWeightGrad` as a function of its
    own, so that its ``vmap`` rule sees real tensors under ``torch.func``
    (the pool's ``MaxPool2x2Backward`` pattern). Returns (input, weight,
    bias) gradients, None where ``needs`` says so."""

    @staticmethod
    def forward(x, weight, dy, stride: int, padding: int, needs: tuple):
        gx = gw = gb = None
        if needs[0]:
            with spans.step_span("conv.dgrad", dy.shape[0], device=dy.is_cuda):
                gx = torch.nn.grad.conv2d_input(x.shape, weight, dy,
                                                stride=stride,
                                                padding=padding)
        if needs[1]:
            gw = weight_grad(x, dy, weight.shape, stride, padding)
        if needs[2]:
            gb = dy.sum((0, 2, 3))
        return gx, gw, gb

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, *grads):
        raise NotImplementedError(
            "conv2d's exact weight gradient is differentiable once")

    @staticmethod
    def vmap(info, in_dims, x, weight, dy, stride, padding, needs):
        _unbatched(in_dims[1:2], "weight")
        v = info.batch_size
        xf, dyf = _fold(x, in_dims[0], v), _fold(dy, in_dims[2], v)
        gx = gw = gb = None
        if needs[0]:
            with spans.step_span("conv.dgrad", dyf.shape[0],
                                 device=dyf.is_cuda):
                gx = torch.nn.grad.conv2d_input(xf.shape, weight, dyf,
                                                stride=stride,
                                                padding=padding)
            gx = gx.view(v, -1, *gx.shape[1:])
        if needs[1]:
            gw = weight_grad(xf, dyf, weight.shape, stride, padding,
                             samples=v)
        if needs[2]:
            gb = dyf.view(v, -1, *dyf.shape[1:]).sum((1, 3, 4))
        return (gx, gw, gb), tuple(None if g is None else 0
                                   for g in (gx, gw, gb))


class Conv2dExactWeightGrad(torch.autograd.Function):
    """``F.conv2d`` forward and input gradient; :func:`weight_grad`. Under
    ``torch.func.vmap`` the samples fold into the batch: one ``F.conv2d``
    forward, and :class:`Conv2dBackward`'s rule for the gradients."""

    @staticmethod
    def forward(x, weight, bias, stride: int, padding: int):
        with spans.step_span("conv.fwd", x.shape[0], device=x.is_cuda):
            return F.conv2d(x, weight, bias, stride=stride, padding=padding)

    @staticmethod
    def setup_context(ctx, inputs, output):
        x, weight, bias, stride, padding = inputs
        ctx.save_for_backward(x, weight)
        ctx.stride, ctx.padding = stride, padding
        ctx.has_bias = bias is not None

    @staticmethod
    def backward(ctx, dy):
        x, weight = ctx.saved_tensors
        needs = (ctx.needs_input_grad[0], ctx.needs_input_grad[1],
                 ctx.has_bias and ctx.needs_input_grad[2])
        gx, gw, gb = Conv2dBackward.apply(x, weight, dy, ctx.stride,
                                          ctx.padding, needs)
        return gx, gw, gb, None, None

    @staticmethod
    def vmap(info, in_dims, x, weight, bias, stride, padding):
        _unbatched(in_dims[1:3], "weight or bias")
        v = info.batch_size
        xf = _fold(x, in_dims[0], v)
        with spans.step_span("conv.fwd", xf.shape[0], device=xf.is_cuda):
            y = F.conv2d(xf, weight, bias, stride=stride, padding=padding)
        return y.view(v, -1, *y.shape[1:]), 0


def conv2d(x: torch.Tensor, weight: torch.Tensor,
           bias: torch.Tensor | None = None, stride: int = 1,
           padding: int = 0) -> torch.Tensor:
    """``F.conv2d`` (square stride and padding), with an exact float32
    weight gradient on the card (:class:`Conv2dExactWeightGrad`)."""
    if (x.is_cuda and x.dtype == torch.float32
            and weight.dtype == torch.float32):
        return Conv2dExactWeightGrad.apply(x, weight, bias, stride, padding)
    return F.conv2d(x, weight, bias, stride=stride, padding=padding)
