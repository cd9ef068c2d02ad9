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
from the NHWC input and cotangent, the input's patches gathered into
shared memory, split over the output pixels into slices that a second
pass sums in a fixed order. It has two designs: a warp-specialised one (a
producer warpgroup filling a ring of stages by TMA and cp.async, two
warpgroups of FFMAs) and the first one, each thread its own loader;
:func:`wgrad_design` picks one from what the call shows, and
:func:`wgrad_plan` the tile and the split. Its result is laid out as the
port's channels_last weights are. :func:`weight_grad_plain`, its plain twin, is
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

# the first design's split: the fewest stages a slice holds (each block
# pays its pipeline's fill and its tile's write once), and its target, the
# blocks the card holds at once times WGRAD_WAVES (two to three were
# fastest at AlexNet's convs, one too few: PERF.md)
WGRAD_MIN_STEPS = 16
WGRAD_WAVES = 2
# the warp-specialised design's split, one block an SM: the slices whose
# waves of blocks, each ceil(stages / slices) stages long plus this many
# for its fill, its sets' sum and its tile's write, end first
WGRAD_WS_BLOCK_STAGES = 6
# ... at most this many waves of blocks, and this many workspace floats
WGRAD_WS_MAX_WAVES = 16
WGRAD_WS_MAX_FLOATS = 64 << 20
# the warp-specialised design takes a group of at least this many output
# pixels (wgrad_design)
WGRAD_WS_MIN_PIXELS = 512
# a call whose patch rows have fewer columns (C_in k k) keeps the plain
# twin: a tile of 128 columns would be more than half empty (small_VGG9's
# first conv, 27 columns, ran 1.45 times slower through the kernel)
WGRAD_MIN_COLUMNS = 64


def wgrad_tile(route: str, cout: int) -> tuple[int, int, int]:
    """Kernel C's tile on ``route`` (:func:`wgrad_design`) at ``cout``
    output channels: (rows of C_out, patch columns, output pixels a
    stage), as ``csrc/conv_wgrad.cu`` takes them."""
    if route == "ws":
        return (256, 96, 16) if cout % 256 == 0 else (128, 192, 16)
    return (128, 128, 8) if cout % 128 == 0 else (64, 128, 16)


@dataclass(frozen=True)
class WgradPlan:
    """One call of kernel C: tile rows ``bm`` (C_out a block) and columns
    ``bn``, ``bk`` pixels a stage, its ``route`` ("ws": the
    warp-specialised design; "vec" / "scalar": the first design, the input
    copied 16 bytes or a float at a time) and ``dy_route`` (the
    cotangent's copies, "vec" or "scalar"), and the split of each group's
    ``pixels`` (all rows' output pixels, or one sample's) into ``slices``
    of ``chunk``; ``ws_floats`` the workspace's floats (0: none)."""
    bm: int
    bn: int
    bk: int
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


@functools.lru_cache(maxsize=4096)
def _ws_slices(tiles: int, steps: int, slots: int, most: int) -> int:
    """The warp-specialised design's slices of ``steps`` stages, at most
    ``most``: the fewest whose waves of ``tiles`` x slices blocks over
    ``slots`` (one block an SM) end first, each block ceil(steps / slices)
    stages plus ``WGRAD_WS_BLOCK_STAGES``. A fixed cost model, so equal
    shapes get equal slices."""
    def cost(s):
        per = -(-steps // s)
        waves = -(-tiles * -(-steps // per) // slots)
        return waves * (per + WGRAD_WS_BLOCK_STAGES), s

    return min(range(1, most + 1), key=cost)


def wgrad_design(route: str, dy_route: str, cout: int, pixels: int) -> str:
    """Kernel C's route for a call whose input and cotangent copy on
    ``route`` and ``dy_route`` (:func:`wgrad_route`), with ``cout`` output
    channels and ``pixels`` output pixels a group: the warp-specialised
    design ("ws") where both copy 16 bytes at a time, C_out is a multiple
    of 128 and a group holds at least ``WGRAD_WS_MIN_PIXELS``; else the
    first design on the input's route. No knob: the rule reads only the
    call.

    The reading behind it (PERF.md §6; both designs timed in turns on
    one H100 at the cells' shapes, batch 200): the warp-specialised design
    ran 70-76% of the FFMA bound where C_out is a multiple of 256 (its 256
    x 96 tile) and 67-73% at C_out 128 and 384 (128 x 192), against the
    first design's 57-71%. A 64 x 192 tile, one reading a conv: at C_out
    192 (AlexNet's conv_1) 51.3% against the first design's 61.6%; at
    C_out 64, 59.9% against 58.9% (VGG-16's conv1_2) and 59.5% against
    57.9% (small_VGG9's conv_1), a gain inside what the first design's own
    variants moved (1-3%), too small to keep a third tile for. So C_out 64
    and 192 keep the first design. Per sample (MAS's 16 samples of one
    row) the warp-specialised design was faster at 784 pixels a sample
    and more, slower at 64-256 (small_VGG9's last convs, VGG-16's 14 x
    14), and even at 169 (AlexNet) and 1,024."""
    if (route == dy_route == "vec" and cout % 128 == 0
            and pixels >= WGRAD_WS_MIN_PIXELS):
        return "ws"
    return route


def wgrad_plan(w_shape, out_hw, rows: int, samples: int | None, route: str,
               dy_route: str, sms: int, resident) -> WgradPlan:
    """Kernel C's tile and split for a call on ``route``, the design that
    :func:`wgrad_design`'s rule picks from the call's copies, C_out and
    pixels a group (its docstring gives the card's reading behind it):
    :func:`wgrad_tile`'s ``bm`` x ``bn`` tile (the first design's 64 rows
    where C_out is 64 or 192, so that they fill it) and ``bk`` pixels a
    stage; then slices of each group's pixels, a whole number of stages
    long, none empty, at most 65,535 in all. The first design's give
    about ``WGRAD_WAVES`` times the blocks that ``sms`` SMs hold at once
    (``resident(bm, route, dy_route)`` an SM), each of at least
    ``WGRAD_MIN_STEPS`` stages; the warp-specialised design's follow
    :func:`_ws_slices`, within ``WGRAD_WS_MAX_WAVES`` waves and
    ``WGRAD_WS_MAX_FLOATS`` of workspace. The first design's rule, fed
    this design's tile and its one block an SM, ran slower on one H100
    (PERF.md §6, both plans timed in turns, batch 200): VGG-16's 11
    warp-specialised convs 123.3 ms against 107.7 (at C_out 512 it gives
    2 slices, 192 blocks on 132 SMs: +35-37%), AlexNet's three +2.3%,
    small_VGG9's four +1.2%, and 16 samples of one row up to +32%."""
    cout, cin, kh, kw = w_shape
    groups = samples or 1
    pixels = rows // groups * out_hw[0] * out_hw[1]
    bm, bn, bk = wgrad_tile(route, cout)
    rows_pad = -(-cout // bm) * bm
    cols_pad = -(-(cin * kh * kw) // bn) * bn
    tiles = rows_pad // bm * cols_pad // bn * groups
    steps = -(-pixels // bk)
    slots = sms * resident(bm, route, dy_route)
    # the grid's third dimension holds groups * slices blocks
    most = min(steps, 65535 // groups)
    if route == "ws":
        most = min(most, WGRAD_WS_MAX_WAVES * slots // tiles,
                   WGRAD_WS_MAX_FLOATS // (tiles * bm * bn))
        slices = _ws_slices(tiles, steps, slots, max(1, most))
    else:
        want = int(WGRAD_WAVES * slots // tiles)
        slices = max(1, min(want, steps // WGRAD_MIN_STEPS, most))
    chunk = -(-steps // slices) * bk
    slices = -(-pixels // chunk)
    # one slice of unpadded tiles: the blocks write dW itself
    direct = slices == 1 and rows_pad == cout and cols_pad == cin * kh * kw
    return WgradPlan(bm, bn, bk, route, dy_route, groups, pixels, slices,
                     chunk,
                     0 if direct else groups * slices * rows_pad * cols_pad)


@functools.cache
def _resident(bm: int, route: str, dy_route: str) -> int:
    """Blocks of kernel C an SM holds at once (the CUDA occupancy API)."""
    lib = _kernels.lib("conv_wgrad")
    n = lib.clsurvey_conv_wgrad_ws_occupancy(bm) if route == "ws" else \
        lib.clsurvey_conv_wgrad_occupancy(bm, int(route == "vec"),
                                          int(dy_route == "vec"))
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
    :func:`wgrad_design`'s route and :func:`wgrad_plan`'s tile and split
    for this card."""
    cout, cin = w_shape[:2]
    n, _, oh, ow = dy.shape
    x_nhwc, dy_nhwc = _nhwc(x, dy, w_shape)
    dy_route = wgrad_route(cout, dy_nhwc.data_ptr())
    route = wgrad_design(wgrad_route(cin, x_nhwc.data_ptr()), dy_route, cout,
                         n // (samples or 1) * oh * ow)
    plan = wgrad_plan(w_shape, (oh, ow), n, samples, route, dy_route,
                      _sms(x.device), _resident)
    out = _launch(plan, x_nhwc, dy_nhwc, w_shape, stride, padding)
    return out if samples else out[0]


def _sms(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _nhwc(x: torch.Tensor, dy: torch.Tensor, w_shape):
    """The NHWC input and cotangent of a call of kernel C (free for
    channels_last), refused where :func:`takes_kernel` or the shapes do
    not fit."""
    if not takes_kernel(x, dy, w_shape) or dy.device != x.device \
            or dy.shape[1] != w_shape[0]:
        raise ValueError(f"kernel C: cotangent {tuple(dy.shape)} "
                         f"{dy.dtype} for input {tuple(x.shape)} {x.dtype}, "
                         f"weight {tuple(w_shape)}")
    return x.permute(0, 2, 3, 1).contiguous(), \
        dy.permute(0, 2, 3, 1).contiguous()


def _launch(plan: WgradPlan, x_nhwc: torch.Tensor, dy_nhwc: torch.Tensor,
            w_shape, stride: int, padding: int) -> torch.Tensor:
    """One launch of kernel C by ``plan`` (its sum over slices included),
    counted under its route: (groups, *w_shape). ``csrc/conv_wgrad.cu``
    refuses a plan whose copies the tensors do not allow."""
    cout, cin, k, _ = w_shape
    n, h, w, _ = x_nhwc.shape
    _, oh, ow, _ = dy_nhwc.shape
    dev = x_nhwc.device
    ws = torch.empty(plan.ws_floats, device=dev, dtype=torch.float32)
    # (V, C_out, k, k, C_in): the channels_last weight's own layout
    out = torch.empty((plan.groups, cout, k, k, cin), device=dev,
                      dtype=torch.float32).permute(0, 1, 4, 2, 3)
    lib = _kernels.lib("conv_wgrad")
    args = (x_nhwc.data_ptr(), dy_nhwc.data_ptr(),
            ws.data_ptr() if plan.ws_floats else None, out.data_ptr(), n, h,
            w, cin, oh, ow, cout, k, stride, padding, plan.groups,
            plan.slices, plan.chunk, plan.bm)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        if plan.route == "ws":
            rc = lib.clsurvey_conv_wgrad_ws(*args, stream)
        else:
            rc = lib.clsurvey_conv_wgrad(*args, int(plan.route == "vec"),
                                         int(plan.dy_route == "vec"), stream)
    _kernels.record_launch(rc, "conv_wgrad", n, plan.route)
    return out


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
